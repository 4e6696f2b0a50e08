"""Stable row partition of the wave learner's row lanes (CUDA kernel + plain).

Port of ``lightgbm_tpu/ops/partition_pallas.py:apply_partition``: every lane
of every row moves to ``dest`` (a permutation of ``[0, N)`` that the caller
computes from exclusive prefix sums of the split flags, as
``learner_wave.py`` does; rows outside the sortable windows have
``dest = pos``), so each split window is stably partitioned in place and
every other row keeps its place.

On a CUDA tensor ``apply_partition`` launches the hand-written Hopper kernel
``csrc/partition.cu`` (design and bound in that file's header); on a CPU
tensor it runs ``apply_partition_plain``, the plain torch version the kernel
is held against.  The TPU kernel's chunk list (``build_partition_chunks``),
bf16 byte planes and ``_recombine`` are TPU mechanism (no scatter on the
TPU) and are not carried over; ``exclusive_cumsum_i32`` becomes
``torch.cumsum`` on int32, which is exact.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import native

Lanes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def exclusive_cumsum(flags: torch.Tensor) -> torch.Tensor:
    """(..., N) {0, 1} flags -> (..., N) int32 exclusive prefix sums."""
    f = flags.to(torch.int32)
    return torch.cumsum(f, dim=-1, dtype=torch.int32) - f


def _outputs(bins, w, rid, lid, out: Optional[Lanes]) -> Lanes:
    if out is None:
        return (torch.empty_like(bins), torch.empty_like(w),
                torch.empty_like(rid), torch.empty_like(lid))
    for a, b in zip(out, (bins, w, rid, lid)):
        if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device \
                or not a.is_contiguous():
            raise ValueError("out must hold four contiguous tensors shaped "
                             "like the input lanes")
    return out


def apply_partition_plain(bins: torch.Tensor, w: torch.Tensor,
                          rid: torch.Tensor, lid: torch.Tensor,
                          dest: torch.Tensor, out: Optional[Lanes] = None
                          ) -> Lanes:
    """Plain torch version: one ``index_copy_`` per lane."""
    bo, wo, ro, lo = _outputs(bins, w, rid, lid, out)
    d = dest.to(torch.int64)
    bo.index_copy_(1, d, bins)
    wo.index_copy_(1, d, w)
    ro.index_copy_(0, d, rid)
    lo.index_copy_(0, d, lid)
    return bo, wo, ro, lo


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = native.load("partition")
        lib.lgbt_partition.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.lgbt_partition.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def apply_partition(bins: torch.Tensor, w: torch.Tensor, rid: torch.Tensor,
                    lid: torch.Tensor, dest: torch.Tensor,
                    out: Optional[Lanes] = None) -> Lanes:
    """Move every lane of row r to ``dest[r]``.

    bins : (Fw, N) int32 packed bin words     w   : (3, N) float32
    rid  : (N,) int64 original row ids          lid : (N,) int32 node slots
    dest : (N,) int32, a permutation of [0, N)
    out  : four tensors shaped like the lanes to write into (default: new
           ones); the inputs are not modified.
    Returns the four permuted lanes.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (counted in ``apply_partition.launches``)
    or raise.  A ``dest`` entry outside [0, N) raises on the CPU
    (``index_copy_``) and traps the kernel on the card, which surfaces as a
    CUDA error at the next synchronisation.
    """
    lanes = (bins, w, rid, lid, dest)
    if all(t.device.type == "cpu" for t in lanes):
        return apply_partition_plain(bins, w, rid, lid, dest, out)
    dev = bins.device
    if dev.type != "cuda" or any(t.device != dev for t in lanes):
        raise ValueError("the lanes and dest must all lie on one CUDA device")
    if bins.dim() != 2 or bins.dtype != torch.int32:
        raise ValueError("bins must be a 2-D int32 tensor")
    fw, n = bins.shape
    want = ((w, torch.float32, (3, n)), (rid, torch.int64, (n,)),
            (lid, torch.int32, (n,)), (dest, torch.int32, (n,)))
    for t, dt, shape in want:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"expected a {dt} tensor of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in lanes):
        raise ValueError("the lanes and dest must be contiguous")
    if not 1 <= n < 2 ** 31 or fw < 1:
        raise ValueError(f"need 1 <= N < 2^31 and Fw >= 1, got N={n}, Fw={fw}")
    bo, wo, ro, lo = _outputs(bins, w, rid, lid, out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    native.launch("partition", _lib().lgbt_partition, bins, fw, w, rid, lid,
                  dest, n, bo, wo, ro, lo, stream)
    native.count(apply_partition)
    return bo, wo, ro, lo


apply_partition.launches = 0
