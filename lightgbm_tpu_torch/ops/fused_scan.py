"""Fused child scans of a quantized growth wave (CUDA kernel + plain torch).

Port of ``lightgbm_tpu/ops/scan_pallas.py:fused_child_scans``: for all K
members of a wave, given each member's SMALLER-child histogram and its
parent's pooled histogram, one call does the sibling subtraction, the
left/right selection, the raw children's pool writes, the per-child
``FixHistogram`` and both children's split scans.  The candidates come back
as a (2K, F)-batched ``SplitCandidates`` in the interleaved child order
[l0, r0, l1, r1, ...] with ``find_best_splits``'s conventions.

Where the TPU kernel hands the raw children back for the caller's pool
writes, this port writes them into the pool in place: the left child over
the parent's slot ``ph[k]``, the right child into the fresh slot ``rh[k]``,
as the wave learner's unfused step does.

On a CUDA tensor ``fused_child_scans`` is one launch of the hand-written
Hopper kernel ``csrc/fused_scan.cu`` (design and bound in that file's
header), which also forms the leaf totals and writes every
``SplitCandidates`` field itself; for the learner's tensors no other device
op runs.  On a CPU tensor it runs ``fused_child_scans_plain``, the unfused
composition the wave learner runs without it: subtraction,
``ops/split.py:fix_histogram`` and ``find_best_splits``.  The kernel's scan
is ``split_scan``'s and its FixHistogram sum the same pairwise tree, so on
any float32 input every field and both pool rows equal the plain version on
the CPU bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import native
from .scan import N_PLANES, candidates_from_kernel
from .split import SplitCandidates, find_best_splits, fix_histogram


def _check_pool(h_small, pool, ph, rh, left_small):
    k, f, b, c = h_small.shape
    if c != 3 or pool.dim() != 4 or tuple(pool.shape[1:]) != (f, b, 3):
        raise ValueError(f"h_small must be (K, F, B, 3) and pool (H, F, B, 3)"
                         f", got {tuple(h_small.shape)} and "
                         f"{tuple(pool.shape)}")
    if any(t.shape != (k,) for t in (ph, rh, left_small)):
        raise ValueError("ph, rh and left_small must be (K,)")


def fused_child_scans_plain(h_small: torch.Tensor, pool: torch.Tensor,
                            ph: torch.Tensor, rh: torch.Tensor,
                            left_small: torch.Tensor, sum_g2: torch.Tensor,
                            sum_h2: torch.Tensor, num2: torch.Tensor,
                            num_bin: torch.Tensor, missing_type: torch.Tensor,
                            default_bin: torch.Tensor,
                            feature_mask: torch.Tensor, **kw
                            ) -> SplitCandidates:
    """Plain torch version: the unfused composition (see the module
    docstring); ``kw`` are ``find_best_splits``'s split parameters."""
    _check_pool(h_small, pool, ph, rh, left_small)
    k = h_small.shape[0]
    ph, rh = ph.to(torch.int64), rh.to(torch.int64)
    h_large = pool.index_select(0, ph) - h_small
    lsm = left_small.view(k, 1, 1, 1)
    hl = torch.where(lsm, h_small, h_large)
    hr = torch.where(lsm, h_large, h_small)
    pool.index_copy_(0, ph, hl)
    pool.index_copy_(0, rh, hr)
    h2 = torch.stack([hl, hr], 1).reshape((2 * k,) + hl.shape[1:])
    h2 = fix_histogram(h2, sum_g2, sum_h2, num2, default_bin)
    return find_best_splits(h2, sum_g2, sum_h2, num2, num_bin, missing_type,
                            default_bin, feature_mask, **kw)


def _as(t: torch.Tensor, dtype, contiguous: bool = False) -> torch.Tensor:
    """``t`` in ``dtype`` (and contiguous), converted only where it is not:
    a call of ``.to`` costs host time even when it returns ``t``."""
    if t.dtype != dtype:
        t = t.to(dtype)
    return t.contiguous() if contiguous and not t.is_contiguous() else t


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = native.load("fused_scan")
        P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
        lib.lgbt_fused_scan.argtypes = [
            P, P, L, P, L, P, L, P, L, P, L, P, L, P, L, P, P, P, P, L, I, I,
            I, F, F, F, I, F, F, F, P, P, P]
        lib.lgbt_fused_scan.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def fused_child_scans(h_small: torch.Tensor, pool: torch.Tensor,
                      ph: torch.Tensor, rh: torch.Tensor,
                      left_small: torch.Tensor, sum_g2: torch.Tensor,
                      sum_h2: torch.Tensor, num2: torch.Tensor,
                      num_bin: torch.Tensor, missing_type: torch.Tensor,
                      default_bin: torch.Tensor, feature_mask: torch.Tensor,
                      *, lambda_l1: float = 0.0, lambda_l2: float = 0.0,
                      max_delta_step: float = 0.0,
                      min_data_in_leaf: int = 20,
                      min_sum_hessian_in_leaf: float = 1e-3,
                      min_gain_to_split: float = 0.0) -> SplitCandidates:
    """Subtract, select, write the pool, fix and scan both children of K
    members.

    h_small    : (K, F, B, 3) float32, each member's smaller child
    pool       : (H, F, B, 3) float32 histogram pool, written in place: the
                 left child over ``ph[k]`` (which holds the parent), the
                 right child into ``rh[k]``; the slots must be distinct
    left_small : (K,) bool;  sum_g2, sum_h2, num2 : (2K,) child totals,
                 interleaved [l0, r0, l1, r1, ...];  feature_mask (F,) or
                 (2K, F) bool
    Returns (2K, F)-batched ``SplitCandidates``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (counted in
    ``fused_child_scans.launches``) or raise.
    """
    kw = dict(lambda_l1=lambda_l1, lambda_l2=lambda_l2,
              max_delta_step=max_delta_step,
              min_data_in_leaf=min_data_in_leaf,
              min_sum_hessian_in_leaf=min_sum_hessian_in_leaf,
              min_gain_to_split=min_gain_to_split)
    if h_small.device.type == "cpu" and pool.device.type == "cpu":
        return fused_child_scans_plain(
            h_small, pool, ph, rh, left_small, sum_g2, sum_h2, num2, num_bin,
            missing_type, default_bin, feature_mask, **kw)
    dev = pool.device
    if dev.type != "cuda" or h_small.device != dev:
        raise ValueError("h_small and pool must lie on one CUDA device")
    if h_small.dtype != torch.float32 or pool.dtype != torch.float32 \
            or h_small.dim() != 4:
        raise ValueError("h_small and pool must be float32 (K, F, B, 3) and "
                         "(H, F, B, 3) tensors")
    _check_pool(h_small, pool, ph, rh, left_small)
    if not pool.is_contiguous():
        raise ValueError("pool must be contiguous (it is written in place)")
    k, f, b, _ = h_small.shape
    if not 1 <= b <= 256 or k < 1 or f < 1:
        raise ValueError(f"need K, F >= 1 and 1 <= B <= 256, got {k, f, b}")
    # every conversion below is skipped for the learner's tensors (int64
    # slots, a bool flag, float32 sums, int32 metadata, a bool mask, a
    # contiguous h_small): the call is then one kernel launch and no other
    # device op
    slots = [_as(t, torch.int64) for t in (ph, rh)]
    ls = _as(left_small, torch.bool)
    sums = [_as(t, torch.float32) for t in (sum_g2, sum_h2, num2)]
    meta = [_as(t, torch.int32, contiguous=True) for t in
            (num_bin, missing_type, default_bin)]
    if any(t.device != dev for t in slots + [ls] + sums + meta):
        raise ValueError("slots, flags, child totals and feature metadata "
                         "must lie on the pool's device")
    if any(t.shape != (2 * k,) for t in sums) \
            or any(t.shape != (f,) for t in meta):
        raise ValueError(f"child totals must be ({2 * k},) and feature "
                         f"metadata ({f},)")
    fm = _as(feature_mask, torch.bool)
    if fm.device != dev or fm.shape not in ((f,), (2 * k, f)):
        raise ValueError(f"feature_mask must be ({f},) or ({2 * k}, {f}) on "
                         f"the pool's device")
    if fm.stride(-1) != 1:
        fm = fm.contiguous()
    if not h_small.is_contiguous():
        h_small = h_small.contiguous()
    planes = torch.empty((N_PLANES, 2 * k, f), dtype=torch.float32,
                         device=dev)
    dleft = torch.empty((2 * k, f), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    native.launch("fused_scan", _lib().lgbt_fused_scan, h_small, pool,
                  pool.shape[0], slots[0], slots[0].stride(0), slots[1],
                  slots[1].stride(0), ls, ls.stride(0), sums[0],
                  sums[0].stride(0), sums[1], sums[1].stride(0), sums[2],
                  sums[2].stride(0), *meta, fm,
                  fm.stride(0) if fm.dim() == 2 else 0, k, f, b,
                  float(lambda_l1), float(lambda_l2), float(max_delta_step),
                  int(max_delta_step > 0.0), float(min_data_in_leaf),
                  float(min_sum_hessian_in_leaf), float(min_gain_to_split),
                  planes, dleft, stream)
    native.count(fused_child_scans)
    if fused_child_scans.shapes is not None \
            and not torch.cuda.is_current_stream_capturing():
        fused_child_scans.shapes.append(k)
    return candidates_from_kernel(planes, dleft)


fused_child_scans.launches = 0
#: a list to record each launch's member count K in, or None;
#: a launch captured into a CUDA graph records nothing
fused_child_scans.shapes = None
