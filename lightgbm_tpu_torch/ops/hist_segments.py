"""Per-member segment histograms of the wave learner (CUDA kernel + plain).

Port of ``lightgbm_tpu/ops/hist_pallas.py:build_histogram_segments``: one
call builds the histogram of every wave member's rows,

    out[m, 4k+s, b, c] = sum over r in [start[m], start[m] + cnt[m])
                         with lid[r] == leaf[m] of
                         [byte_s(words[k, r]) == b] * w[c, r]

so a wave's smaller-child histograms cost one launch, not one per member.
``quant=True`` is the quantized-gradient mode of ``hist_packed``: channel 2
sums lane 1 (h) instead of lane 2 (bag).
Member ranges may start at any row and may overlap: frozen members share
their parent's span and are told apart by the leaf id.  The TPU kernel's
scalar-prefetched chunk list (``learner_wave.py:1152-1195``) and its grid
buckets are TPU mechanism and are not carried over.

On a CUDA tensor ``build_histogram_segments`` launches the hand-written
Hopper kernel ``csrc/hist_segments.cu`` (design and bound in that file's
header); on a CPU tensor it runs ``build_histogram_segments_plain``, the
plain torch version the kernel is held against.  The kernel sums true
float32; ``dp`` (the reference's ``gpu_use_dp``) is the plain version's.
"""

from __future__ import annotations

import ctypes

import torch

from .. import native
from .hist_packed import build_histogram_packed_plain, quant_lanes

#: pass-1 blocks aimed for per launch (about four per SM of an H100); fixed,
#: so the launch geometry and every sum's order depend only on shapes
_TARGET_BLOCKS = 528
#: smallest chunk of rows a block takes
_MIN_CHUNK = 1024


def build_histogram_segments_plain(words: torch.Tensor, w: torch.Tensor,
                                   lid: torch.Tensor, start: torch.Tensor,
                                   cnt: torch.Tensor, leaf: torch.Tensor, *,
                                   num_bins: int, max_cnt: int = 0,
                                   dp: bool = False, quant: bool = False
                                   ) -> torch.Tensor:
    """Plain torch version: one masked ``index_add_`` histogram per member
    (the windows are read to the host; ``max_cnt`` is not needed).  Returns
    (K, 4*Fw, num_bins, 3), float64 with ``dp``."""
    fw = words.shape[0]
    acc = torch.float64 if dp else torch.float32
    if quant:
        w = quant_lanes(w)
    k = start.shape[0]
    out = torch.zeros((k, 4 * fw, num_bins, 3), dtype=acc,
                      device=words.device)
    wins = torch.stack([start.to(torch.int64), cnt.to(torch.int64),
                        leaf.to(torch.int64)], 1).tolist()
    for m, (s, c, lf) in enumerate(wins):
        if c <= 0:
            continue
        wm = w[:, s:s + c] * (lid[s:s + c] == lf)
        out[m] = build_histogram_packed_plain(words[:, s:s + c], wm,
                                              num_bins=num_bins, dp=dp)
    return out


def segment_geometry(fw: int, k: int, max_cnt: int):
    """(nchunks, chunk rows) of pass 1 for K members whose windows hold at
    most ``max_cnt`` rows: about ``_TARGET_BLOCKS`` blocks, chunks of at
    least ``_MIN_CHUNK`` rows and a multiple of 256 (one step of the block's
    eight warps)."""
    max_cnt = max(int(max_cnt), 1)
    nchunks = max(1, min(-(-max_cnt // _MIN_CHUNK),
                         -(-_TARGET_BLOCKS // (fw * k))))
    chunk = -(-max_cnt // nchunks)
    chunk = -(-chunk // 256) * 256
    return -(-max_cnt // chunk), chunk


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = native.load("hist_segments")
        lib.lgbt_hist_segments.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.lgbt_hist_segments.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def build_histogram_segments(words: torch.Tensor, w: torch.Tensor,
                             lid: torch.Tensor, start: torch.Tensor,
                             cnt: torch.Tensor, leaf: torch.Tensor, *,
                             num_bins: int, max_cnt: int,
                             quant: bool = False) -> torch.Tensor:
    """Histograms of K members' rows (see the module docstring).

    words : (Fw, N) int32, w (3, N) float32, lid (N,) int32, all contiguous
    start, cnt, leaf : (K,) integer tensors on the same device
    max_cnt : an upper bound on every ``cnt[m]``, known on the host; it
              sizes the launch (rows past a member's count are never read)
    quant : channel 2 sums lane 1 (h) instead of lane 2.
    Returns (K, 4*Fw, num_bins, 3) float32.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (counted in
    ``build_histogram_segments.launches``, the quant-mode launches also in
    ``.quant_launches``) or raise.
    """
    args = (words, w, lid, start, cnt, leaf)
    if all(t.device.type == "cpu" for t in args):
        return build_histogram_segments_plain(words, w, lid, start, cnt,
                                              leaf, num_bins=num_bins,
                                              max_cnt=max_cnt, quant=quant)
    dev = words.device
    if dev.type != "cuda" or any(t.device != dev for t in args):
        raise ValueError("words, w, lid and the member arrays must all lie "
                         "on one CUDA device")
    if words.dim() != 2 or words.dtype != torch.int32:
        raise ValueError("words must be a 2-D int32 tensor")
    fw, n = words.shape
    if w.dtype != torch.float32 or tuple(w.shape) != (3, n) \
            or lid.dtype != torch.int32 or tuple(lid.shape) != (n,):
        raise ValueError(f"w must be (3, {n}) float32 and lid ({n},) int32")
    if not all(t.is_contiguous() for t in (words, w, lid)):
        raise ValueError("words, w and lid must be contiguous")
    k = start.shape[0]
    if start.dim() != 1 or cnt.shape != (k,) or leaf.shape != (k,) or k < 1:
        raise ValueError("start, cnt and leaf must be (K,) with K >= 1")
    if not 1 <= num_bins <= 256 or fw < 1:
        raise ValueError(f"need 1 <= num_bins <= 256 and Fw >= 1, got "
                         f"num_bins={num_bins}, Fw={fw}")
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows do not fit int32 row indices")
    nchunks, chunk = segment_geometry(fw, k, max_cnt)
    s32, c32, l32 = (t.to(torch.int32).contiguous() for t in
                     (start, cnt, leaf))
    e = 4 * num_bins * 3
    partial = torch.empty(fw * k * nchunks * e, dtype=torch.float32,
                          device=dev)
    out = torch.empty((k, 4 * fw, num_bins, 3), dtype=torch.float32,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().lgbt_hist_segments(
        words.data_ptr(), w.data_ptr(), lid.data_ptr(), n, fw,
        s32.data_ptr(), c32.data_ptr(), l32.data_ptr(), k, num_bins,
        int(quant), nchunks, chunk, partial.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hist_segments kernel launch failed: CUDA error "
                           f"{err}")
    build_histogram_segments.launches += 1
    build_histogram_segments.quant_launches += int(quant)
    return out


build_histogram_segments.launches = 0
build_histogram_segments.quant_launches = 0
