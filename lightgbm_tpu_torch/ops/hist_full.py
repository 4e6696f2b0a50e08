"""Full-pass histogram of unpacked bin codes (CUDA kernel + plain torch).

Port of ``lightgbm_tpu/ops/hist_pallas.py:build_histogram_pallas``, the
masked learner's histogram:

    hist[f, b, c] = sum_r [bins[f, r] == b] * w[c, r]

over uint8 or uint16 codes (the dataset's matrix past 256 bins), in true
float32, exactly ``num_bins`` wide, codes at or past ``num_bins`` dropped.
On a CUDA tensor ``build_histogram_full`` launches the hand-written Hopper
kernel ``csrc/hist_full.cu`` (design and bound in that file's header); on a
CPU tensor it runs ``ops/histogram.py:build_histogram_onehot``, the plain
torch version the kernel is held against.  There is no fallback from one to
the other.  The TPU kernel's one-hot contraction and its 128-lane bin padding
are MXU mechanism and are not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from .. import native
from .histogram import build_histogram_onehot

#: bins per block tile (csrc/hist_full.cu: kMaxTile); wider histograms take
#: more tiles, each block counting only its own tile's codes
TILE_BINS = 1024
#: the widest histogram a uint16 code can fill
MAX_BINS = 1 << 16
#: pass-1 blocks aimed for per launch (about four per SM of an H100); fixed,
#: so the launch geometry and every sum's order depend only on shapes
_TARGET_BLOCKS = 528
_CODE_TYPES = (torch.uint8, torch.uint16)


def _geometry(blocks_per_chunk: int, n: int):
    """(nchunks, chunk rows) of pass 1: about ``_TARGET_BLOCKS`` blocks, at
    most one chunk per 1024 rows, chunks a multiple of 256 rows (one step of
    the block's eight warps)."""
    nchunks = max(1, min(n // 1024, -(-_TARGET_BLOCKS // blocks_per_chunk)))
    chunk = -(-n // nchunks)
    chunk = -(-chunk // 256) * 256
    return -(-n // chunk), chunk


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = native.load("hist_full")
        lib.lgbt_hist_full.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.lgbt_hist_full.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def build_histogram_full(bins: torch.Tensor, w: torch.Tensor, *,
                         num_bins: int) -> torch.Tensor:
    """hist[f, b, c] = sum_r [bins[f, r] == b] * w[c, r].

    bins : (F, N) uint8 or uint16 codes with contiguous rows (a view of the
           first F rows of a larger matrix is taken as it is).
    w    : (3, N) float32 (g*m, h*m, m), rows contiguous.
    Returns (F, num_bins, 3) float32.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (counted in
    ``build_histogram_full.launches``) or raise.
    """
    if bins.device.type == "cpu" and w.device.type == "cpu":
        return build_histogram_onehot(bins, w, num_bins=num_bins)
    if bins.device.type != "cuda" or w.device != bins.device:
        raise ValueError(f"bins and w must both lie on one CUDA device "
                         f"(got {bins.device} and {w.device})")
    if bins.dtype not in _CODE_TYPES or bins.dim() != 2 \
            or bins.stride(1) != 1:
        raise ValueError(f"bins must be a 2-D uint8 or uint16 tensor with "
                         f"contiguous rows, got {bins.dtype} of shape "
                         f"{tuple(bins.shape)}")
    f, n = bins.shape
    if w.dtype != torch.float32 or tuple(w.shape) != (3, n) \
            or w.stride(1) != 1:
        raise ValueError(f"w must be a (3, {n}) float32 tensor with "
                         f"contiguous rows, got {tuple(w.shape)} {w.dtype}")
    if not 1 <= num_bins <= MAX_BINS or f < 1 or n < 1:
        raise ValueError(f"need 1 <= num_bins <= {MAX_BINS}, F >= 1 and "
                         f"N >= 1, got num_bins={num_bins}, F={f}, N={n}")
    tile = min(num_bins, TILE_BINS)
    nchunks, chunk = _geometry(f * -(-num_bins // tile), n)
    partial = torch.empty(f * nchunks * num_bins * 3, dtype=torch.float32,
                          device=bins.device)
    out = torch.empty((f, num_bins, 3), dtype=torch.float32,
                      device=bins.device)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    native.launch("hist_full", _lib().lgbt_hist_full, bins, bins.stride(0),
                  bins.element_size(), w, w.stride(0), f, n, num_bins, tile,
                  nchunks, chunk, partial, out, stream)
    build_histogram_full.launches += 1
    return out


build_histogram_full.launches = 0
