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
import functools
from typing import NamedTuple

import torch

from .. import native
from .histogram import build_histogram_onehot

#: bins per block tile (csrc/hist_full.cu: kMaxTile); wider histograms take
#: more tiles, each block counting only its own tile's codes
TILE_BINS = 1024
#: the widest histogram a uint16 code can fill
MAX_BINS = 1 << 16
#: features a block takes, a warp each (csrc/hist_full.cu: kFeat)
FEATURES_PER_BLOCK = 4
#: rows per shared-memory stage (csrc/hist_full.cu: kRows)
STAGE_ROWS = 256
#: SMs of an H100 SXM, and the shared memory of one SM and the part each
#: block reserves; fixed, so the launch geometry and with it every sum's
#: order depend only on shapes
SMS = 132
SMEM_PER_SM = 233_472
SMEM_RESERVED = 1024
_CODE_TYPES = (torch.uint8, torch.uint16)


class FullPlan(NamedTuple):
    """The launch geometry of ``csrc/hist_full.cu``: block (c, g, t) takes
    rows [c * chunk, min(S, (c + 1) * chunk)), features [4g, 4g + 4) and
    bins [t * tile, (t + 1) * tile), clipped to F and num_bins."""
    tile: int
    ntiles: int
    groups: int
    nchunks: int
    chunk: int


@functools.lru_cache(maxsize=256)
def full_plan(f: int, s: int, num_bins: int) -> FullPlan:
    """About one wave of blocks on the card (SMS times the blocks an SM
    holds at this tile's shared memory, at most 8), chunks a multiple of
    ``STAGE_ROWS`` and at least four rows per bin of the tile, so a chunk's
    partial stays well under its codes' bytes."""
    tile = min(num_bins, TILE_BINS)
    ntiles = -(-num_bins // tile)
    groups = -(-f // FEATURES_PER_BLOCK)
    smem = full_smem_bytes(tile)
    per_sm = max(1, min(8, SMEM_PER_SM // (smem + SMEM_RESERVED)))
    min_chunk = _round_up(max(STAGE_ROWS, 4 * tile), STAGE_ROWS)
    nchunks = max(1, min(s // min_chunk, SMS * per_sm // (groups * ntiles)))
    chunk = _round_up(-(-s // nchunks), STAGE_ROWS)
    return FullPlan(tile, ntiles, groups, -(-s // chunk), chunk)


def full_smem_bytes(tile: int) -> int:
    """A block's shared memory (csrc/hist_full.cu: smem_bytes): four
    histograms and group masks of ``tile`` bins, three weight stages, and
    the list of one segment's (up to 896) active row groups."""
    return 4 * (FEATURES_PER_BLOCK * tile * 4 + 3 * 3 * STAGE_ROWS) \
        + 896 * 2 + 32


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = native.load("hist_full")
        lib.lgbt_hist_full.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
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
    ``build_histogram_full.launches``) or raise; the result is then the
    front of the one allocation that also holds the kernel's scratch.
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
    plan = full_plan(f, n, num_bins)
    # one allocation: the output, then the row ballots, the chunks'
    # partials and their bitmaps
    out_n = f * num_bins * 3
    act_n = -(-n // 32)
    part_n = f * num_bins * 3 * plan.nchunks if plan.nchunks > 1 else 0
    bits_n = f * -(-num_bins // 32) * plan.nchunks if plan.nchunks > 1 else 0
    buf = torch.empty(out_n + act_n + part_n + bits_n, dtype=torch.float32,
                      device=bins.device)
    out = buf[:out_n].view(f, num_bins, 3)
    act = buf.data_ptr() + 4 * out_n
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    native.launch("hist_full", _lib().lgbt_hist_full, bins, bins.stride(0),
                  bins.element_size(), w, w.stride(0), f, n, num_bins,
                  plan.tile, plan.nchunks, plan.chunk, act, act + 4 * act_n,
                  act + 4 * (act_n + part_n), out, stream)
    native.count(build_histogram_full)
    return out


build_histogram_full.launches = 0
