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
buckets are TPU mechanism and are not carried over; the card balances the
work with ``segment_tile_plan``'s tile table instead (rows cut into
``TILE_ROWS``-row tiles, consecutive tiles to each block).

On a CUDA tensor ``build_histogram_segments`` launches the hand-written
Hopper kernel ``csrc/hist_segments.cu`` (design and bound in that file's
header); on a CPU tensor it runs ``build_histogram_segments_plain``, the
plain torch version the kernel is held against.  The kernel sums true
float32; ``dp`` (the reference's ``gpu_use_dp``) is the plain version's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import native
from .hist_packed import build_histogram_packed_plain, quant_lanes

#: rows per tile of the kernel's plan (one pipeline stage, kTile in
#: csrc/hist_segments.cu)
TILE_ROWS = 64
#: blocks of the kernel one SM holds at once (113 KB of shared memory each
#: at Fw = 8, 255 bins)
_BLOCKS_PER_SM = 2
#: fewest rows a block is sized for: below it, writing and summing a
#: block's 98 KB of partial histograms outweighs the rows it reads
_MIN_BLOCK_ROWS = 256


def build_histogram_segments_plain(words: torch.Tensor, w: torch.Tensor,
                                   lid: torch.Tensor, start: torch.Tensor,
                                   cnt: torch.Tensor, leaf: torch.Tensor, *,
                                   num_bins: int, rows_bound: int = 0,
                                   dp: bool = False, quant: bool = False
                                   ) -> torch.Tensor:
    """Plain torch version: one masked ``index_add_`` histogram per member
    (the windows are read to the host; ``rows_bound`` is not needed).
    Returns (K, 4*Fw, num_bins, 3), float64 with ``dp``."""
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


def segment_grid(rows_bound: int, sms: int) -> int:
    """Blocks of the kernel's grid for a wave of at most ``rows_bound``
    member rows on a card of ``sms`` SMs: one per ``_MIN_BLOCK_ROWS`` rows,
    at most the blocks the card holds at once."""
    return max(1, min(_BLOCKS_PER_SM * sms,
                      -(-int(rows_bound) // _MIN_BLOCK_ROWS)))


def segment_tile_plan(start: torch.Tensor, cnt: torch.Tensor, grid: int):
    """The kernel's work plan in plain torch (what each block computes from
    the device counts).  Member m's rows are cut into ceil(cnt[m] /
    TILE_ROWS) tiles, numbered over the wave by an exclusive scan of those
    counts; block b takes tiles [b*q, (b+1)*q) with q = ceil(tiles / grid).
    Returns one int64 column per tile: ``member``, ``row0`` and ``rows``
    (the tile's rows), ``block``, ``slot`` (the partial a block writes for
    a member, ``block + member``) and ``direct`` (the member's tiles all lie
    in one block, which writes its output directly); with ``q``."""
    cnt = cnt.to(torch.int64).clamp(min=0)
    nt = -(-cnt // TILE_ROWS)
    first = torch.cumsum(nt, 0) - nt
    total = int(nt.sum())
    q = -(-total // grid)
    member = torch.repeat_interleave(torch.arange(cnt.numel()), nt)
    j = torch.arange(total) - first[member]
    block = j.new_zeros(total) if q == 0 else torch.arange(total) // q
    b_first = first // max(q, 1)
    b_last = (first + nt - 1) // max(q, 1)
    return {"member": member,
            "row0": start.to(torch.int64)[member] + j * TILE_ROWS,
            "rows": torch.clamp(cnt[member] - j * TILE_ROWS, max=TILE_ROWS),
            "block": block, "slot": block + member,
            "direct": (b_first == b_last)[member], "q": q}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = native.load("hist_segments")
        lib.lgbt_hist_segments.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.lgbt_hist_segments.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def build_histogram_segments(words: torch.Tensor, w: torch.Tensor,
                             lid: torch.Tensor, start: torch.Tensor,
                             cnt: torch.Tensor, leaf: torch.Tensor, *,
                             num_bins: int, rows_bound: int,
                             quant: bool = False) -> torch.Tensor:
    """Histograms of K members' rows (see the module docstring).

    words : (Fw, N) int32, w (3, N) float32, lid (N,) int32, all contiguous
    start, cnt, leaf : (K,) integer tensors on the same device
    rows_bound : an upper bound on ``sum(cnt)``, known on the host (the
              wave learner passes its padded row count); it sizes the
              grid, the device counts divide the work
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
                                              quant=quant)
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
    if n >= 2 ** 31 or k >= 2 ** 16:
        raise ValueError(f"{n} rows or {k} members past the kernel's range")
    grid = segment_grid(rows_bound, _sm_count(dev.index))
    s64, c64, l64 = (t.to(torch.int64).contiguous() for t in
                     (start, cnt, leaf))
    e = 4 * num_bins * 3
    partial = torch.empty((grid + k) * fw * e, dtype=torch.float32,
                          device=dev)
    seg = torch.empty(2 * k, dtype=torch.int32, device=dev)
    out = torch.empty((k, 4 * fw, num_bins, 3), dtype=torch.float32,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    native.launch("hist_segments", _lib().lgbt_hist_segments, words, w, lid,
                  n, fw, s64, c64, l64, k, num_bins, int(quant), grid,
                  partial, seg, out, stream)
    native.count(build_histogram_segments)
    native.count(build_histogram_segments, "quant_launches", int(quant))
    if build_histogram_segments.shapes is not None \
            and not torch.cuda.is_current_stream_capturing():
        build_histogram_segments.shapes.append((cnt, rows_bound))
    return out


build_histogram_segments.launches = 0
build_histogram_segments.quant_launches = 0
#: a list to record each launch's (cnt, rows_bound) in, or None;
#: a launch captured into a CUDA graph records nothing
build_histogram_segments.shapes = None
