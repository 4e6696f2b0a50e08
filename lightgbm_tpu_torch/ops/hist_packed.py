"""Packed bin words and the packed-word histogram (CUDA kernel + plain torch).

Port of the packed part of ``lightgbm_tpu/ops/hist_pallas.py``:

  * ``pack_bin_words`` / ``unpack_bin_words`` — four uint8 bin codes per int32
    word, feature ``4k+s`` in byte ``s`` of word ``k`` (bitwise as the JAX
    package; a code >= 128 in byte 3 makes the word negative, so unpacking
    masks with ``& 0xFF`` after the arithmetic shift);
  * ``build_histogram_packed`` — the compact learner's histogram,
    ``hist[4k+s, b, c] = sum_r [byte_s(words[k, r]) == b] * w[c, r]``, with
    the quantized-gradient mode of ``_expand_terms_quant`` /
    ``_reduce_quant`` (``quant=True``: channel 2 sums lane 1, the hessian,
    not lane 2, the bag; the wave learner rescales it into a count).  On a
    CUDA tensor it launches the hand-written Hopper kernel
    ``csrc/hist_packed.cu`` (design, bound and precision in that file's
    header); on a CPU tensor it runs ``build_histogram_packed_plain``, the
    plain torch version the kernel is held against.  There is no fallback
    from one to the other.

The kernel accumulates true float32 whatever ``tpu_hist_precision`` says: the
bf16 term split (``bf16x2``/``bf16x3``) is a TPU MXU mechanism and is not
carried over, so the key keeps its validation but no longer changes numbers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import native
from .hist_full import SMEM_PER_SM, SMEM_RESERVED, SMS, _round_up
from .histogram import build_histogram_onehot

#: the kernel's row-window granularity (window sizes are multiples of it)
ROW_QUANTUM = 1024
#: word lanes a block takes, four warps each (csrc/hist_packed.cu:
#: kLanesMax), rows per shared-memory stage (kRows) and stages (kStages)
LANES_PER_BLOCK = 4
STAGE_ROWS = 128
STAGES = 3
#: rows per chunk: at least LARGE_CHUNK_ROWS.  A window of fewer than
#: SMALL_WINDOW_ROWS rows takes SMALL_LANES word lanes a block (more blocks
#: per chunk) and up to SMALL_CHUNKS chunks of at least SMALL_CHUNK_ROWS:
#: each chunk's partial costs a block's flush and the second pass's reads,
#: so a small window spreads over word lanes before rows
LARGE_CHUNK_ROWS = 1024
SMALL_WINDOW_ROWS = 131_072
SMALL_LANES = 1
SMALL_CHUNK_ROWS = 256
SMALL_CHUNKS = 64


#: rows packed at a time: the int64 temporaries stay near 120 MB at 28
#: features however many rows there are
PACK_CHUNK_ROWS = 1 << 18


def pack_bin_words(bins: torch.Tensor) -> torch.Tensor:
    """(F, N) uint8 bin codes -> (F/4, N) int32 words (F a multiple of 4),
    ``PACK_CHUNK_ROWS`` rows at a time."""
    f, n = bins.shape
    if f % 4:
        raise ValueError(f"feature count {f} is not a multiple of 4")
    if bins.dtype != torch.uint8:
        raise ValueError(f"packable bins must be uint8, got {bins.dtype}")
    out = torch.empty((f // 4, n), dtype=torch.int32, device=bins.device)
    for s in range(0, n, PACK_CHUNK_ROWS):
        e = min(n, s + PACK_CHUNK_ROWS)
        b = bins[:, s:e].to(torch.int64).view(f // 4, 4, e - s)
        words = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
        # two's-complement wrap into int32, spelled out (byte 3 >= 128 ->
        # < 0)
        words = words - ((words >> 31) & 1) * (1 << 32)
        out[:, s:e] = words
    return out


def unpack_bin_words(words: torch.Tensor, num_features: int) -> torch.Tensor:
    """(Fw, S) int32 words -> (num_features, S) int32 bin codes."""
    fw, s = words.shape
    parts = [(words >> (8 * i)) & 0xFF for i in range(4)]
    return torch.stack(parts, dim=1).reshape(fw * 4, s)[:num_features]


def quant_lanes(w: torch.Tensor) -> torch.Tensor:
    """The lanes a quant-mode histogram sums: (g, h, h)."""
    return torch.stack([w[0], w[1], w[1]])


def build_histogram_packed_plain(words: torch.Tensor, w: torch.Tensor, *,
                                 num_bins: int, dp: bool = False,
                                 quant: bool = False) -> torch.Tensor:
    """Plain torch version: unpack, then ``index_add_`` in float32 (float64
    with ``dp``).  Returns (4*Fw, num_bins, 3)."""
    fw = words.shape[0]
    if quant:
        w = quant_lanes(w)
    return build_histogram_onehot(unpack_bin_words(words, 4 * fw), w,
                                  num_bins=num_bins, dp=dp)


class PackedPlan(NamedTuple):
    """The launch geometry of ``csrc/hist_packed.cu``: block (c, g) takes
    rows [c * chunk, min(S, (c + 1) * chunk)) of word lanes
    [g * lanes, (g + 1) * lanes), clipped to Fw, a warp per feature."""
    lanes: int
    groups: int
    nchunks: int
    chunk: int


def packed_smem_bytes(lanes: int, num_bins: int) -> int:
    """A block's shared memory (csrc/hist_packed.cu: smem_bytes): a
    histogram and a group mask per feature, and the stages."""
    return 4 * (4 * lanes * num_bins * 4
                + STAGES * STAGE_ROWS * (3 + lanes))


@functools.lru_cache(maxsize=256)
def packed_plan(fw: int, s: int, num_bins: int) -> PackedPlan:
    """Word lanes a block and chunks as LARGE_CHUNK_ROWS says, at most one
    wave of blocks on the card (SMS times the blocks an SM holds), chunks
    a multiple of ``STAGE_ROWS``."""
    small = s < SMALL_WINDOW_ROWS
    groups = -(-fw // (SMALL_LANES if small else LANES_PER_BLOCK))
    lanes = -(-fw // groups)
    per_sm = max(1, min(2048 // (128 * lanes),
                        SMEM_PER_SM // (packed_smem_bytes(lanes, num_bins)
                                        + SMEM_RESERVED)))
    want = (min(s // SMALL_CHUNK_ROWS, SMALL_CHUNKS) if small
            else s // LARGE_CHUNK_ROWS)
    nchunks = max(1, min(want, SMS * per_sm // groups))
    chunk = _round_up(-(-s // nchunks), STAGE_ROWS)
    return PackedPlan(lanes, groups, -(-s // chunk), chunk)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = native.load("hist_packed")
        lib.lgbt_hist_packed.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.lgbt_hist_packed.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def build_histogram_packed(words: torch.Tensor, w: torch.Tensor, *,
                           num_bins: int, quant: bool = False
                           ) -> torch.Tensor:
    """hist[4k+s, b, c] = sum_r [byte_s(words[k, r]) == b] * w[c, r].

    words : (Fw, S) int32 — a window view is taken as it is (row offset in
            the data pointer, row stride from ``stride(0)``); rows must be
            contiguous and S a multiple of 1024.
    w     : (3, S) float32 (g*bag, h*bag, bag), rows contiguous.
    quant : channel 2 sums lane 1 (h) instead of lane 2.
    Returns (4*Fw, num_bins, 3) float32.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (counted in ``build_histogram_packed.
    launches``, the quant-mode launches also in ``.quant_launches``) or
    raise; the result is then the front of the one allocation that also
    holds the kernel's scratch.
    """
    if words.device.type == "cpu" and w.device.type == "cpu":
        return build_histogram_packed_plain(words, w, num_bins=num_bins,
                                            quant=quant)
    if words.device.type != "cuda" or w.device != words.device:
        raise ValueError(f"words and w must both lie on one CUDA device "
                         f"(got {words.device} and {w.device})")
    if words.dtype != torch.int32 or words.dim() != 2 or words.stride(1) != 1:
        raise ValueError("words must be a 2-D int32 tensor with contiguous "
                         "rows")
    fw, s = words.shape
    if w.dtype != torch.float32 or tuple(w.shape) != (3, s) \
            or w.stride(1) != 1:
        raise ValueError(f"w must be a (3, {s}) float32 tensor with "
                         f"contiguous rows, got {tuple(w.shape)} {w.dtype}")
    if s < ROW_QUANTUM or s % ROW_QUANTUM:
        raise ValueError(f"window length {s} is not a positive multiple of "
                         f"{ROW_QUANTUM}")
    if not 1 <= num_bins <= 256 or fw < 1:
        raise ValueError(f"need 1 <= num_bins <= 256 and Fw >= 1, got "
                         f"num_bins={num_bins}, Fw={fw}")
    plan = packed_plan(fw, s, num_bins)
    # one allocation: the output, then the chunks' partials and bitmaps
    out_n = 4 * fw * num_bins * 3
    many = plan.nchunks > 1
    part_n = out_n * plan.nchunks if many else 0
    bits_n = 4 * fw * -(-num_bins // 32) * plan.nchunks if many else 0
    buf = torch.empty(out_n + part_n + bits_n, dtype=torch.float32,
                      device=words.device)
    out = buf[:out_n].view(4 * fw, num_bins, 3)
    partial = buf.data_ptr() + 4 * out_n
    stream = torch.cuda.current_stream(words.device).cuda_stream
    native.launch("hist_packed", _lib().lgbt_hist_packed, words,
                  words.stride(0), w, w.stride(0), fw, s, num_bins,
                  int(quant), plan.lanes, plan.nchunks, plan.chunk,
                  partial, partial + 4 * part_n, out, stream)
    native.count(build_histogram_packed)
    native.count(build_histogram_packed, "quant_launches", int(quant))
    return out


build_histogram_packed.launches = 0
build_histogram_packed.quant_launches = 0
