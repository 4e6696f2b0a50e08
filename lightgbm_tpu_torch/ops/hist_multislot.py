"""Per-slot histograms of the level-wise opening (CUDA kernel + plain torch).

Port of ``lightgbm_tpu/ops/hist_pallas.py:build_histogram_multislot``: K
histograms in ONE pass over the full row axis,

    out[j, 4k+s, b, c] = sum over r with slot[r] == j of
                         [byte_s(words[k, r]) == b] * w[c, r]

where a slot outside [0, K) contributes nowhere.  The wave learner's opening
levels run it once per level: no row has moved yet, so the smaller children
of a level's members are told apart by a slot per row, not by windows.
``quant=True`` is the quantized-gradient mode of ``hist_packed``: channel 2
sums lane 1 (h) instead of lane 2 (bag).

On a CUDA tensor ``build_histogram_multislot`` launches the hand-written
Hopper kernel ``csrc/hist_multislot.cu`` (design and bound in that file's
header); on a CPU tensor it runs ``build_histogram_multislot_plain``, the
plain torch version the kernel is held against.  The TPU kernel's bin
one-hot and slot one-hot are MXU mechanism and are not carried over.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import native
from .hist_full import SMEM_PER_SM, SMEM_RESERVED, SMS, _round_up
from .hist_packed import quant_lanes, unpack_bin_words

#: word lanes a block takes, four warps each (csrc/hist_multislot.cu:
#: kLanesMax), rows per shared-memory stage (kRows) and stages (kStages),
#: slots a thread reads per window (kPer) and the row list's length (kList)
LANES_PER_BLOCK = 4
STAGE_ROWS = 128
STAGES = 3
WINDOW_SLOTS = 8
LIST_ROWS = 8192
#: chunks hold at least this many rows
MIN_CHUNK_ROWS = 4096


def build_histogram_multislot_plain(words: torch.Tensor, w: torch.Tensor,
                                    slot: torch.Tensor, *, num_bins: int,
                                    n_slots: int, dp: bool = False,
                                    quant: bool = False) -> torch.Tensor:
    """Plain torch version: one ``index_add_`` over flat (slot, feature,
    bin) indices, rows of other slots routed to a dropped overflow slot and
    codes past ``num_bins`` to a dropped overflow bin.  Returns (K, 4*Fw,
    num_bins, 3), float64 with ``dp``."""
    fw, n = words.shape
    f = 4 * fw
    acc = torch.float64 if dp else torch.float32
    if quant:
        w = quant_lanes(w)
    codes = torch.clamp(unpack_bin_words(words, f).to(torch.int64),
                        max=num_bins)                          # (F, N)
    s = slot.to(torch.int64)
    s = torch.where((s >= 0) & (s < n_slots), s, n_slots)
    feat = torch.arange(f, dtype=torch.int64, device=words.device)
    idx = ((s[None, :] * f + feat[:, None]) * (num_bins + 1) + codes) \
        .reshape(-1)
    src = w.to(acc).t().unsqueeze(0).expand(f, n, 3).reshape(f * n, 3)
    out = torch.zeros((n_slots + 1) * f * (num_bins + 1), 3, dtype=acc,
                      device=words.device)
    out.index_add_(0, idx, src)
    return out.view(n_slots + 1, f, num_bins + 1, 3)[:n_slots, :, :num_bins]


class MultislotPlan(NamedTuple):
    """The launch geometry of ``csrc/hist_multislot.cu``: block (j, g, c)
    takes the rows of slot j among rows [c * chunk, min(N, (c + 1) *
    chunk)) of word lanes [g * lanes, (g + 1) * lanes), clipped to Fw, a
    warp per feature."""
    lanes: int
    groups: int
    nchunks: int
    chunk: int


def multislot_smem_bytes(lanes: int, num_bins: int) -> int:
    """A block's shared memory (csrc/hist_multislot.cu: smem_bytes): a
    histogram and a group mask per feature, the stages, the row list and
    the window counts."""
    return 4 * (4 * lanes * num_bins * 4 + STAGES * STAGE_ROWS * (3 + lanes)
                + LIST_ROWS + 2 * WINDOW_SLOTS * 4 * LANES_PER_BLOCK + 1)


@functools.lru_cache(maxsize=256)
def multislot_plan(fw: int, k: int, n: int, num_bins: int) -> MultislotPlan:
    """``LANES_PER_BLOCK`` word lanes a block and as many chunks of at
    least ``MIN_CHUNK_ROWS`` rows as keep the K x groups x chunks grid
    within one wave of the card (SMS times the blocks an SM holds), chunks
    a multiple of ``STAGE_ROWS``."""
    groups = -(-fw // LANES_PER_BLOCK)
    lanes = -(-fw // groups)
    per_sm = max(1, min(2048 // (128 * lanes),
                        SMEM_PER_SM // (multislot_smem_bytes(lanes, num_bins)
                                        + SMEM_RESERVED)))
    nchunks = max(1, min(n // MIN_CHUNK_ROWS, SMS * per_sm // (groups * k)))
    chunk = _round_up(-(-n // nchunks), STAGE_ROWS)
    return MultislotPlan(lanes, groups, -(-n // chunk), chunk)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = native.load("hist_multislot")
        lib.lgbt_hist_multislot.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.lgbt_hist_multislot.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def build_histogram_multislot(words: torch.Tensor, w: torch.Tensor,
                              slot: torch.Tensor, *, num_bins: int,
                              n_slots: int, quant: bool = False
                              ) -> torch.Tensor:
    """Per-slot histograms over every row (see the module docstring).

    words : (Fw, N) int32, w (3, N) float32, slot (N,) int32, contiguous
    n_slots : K >= 1; quant : channel 2 sums lane 1 (h) instead of lane 2
    Returns (K, 4*Fw, num_bins, 3) float32.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (counted in
    ``build_histogram_multislot.launches``, the quant-mode launches also in
    ``.quant_launches``) or raise; the result is then the front of the one
    allocation that also holds the kernel's scratch.
    """
    args = (words, w, slot)
    if all(t.device.type == "cpu" for t in args):
        return build_histogram_multislot_plain(
            words, w, slot, num_bins=num_bins, n_slots=n_slots, quant=quant)
    dev = words.device
    if dev.type != "cuda" or any(t.device != dev for t in args):
        raise ValueError("words, w and slot must all lie on one CUDA device")
    if words.dim() != 2 or words.dtype != torch.int32:
        raise ValueError("words must be a 2-D int32 tensor")
    fw, n = words.shape
    if w.dtype != torch.float32 or tuple(w.shape) != (3, n) \
            or slot.dtype != torch.int32 or tuple(slot.shape) != (n,):
        raise ValueError(f"w must be (3, {n}) float32 and slot ({n},) int32")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("words, w and slot must be contiguous")
    if not 1 <= num_bins <= 256 or fw < 1 or n_slots < 1:
        raise ValueError(f"need 1 <= num_bins <= 256, Fw >= 1 and K >= 1, "
                         f"got num_bins={num_bins}, Fw={fw}, K={n_slots}")
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"{n} rows do not fit int32 row indices")
    if n_slots * 4 * fw > 65_535:
        raise ValueError(f"K * 4*Fw = {n_slots * 4 * fw} histograms exceed "
                         f"the reduce pass's 65,535 grid rows")
    plan = multislot_plan(fw, n_slots, n, num_bins)
    # one allocation: the output, then the chunks' partials and bitmaps
    out_n = n_slots * 4 * fw * num_bins * 3
    many = plan.nchunks > 1
    part_n = out_n * plan.nchunks if many else 0
    bits_n = n_slots * 4 * fw * -(-num_bins // 32) * plan.nchunks \
        if many else 0
    buf = torch.empty(out_n + part_n + bits_n, dtype=torch.float32,
                      device=dev)
    out = buf[:out_n].view(n_slots, 4 * fw, num_bins, 3)
    partial = buf.data_ptr() + 4 * out_n
    stream = torch.cuda.current_stream(dev).cuda_stream
    native.launch("hist_multislot", _lib().lgbt_hist_multislot, words, w,
                  slot, n, fw, n_slots, num_bins, int(quant), plan.lanes,
                  plan.nchunks, plan.chunk, partial, partial + 4 * part_n,
                  out, stream)
    native.count(build_histogram_multislot)
    native.count(build_histogram_multislot, "quant_launches", int(quant))
    if build_histogram_multislot.shapes is not None \
            and not torch.cuda.is_current_stream_capturing():
        build_histogram_multislot.shapes.append((n_slots, slot))
    return out


build_histogram_multislot.launches = 0
build_histogram_multislot.quant_launches = 0
#: a list to record each launch's slot count K and slot tensor in, or None;
#: a launch captured into a CUDA graph records nothing
build_histogram_multislot.shapes = None
