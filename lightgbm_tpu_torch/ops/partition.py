"""Stable row partitions of the learners' row lanes (CUDA kernels + plain).

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

``partition_window`` is the compact learner's split of one leaf
(``DataPartition::Split``; the JAX compact learner's
``_make_partition_branch``, a stable one-bit-key ``lax.sort`` of the
parent's window): the split's decision on the rows ``[s, s + c)`` and,
above the sort cutoff, their stable partition in place, every number of it
(leaf, window, feature, threshold, ``do``) read from a device vector, so
the learner's split step holds no host read.  On a CUDA tensor it launches
``lgbt_partition_window`` of ``csrc/partition.cu``; on a CPU tensor it runs
``partition_window_plain`` (cumsum, ``scatter_`` and ``index_select`` over
the window).
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

#: rows a block of the windowed kernel takes (kWinTile, csrc/partition.cu)
WINDOW_TILE = 2048
#: columns of the (F, 7) int64 per-feature decode table: the word row and
#: byte shift of the feature's code, its missing type, default bin, bin
#: count, bundle offset and whether it is bundled (EFB)
FT_WIDX, FT_SHIFT, FT_MT, FT_DB, FT_NB, FT_BOFF, FT_BND = range(7)
#: entries of the (6,) int64 result: the children's windows and the bagged
#: left and total counts
O_LS, O_LW, O_RS, O_RW, O_LBAG, O_BAG = range(6)


def window_decision(words: torch.Tensor, tab, thr: int, flags: int,
                    bits: Optional[torch.Tensor]) -> torch.Tensor:
    """The split's decision on rows whose feature word row is ``words``
    (``NumericalDecisionInner``, `tree.h:233-249`, with the EFB decode;
    ``CategoricalDecisionInner``, `tree.h:270-277`); ``tab`` is the
    feature's row of the decode table as host ints."""
    frow = (words >> tab[FT_SHIFT]) & 0xFF
    if tab[FT_BND]:
        # bundle code -> this feature's bin (out-of-range codes mean
        # another member was active: this feature sits at its default)
        d = tab[FT_DB]
        r = frow - tab[FT_BOFF]
        in_r = (r >= 0) & (r < tab[FT_NB] - 1)
        frow = torch.where(in_r, r + (r >= d).to(r.dtype), d)
    if flags & 2 and bits is not None:
        word = bits.index_select(0, torch.clamp(
            frow >> 5, max=bits.shape[0] - 1).to(torch.int64))
        return ((word >> (frow & 31)) & 1) == 1
    missing = ((tab[FT_MT] == 1) & (frow == tab[FT_DB])) \
        | ((tab[FT_MT] == 2) & (frow == tab[FT_NB] - 1))
    return torch.where(missing, bool(flags & 1), frow <= thr)


def partition_window_plain(bins: torch.Tensor, w: torch.Tensor,
                           rid: torch.Tensor, lid: torch.Tensor,
                           split: torch.Tensor, ftab: torch.Tensor,
                           bits: Optional[torch.Tensor] = None, *,
                           mask_max: int, scratch=None) -> torch.Tensor:
    """Plain torch version of ``partition_window``: the split vector read to
    the host, then over the window a stable cumsum partition and one
    ``index_select`` per lane (sort mode) or a leaf-id rewrite (mask
    mode)."""
    leaf, new, feat, thr, flags, do, s, c = split.tolist()
    c = c if do else 0
    dev = bins.device
    if c == 0:
        return torch.tensor([s, 0, s, 0, 0, 0], dtype=torch.int64,
                            device=dev)
    tab = ftab[feat].tolist()
    go_left = window_decision(bins[tab[FT_WIDX], s:s + c], tab, thr, flags,
                              bits)
    bag = w[2, s:s + c] > 0.5
    if c > mask_max:
        # stable partition: left rows first, then right, each in order
        cl = torch.cumsum(go_left, 0)
        lc_w = int(cl[-1])
        pos = torch.arange(c, device=dev)
        dest = torch.where(go_left, cl - 1, lc_w + pos - cl)
        perm = torch.empty_like(dest).scatter_(0, dest, pos)
        bins[:, s:s + c] = bins[:, s:s + c].index_select(1, perm)
        w[:, s:s + c] = w[:, s:s + c].index_select(1, perm)
        rid[s:s + c] = rid[s:s + c].index_select(0, perm)
        lid[s:s + c] = torch.where(pos >= lc_w, new, leaf).to(lid.dtype)
        lbag, nbag = (go_left & bag).sum(), bag.sum()
        win = [s, lc_w, s + lc_w, c - lc_w]
    else:
        lid_w = lid[s:s + c]
        in_seg = lid_w == leaf
        lid[s:s + c] = torch.where(in_seg & ~go_left, new, lid_w)
        lbag, nbag = (in_seg & go_left & bag).sum(), (in_seg & bag).sum()
        win = [s, c, s, c]
    return torch.cat([torch.tensor(win, dtype=torch.int64, device=dev),
                      torch.stack([lbag, nbag]).to(torch.int64)])


_WLIB = None


def _wlib():
    global _WLIB
    if _WLIB is None:
        lib = native.load("partition")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lgbt_partition_window.argtypes = [
            p, i, p, p, p, i, p, p, p, i, ctypes.c_longlong, p, p, p, p, p,
            p, p]
        lib.lgbt_partition_window.restype = ctypes.c_int
        _WLIB = lib
    return _WLIB


def partition_window(bins: torch.Tensor, w: torch.Tensor, rid: torch.Tensor,
                     lid: torch.Tensor, split: torch.Tensor,
                     ftab: torch.Tensor, bits: Optional[torch.Tensor] = None,
                     *, mask_max: int, scratch: Optional[Lanes] = None
                     ) -> torch.Tensor:
    """Split one leaf's window of the lanes in place.

    bins, w, rid, lid : the lanes as in ``apply_partition``, updated in place
    split : (8,) int64 [leaf, new_leaf, feature, threshold, flags (bit 0
            default left, bit 1 categorical), do, start, count]
    ftab  : (F, 7) int64 per-feature decode table (``FT_*``)
    bits  : (W,) int32 bitset of a categorical split, or None
    mask_max : windows of at most this many rows split in mask mode (leaf
            ids only, both children keep the window), larger ones are
            partitioned: left rows first, then right, each in row order
    scratch : four tensors shaped like the lanes for the kernel's moves
            (allocated when None); the plain version takes none
    Returns (6,) int64 on the device: the children's windows [ls, lw, rs,
    rw] and the bagged left and total counts of the window (in mask mode of
    the leaf's rows).  ``do == 0`` changes no lane.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (counted in
    ``partition_window.launches``) or raise."""
    args = (bins, w, rid, lid, split, ftab)
    if all(t.device.type == "cpu" for t in args):
        return partition_window_plain(bins, w, rid, lid, split, ftab, bits,
                                      mask_max=mask_max)
    dev = bins.device
    if dev.type != "cuda" or any(t.device != dev for t in args) \
            or (bits is not None and bits.device != dev):
        raise ValueError("the lanes, split, ftab and bits must all lie on "
                         "one CUDA device")
    if bins.dim() != 2 or bins.dtype != torch.int32:
        raise ValueError("bins must be a 2-D int32 tensor")
    fw, n = bins.shape
    want = ((w, torch.float32, (3, n)), (rid, torch.int64, (n,)),
            (lid, torch.int32, (n,)), (split, torch.int64, (8,)))
    for t, dt, shape in want:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"expected a {dt} tensor of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if ftab.dtype != torch.int64 or ftab.dim() != 2 or ftab.shape[1] != 7:
        raise ValueError("ftab must be an (F, 7) int64 tensor")
    if bits is not None and (bits.dtype != torch.int32 or bits.dim() != 1):
        raise ValueError("bits must be a (W,) int32 tensor")
    if not all(t.is_contiguous() for t in args) \
            or (bits is not None and not bits.is_contiguous()):
        raise ValueError("the lanes, split, ftab and bits must be contiguous")
    if not 1 <= n < 2 ** 31 or fw < 1:
        raise ValueError(f"need 1 <= N < 2^31 and Fw >= 1, got N={n}, Fw={fw}")
    sb, sw, sr, sl = _outputs(bins, w, rid, lid, scratch)
    blk = torch.empty(3 * (-(-n // WINDOW_TILE)), dtype=torch.int32,
                      device=dev)
    out = torch.empty(6, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    native.launch("partition_window", _wlib().lgbt_partition_window, bins,
                  fw, w, rid, lid, n, split, ftab,
                  0 if bits is None else bits,
                  0 if bits is None else int(bits.shape[0]), int(mask_max),
                  sb, sw, sr, sl, blk, out, stream)
    native.count(partition_window)
    return out


partition_window.launches = 0
