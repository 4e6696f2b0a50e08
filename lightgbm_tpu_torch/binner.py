"""Predict-time binning of a raw matrix over padded per-feature arrays.

Port of ``lightgbm_tpu/serving/binner.py`` (``BinnerArrays``: ``__init__``,
``for_data``, ``bin_host``, ``device_arrays``, ``bin_device`` and the jitted
``_bin_device``).  The mapper fleet becomes a handful of padded arrays, so a
request matrix is binned without a fresh lookup table per feature and call:

  * ``bounds``   (F, B) float64 — each row is the feature's searchable upper
    bounds (``bin_upper_bound[:r]``, the slice ``values_to_bins`` searches),
    padded with ``+inf``;
  * ``cat_lut``  (F, C) int32 — category value -> bin, padded with the OOV
    sentinel; ``cat_max`` carries each feature's largest category, so the
    clip-and-mask reproduces the mapper's unseen and negative handling;
  * ``missing`` / ``nan_bin`` / ``default_bin`` / ``is_cat`` — per-feature
    metadata for the NaN rules.

The categorical fields keep the JAX package's layout.  ``bin_host`` is
bit-identical to ``BinMapper.values_to_bins_predict`` per used feature: a
numerical row is the count of bounds below each value, taken with
``np.searchsorted(side="left")`` over the sorted, ``+inf``-padded row, which
equals the JAX package's broadcast count without its (F, B, rows)
comparison block.

Semantics (`tree.h:250-268`, raw-prediction traversal): unseen or negative
categories map to ``OOV_BIN``, beyond every split bitset, always right; NaN
maps to the NaN bin (numerical, missing type NaN), to ``OOV_BIN``
(categorical, missing type NaN), or probes as 0.0 otherwise.

Two binners share the arrays.  ``bin_host`` (numpy) bins on the host.
``bin_device`` bins a raw matrix on a torch device over the arrays uploaded
once per device (``device_arrays``, which pads each bounds row with ``+inf``
to a power of two and adds its Eytzinger layout, the kernel's search tree):
on a CUDA tensor ``bin_predict`` launches the hand-written Hopper kernel
``csrc/bin_predict.cu`` (design and bound in its header) as ``bin_plan``
lays it out, on a CPU tensor it runs ``bin_plain``, a batched
``torch.searchsorted`` and a gather.  All three give the same codes, bit for
bit.  A categorical value is truncated toward zero (``-0.5`` is category 0)
and kept only inside ``[0, cat_max]``: the rule of the host binner's int64
cast, which sends every value outside that range (negative, past the table,
+-inf, 1e30) below 0 or past ``cat_max``.  The JAX ``_bin_device`` casts to
int32 instead; the two would differ only where a float-to-int32 cast wrapped
a value past 2**31 into ``[0, cat_max]``, and XLA's cast saturates, so they
agree (``tests/test_torch_binner.py`` holds all four on such values).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import native
from .binning import BIN_CATEGORICAL, MISSING_NAN, BinMapper

# categories unseen at train time probe past every split bitset -> right
# child, matching raw-value traversal (`tree.h:250-268`)
OOV_BIN = 1 << 20
#: the columns of ``DeviceArrays.meta``, as csrc/bin_predict.cu reads them
M_COL, M_MISSING, M_NAN_BIN, M_IS_CAT, M_CAT_MAX = range(5)


class DeviceArrays(NamedTuple):
    """The binning arrays on one device: ``meta`` (fu, 5) int32 (see
    ``M_*``), ``bounds`` (fu, W) float64 sorted rows padded with ``+inf``
    to ``W = tree_width(B)``, ``tree`` (fu, W) the same rows in Eytzinger
    order (``eytzinger``), ``cat_lut`` (fu, C) int32, the used and padded
    feature counts, the least column count of a raw matrix, the used
    columns in feature order and ``B``, the bounds a row before the
    padding."""
    meta: torch.Tensor
    bounds: torch.Tensor
    tree: torch.Tensor
    cat_lut: torch.Tensor
    fu: int
    f_pad: int
    min_cols: int
    cols: Tuple[int, ...]
    num_bounds: int


def tree_width(b: int) -> int:
    """The row width ``W`` of the kernel's search tree for ``b`` bounds: the
    least power of two with ``W - 1 >= b`` (a perfect tree of ``W - 1``
    nodes; node 0 is unused)."""
    return 1 << max(int(b), 1).bit_length()


def eytzinger(rows: np.ndarray) -> np.ndarray:
    """The (R, W) rows (``W`` a power of two) in Eytzinger order: node ``i``
    in ``[2^l, 2^(l+1))``, the ``(i - 2^l)``-th node of level ``l`` of the
    perfect search tree over the first ``W - 1`` entries, holds entry
    ``(2 (i - 2^l) + 1) 2^(L-1-l) - 1``; node 0 holds entry ``W - 1``
    (unused).  Over sorted rows the descent ``i = 2i + (t[i] < v)``, ``L``
    times from ``i = 1``, ends at ``2^L`` plus the count of entries below
    ``v``."""
    w = rows.shape[1]
    depth = w.bit_length() - 1
    node = np.arange(1, w)
    level = np.floor(np.log2(node)).astype(np.int64)
    idx = (2 * (node - (1 << level)) + 1) * (1 << (depth - 1 - level)) - 1
    return np.ascontiguousarray(rows[:, np.concatenate([[w - 1], idx])])


class BinnerArrays:
    """Padded per-feature binning arrays for one mapper fleet (see the
    module docstring)."""

    #: calls of ``bin_host``, in every instance
    host_calls = 0

    def __init__(self, bin_mappers: Sequence[BinMapper],
                 used_feature_map, f_pad: int):
        fu = len(bin_mappers)
        self.used_feature_map = np.asarray(used_feature_map, dtype=np.int64)
        self.f_pad = int(f_pad)
        self.num_used = fu

        r_list: List[int] = []
        cat_sz: List[int] = []
        for m in bin_mappers:
            if m.bin_type == BIN_CATEGORICAL:
                r_list.append(0)
                # mapper LUT size: lut_max + 2 (`values_to_bins_predict`)
                lut_max = max(m.categorical_2_bin.keys(), default=0)
                cat_sz.append(lut_max + 2)
            else:
                r = m.num_bin - 1
                if m.missing_type == MISSING_NAN:
                    r -= 1
                r_list.append(max(r, 0))
                cat_sz.append(0)
        B = max(max(r_list, default=0), 1)
        C = max(max(cat_sz, default=0), 1)

        self.bounds = np.full((max(fu, 1), B), np.inf, dtype=np.float64)
        self.missing = np.zeros(max(fu, 1), dtype=np.int32)
        self.nan_bin = np.zeros(max(fu, 1), dtype=np.int32)
        self.default_bin = np.zeros(max(fu, 1), dtype=np.int32)
        self.is_cat = np.zeros(max(fu, 1), dtype=bool)
        self.cat_lut = np.full((max(fu, 1), C), OOV_BIN, dtype=np.int32)
        self.cat_max = np.zeros(max(fu, 1), dtype=np.int32)
        for k, m in enumerate(bin_mappers):
            self.missing[k] = m.missing_type
            self.nan_bin[k] = m.num_bin - 1
            self.default_bin[k] = m.default_bin
            if m.bin_type == BIN_CATEGORICAL:
                self.is_cat[k] = True
                lut_max = max(m.categorical_2_bin.keys(), default=0)
                self.cat_max[k] = lut_max
                for cat, b in m.categorical_2_bin.items():
                    if cat >= 0:
                        self.cat_lut[k, cat] = b
            else:
                r = r_list[k]
                self.bounds[k, :r] = m.bin_upper_bound[:r]
        self._dev: Dict[str, DeviceArrays] = {}

    @classmethod
    def for_data(cls, data) -> "BinnerArrays":
        """Arrays for a dataset-like object (``_ConstructedDataset`` or
        ``PredictionBinSchema``), cached on the object."""
        arrs = getattr(data, "_binner_arrays", None)
        if arrs is None:
            arrs = cls(data.bin_mappers, data.used_feature_map,
                       data.bins.shape[0])
            data._binner_arrays = arrs
        return arrs

    def bin_host(self, X: np.ndarray) -> np.ndarray:
        """(f_pad, n) int32 predict-bins of an (n, num_total_features) raw
        matrix, bit-identical to ``values_to_bins_predict`` per used
        feature.  Counted in ``BinnerArrays.host_calls``."""
        BinnerArrays.host_calls += 1
        X = np.asarray(X, dtype=np.float64)
        n = X.shape[0]
        fu = self.num_used
        out = np.zeros((self.f_pad, n), dtype=np.int32)
        if fu == 0 or n == 0:
            return out
        v = np.ascontiguousarray(X[:, self.used_feature_map].T)  # (fu, n)
        nan = np.isnan(v)
        v0 = np.where(nan, 0.0, v)

        # numerical: count of bounds < v, one sorted search per feature
        cnt = np.empty((fu, n), dtype=np.int32)
        for k in range(fu):
            cnt[k] = np.searchsorted(self.bounds[k], v0[k], side="left")
        num = np.where(nan & (self.missing[:, None] == MISSING_NAN),
                       self.nan_bin[:, None], cnt)

        # categorical: LUT probe with the mapper's exact clip-and-mask
        iv = v0.astype(np.int64)
        cm = self.cat_max[:, None].astype(np.int64)
        oov_mask = (iv < 0) | (iv > cm)
        gathered = np.take_along_axis(
            self.cat_lut, np.clip(iv, 0, cm).astype(np.int64), axis=1)
        cat = np.where(oov_mask, OOV_BIN, gathered)
        # raw categorical prediction always sends NaN right under
        # missing_type NaN (`tree.h:255-258`)
        cat = np.where(nan & (self.missing[:, None] == MISSING_NAN),
                       OOV_BIN, cat)

        out[:fu] = np.where(self.is_cat[:, None], cat, num)
        return out

    def device_arrays(self, device) -> DeviceArrays:
        """The arrays on ``device``, uploaded once per device and cached;
        the bounds rows padded with ``+inf`` to ``tree_width(B)``, and the
        same rows in Eytzinger order, the kernel's search trees."""
        key = str(torch.device(device))
        arrs = self._dev.get(key)
        if arrs is None:
            fu = self.num_used
            rows = max(fu, 1)
            meta = np.zeros((rows, 5), dtype=np.int32)
            meta[:fu, M_COL] = self.used_feature_map[:fu]
            meta[:, M_MISSING] = self.missing
            meta[:, M_NAN_BIN] = self.nan_bin
            meta[:, M_IS_CAT] = self.is_cat
            meta[:, M_CAT_MAX] = self.cat_max
            b = self.bounds.shape[1]
            bounds = np.full((rows, tree_width(b)), np.inf)
            bounds[:, :b] = self.bounds
            cols = tuple(int(c) for c in self.used_feature_map[:fu])
            arrs = DeviceArrays(
                *(torch.from_numpy(a).to(device) for a in (
                    meta, bounds, eytzinger(bounds), self.cat_lut)),
                fu, self.f_pad, max(cols) + 1 if fu else 0, cols, b)
            self._dev[key] = arrs
        return arrs

    def bin_device(self, X, device) -> torch.Tensor:
        """(f_pad, n) int32 codes on ``device`` of an (n,
        num_total_features) raw matrix (numpy, or a float64 tensor),
        equal to ``bin_host``'s: ``bin_predict`` over ``device_arrays``."""
        device = torch.device(device)
        if isinstance(X, np.ndarray):
            from .dataset import upload
            X = upload(np.ascontiguousarray(X, dtype=np.float64), device)
        return bin_predict(X, self.device_arrays(device))


def bin_plain(x: torch.Tensor, a: DeviceArrays) -> torch.Tensor:
    """Plain torch version of ``bin_predict``: a batched
    ``torch.searchsorted`` over the bounds rows and a gather from the
    category tables."""
    n = x.shape[0]
    out = torch.zeros((a.f_pad, n), dtype=torch.int32, device=x.device)
    fu = a.fu
    if fu == 0 or n == 0:
        return out
    meta = a.meta[:fu]
    v = x.index_select(1, meta[:, M_COL].long()).T.contiguous()  # (fu, n)
    nan = torch.isnan(v)
    v0 = v.masked_fill(nan, 0.0)
    nan_missing = nan & (meta[:, M_MISSING:M_MISSING + 1] == MISSING_NAN)
    cnt = torch.searchsorted(a.bounds[:fu], v0, side="left").to(torch.int32)
    num = torch.where(nan_missing, meta[:, M_NAN_BIN:M_NAN_BIN + 1], cnt)
    t = torch.trunc(v0)
    keep = (t >= 0) & (t <= meta[:, M_CAT_MAX:M_CAT_MAX + 1].to(t.dtype))
    cat = torch.gather(a.cat_lut[:fu], 1, t.masked_fill(~keep, 0).long())
    cat = cat.masked_fill(~keep | nan_missing, OOV_BIN)
    out[:fu] = torch.where(meta[:, M_IS_CAT:M_IS_CAT + 1] != 0, cat, num)
    return out


#: dynamic shared memory a block may take: the H100's 232,448 bytes less
#: the kernel's static mbarriers (2 x 8 x 8 bytes)
SMEM_LIMIT = 232_448 - 128
#: a bounds row is staged in shared memory up to this size (W <= 8,192:
#: every max_bin up to 8,191); a wider row would leave a group one or two
#: features, each tile read once for them, and is searched in global memory
STAGE_ROW_BYTES = 65_536
#: the size of one row tile aimed at (whole tasks of CHUNK rows), the most
#: rows of a tile, the row-tile buffers (a third took 1% less at 11,000,000
#: rows)
TILE_BYTES = 65_536
MAX_TILE_ROWS = 1024
STAGES = 2
#: row tiles a block must walk for whole rows to be staged: a block's
#: first copy is a wait the ring does not hide (at 100,000 x 28, three
#: tiles a block, the strided reads took 9% less; at 1,023 bins, six tiles
#: a block of two groups, the row tiles 17% less; at 11,000,000 rows 13%)
ROW_TILES = 4
#: rows of one task of the kernel: one feature over 32 lanes x the 4 rows
#: a lane bins at once (csrc/bin_predict.cu's kU); a multiple of 128 rows
#: keeps a tile's start on the matrix's 16-byte alignment
CHUNK = 128
#: shared-memory bytes of one feature's metadata row
META_BYTES = 5 * 4


class BinPlan(NamedTuple):
    """How ``csrc/bin_predict.cu`` bins an (n, ldx) matrix (``bin_plan``):
    read whole row tiles (``rows``) or the used columns strided; bounds rows
    staged in shared memory (``staged``) or searched in global memory;
    ``group`` used features per group (the last group also writes the
    padding features), ``groups`` of them; ``tiles`` row tiles of
    ``tile_rows`` rows, ``stages`` tile buffers of ``stage_doubles``
    doubles; ``stripes`` blocks per group, ``grid`` blocks; ``smem``
    dynamic shared-memory bytes a block; ``moved_bytes`` what the
    blocks ask of the L2 and device memory (row tiles once per group, each
    block's staged bounds, the codes) against ``bound_bytes``, what the
    function must move (``chip_smoke.py:_bin_bytes``)."""
    fu: int
    f_pad: int
    n: int
    rows: bool
    staged: bool
    group: int
    groups: int
    tile_rows: int
    tiles: int
    stages: int
    stage_doubles: int
    stripes: int
    grid: int
    smem: int
    moved_bytes: int
    bound_bytes: int

    def features(self, g: int) -> range:
        """The features group ``g`` writes."""
        k0 = g * self.group
        k1 = self.f_pad if g == self.groups - 1 \
            else min(self.fu, k0 + self.group)
        return range(k0, k1)

    def stripe_tiles(self, s: int) -> range:
        """The row tiles the blocks of stripe ``s`` walk."""
        return range(s, self.tiles, self.stripes)

    def tile(self, t: int) -> Tuple[int, int]:
        """The rows ``[r0, r1)`` of tile ``t``."""
        r0 = t * self.tile_rows
        return r0, min(self.n, r0 + self.tile_rows)


@lru_cache(maxsize=256)
def _sector_bytes(cols: Tuple[int, ...], ldx: int) -> float:
    """Mean bytes of the 32-byte sectors a row's used columns lie in, over
    the offsets modulo 32 bytes that the row starts take (8-byte aligned)."""
    c = np.asarray(cols, dtype=np.int64)
    offs = {(r * ldx) % 4 for r in range(4)}
    return 32.0 * sum(len(np.unique((c + o) // 4)) for o in offs) / len(offs)


@lru_cache(maxsize=1024)
def bin_plan(fu: int, b: int, ldx: int, n: int, *, f_pad: int, ncat: int,
             cols: Optional[Tuple[int, ...]] = None, aligned: bool = True,
             sms: int = 132) -> BinPlan:
    """The layout of one ``bin_predict`` launch over ``fu`` used features
    (of ``f_pad``) with ``b`` bounds a row (search rows of ``tree_width(b)``)
    and category tables of ``ncat`` entries, on an (n, ldx) matrix whose used
    columns are ``cols`` (default ``0 .. fu - 1``) and which starts on a
    16-byte boundary where ``aligned``, on a card of ``sms`` SMs.  The only
    place these numbers are decided.

    * Whole rows are read when the matrix is ``aligned`` (the bulk copies
      need it), their bytes do not exceed the sectors that hold the used
      columns (``_sector_bytes``), two tile buffers of a task's ``CHUNK``
      rows fit beside a bounds row, and a block walks ``ROW_TILES`` tiles or
      more; otherwise the used columns are read strided.
    * A bounds row is staged when its search row's bytes are at most
      ``STAGE_ROW_BYTES``.  A group is the most used features whose staged
      rows and metadata fit beside two tile buffers; a request of fewer
      tiles than the card has blocks spreads its features over more groups.
      The tile ring then takes ``STAGES`` buffers, fewer where a stripe
      walks fewer tiles.
    * ``stripes`` blocks per group, at most one per tile."""
    if n < 0 or ldx < 1 or fu < 0 or f_pad < max(fu, 1) or b < 0:
        raise ValueError(f"bad shape: n={n}, ldx={ldx}, fu={fu}, "
                         f"f_pad={f_pad}, b={b}")
    cols = tuple(range(fu)) if cols is None else tuple(cols)
    nb = tree_width(b)
    staged = nb * 8 <= STAGE_ROW_BYTES
    per_feature = (nb * 8 if staged else 0) + META_BYTES
    row_bytes = ldx * 8
    room = SMEM_LIMIT - 15          # smem is rounded up to 16 bytes
    blocks = sms                    # one block an SM
    fu_g = max(fu, 1)

    def layout(rows: bool):
        """(tile rows, buffer doubles, tiles, groups, group, stripes) of a
        read mode, or None where two buffers of a task's rows leave no
        room: the fewest groups beside two such buffers, then the tiles
        sized to what the group leaves, in whole tasks."""
        least = 2 * (CHUNK * ldx + 1) * 8 if rows else 0
        if least + per_feature > room:
            return None
        gmax = max(1, (room - least) // per_feature)
        groups = -(-fu_g // gmax)
        group = -(-fu_g // groups)
        stage_doubles = 0
        if rows:
            fit = (room - group * per_feature) // (2 * row_bytes) - 1
            tr = min(MAX_TILE_ROWS, -(-max(n, 1) // CHUNK) * CHUNK,
                     max(CHUNK, min(fit, TILE_BYTES // row_bytes)
                         // CHUNK * CHUNK))
            stage_doubles = (tr * ldx + 1) // 2 * 2
        else:                       # a task's rows: the blocks balance
            tr = CHUNK
        tiles = -(-n // tr)
        if 0 < tiles < blocks:
            groups = max(groups, min(fu_g, blocks // tiles))
        group = -(-fu_g // groups)
        groups = -(-fu_g // group)
        stripes = max(1, min(tiles, blocks // groups))
        return tr, stage_doubles, tiles, groups, group, stripes

    # no used feature: nothing to read; whole rows where they cost no more
    # than the used columns' sectors and a block walks enough tiles to
    # amortize the wait for its first copy
    lay = layout(True) if fu > 0 and aligned \
        and row_bytes <= _sector_bytes(cols, ldx) else None
    rows = lay is not None and lay[2] >= ROW_TILES * lay[5]
    if not rows:
        lay = layout(False)
    tr, stage_doubles, tiles, groups, group, stripes = lay
    stages = min(STAGES, (room - group * per_feature) // (stage_doubles * 8),
                 -(-tiles // stripes)) if rows else 0
    grid = groups * stripes if tiles else 0
    smem = -(-(stages * stage_doubles * 8 + group * per_feature) // 16) * 16

    # what the blocks ask for: each group reads its input once (whole rows,
    # or its own columns' sectors), each block its staged rows and metadata
    reads = 0.0
    for g in range(groups):
        ks = range(g * group, min(fu, (g + 1) * group))
        if rows:
            reads += n * row_bytes
        elif len(ks):
            reads += n * _sector_bytes(cols[ks.start:ks.stop], ldx)
        reads += stripes * len(ks) * per_feature
    if not staged:
        reads += fu * nb * 8
    moved = reads + fu * ncat * 4 + f_pad * n * 4
    # the bound reads the tables at their own width, without the padding
    bound = n * fu * 8 + fu_g * (META_BYTES + b * 8 + ncat * 4) \
        + f_pad * n * 4
    return BinPlan(fu, f_pad, n, rows, staged, group, groups, tr, tiles,
                   stages, stage_doubles, stripes, grid, smem, int(moved),
                   int(bound))


_LIB = None
_SMS: Dict[int, int] = {}


def _lib():
    global _LIB
    if _LIB is None:
        lib = native.load("bin_predict")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lgbt_bin_predict.argtypes = [P, L, L, I, I, P, P, I, P, L, P, I,
                                         I, I, I, I, I, I, L, L, P]
        lib.lgbt_bin_predict.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def plan_for(x: torch.Tensor, a: DeviceArrays) -> BinPlan:
    """``bin_plan`` for the matrix ``x`` over the arrays ``a`` on ``x``'s
    card."""
    dev = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return bin_plan(a.fu, a.num_bounds, x.shape[1], x.shape[0],
                    f_pad=a.f_pad, ncat=a.cat_lut.shape[1], cols=a.cols,
                    aligned=x.data_ptr() % 16 == 0, sms=_SMS[dev])


def bin_predict(x: torch.Tensor, a: DeviceArrays) -> torch.Tensor:
    """(f_pad, n) int32 predict codes of the (n, F_total) float64 raw
    matrix ``x`` over the device arrays ``a`` (on ``x``'s device).  A CPU
    tensor takes ``bin_plain``; a CUDA tensor launches
    ``csrc/bin_predict.cu`` as ``plan_for(x, a)`` lays it out, counted in
    ``bin_predict.launches``, or raises."""
    if x.device.type == "cpu" and a.meta.device.type == "cpu":
        return bin_plain(x, a)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in a[:4]):
        raise ValueError("x and the binning arrays must lie on one CUDA "
                         "device")
    if x.dim() != 2 or x.dtype != torch.float64 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 2-D float64 tensor")
    if not all(t.is_contiguous() for t in a[:4]):
        raise ValueError("the binning arrays must be contiguous")
    if x.data_ptr() % 8:
        raise ValueError("x must be 8-byte aligned: the kernel reads whole "
                         "doubles")
    n, ldx = x.shape
    if n >= 2 ** 31 or a.f_pad < 1:
        raise ValueError(f"need n < 2^31 and f_pad >= 1, got n={n}, "
                         f"f_pad={a.f_pad}")
    if ldx < a.min_cols:
        raise ValueError(f"x has {ldx} columns; the model reads column "
                         f"{a.min_cols - 1}")
    out = torch.empty((a.f_pad, n), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    p = plan_for(x, a)
    stream = torch.cuda.current_stream(dev).cuda_stream
    native.launch("bin_predict", _lib().lgbt_bin_predict, x, ldx, n, a.fu,
                  a.f_pad, a.meta, a.tree, a.bounds.shape[1], a.cat_lut,
                  a.cat_lut.shape[1], out, int(p.rows), int(p.staged),
                  p.group, p.groups, p.stripes, p.tile_rows, p.stages,
                  p.stage_doubles, p.smem, stream)
    native.count(bin_predict)
    return out


bin_predict.launches = 0
