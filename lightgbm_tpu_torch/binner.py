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
once per device (``device_arrays``): on a CUDA tensor ``bin_predict``
launches the hand-written Hopper kernel ``csrc/bin_predict.cu`` (design and
bound in its header), on a CPU tensor it runs ``bin_plain``, a batched
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
from typing import Dict, List, NamedTuple, Sequence

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
    ``M_*``), ``bounds`` (fu, B) float64, ``cat_lut`` (fu, C) int32, the
    used and padded feature counts and the least column count of a raw
    matrix."""
    meta: torch.Tensor
    bounds: torch.Tensor
    cat_lut: torch.Tensor
    fu: int
    f_pad: int
    min_cols: int


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
        """The arrays on ``device``, uploaded once per device and cached."""
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
            arrs = DeviceArrays(
                *(torch.from_numpy(a).to(device) for a in (
                    meta, self.bounds, self.cat_lut)), fu, self.f_pad,
                int(meta[:fu, M_COL].max()) + 1 if fu else 0)
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


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = native.load("bin_predict")
        lib.lgbt_bin_predict.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.lgbt_bin_predict.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def bin_predict(x: torch.Tensor, a: DeviceArrays) -> torch.Tensor:
    """(f_pad, n) int32 predict codes of the (n, F_total) float64 raw
    matrix ``x`` over the device arrays ``a`` (on ``x``'s device).  A CPU
    tensor takes ``bin_plain``; a CUDA tensor launches
    ``csrc/bin_predict.cu`` (counted in ``bin_predict.launches``) or
    raises."""
    if x.device.type == "cpu" and a.meta.device.type == "cpu":
        return bin_plain(x, a)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in a[:3]):
        raise ValueError("x and the binning arrays must lie on one CUDA "
                         "device")
    if x.dim() != 2 or x.dtype != torch.float64 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 2-D float64 tensor")
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    native.launch("bin_predict", _lib().lgbt_bin_predict, x, ldx, n, a.fu,
                  a.f_pad, a.meta, a.bounds, a.bounds.shape[1], a.cat_lut,
                  a.cat_lut.shape[1], out, stream)
    bin_predict.launches += 1
    return out


bin_predict.launches = 0
