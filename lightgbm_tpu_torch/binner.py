"""Predict-time binning of a raw matrix over padded per-feature arrays.

Port of the host part of ``lightgbm_tpu/serving/binner.py``
(``BinnerArrays``: ``__init__``, ``for_data``, ``bin_host``), numpy only.
The mapper fleet becomes a handful of padded arrays, so a request matrix is
binned without a fresh lookup table per feature and call:

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
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .binning import BIN_CATEGORICAL, MISSING_NAN, BinMapper

# categories unseen at train time probe past every split bitset -> right
# child, matching raw-value traversal (`tree.h:250-268`)
OOV_BIN = 1 << 20


class BinnerArrays:
    """Padded per-feature binning arrays for one mapper fleet (see the
    module docstring)."""

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
        feature."""
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
