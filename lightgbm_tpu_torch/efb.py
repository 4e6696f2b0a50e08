# Port copy of lightgbm_tpu/efb.py: the port keeps its own numpy-only copy so
# that importing it never runs lightgbm_tpu/__init__.py (which imports JAX).
"""Exclusive Feature Bundling (EFB).

Host-side port of ``FindGroups`` / ``FastFeatureBundling``
(`src/io/dataset.cpp:67-213`): mutually-exclusive (never simultaneously
non-default) features merge into one bundle column whose code space is

    0                          — every member at its default bin
    off_j + rank(b)            — member j at non-default bin b, where
                                 rank(b) = b - (b > default_j) and
                                 off_j = 1 + Σ_{i<j} (num_bin_i - 1)

so a bundle behaves exactly like the reference's multi-feature
``FeatureGroup`` with per-member bin offsets.  The dense per-feature bin
matrix stays canonical on the host; the compact learner encodes the bundled
matrix for its device residency (histograms then cost O(groups), not
O(features)) and un-bundles histograms with a precomputed gather at split
scan time, reconstructing each member's default-bin entry from the leaf
totals (``Dataset::FixHistogram``, `src/io/dataset.cpp:923-942`).

Bundled group codes are capped at 256 so the packed Pallas kernel's
byte-per-feature layout still applies (the reference GPU path's
``gpu_max_bin_per_group`` cap).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .binning import BIN_CATEGORICAL

MAX_GROUP_BIN = 256


def find_bundles(data, cfg) -> List[List[int]]:
    """Greedy exclusive grouping over the binned matrix.  Rows beyond
    ``bin_construct_sample_cnt`` are SAMPLED (like the reference's
    FindGroups over sampled indices), so on very large data exclusivity is
    estimated and residual conflicts degrade within ``max_conflict_rate``
    semantics.  Returns used-feature index groups; singletons included."""
    n = data.num_data
    fu = data.num_used_features
    # bound the exclusivity scan like the reference's sampled FindGroups —
    # the exact full-N scan is O(F·G·N) and stalls construction on exactly
    # the wide sparse data EFB targets
    cap = max(int(cfg.bin_construct_sample_cnt), 1)
    if n > cap:
        sample = np.random.default_rng(cfg.data_random_seed).choice(
            n, cap, replace=False)  # Generator.choice is O(cap), not O(n)
    else:
        sample = slice(0, n)
    n_eff = cap if n > cap else n
    max_conflict = int(n_eff * float(cfg.max_conflict_rate))
    nondef = []
    counts = []
    for k, m in enumerate(data.bin_mappers):
        if m.bin_type == BIN_CATEGORICAL:
            nd = None          # categoricals stay un-bundled
        else:
            nd = data.bins[k, :n][sample] != m.default_bin
        nondef.append(nd)
        counts.append(int(nd.sum()) if nd is not None else -1)
    order = sorted(range(fu), key=lambda k: -counts[k])

    groups: List[List[int]] = []
    marks: List[np.ndarray] = []
    conflicts: List[int] = []
    bins_used: List[int] = []
    for k in order:
        nd = nondef[k]
        nb = data.bin_mappers[k].num_bin
        if nd is None:
            groups.append([k])
            marks.append(None)
            conflicts.append(0)
            bins_used.append(nb)
            continue
        placed = False
        for gi in range(len(groups)):
            if marks[gi] is None:
                continue
            if bins_used[gi] + nb - 1 > MAX_GROUP_BIN:
                continue
            rest = max_conflict - conflicts[gi]
            cnt = int((marks[gi] & nd).sum())
            if cnt <= rest:
                groups[gi].append(k)
                marks[gi] |= nd
                conflicts[gi] += cnt
                bins_used[gi] += nb - 1
                placed = True
                break
        if not placed:
            groups.append([k])
            marks.append(nd.copy())
            conflicts.append(0)
            bins_used.append(1 + nb - 1)
    # deterministic layout: groups ordered by their smallest member
    groups.sort(key=lambda g: min(g))
    return groups


class Bundle:
    """Bundled layout: per-feature (group column, code offset) and the
    encoded device matrix builder."""

    def __init__(self, data, groups: List[List[int]]):
        fu = data.num_used_features
        self.groups = groups
        self.num_groups = len(groups)
        self.f_gcol = np.zeros(fu, np.int32)
        self.f_off = np.zeros(fu, np.int32)
        self.f_bundled = np.zeros(fu, bool)
        self.group_num_bin = np.zeros(len(groups), np.int32)
        for gi, g in enumerate(groups):
            if len(g) == 1:
                k = g[0]
                self.f_gcol[k] = gi
                self.group_num_bin[gi] = data.bin_mappers[k].num_bin
                continue
            off = 1
            for k in g:
                self.f_gcol[k] = gi
                self.f_off[k] = off
                self.f_bundled[k] = True
                off += data.bin_mappers[k].num_bin - 1
            self.group_num_bin[gi] = off
        self.max_group_bin = int(self.group_num_bin.max())

    def encode(self, data) -> np.ndarray:
        """(G_pad, N_pad) bundle codes from the canonical per-feature bins."""
        from .dataset import _ConstructedDataset, _round_up

        n_pad = data.num_data_padded
        g_pad = _round_up(max(self.num_groups, 1),
                          _ConstructedDataset.FEATURE_TILE)
        out = np.zeros((g_pad, n_pad), np.uint8)
        for gi, g in enumerate(self.groups):
            if len(g) == 1:
                out[gi] = data.bins[g[0]].astype(np.uint8)
                continue
            code = np.zeros(n_pad, np.int32)
            for k in g:
                d = data.bin_mappers[k].default_bin
                b = data.bins[k].astype(np.int32)
                nd = b != d
                rank = b - (b > d)
                code = np.where(nd, self.f_off[k] + rank, code)
            out[gi] = code.astype(np.uint8)
        return out

    def unbundle_maps(self, num_features: int, b_feat: int, b_group: int,
                      num_bin: np.ndarray):
        """Gather map (F, b_feat) of flat indices into the (G·b_group) group
        histogram, per-(f, b) validity (bins past the feature's own count
        are zeroed — they would otherwise corrupt the default-bin
        reconstruction), and the per-feature needs-default-fix mask."""
        idx = np.zeros((num_features, b_feat), np.int32)
        valid = np.zeros((num_features, b_feat), bool)
        for k in range(num_features):
            gi = int(self.f_gcol[k])
            bins = np.arange(b_feat)
            in_feat = bins < int(num_bin[k])
            if not self.f_bundled[k]:
                idx[k] = np.clip(gi * b_group + bins,
                                 0, self.num_groups * b_group - 1)
                valid[k] = in_feat
                continue
            off = int(self.f_off[k])
            # non-default bins gather from the bundle range; the default bin
            # entry is reconstructed from leaf totals (fix mask)
            rank = bins - (bins > self._default(k))
            code = off + rank
            idx[k] = np.clip(gi * b_group + code,
                             0, self.num_groups * b_group - 1)
            valid[k] = in_feat & (bins != self._default(k))
        fix = self.f_bundled.copy()
        return idx, valid, fix

    def _default(self, k):
        self__ = getattr(self, "_defaults", None)
        if self__ is None:
            raise RuntimeError("defaults not bound")
        return self__[k]

    def bind_defaults(self, defaults: np.ndarray) -> "Bundle":
        self._defaults = np.asarray(defaults, np.int64)
        return self


def apply_bundles(data, groups: List[List[int]]) -> Bundle:
    num_bin, missing, default_bin, _ = data.feature_meta_arrays()
    return Bundle(data, groups).bind_defaults(default_bin)
