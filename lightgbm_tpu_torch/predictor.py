"""Device batch predictor: every tree traversed on the device in bin space.

Port of ``lightgbm_tpu/predictor.py``, the analogue of ``Predictor``
(`src/application/predictor.hpp:25-230`): the raw input matrix is uploaded
and binned once on the booster's device with the model's own mappers
(``binner.py:BinnerArrays.bin_device``, the ``bin_predict`` kernel on the
card), and the trees traverse the bin codes there, every decision an
integer compare or a bitset probe.  The JAX package scans the trees one by
one (``lax.scan``); eager torch would pay launches per tree and level
there, so the port traverses a group of trees at once: a (trees, rows)
node tensor stepped ``depth`` times with batched gathers over the packed
node arrays, rows chunked so that trees x rows stays within
``_BLOCK_ELEMS``.  Leaf values and sums are float64 (the JAX package's x64 semantics, which its tests run
under, and the host path's), summed in tree order.

Prediction early stop (`src/boosting/prediction_early_stop.cpp`) is a
per-row ``active`` lane re-evaluated every ``pred_early_stop_freq``
iterations: frozen rows stop accumulating (margin ``2|s|`` for binary, top1
minus top2 for multiclass).  A group is then ``pred_early_stop_freq * K``
trees, the trees between two decisions.

Boosters loaded from model text carry no training mappers:
``reconstruct_bin_schema`` builds a synthetic bin space whose bounds are the
model's own thresholds and rebinds every tree into it.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from .binner import BinnerArrays
from .tree import Tree

#: trees x rows per traversal block (a few int64 and float64 tensors of this
#: many elements are alive at once)
_BLOCK_ELEMS = 1 << 21
# packed node columns
N_FEAT, N_THR, N_MISS, N_DLEFT, N_LCH, N_RCH, N_CAT, N_CLO, N_CHI = range(9)


def pack_trees(models: List[Tree], f_missing: np.ndarray,
               f_default_bin: np.ndarray, f_nan_bin: np.ndarray):
    """Per-tree node arrays padded to the fleet maxima, in inner (bin-space)
    fields: ``nodes`` (T, ni, 9) int64 (see ``N_*``; ``N_MISS`` is the code
    that counts as missing at the node's feature, -1 for none), ``lval`` (T,
    nl) float64, ``cat_bits`` (T, W) int64 words of the inner bitsets, and
    the traversal depth."""
    T = len(models)
    ni = max(max(t.num_leaves - 1, 1) for t in models)
    nl = max(max(t.num_leaves, 1) for t in models)
    depth = max(max(int(t.leaf_depth[:t.num_leaves].max()), 1)
                for t in models)
    nodes = np.zeros((T, ni, 9), np.int64)
    nodes[:, :, N_LCH] = -1
    nodes[:, :, N_RCH] = -1
    nodes[:, :, N_MISS] = -1
    lval = np.zeros((T, nl), np.float64)
    miss_code = np.where(f_missing == 1, f_default_bin,
                         np.where(f_missing == 2, f_nan_bin, -1))
    cat_words: List[List[int]] = []
    for i, t in enumerate(models):
        k = t.num_leaves - 1
        words: List[int] = []
        if t.num_leaves <= 1:
            lval[i, 0] = t.leaf_value[0]   # children -1 -> leaf 0
        else:
            feat = t.split_feature_inner[:k].astype(np.int64)
            dt = t.decision_type[:k].astype(np.int64)
            nodes[i, :k, N_FEAT] = feat
            nodes[i, :k, N_THR] = t.threshold_in_bin[:k]
            nodes[i, :k, N_MISS] = miss_code[feat]
            nodes[i, :k, N_DLEFT] = (dt & 2) != 0
            nodes[i, :k, N_LCH] = t.left_child[:k]
            nodes[i, :k, N_RCH] = t.right_child[:k]
            nodes[i, :k, N_CAT] = dt & 1
            lval[i, :t.num_leaves] = t.leaf_value[:t.num_leaves]
            if t.num_cat > 0:
                inner = getattr(t, "_cat_bitsets_inner", {})
                for nd in range(k):
                    if dt[nd] & 1:
                        bins = sorted(inner.get(int(t.threshold_in_bin[nd]),
                                                ()))
                        w0 = len(words)
                        nw = (bins[-1] // 32 + 1) if bins else 0
                        chunk = [0] * nw
                        for b_ in bins:
                            chunk[b_ // 32] |= 1 << (b_ % 32)
                        words.extend(chunk)
                        nodes[i, nd, N_CLO] = w0
                        nodes[i, nd, N_CHI] = w0 + nw
        cat_words.append(words)
    W = max((len(w) for w in cat_words), default=0) or 1
    cat_bits = np.zeros((T, W), np.int64)
    for i, words in enumerate(cat_words):
        cat_bits[i, :len(words)] = words
    return nodes, lval, cat_bits, depth


class DevicePredictor:
    """Batched device inference over the model's own bin space."""

    def __init__(self, gbdt, data, num_iteration: int = -1,
                 pred_early_stop: bool = False,
                 pred_early_stop_freq: int = 10,
                 pred_early_stop_margin: float = 10.0):
        self.data = data
        self.device = gbdt.device
        models = gbdt.models[:gbdt._num_models_for(num_iteration)]
        if not models:
            raise ValueError("no trees to predict with")
        self.K = max(gbdt.num_tree_per_iteration, 1)
        num_bin, missing, default_bin, _ = data.feature_meta_arrays()
        nodes, lval, cat_bits, self.depth = pack_trees(
            models, missing, default_bin, num_bin - 1)
        self.T, self.ni = nodes.shape[:2]
        self.nl = lval.shape[1]
        self.has_cat = bool(nodes[:, :, N_CAT].any())
        dev = self.device
        self.nodes = torch.from_numpy(nodes.reshape(-1, 9)).to(dev)
        self.lval = torch.from_numpy(lval.reshape(-1)).to(dev)
        self.cat_bits = torch.from_numpy(cat_bits.reshape(-1)).to(dev)
        self.W = cat_bits.shape[1]
        self.es = bool(
            pred_early_stop and gbdt.objective is not None
            and gbdt.objective.name in ("binary", "multiclass",
                                        "multiclassova"))
        self.es_freq = max(int(pred_early_stop_freq), 1)
        self.es_margin = float(pred_early_stop_margin)

    def _leaf_values(self, bins: torch.Tensor, t0: int, t1: int, r0: int,
                     r1: int) -> torch.Tensor:
        """(t1 - t0, r1 - r0) float64 leaf values of trees [t0, t1) for rows
        [r0, r1) of the (F_pad, N) bin matrix."""
        dev = self.device
        n = bins.shape[1]
        flat_bins = bins.reshape(-1)
        tree_off = (torch.arange(t0, t1, device=dev) * self.ni)[:, None]
        rows = torch.arange(r0, r1, device=dev)[None, :]
        node = torch.zeros((t1 - t0, r1 - r0), dtype=torch.int64, device=dev)
        for _ in range(self.depth):
            nd = self.nodes[tree_off + torch.clamp(node, min=0)]  # (t, r, 9)
            fv = flat_bins[nd[..., N_FEAT] * n + rows].to(torch.int64)
            go_left = torch.where(fv == nd[..., N_MISS],
                                  nd[..., N_DLEFT] != 0, fv <= nd[..., N_THR])
            if self.has_cat:
                # CategoricalDecisionInner: inner bitset probe
                lo = nd[..., N_CLO]
                widx = fv >> 5
                word = self.cat_bits[
                    torch.arange(t0, t1, device=dev)[:, None] * self.W
                    + torch.clamp(lo + widx, 0, self.W - 1)]
                in_set = (widx < nd[..., N_CHI] - lo) \
                    & (((word >> (fv & 31)) & 1) == 1)
                go_left = torch.where(nd[..., N_CAT] != 0, in_set, go_left)
            nxt = torch.where(go_left, nd[..., N_LCH], nd[..., N_RCH])
            node = torch.where(node < 0, node, nxt)
        leaf = torch.where(node < 0, ~node, 0)
        return self.lval[(tree_off // self.ni) * self.nl + leaf]

    def predict_binned(self, bins: torch.Tensor) -> torch.Tensor:
        """(K, N) float64 raw scores from an (F_pad, N) device bin matrix."""
        K, T = self.K, self.T
        n = bins.shape[1]
        group = self.es_freq * K if self.es else T
        rows = max(1, _BLOCK_ELEMS // min(group, T))
        score = torch.zeros((K, n), dtype=torch.float64, device=self.device)
        for r0 in range(0, n, rows):
            r1 = min(n, r0 + rows)
            s = score[:, r0:r1]
            active = None
            for t0 in range(0, T, group):
                t1 = min(T, t0 + group)
                vals = self._leaf_values(bins, t0, t1, r0, r1)
                if self.es:
                    if t0 > 0:
                        # re-evaluate frozen rows at iteration boundaries
                        if K == 1:
                            margin = 2.0 * s[0].abs()
                        else:
                            top2 = torch.topk(s.t(), 2, dim=1).values
                            margin = top2[:, 0] - top2[:, 1]
                        still = margin <= self.es_margin
                        active = still if active is None else active & still
                    if active is not None:
                        vals = vals * active.to(vals.dtype)
                # tree t of the group adds to class (t0 + t) % K, in order
                for k in range(K):
                    kk = (k - t0) % K
                    s[k] = torch.cat([s[k:k + 1], vals[kk::K]]).cumsum(0)[-1]
        return score

    def predict_raw(self, X: np.ndarray) -> np.ndarray:
        """(n,) or (n, K) float64 raw scores: the raw float64 matrix
        uploaded to the device, binned there with the model's own mappers
        (``BinnerArrays.bin_device``: the ``bin_predict`` kernel on a CUDA
        device, its plain version on the CPU) and traversed there."""
        bins = BinnerArrays.for_data(self.data).bin_device(X, self.device)
        score = self.predict_binned(bins).cpu().numpy()
        return score[0] if self.K == 1 else score.T


class PredictionBinSchema:
    """Duck-typed stand-in for ``_ConstructedDataset`` covering exactly the
    surface the device predictor and binner read: ``bin_mappers``,
    ``used_feature_map``, ``feature_meta_arrays`` and the padded feature
    count.  Built by ``reconstruct_bin_schema`` for boosters loaded from
    model text (no training data attached)."""

    FEATURE_TILE = 8  # match _ConstructedDataset's feature-axis padding

    def __init__(self, bin_mappers, used_feature_map):
        self.bin_mappers = list(bin_mappers)
        self.used_feature_map = np.asarray(used_feature_map, dtype=np.int32)
        fu = len(self.bin_mappers)
        f_pad = ((max(fu, 1) + self.FEATURE_TILE - 1)
                 // self.FEATURE_TILE) * self.FEATURE_TILE
        # shape carrier only: the schema never holds binned rows
        self.bins = np.zeros((f_pad, 0), dtype=np.uint16)
        self._feature_meta = None

    @property
    def num_used_features(self) -> int:
        return len(self.bin_mappers)

    def feature_meta_arrays(self):
        if self._feature_meta is None:
            from .binning import BIN_CATEGORICAL
            num_bin = np.array([m.num_bin for m in self.bin_mappers],
                               dtype=np.int32)
            missing = np.array([m.missing_type for m in self.bin_mappers],
                               dtype=np.int32)
            default_bin = np.array([m.default_bin for m in self.bin_mappers],
                                   dtype=np.int32)
            is_categorical = np.array([m.bin_type == BIN_CATEGORICAL
                                       for m in self.bin_mappers], dtype=bool)
            self._feature_meta = (num_bin, missing, default_bin,
                                  is_categorical)
        return self._feature_meta


def reconstruct_bin_schema(gbdt) -> PredictionBinSchema:
    """Rebuild a servable bin space for a text-loaded booster.

    The model text carries raw thresholds, per-node missing semantics and
    the categorical vocabularies (``feature_infos``) but not the training
    bin boundaries.  For prediction none of the boundaries between
    thresholds matter: a synthetic mapper whose upper bounds are exactly
    the feature's split thresholds (plus the +-kZeroThreshold pair when a
    node uses zero-as-missing, plus the NaN bin when a node uses NaN
    missing) reproduces raw traversal decisions bit for bit —
    ``v <= t  <=>  bin(v) <= bin(t)`` when every ``t`` is itself a bound.

    Side effect: every tree is rebound into the synthetic bin space
    (``split_feature_inner`` / ``threshold_in_bin`` / inner cat bitsets),
    after which the booster predicts on the device like a freshly trained
    one.
    """
    from .binning import (BIN_CATEGORICAL, BIN_NUMERICAL, MISSING_NAN,
                          MISSING_ZERO, BinMapper, kZeroThreshold)
    from .boosting.gbdt import rebind_tree_to_dataset

    models = gbdt.models
    nfeat = int(gbdt.max_feature_idx) + 1
    thresholds = [set() for _ in range(nfeat)]
    bitset_cats = [set() for _ in range(nfeat)]
    missing = [0] * nfeat
    is_cat = [False] * nfeat
    for t in models:
        for nd in range(t.num_leaves - 1):
            j = int(t.split_feature[nd])
            dt = int(t.decision_type[nd])
            missing[j] = max(missing[j], (dt >> 2) & 3)
            if dt & 1:
                is_cat[j] = True
                cat_idx = int(t.threshold[nd])
                lo, hi = t.cat_boundaries[cat_idx], \
                    t.cat_boundaries[cat_idx + 1]
                for w in range(lo, hi):
                    word = int(t.cat_threshold[w])
                    for b in range(32):
                        if (word >> b) & 1:
                            bitset_cats[j].add(32 * (w - lo) + b)
            else:
                thresholds[j].add(float(t.threshold[nd]))

    # used features: the training-time non-trivial set when feature_infos
    # is intact, else every feature the trees actually split on
    infos = list(getattr(gbdt, "feature_infos", []) or [])
    if len(infos) == nfeat:
        used = [j for j in range(nfeat) if infos[j] != "none"]
    else:
        infos = ["none"] * nfeat
        used = sorted(j for j in range(nfeat)
                      if thresholds[j] or is_cat[j])

    mappers = []
    for j in used:
        m = BinMapper()
        m.missing_type = missing[j]
        m.is_trivial = False
        info = infos[j]
        if is_cat[j] or (info not in ("none", "") and not
                         info.startswith("[")):
            m.bin_type = BIN_CATEGORICAL
            if info not in ("none", "") and not info.startswith("["):
                cats = [int(c) for c in info.split(":")]
            else:
                cats = sorted(bitset_cats[j])
                if m.missing_type == MISSING_NAN:
                    cats.append(-1)
            m.bin_2_categorical = cats
            m.categorical_2_bin = {c: i for i, c in enumerate(cats)}
            m.num_bin = max(len(cats), 1)
            m.default_bin = m.categorical_2_bin.get(0, m.num_bin - 1)
        else:
            m.bin_type = BIN_NUMERICAL
            bounds = set(thresholds[j])
            if m.missing_type == MISSING_ZERO:
                bounds.update((-kZeroThreshold, kZeroThreshold))
            bounds = sorted(bounds) + [math.inf]
            if m.missing_type == MISSING_NAN:
                bounds.append(math.nan)
            m.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
            m.num_bin = len(bounds)
            m.default_bin = int(m.value_to_bin(0.0))
        mappers.append(m)

    schema = PredictionBinSchema(mappers, used)
    for t in models:
        t.needs_rebind = True
        rebind_tree_to_dataset(t, schema)
    return schema
