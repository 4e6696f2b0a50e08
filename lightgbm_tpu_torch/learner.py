"""Learner base: per-feature metadata, split candidates, host tree assembly.

Port of the parts of ``lightgbm_tpu/learner.py`` (``TPUTreeLearner``) that the
compact learner stands on: feature metadata, ``_fix_histogram`` (`:237-253`),
the numerical ``_feature_cands`` path, the per-split record layout
(``REC_*``, ``NUM_REC_FIELDS = 17``, `:42-46`) and host assembly
(``_split_host_tree`` / ``_assemble_vec``, `:626-778`).  The masked learner's
own full-pass growth is not ported in this slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .binning import MISSING_NONE
from .config import BREADTH, Config, not_ported
from .dataset import _ConstructedDataset
from .ops.split import find_best_splits, fix_histogram
from .tree import K_DEFAULT_LEFT_MASK, Tree

# per-split record layout fetched to host once per tree
REC_VALID, REC_LEAF, REC_FEATURE, REC_THRESHOLD, REC_DEFAULT_LEFT, REC_GAIN, \
    REC_LEFT_OUT, REC_RIGHT_OUT, REC_LEFT_CNT, REC_RIGHT_CNT, \
    REC_INTERNAL_VALUE, REC_INTERNAL_CNT, REC_LEFT_SUM_H, REC_RIGHT_SUM_H, \
    REC_LEFT_SUM_G, REC_RIGHT_SUM_G, REC_IS_CAT = range(17)
NUM_REC_FIELDS = 17


class _FeatCand(NamedTuple):
    """Best split per feature (fields (..., F))."""
    gain: torch.Tensor
    threshold: torch.Tensor
    default_left: torch.Tensor
    left_sum_g: torch.Tensor
    left_sum_h: torch.Tensor
    left_cnt: torch.Tensor
    right_sum_g: torch.Tensor
    right_sum_h: torch.Tensor
    right_cnt: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor


class TreeLearner:
    """Shared state of the port's learners: config, dataset, device, the
    per-feature metadata as device tensors, the split parameters."""

    def __init__(self, cfg: Config, data: _ConstructedDataset,
                 device: torch.device):
        self.cfg = cfg
        self.data = data
        self.device = device
        self.num_leaves = max(int(cfg.num_leaves), 2)
        num_bin, missing, default_bin, is_cat = data.feature_meta_arrays()
        if is_cat.any():
            raise not_ported("categorical features", BREADTH)
        self.np_num_bin = num_bin
        self.np_missing = missing
        self.np_default_bin = default_bin
        self.f_num_bin = torch.from_numpy(num_bin).to(device)
        self.f_missing = torch.from_numpy(missing).to(device)
        self.f_default_bin = torch.from_numpy(default_bin).to(device)
        self.num_bins_padded = int(data.max_num_bin)
        self.num_features = data.num_used_features
        # float64 histograms and split accounting: the reference's gpu_use_dp
        self.hist_dp = bool(cfg.gpu_use_dp or cfg.tpu_double_precision)
        self._split_kwargs = dict(
            lambda_l1=float(cfg.lambda_l1), lambda_l2=float(cfg.lambda_l2),
            max_delta_step=float(cfg.max_delta_step),
            min_data_in_leaf=int(cfg.min_data_in_leaf),
            min_sum_hessian_in_leaf=float(cfg.min_sum_hessian_in_leaf),
            min_gain_to_split=float(cfg.min_gain_to_split),
            # all-MISSING_NONE data skips the missing-right scan (exact: it
            # can contribute nothing)
            skip_missing_scan=not bool((missing != MISSING_NONE).any()))

    def _fix_histogram(self, hist, sum_g, sum_h, cnt):
        """``Dataset::FixHistogram`` (`src/io/dataset.cpp:923-941`) of a
        (K, F, B, 3) batch with (K,) totals (``ops/split.py``)."""
        return fix_histogram(hist, sum_g, sum_h, cnt, self.f_default_bin)

    def _feature_cands(self, hist, sum_g, sum_h, cnt,
                       feature_mask) -> _FeatCand:
        """Per-feature numerical candidates for a batch of leaves."""
        hist = self._fix_histogram(hist, sum_g, sum_h, cnt)
        num = find_best_splits(
            hist, sum_g, sum_h, cnt, self.f_num_bin, self.f_missing,
            self.f_default_bin, feature_mask, **self._split_kwargs)
        return _FeatCand(*num)

    # -- host assembly -------------------------------------------------------

    def _split_host_tree(self, tree: Tree, r: np.ndarray, left_cnt: int,
                         right_cnt: int) -> None:
        """Apply one recorded numerical split to the host tree."""
        fi = int(r[REC_FEATURE])
        mapper = self.data.bin_mappers[fi]
        thr_bin = int(r[REC_THRESHOLD])
        tree.split(leaf=int(r[REC_LEAF]), feature_inner=fi,
                   real_feature=int(self.data.used_feature_map[fi]),
                   threshold_bin=thr_bin,
                   threshold_double=mapper.bin_to_value(thr_bin),
                   left_value=float(r[REC_LEFT_OUT]),
                   right_value=float(r[REC_RIGHT_OUT]),
                   left_cnt=left_cnt, right_cnt=right_cnt,
                   gain=float(r[REC_GAIN]),
                   missing_type=int(self.np_missing[fi]),
                   default_left=bool(r[REC_DEFAULT_LEFT] > 0.5))
        tree.internal_value[tree.num_leaves - 2] = float(r[REC_INTERNAL_VALUE])

    def _assemble(self, records: np.ndarray, rec_i: np.ndarray) -> Tree:
        """Replay the records split by split (``Tree.split`` per record)."""
        tree = Tree(self.num_leaves)
        for i in range(records.shape[0]):
            r = records[i]
            if r[REC_VALID] < 0.5:
                break
            self._split_host_tree(tree, r, left_cnt=int(rec_i[i, 0]),
                                  right_cnt=int(rec_i[i, 1]))
        return tree

    def assemble_host(self, records: np.ndarray, rec_i: np.ndarray) -> Tree:
        if bool(getattr(self.cfg, "tpu_vec_assemble", True)):
            return self._assemble_vec(records, rec_i)
        return self._assemble(records, rec_i)

    def _thr_value_table(self) -> np.ndarray:
        """(F, B) float64 table of ``mapper.bin_to_value`` (model-text
        thresholds), built once per learner."""
        tab = getattr(self, "_np_thr_val", None)
        if tab is None:
            b = max(int(self.np_num_bin.max()), 1)
            tab = np.zeros((self.num_features, b), dtype=np.float64)
            for k, m in enumerate(self.data.bin_mappers):
                ub = np.asarray(m.bin_upper_bound, dtype=np.float64)
                tab[k, :min(len(ub), b)] = ub[:b]
            self._np_thr_val = tab
        return tab

    def _assemble_vec(self, records: np.ndarray, rec_i: np.ndarray) -> Tree:
        """One numpy pass over the record batch, identical to replaying
        ``Tree.split`` record by record: records are in pop order, so the
        node a record creates is its own index, the left child keeps the
        parent's leaf number and the right child gets ``num_leaves``."""
        valid = records[:, REC_VALID] > 0.5
        nv = int(np.argmin(valid)) if not valid.all() else len(valid)
        tree = Tree(self.num_leaves)
        if nv == 0:
            return tree
        r = records[:nv]
        leaves = r[:, REC_LEAF].astype(np.int64)
        iota = np.arange(nv, dtype=np.int64)
        fi = r[:, REC_FEATURE].astype(np.int64)
        thr_bin = r[:, REC_THRESHOLD].astype(np.int64)
        tree.num_leaves = nv + 1
        tree.split_feature_inner[:nv] = fi
        tree.split_feature[:nv] = np.asarray(self.data.used_feature_map)[fi]
        gains = r[:, REC_GAIN].astype(np.float64)
        tree.split_gain[:nv] = np.clip(np.nan_to_num(gains, nan=0.0),
                                       -1e300, 1e300)   # Common::AvoidInf
        tree.threshold_in_bin[:nv] = thr_bin
        tree.threshold[:nv] = self._thr_value_table()[fi, thr_bin]
        tree.decision_type[:nv] = (
            (r[:, REC_DEFAULT_LEFT] > 0.5) * K_DEFAULT_LEFT_MASK
            | ((self.np_missing[fi].astype(np.int64) & 3) << 2)
        ).astype(np.int8)
        tree.internal_value[:nv] = r[:, REC_INTERNAL_VALUE]
        lc = rec_i[:nv, 0].astype(np.int64)
        rc = rec_i[:nv, 1].astype(np.int64)
        tree.internal_count[:nv] = lc + rc
        # previous/next record splitting the same leaf number
        ordx = np.argsort(leaves, kind="stable")
        lv = leaves[ordx]
        same = lv[1:] == lv[:-1]
        nxt = np.full(nv, -1, np.int64)
        nxt[ordx[:-1][same]] = ordx[1:][same]
        prv = np.full(nv, -1, np.int64)
        prv[ordx[1:][same]] = ordx[:-1][same]
        mask_first = np.r_[True, ~same]
        firsts = np.full(nv + 2, -1, np.int64)
        firsts[lv[mask_first]] = ordx[mask_first]
        tree.left_child[:nv] = np.where(nxt >= 0, nxt, ~leaves)
        nxt_r = firsts[iota + 1]
        tree.right_child[:nv] = np.where(nxt_r >= 0, nxt_r, ~(iota + 1))
        # the last record touching each leaf number owns its value/count
        lp = np.full(nv + 1, -1, np.int64)
        np.maximum.at(lp, leaves, iota)
        np.maximum.at(lp, iota + 1, iota)
        tree.leaf_parent[:nv + 1] = lp
        own_left = leaves[lp] == np.arange(nv + 1)
        lval = np.where(own_left, r[lp, REC_LEFT_OUT], r[lp, REC_RIGHT_OUT])
        tree.leaf_value[:nv + 1] = np.nan_to_num(lval, nan=0.0)
        tree.leaf_count[:nv + 1] = np.where(own_left, lc[lp], rc[lp])
        # depth of record i's children = 1 + that of its parent record (the
        # previous same-leaf splitter, or the right-creator record leaf-1)
        creator = np.where(leaves > 0, leaves - 1, -1)
        parent_rec = np.maximum(creator, prv).tolist()
        cd = [0] * nv
        for i in range(nv):
            p = parent_rec[i]
            cd[i] = 1 + (cd[p] if p >= 0 else 0)
        tree.leaf_depth[:nv + 1] = np.asarray(cd, np.int64)[lp]
        return tree
