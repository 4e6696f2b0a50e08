"""Learner base and the masked learner.

Port of ``lightgbm_tpu/learner.py`` (``TPUTreeLearner``).  The base class
``TreeLearner`` holds what every learner of the port stands on: feature
metadata, ``_fix_histogram`` (`:237-253`), ``_feature_cands`` (`:255-310`:
numerical features through ``find_best_splits``, categorical ones through
``ops/split_cat.py``, merged per feature), the per-leaf candidate rows with
the winner's bitset, the per-split record layout (``REC_*``,
``NUM_REC_FIELDS = 17``, `:42-46`; the exact integer columns carry the
counts and, with categorical features, the split's bitset words) and host
assembly (``_split_host_tree`` / ``_assemble_vec``, `:626-778`; trees with
a categorical split take the sequential ``_assemble``, as `:698-706`).

``MaskedTreeLearner`` is ``TPUTreeLearner`` itself for serial numerical
data: leaf-wise growth in which every split step reads every row.  Rows
never move; a leaf id per row marks the partition, and the smaller child's
histogram is one full pass over the unpacked bin codes with the weights of
every other row masked to zero (``ops/histogram.py:build_histogram``, the
hand-written ``hist_full`` kernel on the card), the sibling's by subtraction
from the parent.  The factory sends it data past 256 bins (codes that do not
pack four to a word) and ``tpu_learner=masked``.

What changes in eager torch: the JAX package fuses the tree into one
``lax.while_loop``, an XLA dispatch device; the port runs its unfused step
loop (`learner.py:606-624`, ``fused=False``): exactly ``num_leaves - 1``
no-op-able steps, every state update under ``torch.where(do, ...)``, with no
host read between them.  The records, their exact counts and the leaf
outputs are read once per tree (``train_async`` leaves them on the device
for the pipelined boosting loop).  The numerical split search is the plain
torch ``ops/split.py:find_best_splits``, as the JAX masked learner's is
plain XLA with no Pallas kernel; the categorical one is
``ops/split_cat.py`` (the ``split_cat`` kernel on the card, at every
uint16 width), and a categorical split routes rows by its bitset (`:401-404`).

Monotone constraints and ``feature_contri`` penalties (`:176-194`) are
per-feature tensors mapped through ``used_feature_map``; every learner
passes its leaves' value bounds (``LF_MIN_C`` / ``LF_MAX_C``) to the split
search and propagates them on a split (``_child_constraints``, `:320-331`).
Forced splits (``forced.py``) run before best-gain growth: in the masked
learner as extra ``do``-gated steps of the same fixed-shape loop (the JAX
fused tree's forced phase, `:512-575`), records written at the cursor
``num_leaves - 1`` so that an aborted forced queue leaves no gap; in the
compact learner in its host loop (``learner_compact.py``).  The GSPMD
parallel modes are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO
from .config import Config
from .dataset import _ConstructedDataset
from .ops.histogram import build_histogram, read_codes
from .ops.split import (K_EPSILON, find_best_splits, fix_histogram,
                        forced_split_info)
from .ops.split_cat import (cat_words, categorical_candidates,
                            categorical_candidates_plain)
from .tree import K_DEFAULT_LEFT_MASK, Tree

# per-split record layout fetched to host once per tree
REC_VALID, REC_LEAF, REC_FEATURE, REC_THRESHOLD, REC_DEFAULT_LEFT, REC_GAIN, \
    REC_LEFT_OUT, REC_RIGHT_OUT, REC_LEFT_CNT, REC_RIGHT_CNT, \
    REC_INTERNAL_VALUE, REC_INTERNAL_CNT, REC_LEFT_SUM_H, REC_RIGHT_SUM_H, \
    REC_LEFT_SUM_G, REC_RIGHT_SUM_G, REC_IS_CAT = range(17)
NUM_REC_FIELDS = 17

# fused per-leaf state columns (acc dtype)
LF_SUM_G, LF_SUM_H, LF_CNT, LF_OUT, LF_DEPTH, LF_MIN_C, LF_MAX_C = range(7)
NUM_LF = 7
# fused per-leaf best-candidate columns (acc dtype)
CF_GAIN, CF_LSG, CF_LSH, CF_LCNT, CF_RSG, CF_RSH, CF_RCNT, CF_LOUT, \
    CF_ROUT = range(9)
NUM_CF = 9
# int candidate columns; flags bit0 = default_left, bit1 = categorical
CI_FEAT, CI_THR, CI_FLAGS = range(3)
NUM_CI = 3

HistogramFn = Callable[..., torch.Tensor]


class _FeatCand(NamedTuple):
    """Best split per feature (fields (..., F)); with categorical features
    ``is_cat`` (F,) marks them and ``cat_bits`` (..., F, W) int32 holds
    their bitsets (zeros on numerical features)."""
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
    is_cat: Optional[torch.Tensor] = None
    cat_bits: Optional[torch.Tensor] = None


class AsyncTree(NamedTuple):
    """One tree grown with no blocking host read (``train_async``): its
    records packed in one float64 device tensor (the learner's
    ``host_records`` decodes them once they are on the host), the leaf id
    per row and the leaf outputs on the device, and the host's counters of
    the tree."""
    records: torch.Tensor
    leaf_id: torch.Tensor
    leaf_out: torch.Tensor
    host_stats: dict


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
        self._acc = torch.float64 if self.hist_dp else torch.float32
        self._split_kwargs = dict(
            lambda_l1=float(cfg.lambda_l1), lambda_l2=float(cfg.lambda_l2),
            max_delta_step=float(cfg.max_delta_step),
            min_data_in_leaf=int(cfg.min_data_in_leaf),
            min_sum_hessian_in_leaf=float(cfg.min_sum_hessian_in_leaf),
            min_gain_to_split=float(cfg.min_gain_to_split),
            # all-MISSING_NONE data skips the missing-right scan (exact: it
            # can contribute nothing)
            skip_missing_scan=not bool((missing != MISSING_NONE).any()))
        # categorical features (`:162-190`): their own finder, a (W,) bin
        # bitset per candidate, the numerical scan masked off them
        self.has_categorical = bool(is_cat.any())
        self.cat_W = cat_words(self.num_bins_padded)
        self._cat_split_kwargs = dict(
            {k: v for k, v in self._split_kwargs.items()
             if k != "skip_missing_scan"},
            cat_l2=float(cfg.cat_l2), cat_smooth=float(cfg.cat_smooth),
            max_cat_threshold=int(cfg.max_cat_threshold),
            max_cat_to_onehot=int(cfg.max_cat_to_onehot),
            min_data_per_group=int(cfg.min_data_per_group))
        if self.has_categorical:
            self._is_cat_t = torch.from_numpy(is_cat).to(device)
            self._num_mask = ~self._is_cat_t
            self._cat_cols = torch.from_numpy(
                np.flatnonzero(is_cat).astype(np.int32)).to(device)
        #: columns of the exact integer record rows: the bagged left and
        #: right counts, then the split's bitset words (categorical data)
        self.rec_i_cols = 2 + (self.cat_W if self.has_categorical else 0)
        #: the categorical search (``categorical_candidates``: the kernel on
        #: a CUDA tensor); the wave learner takes its ``WaveKernels.cat``
        self.split_cat = categorical_candidates
        #: calls to each kernel function, over all trees
        self.kernel_calls: Dict[str, int] = {"split_cat": 0}
        # monotone constraints and the per-feature gain penalty, mapped from
        # real feature index to used-feature slots (`config.h:355-368`)
        used_map = data.used_feature_map
        mono = np.zeros(self.num_features, np.int8)
        mc = list(cfg.monotone_constraints or [])
        pen = np.ones(self.num_features, np.float32)
        fc = list(cfg.feature_contri or [])
        for k, j in enumerate(used_map):
            if int(j) < len(mc):
                mono[k] = int(mc[int(j)])
            if int(j) < len(fc):
                pen[k] = float(fc[int(j)])
        self.np_monotone = mono
        self.has_monotone = bool(mono.any())
        self.f_monotone = torch.from_numpy(mono).to(device) \
            if self.has_monotone else None
        self.has_penalty = bool((pen != 1.0).any())
        self.f_penalty = torch.from_numpy(pen).to(device) \
            if self.has_penalty else None
        #: the static BFS forced-split list (``set_forced_splits``)
        self._forced = None

    def _fix_histogram(self, hist, sum_g, sum_h, cnt):
        """``Dataset::FixHistogram`` (`src/io/dataset.cpp:923-941`) of a
        (K, F, B, 3) batch with (K,) totals (``ops/split.py``)."""
        return fix_histogram(hist, sum_g, sum_h, cnt, self.f_default_bin)

    def _leaf_bounds(self, min_c, max_c, k: int):
        """The (K,) value bounds the split search takes: None without
        monotone constraints (no clip), -inf and +inf where the caller has
        none (the root), else the caller's."""
        if not self.has_monotone:
            return None, None
        if min_c is None:
            min_c = torch.full((k,), float("-inf"), dtype=self._acc,
                               device=self.device)
            max_c = torch.full((k,), float("inf"), dtype=self._acc,
                               device=self.device)
        return min_c, max_c

    def _feature_cands(self, hist, sum_g, sum_h, cnt, feature_mask,
                       min_c=None, max_c=None) -> _FeatCand:
        """Per-feature candidates for a batch of leaves: the numerical scan,
        then the categorical columns written over it; ``min_c`` / ``max_c``
        (K,) are the leaves' monotone value bounds."""
        hist = self._fix_histogram(hist, sum_g, sum_h, cnt)
        min_c, max_c = self._leaf_bounds(min_c, max_c, hist.shape[0])
        num = find_best_splits(
            hist, sum_g, sum_h, cnt, self.f_num_bin, self.f_missing,
            self.f_default_bin, self._num_features_of(feature_mask),
            self.f_monotone, min_c, max_c, penalty=self.f_penalty,
            **self._split_kwargs)
        return self._with_categorical(num, hist, sum_g, sum_h, cnt,
                                      feature_mask, min_c, max_c)

    def _child_constraints(self, feat, flags, lout, rout, pmin, pmax):
        """Constraint propagation on a split (`serial_tree_learner.cpp:
        765-776`, JAX `learner.py:320-331`), batched over (K,) splits:
        children inherit the parent's range; a monotone numerical split pins
        the shared boundary at the output midpoint.  Returns (lmin, lmax,
        rmin, rmax)."""
        mono = self.f_monotone.index_select(0, feat)
        mono = torch.where((flags & 2) != 0, 0, mono)
        mid = (lout + rout) / 2.0
        return (torch.where(mono < 0, mid, pmin),
                torch.where(mono > 0, mid, pmax),
                torch.where(mono > 0, mid, pmin),
                torch.where(mono < 0, mid, pmax))

    def set_forced_splits(self, forced) -> None:
        """Install the static BFS forced-split list (``forced.py``); called
        before the first tree.  Each split's integer row and bitset are
        static, built here once."""
        self._forced = list(forced) if forced else None
        self._forced_static = []
        for fs in self._forced or ():
            # numerical forced splits send missing values left
            ci = torch.tensor([fs.feature_inner, fs.threshold_bin,
                               2 if fs.is_cat else 1], dtype=torch.int64,
                              device=self.device)
            cb = None
            if self.has_categorical:
                words = np.zeros(self.cat_W, np.uint32)
                if fs.is_cat:
                    t = fs.threshold_bin
                    words[t // 32] = np.uint32(1) << np.uint32(t % 32)
                cb = torch.from_numpy(words.view(np.int32)).to(self.device)
            self._forced_static.append((ci, cb))

    def _forced_rows(self, i: int, hist, lrow):
        """Candidate rows of forced split ``i`` (``GatherInfoForThreshold``)
        from its leaf's (F, B, 3) unbundled histogram and leaf row: ((NUM_CF,)
        acc, (NUM_CI,) int64, the (W,) int32 bitset or None without
        categorical features, whether the split is valid as a () bool)."""
        cfg = self.cfg
        fs = self._forced[i]
        sum_g, sum_h, cnt = lrow[LF_SUM_G], lrow[LF_SUM_H], lrow[LF_CNT]
        # FixHistogram before the gather, as the scans see it
        hist = self._fix_histogram(hist[None], sum_g[None], sum_h[None],
                                   cnt[None])[0]
        f = fs.feature_inner
        gain, lg, lh, lc, rg, rh, rc, lo, ro, valid = forced_split_info(
            hist[f], sum_g, sum_h, cnt, threshold=fs.threshold_bin,
            num_bin=int(self.np_num_bin[f]),
            missing_type=int(self.np_missing[f]),
            default_bin=int(self.np_default_bin[f]), is_cat=fs.is_cat,
            lambda_l1=float(cfg.lambda_l1), lambda_l2=float(cfg.lambda_l2),
            max_delta_step=float(cfg.max_delta_step),
            min_gain_to_split=float(cfg.min_gain_to_split))
        cf = torch.stack([gain, lg, lh - K_EPSILON, lc, rg, rh - K_EPSILON,
                          rc, lo, ro]).to(self._acc)
        ci, cb = self._forced_static[i]
        return cf, ci, cb, valid

    def _num_features_of(self, feature_mask):
        """The mask the numerical scan takes: categorical features off."""
        if not self.has_categorical:
            return feature_mask
        return feature_mask & self._num_mask

    def _with_categorical(self, num, hist, sum_g, sum_h, cnt,
                          feature_mask, min_c=None, max_c=None) -> _FeatCand:
        """``num``'s candidates with the categorical columns replaced by
        the categorical search's (in place, `:286-310`) and their bitsets;
        plain float64 in dp, ``split_cat`` otherwise.  The leaves' bounds
        ``min_c`` / ``max_c`` clip its outputs; the penalty scales its
        gains."""
        if not self.has_categorical:
            return _FeatCand(*num)
        k, f = num.gain.shape
        bits = torch.zeros((k, f, self.cat_W), dtype=torch.int32,
                           device=self.device)
        if self.hist_dp:
            fn = categorical_candidates_plain
        else:
            fn = self.split_cat
            self.kernel_calls["split_cat"] += 1
        fn(num, bits, hist, sum_g, sum_h, cnt, self.f_num_bin,
           self.f_missing, feature_mask, self._cat_cols, min_c, max_c,
           self.f_penalty, **self._cat_split_kwargs)
        return _FeatCand(*num, is_cat=self._is_cat_t, cat_bits=bits)

    def _pack_cands(self, c, depth_ok):
        """(K, F) per-feature candidates -> per-leaf best rows ((K, NUM_CF)
        acc, (K, NUM_CI) int64, the winner's (K, W) int32 bitset or None
        without categorical features); argmax over features, lowest index
        winning ties (`serial_tree_learner.cpp:505-520`)."""
        best_f = torch.argmax(c.gain, dim=-1)                     # (K,)

        def pick(a):
            return torch.gather(a, -1, best_f[:, None]).squeeze(-1)

        gain = pick(c.gain)
        if depth_ok is not True:
            gain = torch.where(depth_ok, gain, float("-inf"))
        cf = torch.stack([
            gain.to(self._acc), pick(c.left_sum_g), pick(c.left_sum_h),
            pick(c.left_cnt), pick(c.right_sum_g), pick(c.right_sum_h),
            pick(c.right_cnt), pick(c.left_output), pick(c.right_output)],
            dim=-1).to(self._acc)
        flags = pick(c.default_left).to(torch.int64)
        cb = None
        if c.is_cat is not None:
            flags = flags + 2 * c.is_cat.index_select(0, best_f) \
                .to(torch.int64)
            cb = torch.gather(c.cat_bits, 1, best_f[:, None, None].expand(
                -1, 1, c.cat_bits.shape[-1]))[:, 0]
        ci = torch.stack([best_f, pick(c.threshold).to(torch.int64), flags],
                         dim=-1)
        return cf, ci, cb

    # -- host assembly -------------------------------------------------------

    def _split_host_tree(self, tree: Tree, r: np.ndarray, left_cnt: int,
                         right_cnt: int, cat_bits=None) -> None:
        """Apply one recorded split to the host tree: numerical through
        ``Tree.split``, categorical through ``Tree.split_categorical`` with
        the bin bitset ``cat_bits`` (W words) turned into category values,
        the "other" bin (category -1) left out (`:626-656`)."""
        fi = int(r[REC_FEATURE])
        mapper = self.data.bin_mappers[fi]
        common = dict(leaf=int(r[REC_LEAF]), feature_inner=fi,
                      real_feature=int(self.data.used_feature_map[fi]),
                      left_value=float(r[REC_LEFT_OUT]),
                      right_value=float(r[REC_RIGHT_OUT]),
                      left_cnt=left_cnt, right_cnt=right_cnt,
                      gain=float(r[REC_GAIN]),
                      missing_type=int(self.np_missing[fi]))
        if r[REC_IS_CAT] > 0.5:
            b2c = mapper.bin_2_categorical
            bins = [b for b in range(int(self.np_num_bin[fi]))
                    if (int(cat_bits[b // 32]) >> (b % 32)) & 1]
            cats = [int(b2c[b]) for b in bins
                    if b < len(b2c) and int(b2c[b]) >= 0]
            tree.split_categorical(threshold_bins=bins, threshold_cats=cats,
                                   **common)
        else:
            thr_bin = int(r[REC_THRESHOLD])
            tree.split(threshold_bin=thr_bin,
                       threshold_double=mapper.bin_to_value(thr_bin),
                       default_left=bool(r[REC_DEFAULT_LEFT] > 0.5),
                       **common)
        tree.internal_value[tree.num_leaves - 2] = float(r[REC_INTERNAL_VALUE])

    def _assemble(self, records: np.ndarray, rec_i: np.ndarray) -> Tree:
        """Replay the records split by split (``Tree.split`` or
        ``Tree.split_categorical`` per record); ``rec_i`` (L-1,
        ``rec_i_cols``) holds the exact counts and the bitset words."""
        tree = Tree(self.num_leaves)
        for i in range(records.shape[0]):
            r = records[i]
            if r[REC_VALID] < 0.5:
                break
            self._split_host_tree(tree, r, left_cnt=int(rec_i[i, 0]),
                                  right_cnt=int(rec_i[i, 1]),
                                  cat_bits=rec_i[i, 2:])
        return tree

    def assemble_host(self, records: np.ndarray, rec_i: np.ndarray) -> Tree:
        """The host tree of one record batch: vectorized, or sequential
        with ``tpu_vec_assemble=false`` and for a tree with a categorical
        split (its bitset bookkeeping is order-dependent)."""
        valid = records[:, REC_VALID] > 0.5
        nv = int(np.argmin(valid)) if not valid.all() else len(valid)
        if bool(getattr(self.cfg, "tpu_vec_assemble", True)) \
                and not (records[:nv, REC_IS_CAT] > 0.5).any():
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


@dataclass
class MaskedState:
    """One tree's device state (the JAX ``TreeState`` for serial numerical
    data); the tensors are updated in place, ``leaf_id`` is replaced."""
    leaf_id: torch.Tensor     # (N,) int32 leaf of each row
    hist_pool: torch.Tensor   # (L, F, B, 3) acc
    leaf_f: torch.Tensor      # (L, NUM_LF) acc sums/cnt/output/depth
    cand_f: torch.Tensor      # (L, NUM_CF) acc per-leaf best split floats
    cand_i: torch.Tensor      # (L, NUM_CI) int64 feature/threshold/flags
    num_leaves: torch.Tensor  # () int64
    rec_f: torch.Tensor       # (L-1, NUM_REC_FIELDS) f32 per-split records
    rec_i: torch.Tensor       # (L-1, rec_i_cols) int64 exact bagged
                              # left/right counts (and bitset words)
    w: torch.Tensor           # (3, N) f32 (g*bag, h*bag, bag)
    w_small: torch.Tensor     # (3, N) f32 the smaller child's weights
    bag_b: torch.Tensor       # (N,) bool rows in the bag
    cand_b: Optional[torch.Tensor] = None  # (L, W) int32 bitsets (cat data)


class MaskedTreeLearner(TreeLearner):
    """Leaf-wise growth over every row, one full-pass histogram per split
    (see the module docstring)."""

    def __init__(self, cfg: Config, data: _ConstructedDataset,
                 device: torch.device,
                 histogram: Optional[HistogramFn] = None):
        super().__init__(cfg, data, device)
        # only the used features' code rows are read, not the padding rows
        self.bins = data.device_bins(device)[:self.num_features]
        #: ``histogram(bins, w, num_bins=, dp=)``; the dispatcher by default
        #: (the kernel on the card); the chip check passes the plain version
        self.histogram = histogram or build_histogram
        self.host_syncs = 0          # blocking device->host reads so far
        self.kernel_calls["hist_full"] = 0
        self._all_features = torch.ones(self.num_features, dtype=torch.bool,
                                        device=device)

    def _hist(self, w: torch.Tensor) -> torch.Tensor:
        self.kernel_calls["hist_full"] += int(not self.hist_dp)
        return self.histogram(self.bins, w, num_bins=self.num_bins_padded,
                              dp=self.hist_dp)

    def _cands(self, hist, sum_g, sum_h, cnt, feature_mask, depth_ok,
               min_c=None, max_c=None):
        return self._pack_cands(
            self._feature_cands(hist, sum_g, sum_h, cnt, feature_mask,
                                min_c, max_c), depth_ok)

    def _init_root(self, grad, hess, bag, feature_mask) -> MaskedState:
        n, L, acc, dev = self.bins.shape[1], self.num_leaves, self._acc, \
            self.device
        w = torch.stack([grad * bag, hess * bag, bag]).to(torch.float32)
        root_hist = self._hist(w)
        sum_g = (grad * bag).to(acc).sum()
        sum_h = (hess * bag).to(acc).sum()
        cnt = bag.to(acc).sum()
        cf, ci, cb = self._cands(root_hist[None], sum_g[None], sum_h[None],
                                 cnt[None], feature_mask, True)
        st = MaskedState(
            leaf_id=torch.zeros(n, dtype=torch.int32, device=dev),
            hist_pool=torch.zeros((L,) + tuple(root_hist.shape), dtype=acc,
                                  device=dev),
            leaf_f=torch.zeros((L, NUM_LF), dtype=acc, device=dev),
            cand_f=torch.zeros((L, NUM_CF), dtype=acc, device=dev),
            cand_i=torch.zeros((L, NUM_CI), dtype=torch.int64, device=dev),
            num_leaves=torch.ones((), dtype=torch.int64, device=dev),
            rec_f=torch.zeros((L - 1, NUM_REC_FIELDS), dtype=torch.float32,
                              device=dev),
            rec_i=torch.zeros((L - 1, self.rec_i_cols), dtype=torch.int64,
                              device=dev),
            w=w, w_small=torch.empty_like(w), bag_b=bag > 0.5)
        if cb is not None:
            st.cand_b = torch.zeros((L, self.cat_W), dtype=torch.int32,
                                    device=dev)
            st.cand_b[0] = cb[0]
        st.hist_pool[0] = root_hist
        st.leaf_f[0, :LF_OUT] = torch.stack([sum_g, sum_h, cnt])
        st.leaf_f[:, LF_MIN_C] = float("-inf")
        st.leaf_f[:, LF_MAX_C] = float("inf")
        st.cand_f[:, CF_GAIN] = float("-inf")
        st.cand_f[0] = cf[0]
        st.cand_i[0] = ci[0]
        return st

    def _split_step(self, st: MaskedState, feature_mask, step,
                    forced=None) -> None:
        """One no-op-able split (`learner.py:373-510`): the best leaf splits
        when its gain is positive (``do``), else nothing changes but record
        ``step``, written invalid.  ``forced=(i, cf, ci, cb, do)`` splits
        the leaf of forced split ``i`` at ``_forced_rows``' candidate
        instead where ``do`` (it is valid and no earlier one aborted).
        With ``step`` None (a tree with forced splits) the record goes to
        the cursor ``num_leaves - 1``, written only by a split that is
        done, and a best-gain split also needs a leaf to spare (JAX
        `learner_compact.py:444-451`).  No value is read to the host: rows
        are picked with ``index_select`` on device indices."""
        L = self.num_leaves
        if forced is None:
            best = torch.argmax(st.cand_f[:, CF_GAIN]).view(1)    # (1,)
            cf = st.cand_f.index_select(0, best)[0]
            ci = st.cand_i.index_select(0, best)[0]
            do = cf[CF_GAIN] > 0.0
            if step is None:
                do = do & (st.num_leaves < L)
        else:
            i, cf, ci, cb_f, do = forced
            best = torch.full((1,), self._forced[i].leaf, dtype=torch.int64,
                              device=self.device)
        lrow = st.leaf_f.index_select(0, best)[0]
        new = st.num_leaves.view(1)
        if step is None:
            # a full tree's no-op steps stay inside the tables
            new = torch.clamp(new, max=L - 1)
        pair = torch.cat([best, new])
        best32 = best.to(torch.int32)

        # ---- partition rows (`tree.h:233-249` NumericalDecisionInner,
        # `tree.h:270-277` CategoricalDecisionInner) from the split
        # feature's code row, widened before any compare
        feat = ci[CI_FEAT:CI_FEAT + 1]
        frow = read_codes(self.bins, feat)[0]                      # (N,)
        mt = self.f_missing.index_select(0, feat)
        is_missing = ((mt == MISSING_ZERO)
                      & (frow == self.f_default_bin.index_select(0, feat))) \
            | ((mt == MISSING_NAN)
               & (frow == self.f_num_bin.index_select(0, feat) - 1))
        go_left = torch.where(is_missing, (ci[CI_FLAGS] & 1) != 0,
                              frow <= ci[CI_THR])
        cb = None
        if st.cand_b is not None:
            # a categorical row ignores the missing rule: its bin's bit
            cb = st.cand_b.index_select(0, best)[0] if forced is None \
                else cb_f                                          # (W,)
            word = cb.index_select(0, frow >> 5)
            go_left = torch.where((ci[CI_FLAGS] & 2) != 0,
                                  ((word >> (frow & 31)) & 1) == 1, go_left)
        at_leaf = st.leaf_id == best32
        st.leaf_id = torch.where(do & at_leaf & ~go_left,
                                 new.to(torch.int32), st.leaf_id)
        # exact integer bagged counts (a float32 count channel loses
        # integer exactness past 2^24 rows)
        lc_bag = (at_leaf & go_left & st.bag_b).sum()
        c_bag = (at_leaf & st.bag_b).sum()

        # ---- smaller-child histogram over every row, the other rows'
        # weights masked to zero, and sibling subtraction
        # (`serial_tree_learner.cpp:371-385`)
        left_smaller = cf[CF_LCNT] <= cf[CF_RCNT]
        small = torch.where(left_smaller, best32, new.to(torch.int32))
        m_small = (st.leaf_id == small) & at_leaf & do
        torch.mul(st.w, m_small.to(torch.float32), out=st.w_small)
        hist_small = self._hist(st.w_small)
        parent = st.hist_pool.index_select(0, best)[0]
        large = parent - hist_small
        hist_left = torch.where(left_smaller, hist_small, large)
        hist_right = torch.where(left_smaller, large, hist_small)
        hists = torch.stack([hist_left, hist_right])
        st.hist_pool.index_copy_(0, pair, torch.where(
            do, hists, st.hist_pool.index_select(0, pair)))

        # ---- leaf bookkeeping.  A forced split mirrors the reference: the
        # children's sums from GatherInfoForThreshold, their counts from the
        # partition (`leaf_splits.hpp:40-52`, JAX `learner.py:431-438`)
        if forced is not None:
            cf = torch.cat([cf[:CF_LCNT], lc_bag.to(cf.dtype).view(1),
                            cf[CF_RSG:CF_RCNT],
                            (c_bag - lc_bag).to(cf.dtype).view(1),
                            cf[CF_LOUT:]])
        child_depth = lrow[LF_DEPTH:LF_DEPTH + 1] + 1.0
        pmin, pmax = lrow[LF_MIN_C:LF_MIN_C + 1], lrow[LF_MAX_C:]
        mins = maxs = None
        lmin = rmin = pmin
        lmax = rmax = pmax
        if self.has_monotone:
            # monotone propagation (JAX `learner.py:451-463`); the JAX
            # learner keeps the bounds in float32 arrays, so the stored
            # ones are rounded to float32 while the children's scans below
            # take them as computed
            lmin, lmax, rmin, rmax = self._child_constraints(
                ci[CI_FEAT:CI_FEAT + 1], ci[CI_FLAGS:],
                cf[CF_LOUT:CF_LOUT + 1], cf[CF_ROUT:CF_ROUT + 1], pmin, pmax)
            mins, maxs = torch.cat([lmin, rmin]), torch.cat([lmax, rmax])
            lmin, lmax, rmin, rmax = (
                x.to(torch.float32).to(x.dtype)
                for x in (lmin, lmax, rmin, rmax))
        rows = torch.stack([
            torch.cat([cf[CF_LSG:CF_LCNT + 1], cf[CF_LOUT:CF_LOUT + 1],
                       child_depth, lmin, lmax]),
            torch.cat([cf[CF_RSG:CF_RCNT + 1], cf[CF_ROUT:CF_ROUT + 1],
                       child_depth, rmin, rmax])])
        st.leaf_f.index_copy_(0, pair, torch.where(
            do, rows, st.leaf_f.index_select(0, pair)))

        # ---- both children's best splits in one scan
        md = int(self.cfg.max_depth)
        depth_ok = True if md <= 0 else child_depth[0] < md
        cf2, ci2, cb2 = self._cands(
            hists, torch.stack([cf[CF_LSG], cf[CF_RSG]]),
            torch.stack([cf[CF_LSH], cf[CF_RSH]]),
            torch.stack([cf[CF_LCNT], cf[CF_RCNT]]), feature_mask, depth_ok,
            mins, maxs)
        st.cand_f.index_copy_(0, pair, torch.where(
            do, cf2, st.cand_f.index_select(0, pair)))
        st.cand_i.index_copy_(0, pair, torch.where(
            do, ci2, st.cand_i.index_select(0, pair)))

        # ---- record for host tree assembly (JAX `:482-500`); the bitset
        # words widened to int64 with the counts
        flags = ci[CI_FLAGS:]
        head = torch.cat([do.view(1).to(torch.int64), best, ci[:CI_FLAGS],
                          flags & 1])
        body = torch.stack([
            cf[CF_GAIN], cf[CF_LOUT], cf[CF_ROUT], cf[CF_LCNT], cf[CF_RCNT],
            lrow[LF_OUT], lrow[LF_CNT], cf[CF_LSH], cf[CF_RSH], cf[CF_LSG],
            cf[CF_RSG]])
        rec = torch.cat([head.to(torch.float32), body.to(torch.float32),
                         (flags >> 1).to(torch.float32)])
        counts = torch.stack([lc_bag, c_bag - lc_bag])
        if cb is not None:
            st.cand_b.index_copy_(0, pair, torch.where(
                do, cb2, st.cand_b.index_select(0, pair)))
            counts = torch.cat([counts, cb.to(torch.int64) & 0xFFFFFFFF])
        if step is None:
            cur = torch.clamp(st.num_leaves - 1, max=L - 2).view(1)
            st.rec_f.index_copy_(0, cur, torch.where(
                do, rec, st.rec_f.index_select(0, cur)[0])[None])
            st.rec_i.index_copy_(0, cur, torch.where(
                do, counts, st.rec_i.index_select(0, cur)[0])[None])
        else:
            st.rec_f[step] = rec
            st.rec_i[step] = counts
        st.num_leaves += do.to(torch.int64)

    def _forced_phase(self, st: MaskedState, feature_mask) -> None:
        """The forced splits in BFS order before best-gain growth, each a
        ``do``-gated step (JAX `learner.py:561-571`): an invalid one aborts
        the rest of the queue (`serial_tree_learner.cpp:612-616`), with no
        host read."""
        aborted = torch.zeros((), dtype=torch.bool, device=self.device)
        for i, fs in enumerate(self._forced):
            lrow = st.leaf_f[fs.leaf]
            cf, ci, cb, valid = self._forced_rows(i, st.hist_pool[fs.leaf],
                                                  lrow)
            self._split_step(st, feature_mask, None,
                             forced=(i, cf, ci, cb, valid & ~aborted))
            aborted = aborted | ~valid

    def train_async(self, grad: torch.Tensor, hess: torch.Tensor,
                    bag: torch.Tensor,
                    feature_mask: Optional[torch.Tensor] = None
                    ) -> AsyncTree:
        """Grow one tree in exactly ``num_leaves - 1`` steps with no host
        read: the records and their exact integer columns packed as (L-1)
        rows of ``NUM_REC_FIELDS + rec_i_cols`` float64, the leaf id per row
        (N,) int64 and the leaf outputs (L,) acc, all on the device."""
        if feature_mask is None:
            feature_mask = self._all_features
        st = self._init_root(grad, hess, bag, feature_mask)
        if self._forced:
            # the forced phase, then as many best-gain steps as the tree
            # can take; records at the cursor
            self._forced_phase(st, feature_mask)
            for _ in range(self.num_leaves - 1):
                self._split_step(st, feature_mask, None)
        else:
            for step in range(self.num_leaves - 1):
                self._split_step(st, feature_mask, step)
        packed = torch.cat([st.rec_f.to(torch.float64),
                            st.rec_i.to(torch.float64)], dim=1).reshape(-1)
        return AsyncTree(packed, st.leaf_id.to(torch.int64),
                         st.leaf_f[:, LF_OUT], {})

    def host_records(self, flat: np.ndarray, host_stats=None):
        """(records (L-1, 17) float32, exact integer columns (L-1,
        rec_i_cols) int64: the bagged counts, then any bitset words) from a
        tree's packed records read to the host."""
        out = flat.reshape(self.num_leaves - 1,
                           NUM_REC_FIELDS + self.rec_i_cols)
        return (out[:, :NUM_REC_FIELDS].astype(np.float32),
                out[:, NUM_REC_FIELDS:].astype(np.int64))

    def grow(self, grad: torch.Tensor, hess: torch.Tensor, bag: torch.Tensor,
             feature_mask: Optional[torch.Tensor] = None):
        """Grow one tree; returns (records (L-1, 17) f32 numpy, exact
        integer columns (L-1, rec_i_cols) int64 numpy, leaf id per row (N,)
        int64 tensor, leaf outputs (L,) acc tensor).  The records are the
        one host read of the tree."""
        tree = self.train_async(grad, hess, bag, feature_mask)
        flat = tree.records.cpu().numpy()
        self.host_syncs += 1
        rec_f, rec_i = self.host_records(flat)
        return rec_f, rec_i, tree.leaf_id, tree.leaf_out

    def train(self, grad: torch.Tensor, hess: torch.Tensor, bag: torch.Tensor,
              feature_mask: Optional[torch.Tensor] = None):
        """Build one tree; returns (host Tree with unit shrinkage, leaf id
        per row, leaf outputs) — the last two on the device."""
        rec_f, rec_i, leaf_id, leaf_out = self.grow(grad, hess, bag,
                                                    feature_mask)
        return self.assemble_host(rec_f, rec_i), leaf_id, leaf_out
