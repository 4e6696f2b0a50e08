"""Compacted tree learner: leaf-wise growth over leaf-contiguous rows.

Port of ``lightgbm_tpu/learner_compact.py:CompactTPUTreeLearner``.  The row
payloads (packed bin words, weight channels, row ids, leaf ids) are kept
permuted so that the rows of leaf ``l`` live at ``[start[l], start[l] +
size[l])``; a split partitions only its parent's window and the smaller
child's histogram is built through ``ops/hist_packed.py``, the sibling's by
subtraction from the parent (`serial_tree_learner.cpp:371-385`).  Split
semantics are the JAX package's: both call ``find_best_splits`` and, for
categorical features, the categorical search (``ops/split_cat.py``, the
``split_cat`` kernel on the card); a categorical split routes the rows of
its window by the bin bitset kept per leaf (`learner_compact.py:281-316`).
A split propagates monotone value bounds to its children
(`learner_compact.py:563-569`), and the forced splits (``forced.py``) run
before best-gain growth on every tree (`:618-720`), one host read each,
the first invalid one ending the queue.

What changes in eager torch:

  * The tree is a Python loop over split steps, not a jitted ``while_loop``
    with ``lax.switch`` over power-of-two window buckets (the buckets exist
    only because XLA needs static shapes).  Each step slices its windows
    directly, rounded up to the histogram kernel's 1024-row quantum.
  * Each step reads ONE small packed tensor to the host: the best leaf, its
    window start and size, its best split (feature, threshold, flags) and
    whether its gain is positive (``do``, which is also the loop condition).
    That is one host sync per split; ``host_syncs`` counts them.  Because the
    smaller child's window position is only known on the device after the
    partition, its histogram runs over the parent's window with the weights
    masked to the smaller child's leaf id, so no second sync is needed.
  * The partition keeps both JAX modes as semantics.  Windows whose size
    bucket is above ``tpu_sort_cutoff`` are physically compacted by a stable
    cumsum partition and one gather per lane (the one-bit-key ``lax.sort``);
    smaller windows are frozen and only the leaf-id lane is rewritten (mask
    mode), children sharing the parent's window.
  * ``gpu_use_dp`` keeps the plain float64 histogram, as the JAX package keeps
    dp off its Pallas kernel.  Otherwise the histogram is the ``histogram``
    argument, by default the kernel wrapper ``build_histogram_packed``; the
    tests and the chip check pass ``build_histogram_packed_plain`` to grow
    the same tree through the plain version.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .binning import MISSING_NAN, MISSING_ZERO
from .config import PARALLEL, Config, not_ported
from .dataset import _ConstructedDataset, _round_up
from .learner import (CF_GAIN, CF_LCNT, CF_LOUT, CF_LSG, CF_LSH, CF_RCNT,
                      CF_ROUT, CF_RSG, CF_RSH, CI_FEAT, CI_FLAGS, LF_CNT,
                      LF_DEPTH, LF_MAX_C, LF_MIN_C, LF_OUT, LF_SUM_G,
                      LF_SUM_H, NUM_CF, NUM_CI, NUM_LF, NUM_REC_FIELDS,
                      REC_IS_CAT, HistogramFn, TreeLearner)
from .ops.hist_packed import (ROW_QUANTUM, build_histogram_packed,
                              build_histogram_packed_plain, pack_bin_words)
from .tree import Tree

# record fields known on the host (REC_VALID .. REC_DEFAULT_LEFT)
NUM_HOST_REC = 5


@dataclass
class CompactState:
    """One tree's device state; the tensors are updated in place."""
    bins_p: torch.Tensor     # (Fw, N) int32 packed bins, permuted by leaf
    w_p: torch.Tensor        # (3, N) f32 (g*bag, h*bag, bag), permuted
    rid_p: torch.Tensor      # (N,) int64 original row id at each position
    lid_p: torch.Tensor      # (N,) int32 leaf id at each position
    leaf_i: torch.Tensor     # (L, 2) int64 [window start, window size]
    leaf_f: torch.Tensor     # (L, NUM_LF) acc sums/cnt/output/depth/bounds
    hist_pool: torch.Tensor  # (L, F, B, 3) acc
    cand_f: torch.Tensor     # (L, NUM_CF) acc per-leaf best split floats
    cand_i: torch.Tensor     # (L, NUM_CI) int64 feature/threshold/flags
    rec_f: torch.Tensor      # (L-1, NUM_REC_FIELDS) f32 per-split records
    rec_i: torch.Tensor      # (L-1, rec_i_cols) int64 exact bagged
                             # left/right counts (and bitset words)
    cand_b: Optional[torch.Tensor] = None  # (L, W) int32 bitsets (cat data)


class CompactTreeLearner(TreeLearner):
    """Leaf-wise learner with leaf-contiguous row compaction (see the module
    docstring)."""

    def __init__(self, cfg: Config, data: _ConstructedDataset,
                 device: torch.device,
                 histogram: Optional[HistogramFn] = None):
        super().__init__(cfg, data, device)
        self.n_pad = int(data.num_data_padded)
        self._bundle = data.bundle
        if self._bundle is not None:
            bu = self._bundle
            f_pad = _round_up(bu.num_groups, data.FEATURE_TILE)
            self._hist_cols = bu.num_groups
            self._hist_nbins = int(max(self.num_bins_padded,
                                       bu.max_group_bin))
            idx, valid, fix = bu.unbundle_maps(
                self.num_features, self.num_bins_padded, self._hist_nbins,
                self.np_num_bin)
            self._ub_idx = torch.from_numpy(idx.astype(np.int64)).to(device)
            self._ub_valid = torch.from_numpy(valid).to(device)
            self._ub_fix = torch.from_numpy(fix).to(device)
        else:
            f_pad = data.bins.shape[0]       # padded to a multiple of 8
            self._hist_cols = self.num_features
            self._hist_nbins = self.num_bins_padded
        if self._hist_nbins > 256:
            raise ValueError(f"{self._hist_nbins}-bin data: bin codes past a "
                             f"byte do not pack; the masked learner takes it")
        self.fw = f_pad // 4
        # window size buckets of the JAX learner, smallest..largest (= N):
        # a window is physically compacted when its bucket is above
        # tpu_sort_cutoff, and frozen (mask mode) otherwise
        mw = max(int(cfg.tpu_min_window), 1024)
        mw = 1 << (mw - 1).bit_length()
        sizes = []
        s0 = mw
        while s0 < self.n_pad:
            sizes.append(s0)
            s0 *= 2
        sizes.append(self.n_pad)
        self._win_sizes = sizes
        if cfg.tpu_hist_precision not in ("bf16x2", "bf16x3", "highest"):
            raise ValueError(f"tpu_hist_precision must be one of "
                             f"['bf16x2', 'bf16x3', 'highest'], got "
                             f"{cfg.tpu_hist_precision}")
        self._sort_cutoff = int(cfg.tpu_sort_cutoff)
        self.histogram = histogram or build_histogram_packed
        if device.type == "cuda" and self.n_pad % ROW_QUANTUM:
            raise ValueError(f"on the CUDA card the padded row count must be "
                             f"a multiple of {ROW_QUANTUM}; set "
                             f"tpu_row_block to a multiple of {ROW_QUANTUM}")
        self._bins_packed: Optional[torch.Tensor] = None
        # quantized-gradient mode is a wave-learner setting: the compact
        # learner never quantizes; the wave subclass sets _quant per config
        # and _q_rescale = (1, 1, the count rescale) per tree
        self._quant = False
        self._q_rescale: Optional[torch.Tensor] = None
        self.host_syncs = 0          # blocking device->host reads so far
        self._all_features = torch.ones(self.num_features, dtype=torch.bool,
                                        device=device)

    # -- packed bins ---------------------------------------------------------

    def bins_packed(self) -> torch.Tensor:
        """(Fw, N) int32 packed bin words (bundle codes under EFB) on the
        learner's device, built once."""
        if self._bins_packed is None:
            if self._bundle is not None:
                src = torch.from_numpy(self._bundle.encode(self.data)) \
                    .to(self.device)
            else:
                src = self.data.device_bins(self.device)
            self._bins_packed = pack_bin_words(src)
        return self._bins_packed

    def _bucket(self, cnt: int) -> int:
        """Smallest window bucket >= cnt."""
        for s in self._win_sizes:
            if s >= cnt:
                return s
        return self._win_sizes[-1]

    # -- windowed histogram --------------------------------------------------

    def _window_hist(self, st: CompactState, start: int, cnt: int,
                     leaf) -> torch.Tensor:
        """Histogram of the rows of ``leaf`` (a device scalar; None = every
        row) inside the window ``[start, start + cnt)``, over that window
        rounded up to the kernel's row quantum."""
        n = self.n_pad
        size = min(_round_up(max(cnt, 1), ROW_QUANTUM), n)
        sa = min(start, n - size)
        words = st.bins_p[:, sa:sa + size]
        w = st.w_p[:, sa:sa + size]
        if leaf is not None:
            w = w * (st.lid_p[sa:sa + size] == leaf)
        if self.hist_dp:
            h = build_histogram_packed_plain(words, w,
                                             num_bins=self._hist_nbins,
                                             dp=True)
            return h[:self._hist_cols]
        h = self.histogram(words, w, num_bins=self._hist_nbins,
                           quant=self._quant)
        return self._quant_count(h[:self._hist_cols])

    def _quant_count(self, h: torch.Tensor) -> torch.Tensor:
        """In quant mode the count channel holds the hessian lane's sums:
        rescale it into the normalized count (``ops/quant.py``, the wave
        learner's ``_init_root_wave``); otherwise ``h`` as it is."""
        return h * self._q_rescale if self._quant else h

    # -- EFB unbundling ------------------------------------------------------

    def _unbundle_hist(self, hist_g, sum_g, sum_h, cnt):
        """(K, G, Bg, 3) bundle histograms -> (K, F, Bf, 3) per-feature view;
        each bundled member's default-bin entry is rebuilt from the leaf
        totals (``Dataset::FixHistogram``)."""
        k = hist_g.shape[0]
        flat = hist_g.reshape(k, -1, 3)
        view = flat[:, self._ub_idx]
        view = view * self._ub_valid[..., None].to(view.dtype)
        totals = torch.stack([sum_g, sum_h, cnt], -1).to(view.dtype)
        dflt = totals[:, None, :] - torch.sum(view, dim=2)
        bins = torch.arange(view.shape[2], device=view.device)
        bsel = (bins[None, :] == self.f_default_bin[:, None]) \
            & self._ub_fix[:, None]
        return torch.where(bsel[..., None], dflt[:, :, None, :], view)

    # -- per-leaf candidates -------------------------------------------------

    def _cand_rows(self, hist, sum_g, sum_h, cnt, feature_mask, depth_ok,
                   min_c=None, max_c=None):
        """(K, ...) histograms -> per-leaf best rows ((K, NUM_CF) acc,
        (K, NUM_CI) int64, the winner's (K, W) int32 bitset or None);
        ``min_c`` / ``max_c`` (K,) the leaves' value bounds."""
        if self._bundle is not None:
            hist = self._unbundle_hist(hist, sum_g, sum_h, cnt)
        return self._pack_cands(
            self._feature_cands(hist, sum_g, sum_h, cnt, feature_mask,
                                min_c, max_c), depth_ok)

    # -- root ----------------------------------------------------------------

    def _init_root(self, grad, hess, bag, feature_mask) -> CompactState:
        n, L, acc, dev = self.n_pad, self.num_leaves, self._acc, self.device
        w = torch.stack([grad * bag, hess * bag, bag]).to(torch.float32)
        st = CompactState(
            bins_p=self.bins_packed().clone(), w_p=w,
            rid_p=torch.arange(n, device=dev),
            lid_p=torch.zeros(n, dtype=torch.int32, device=dev),
            leaf_i=torch.zeros((L, 2), dtype=torch.int64, device=dev),
            leaf_f=torch.zeros((L, NUM_LF), dtype=acc, device=dev),
            hist_pool=torch.zeros((L, self._hist_cols, self._hist_nbins, 3),
                                  dtype=acc, device=dev),
            cand_f=torch.zeros((L, NUM_CF), dtype=acc, device=dev),
            cand_i=torch.zeros((L, NUM_CI), dtype=torch.int64, device=dev),
            rec_f=torch.zeros((L - 1, NUM_REC_FIELDS), dtype=torch.float32,
                              device=dev),
            rec_i=torch.zeros((L - 1, self.rec_i_cols), dtype=torch.int64,
                              device=dev))
        root_hist = self._window_hist(st, 0, n, None)
        sum_g = (grad * bag).to(acc).sum()
        sum_h = (hess * bag).to(acc).sum()
        cnt = bag.to(acc).sum()
        md = int(self.cfg.max_depth)
        depth_ok = True if md <= 0 else md > 0
        cf, ci, cb = self._cand_rows(root_hist[None], sum_g[None],
                                     sum_h[None], cnt[None], feature_mask,
                                     depth_ok)
        if cb is not None:
            st.cand_b = torch.zeros((L, self.cat_W), dtype=torch.int32,
                                    device=dev)
            st.cand_b[0] = cb[0]
        st.leaf_i[0, 1] = n
        st.leaf_f[:, LF_MIN_C] = float("-inf")
        st.leaf_f[:, LF_MAX_C] = float("inf")
        st.leaf_f[0, :LF_OUT] = torch.stack([sum_g, sum_h, cnt])
        st.hist_pool[0] = root_hist
        st.cand_f[:, CF_GAIN] = float("-inf")
        st.cand_f[0] = cf[0]
        st.cand_i[0] = ci[0]
        return st

    # -- one split -----------------------------------------------------------

    def _split_step(self, st: CompactState, feature_mask, leaf: int,
                    s: int, c: int, feat: int, thr: int, flags: int,
                    new_leaf: int, forced=None) -> None:
        """Split ``leaf`` at its best candidate, or at the forced split's
        rows ``forced=(crow_f, crow_i, crow_b)`` (``_forced_rows``)."""
        dev = self.device
        dleft = bool(flags & 1)
        if forced is None:
            crow_f = st.cand_f[leaf].clone()
            crow_i = st.cand_i[leaf]      # read before the row is rewritten
            crow_b = None if st.cand_b is None else st.cand_b[leaf].clone()
        else:
            crow_f, crow_i, crow_b = forced
        lrow_f = st.leaf_f[leaf].clone()

        # ---- partition the parent's window (DataPartition::Split): the
        # decision on the split feature (NumericalDecisionInner,
        # `tree.h:233-249`) from its byte lane
        col = int(self._bundle.f_gcol[feat]) if self._bundle is not None \
            else feat
        word = st.bins_p[col // 4, s:s + c]
        frow = (word >> (8 * (col % 4))) & 0xFF
        if self._bundle is not None and self._bundle.f_bundled[feat]:
            # bundle code -> this feature's bin (out-of-range codes mean
            # another member was active: this feature sits at its default)
            d = int(self.np_default_bin[feat])
            r = frow - int(self._bundle.f_off[feat])
            in_r = (r >= 0) & (r < int(self.np_num_bin[feat]) - 1)
            frow = torch.where(in_r, r + (r >= d).to(r.dtype), d)
        mt = int(self.np_missing[feat])
        if flags & 2:
            # CategoricalDecisionInner (`tree.h:270-277`): the bin's bit of
            # the leaf's bitset; no missing rule
            word = crow_b.index_select(0, (frow >> 5).to(torch.int64))
            go_left = ((word >> (frow & 31)) & 1) == 1
        else:
            go_left = frow <= thr
            if mt == MISSING_ZERO:
                go_left = torch.where(
                    frow == int(self.np_default_bin[feat]), dleft, go_left)
            elif mt == MISSING_NAN:
                go_left = torch.where(
                    frow == int(self.np_num_bin[feat]) - 1, dleft, go_left)
        bag = st.w_p[2, s:s + c] > 0.5
        sort_mode = self._bucket(c) > self._sort_cutoff
        if sort_mode:
            # stable partition: left rows first, then right, each in order
            cl = torch.cumsum(go_left, 0)
            lc_w = cl[-1]
            pos = torch.arange(c, device=dev)
            dest = torch.where(go_left, cl - 1, lc_w + pos - cl)
            perm = torch.empty_like(dest).scatter_(0, dest, pos)
            st.bins_p[:, s:s + c] = st.bins_p[:, s:s + c].index_select(1, perm)
            st.w_p[:, s:s + c] = st.w_p[:, s:s + c].index_select(1, perm)
            st.rid_p[s:s + c] = st.rid_p[s:s + c].index_select(0, perm)
            st.lid_p[s:s + c] = torch.where(pos >= lc_w, new_leaf, leaf)
            lc_bag = (go_left & bag).sum()
            c_bag = bag.sum()
        else:
            lid_w = st.lid_p[s:s + c]
            in_seg = lid_w == leaf
            st.lid_p[s:s + c] = torch.where(in_seg & ~go_left, new_leaf,
                                            lid_w)
            lc_bag = (in_seg & go_left & bag).sum()
            c_bag = (in_seg & bag).sum()

        # ---- smaller-child histogram + sibling subtraction; the smaller
        # child is chosen by BAGGED counts like the reference
        left_smaller = lc_bag <= (c_bag - lc_bag)
        small_leaf = torch.where(left_smaller, leaf, new_leaf)
        hist_small = self._window_hist(st, s, c, small_leaf)
        hist_large = st.hist_pool[leaf] - hist_small
        hist_left = torch.where(left_smaller, hist_small, hist_large)
        hist_right = torch.where(left_smaller, hist_large, hist_small)
        st.hist_pool[leaf] = hist_left
        st.hist_pool[new_leaf] = hist_right

        # ---- children bookkeeping.  A forced split mirrors the reference:
        # the children's sums from GatherInfoForThreshold, their counts from
        # the partition (`leaf_splits.hpp:40-52`)
        if forced is not None:
            crow_f = crow_f.clone()
            crow_f[CF_LCNT] = lc_bag
            crow_f[CF_RCNT] = c_bag - lc_bag
        child_depth = lrow_f[LF_DEPTH] + 1.0
        lout, rout = crow_f[CF_LOUT], crow_f[CF_ROUT]
        pmin, pmax = lrow_f[LF_MIN_C], lrow_f[LF_MAX_C]
        lmin = rmin = pmin
        lmax = rmax = pmax
        mins = maxs = None
        if self.has_monotone:
            lmin, lmax, rmin, rmax = (x[0] for x in self._child_constraints(
                crow_i[CI_FEAT:CI_FEAT + 1], crow_i[CI_FLAGS:], lout.view(1),
                rout.view(1), pmin.view(1), pmax.view(1)))
            mins, maxs = torch.stack([lmin, rmin]), torch.stack([lmax, rmax])
        st.leaf_f[leaf] = torch.stack([crow_f[CF_LSG], crow_f[CF_LSH],
                                       crow_f[CF_LCNT], lout, child_depth,
                                       lmin, lmax])
        st.leaf_f[new_leaf] = torch.stack([crow_f[CF_RSG], crow_f[CF_RSH],
                                           crow_f[CF_RCNT], rout, child_depth,
                                           rmin, rmax])
        if sort_mode:
            st.leaf_i[leaf, 0] = s
            st.leaf_i[leaf, 1] = lc_w
            st.leaf_i[new_leaf, 0] = lc_w + s
            st.leaf_i[new_leaf, 1] = c - lc_w
        else:
            st.leaf_i[new_leaf, 0] = s
            st.leaf_i[new_leaf, 1] = c

        # ---- children's best splits, both in one batched scan
        md = int(self.cfg.max_depth)
        depth_ok = True if md <= 0 else child_depth < md
        cf, ci, cb = self._cand_rows(
            torch.stack([hist_left, hist_right]),
            torch.stack([crow_f[CF_LSG], crow_f[CF_RSG]]),
            torch.stack([crow_f[CF_LSH], crow_f[CF_RSH]]),
            torch.stack([crow_f[CF_LCNT], crow_f[CF_RCNT]]),
            feature_mask, depth_ok, mins, maxs)
        st.cand_f[leaf] = cf[0]
        st.cand_f[new_leaf] = cf[1]
        st.cand_i[leaf] = ci[0]
        st.cand_i[new_leaf] = ci[1]
        if cb is not None:
            st.cand_b[leaf] = cb[0]
            st.cand_b[new_leaf] = cb[1]

        # ---- record for host tree assembly (the host-known fields
        # REC_VALID..REC_DEFAULT_LEFT are filled in on the host)
        step = new_leaf - 1
        st.rec_f[step, NUM_HOST_REC:NUM_REC_FIELDS - 1] = torch.stack([
            crow_f[CF_GAIN], lout, rout, crow_f[CF_LCNT], crow_f[CF_RCNT],
            lrow_f[LF_OUT], lrow_f[LF_CNT], crow_f[CF_LSH], crow_f[CF_RSH],
            crow_f[CF_LSG], crow_f[CF_RSG]]).to(torch.float32)
        counts = torch.stack([lc_bag, c_bag - lc_bag])
        if crow_b is not None:
            counts = torch.cat([counts, crow_b.to(torch.int64) & 0xFFFFFFFF])
        st.rec_i[step] = counts

    # -- whole tree ----------------------------------------------------------

    def grow(self, grad: torch.Tensor, hess: torch.Tensor, bag: torch.Tensor,
             feature_mask: Optional[torch.Tensor] = None):
        """Grow one tree; returns (records (L-1, 17) f32 numpy, exact
        integer columns (L-1, rec_i_cols) int64 numpy: the bagged counts and
        any bitset words, leaf id per original row (N,) int64 tensor, leaf
        outputs (L,) acc tensor)."""
        if feature_mask is None:
            feature_mask = self._all_features
        st = self._init_root(grad, hess, bag, feature_mask)
        host_rec: List[Tuple[int, int, int, int, int]] = []
        num_leaves = 1
        for i, fs in enumerate(self._forced or ()):
            # the forced splits in BFS order (JAX `learner_compact.py:
            # 686-703`): one read of the split's validity and its leaf's
            # window; the first invalid one ends the queue
            if num_leaves >= self.num_leaves:
                break
            hist = st.hist_pool[fs.leaf][None]
            lrow = st.leaf_f[fs.leaf]
            if self._bundle is not None:
                hist = self._unbundle_hist(hist, lrow[LF_SUM_G][None],
                                           lrow[LF_SUM_H][None],
                                           lrow[LF_CNT][None])
            cf, ci, cb, valid = self._forced_rows(i, hist[0], lrow)
            head = torch.cat([valid.view(1).to(torch.int64),
                              st.leaf_i[fs.leaf]]).tolist()
            self.host_syncs += 1
            if not head[0]:
                break
            flags = 2 if fs.is_cat else 1
            self._split_step(st, feature_mask, fs.leaf, head[1], head[2],
                             fs.feature_inner, fs.threshold_bin, flags,
                             num_leaves, forced=(cf, ci, cb))
            host_rec.append((fs.leaf, fs.feature_inner, fs.threshold_bin,
                             flags & 1, flags >> 1))
            num_leaves += 1
        while num_leaves < self.num_leaves:
            # (index_select, not tensor indexing: a 0-d index tensor would
            # be read to the host)
            best = torch.argmax(st.cand_f[:, CF_GAIN]).view(1)
            head = torch.cat([
                best, st.leaf_i.index_select(0, best)[0],
                st.cand_i.index_select(0, best)[0],
                (st.cand_f.index_select(0, best)[0, CF_GAIN] > 0.0).view(1)])
            leaf, s, c, feat, thr, flags, do = head.tolist()
            self.host_syncs += 1
            if not do:
                break
            self._split_step(st, feature_mask, leaf, s, c, feat, thr, flags,
                             num_leaves)
            host_rec.append((leaf, feat, thr, flags & 1, flags >> 1))
            num_leaves += 1
        leaf_id = torch.empty_like(st.rid_p)
        leaf_id[st.rid_p] = st.lid_p.to(torch.int64)
        out = torch.cat([st.rec_f.to(torch.float64),
                         st.rec_i.to(torch.float64)], dim=1).cpu().numpy()
        self.host_syncs += 1
        rec_f = out[:, :NUM_REC_FIELDS].astype(np.float32)
        rec_i = out[:, NUM_REC_FIELDS:].astype(np.int64)
        if host_rec:
            hr = np.asarray(host_rec, dtype=np.float32)
            rec_f[:len(host_rec), 0] = 1.0
            rec_f[:len(host_rec), 1:NUM_HOST_REC] = hr[:, :-1]
            rec_f[:len(host_rec), REC_IS_CAT] = hr[:, -1]
        return rec_f, rec_i, leaf_id, st.leaf_f[:, LF_OUT]

    def train(self, grad: torch.Tensor, hess: torch.Tensor, bag: torch.Tensor,
              feature_mask: Optional[torch.Tensor] = None):
        """Build one tree; returns (host Tree with unit shrinkage, leaf id
        per original row, leaf outputs) — the last two on the device."""
        rec_f, rec_i, leaf_id, leaf_out = self.grow(grad, hess, bag,
                                                    feature_mask)
        return self.assemble_host(rec_f, rec_i), leaf_id, leaf_out


def create_tree_learner(cfg: Config, data: _ConstructedDataset,
                        device: torch.device) -> TreeLearner:
    """(tree_learner, tpu_learner) -> learner, as
    ``lightgbm_tpu.learner_compact.create_tree_learner`` with the JAX
    package's messages: ``auto`` and ``wave`` pick the frontier-wave learner
    where it is eligible, ``compact`` the compact learner; data past 256 bins
    (codes that do not pack four to a word) and ``masked`` go to the masked
    learner.  Only the serial tree learner is ported."""
    import warnings

    from .learner import MaskedTreeLearner
    from .learner_wave import WaveTreeLearner, wave_ineligible_reason

    if cfg.tree_learner != "serial":
        raise not_ported(f"tree_learner={cfg.tree_learner}", PARALLEL)
    mode = cfg.tpu_learner
    if mode not in ("auto", "wave", "compact", "masked"):
        raise ValueError(f"tpu_learner must be one of auto, wave, compact, "
                         f"masked; got {mode!r}")
    explicit = mode != "auto"
    verbose = int(getattr(cfg, "verbosity", 1))
    if mode == "auto":
        mode = "wave"
    if mode == "wave" and cfg.forcedsplits_filename:
        if verbose >= 1:
            print("[lightgbm_tpu_torch] forcedsplits_filename set: using the "
                  "sequential compact learner (identical trees)")
        mode = "compact"
    if mode == "wave":
        reason = wave_ineligible_reason(cfg, data)
        if reason is None:
            return WaveTreeLearner(cfg, data, device)
        mode = "compact"
        if explicit:
            warnings.warn(f"tpu_learner=wave was requested but is ineligible "
                          f"({reason}); falling back to the sequential "
                          f"compact learner")
        elif verbose >= 1:
            print(f"[lightgbm_tpu_torch] wave learner ineligible ({reason}); "
                  f"using the sequential compact learner")
    if mode == "compact" and data.max_num_bin > 256:
        why = f"max_num_bin={data.max_num_bin} > 256"
        if explicit:
            warnings.warn(f"tpu_learner=compact was requested but is "
                          f"ineligible ({why}); falling back to the masked "
                          f"learner")
        elif verbose >= 1:
            print(f"[lightgbm_tpu_torch] compact learner ineligible ({why}); "
                  f"using the masked learner")
        mode = "masked"
    if mode == "compact":
        return CompactTreeLearner(cfg, data, device)
    return MaskedTreeLearner(cfg, data, device)
