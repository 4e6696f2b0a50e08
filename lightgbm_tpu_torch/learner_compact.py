"""Compacted tree learner: leaf-wise growth over leaf-contiguous rows.

Port of ``lightgbm_tpu/learner_compact.py:CompactTPUTreeLearner``.  The row
payloads (packed bin words, weight channels, row ids, leaf ids) are kept
permuted so that the rows of leaf ``l`` live at ``[start[l], start[l] +
size[l])``; a split partitions only its parent's window and the smaller
child's histogram is built over that child's rows, the sibling's by
subtraction from the parent (`serial_tree_learner.cpp:371-385`).  Split
semantics are the JAX package's: both call ``find_best_splits`` and, for
categorical features, the categorical search (``ops/split_cat.py``, the
``split_cat`` kernel on the card); a categorical split routes the rows of
its window by the bin bitset kept per leaf (`learner_compact.py:281-316`).
A split propagates monotone value bounds to its children
(`learner_compact.py:563-569`), and the forced splits (``forced.py``) run
before best-gain growth on every tree (`:672-690`), an invalid one ending
the queue.

The tree is grown as the JAX ``_train_tree_compact`` grows it, on the
device: the root histogram through ``ops/hist_packed.py``, then a fixed
number of split steps of one shape each (the JAX ``while_loop``'s body,
`:694-725`), with no host read between them.  What changes in eager torch:

  * A step does not read its leaf to the host.  The best leaf, its window
    start and size, its split (feature, threshold, flags) and whether its
    gain is positive (``do``) stay device tensors; every state write is
    gated by ``do``, so a step that does nothing leaves the state bitwise
    unchanged.  ``grow`` runs exactly ``num_leaves - 1`` steps (after the
    forced phase, each forced split a ``do``-gated step with a running
    ``aborted``, as `:672-690`) and reads the records once per tree
    (``host_syncs``); records go to the cursor ``num_leaves - 1``.
  * The partition is ``ops/partition.py:partition_window`` (the
    ``csrc/partition.cu`` windowed kernel on the card): it reads the window
    and the split from device memory.  Windows whose size bucket is above
    ``tpu_sort_cutoff`` are stably partitioned in place (the one-bit-key
    ``lax.sort``); smaller ones are frozen and only the leaf ids change
    (mask mode), the children sharing the parent's window.  The JAX
    package's power-of-two window buckets (``lax.switch``) exist for XLA's
    static shapes and are kept only as that rule.
  * The smaller child's histogram is one K = 1 launch of
    ``ops/hist_segments.py`` (the window and leaf read from device memory,
    the grid sized by the padded row count); ``gpu_use_dp`` keeps a plain
    float64 histogram of the child's rows, as the JAX package keeps dp off
    its Pallas kernel.
  * On a CUDA card with the default kernels and float32 histograms the
    step is captured once per learner as a CUDA graph (the forced steps
    one graph each) over state allocated once per learner, and replayed
    from the second tree on (``graph_launches``; the wave learner's
    ``_queue`` and ``_capture``, which live here).  ``train_async`` returns
    the packed records unread (``learner.AsyncTree``), so the pipelined
    boosting loop admits this learner.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import native
from .config import Config
from .dataset import _ConstructedDataset, _round_up
from .learner import (CF_GAIN, CF_LCNT, CF_LOUT, CF_LSG, CF_LSH, CF_RCNT,
                      CF_ROUT, CF_RSG, CF_RSH, CI_FEAT, CI_FLAGS, LF_CNT,
                      LF_DEPTH, LF_MAX_C, LF_MIN_C, LF_OUT, LF_SUM_G,
                      LF_SUM_H, NUM_CF, NUM_CI, NUM_LF, NUM_REC_FIELDS,
                      AsyncTree, TreeLearner)
from .ops.hist_packed import (ROW_QUANTUM, build_histogram_packed,
                              build_histogram_packed_plain, pack_bin_words)
from .ops.hist_segments import (build_histogram_segments,
                                build_histogram_segments_plain)
from .ops.partition import (O_BAG, O_LBAG, O_LS, O_LW, O_RS, O_RW,
                            partition_window, partition_window_plain)


@dataclass(frozen=True)
class CompactKernels:
    """The kernel functions the compact learner's tree calls: the root
    histogram, the smaller child's (K = 1 segment) histogram and the
    windowed partition.  The defaults are the wrappers (kernel on a CUDA
    tensor, plain version on a CPU tensor); ``PLAIN_COMPACT`` grows the
    same tree through the plain versions on any device."""
    packed: Callable = build_histogram_packed
    segments: Callable = build_histogram_segments
    partition: Callable = partition_window


PLAIN_COMPACT = CompactKernels(build_histogram_packed_plain,
                               build_histogram_segments_plain,
                               partition_window_plain)


@dataclass
class CompactState:
    """The learner's device state, allocated once per learner and reset per
    tree (a CUDA graph replays on fixed addresses); updated in place."""
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
    num_leaves: torch.Tensor  # () int64 leaves so far
    aborted: torch.Tensor    # () bool an invalid forced split was met
    fmask: torch.Tensor      # (F,) bool this tree's feature mask
    scratch: tuple           # the windowed partition's scratch lanes
    cand_b: Optional[torch.Tensor] = None  # (L, W) int32 bitsets (cat data)


class CompactTreeLearner(TreeLearner):
    """Leaf-wise learner with leaf-contiguous row compaction (see the module
    docstring)."""

    #: the sharded learners keep every feature in its own column (no EFB)
    _supports_bundle = True

    def __init__(self, cfg: Config, data: _ConstructedDataset,
                 device: torch.device,
                 kernels: CompactKernels = CompactKernels()):
        super().__init__(cfg, data, device)
        #: the kernel functions (the wave learner sets its ``WaveKernels``,
        #: whose ``packed`` the root histogram takes as well)
        self.kernels = kernels
        #: rows of the whole dataset, and the rows this learner holds (a
        #: row shard's under ``parallel/``); the lanes have ``n_pad`` rows
        self.n_global = int(data.num_data_padded)
        self.n_pad = self._local_rows()
        self._bundle = data.bundle if self._supports_bundle else None
        f = self.num_features
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
            col = np.asarray(bu.f_gcol, np.int64)
            goff = np.asarray(bu.f_off, np.int64)
            bnd = np.asarray(bu.f_bundled, np.int64)
        else:
            f_pad = data.bins.shape[0]       # padded to a multiple of 8
            self._hist_cols = self.num_features
            self._hist_nbins = self.num_bins_padded
            col = np.arange(f, dtype=np.int64)
            goff = np.zeros(f, np.int64)
            bnd = np.zeros(f, np.int64)
        if self._hist_nbins > 256:
            raise ValueError(f"{self._hist_nbins}-bin data: bin codes past a "
                             f"byte do not pack; the masked learner takes it")
        self.fw = f_pad // 4
        #: the decode table of the windowed partition (``ops/partition.py``
        #: ``FT_*``): each feature's word row and byte shift, missing type,
        #: default bin, bin count, bundle offset and bundled flag
        #: columns of a histogram pool row (a sharded learner's slice)
        self._pool_cols = self._hist_cols
        self._ftab = torch.from_numpy(np.stack([
            col // 4, (col % 4) * 8, self.np_missing.astype(np.int64),
            self.np_default_bin.astype(np.int64),
            self.np_num_bin.astype(np.int64), goff, bnd], 1)).to(device)
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
        #: the largest window split in mask mode: a window of c rows is
        #: partitioned exactly when its bucket is above the cutoff
        self._mask_max = max([s for s in sizes if s <= self._sort_cutoff],
                             default=0)
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
        self.kernel_calls.update(hist_packed=0, hist_segments=0,
                                 partition_window=0)
        self._st: Optional[CompactState] = None
        # CUDA graphs of the split steps (the wave learner: of its passes)
        self.use_graphs = device.type == "cuda" and not self.hist_dp \
            and kernels == CompactKernels()
        self._graphs: Dict[tuple, tuple] = {}
        self._graph_pool = None
        self._live = False           # this tree replays captured graphs
        self._trees = 0
        self.graph_launches = 0
        self.graph_captures = 0
        self.passes = 0              # steps (passes) queued, over all trees
        self._tree_stats: List[Dict[str, int]] = []
        #: called before ``tree_stats`` is read: the pipelined boosting
        #: loop sets it to its flush, which decodes the queued trees
        self.on_stats_read: Optional[Callable[[], None]] = None

    @property
    def tree_stats(self) -> List[Dict[str, int]]:
        """Per tree: the learner's device counters (the compact learner's:
        the splits its records hold, as ``total_splits``, ``grow_splits``
        and ``pops``; the wave learner's ``DEVICE_STATS`` but the error
        flags) and the host's: blocking reads, steps or passes queued,
        graph launches and captures."""
        if self.on_stats_read is not None:
            self.on_stats_read()
        return self._tree_stats

    def _local_rows(self) -> int:
        """Rows of this learner's lanes."""
        return self.n_global

    def _dataset_rows(self) -> int:
        """Padded rows of the whole dataset (a sharded learner's lanes hold
        a block of them; gates and grids sized by the dataset read this)."""
        return self.n_pad

    def _hist_bins(self, bins: torch.Tensor) -> torch.Tensor:
        """The packed word rows a histogram reads (a feature-sharded
        learner's word slice)."""
        return bins

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

    # -- histograms ----------------------------------------------------------

    def _root_hist(self, st) -> torch.Tensor:
        """Histogram of every row (the root's; the wave learner's too)."""
        bins = self._hist_bins(st.bins_p)
        if self.hist_dp:
            h = build_histogram_packed_plain(bins, st.w_p,
                                             num_bins=self._hist_nbins,
                                             dp=True)
            return self._reduce_hist(h[:self._hist_cols])
        h = self.kernels.packed(bins, st.w_p, num_bins=self._hist_nbins,
                                quant=self._quant)
        return self._reduce_hist(self._quant_count(h[:self._hist_cols]))

    def _child_hist(self, st: CompactState, start: torch.Tensor,
                    cnt: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
        """Histogram of the rows of ``leaf`` in ``[start, start + cnt)``,
        all (1,) device tensors: one K = 1 segment launch, or in dp a plain
        float64 pass over every row with the others' weights masked off (no
        window read to the host)."""
        bins = self._hist_bins(st.bins_p)
        if self.hist_dp:
            pos = torch.arange(self.n_pad, device=self.device)
            m = (pos >= start) & (pos < start + cnt) & (st.lid_p == leaf)
            h = build_histogram_packed_plain(bins, st.w_p * m,
                                             num_bins=self._hist_nbins,
                                             dp=True)
            return self._reduce_hist(h[:self._hist_cols])
        self.kernel_calls["hist_segments"] += 1
        h = self.kernels.segments(bins, st.w_p, st.lid_p, start, cnt,
                                  leaf, num_bins=self._hist_nbins,
                                  rows_bound=self.n_pad)
        return self._reduce_hist(h[0, :self._hist_cols])

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

    def _alloc_state(self) -> CompactState:
        n, L, acc, dev = self.n_pad, self.num_leaves, self._acc, self.device
        bins = self.bins_packed()
        i64 = dict(dtype=torch.int64, device=dev)
        return CompactState(
            bins_p=torch.empty_like(bins),
            w_p=torch.empty((3, n), dtype=torch.float32, device=dev),
            rid_p=torch.empty(n, **i64),
            lid_p=torch.empty(n, dtype=torch.int32, device=dev),
            leaf_i=torch.zeros((L, 2), **i64),
            leaf_f=torch.zeros((L, NUM_LF), dtype=acc, device=dev),
            hist_pool=torch.zeros((L, self._pool_cols, self._hist_nbins, 3),
                                  dtype=acc, device=dev),
            cand_f=torch.zeros((L, NUM_CF), dtype=acc, device=dev),
            cand_i=torch.zeros((L, NUM_CI), **i64),
            rec_f=torch.zeros((L - 1, NUM_REC_FIELDS), dtype=torch.float32,
                              device=dev),
            rec_i=torch.zeros((L - 1, self.rec_i_cols), **i64),
            num_leaves=torch.zeros((), **i64),
            aborted=torch.zeros((), dtype=torch.bool, device=dev),
            fmask=torch.zeros(self.num_features, dtype=torch.bool,
                              device=dev),
            scratch=(torch.empty_like(bins),
                     torch.empty((3, n), dtype=torch.float32, device=dev),
                     torch.empty(n, **i64),
                     torch.empty(n, dtype=torch.int32, device=dev)),
            cand_b=torch.zeros((L, self.cat_W), dtype=torch.int32,
                               device=dev) if self.has_categorical else None)

    def _init_root(self, grad, hess, bag, feature_mask) -> CompactState:
        """Reset the learner's state for a new tree (allocated on the first)
        and fill in the root: its rows, histogram and best split."""
        n, acc = self.n_pad, self._acc
        if self._st is None:
            self._st = self._alloc_state()
        st = self._st
        st.bins_p.copy_(self.bins_packed())
        st.w_p.copy_(torch.stack([grad * bag, hess * bag, bag]))
        torch.arange(n, out=st.rid_p)
        st.fmask.copy_(feature_mask)
        for t in (st.lid_p, st.leaf_i, st.leaf_f, st.hist_pool, st.cand_f,
                  st.cand_i, st.rec_f, st.rec_i, st.aborted):
            t.zero_()
        st.num_leaves.fill_(1)
        self._coll_ctx = ("root", "tree")
        self.kernel_calls["hist_packed"] += int(not self.hist_dp)
        root_hist = self._root_hist(st)
        sum_g = self._global_scalar((grad * bag).to(acc).sum())
        sum_h = self._global_scalar((hess * bag).to(acc).sum())
        cnt = self._global_scalar(bag.to(acc).sum())
        md = int(self.cfg.max_depth)
        depth_ok = True if md <= 0 else md > 0
        cf, ci, cb = self._cand_rows(root_hist[None], sum_g[None],
                                     sum_h[None], cnt[None], st.fmask,
                                     depth_ok)
        if cb is not None:
            st.cand_b.zero_()
            st.cand_b[0] = cb[0]
        # (fill_ on views: a Python scalar stored into a CUDA tensor by
        # indexing goes through a blocking copy)
        st.leaf_i[:1, 1].fill_(n)
        st.leaf_f[:, LF_MIN_C].fill_(float("-inf"))
        st.leaf_f[:, LF_MAX_C].fill_(float("inf"))
        st.leaf_f[0, :LF_OUT] = torch.stack([sum_g, sum_h, cnt])
        st.hist_pool[0] = root_hist
        st.cand_f[:, CF_GAIN].fill_(float("-inf"))
        st.cand_f[0] = cf[0]
        st.cand_i[0] = ci[0]
        return st

    # -- one split -----------------------------------------------------------

    def _split_step(self, st: CompactState, forced=None) -> None:
        """One no-op-able split (JAX ``_split_step_compact``): the best leaf
        splits when its gain is positive and a leaf is to spare (``do``),
        or, with ``forced=(i, cf, ci, cb, do)``, the leaf of forced split
        ``i`` at ``_forced_rows``' candidate where ``do``.  Every write is
        gated by ``do``; the record goes to the cursor ``num_leaves - 1``.
        No value is read to the host: rows are picked with
        ``index_select`` on device indices."""
        L, dev = self.num_leaves, self.device
        self._coll_ctx = ("split_step", "split")
        if forced is None:
            best = torch.argmax(st.cand_f[:, CF_GAIN]).view(1)
            cf = st.cand_f.index_select(0, best)[0]
            ci = st.cand_i.index_select(0, best)[0]
            cb = None if st.cand_b is None \
                else st.cand_b.index_select(0, best)[0]
            do = (cf[CF_GAIN] > 0.0) & (st.num_leaves < L)
        else:
            i, cf, ci, cb, do = forced
            best = torch.full((1,), self._forced[i].leaf, dtype=torch.int64,
                              device=dev)
        lrow = st.leaf_f.index_select(0, best)[0]
        # a full tree's no-op steps stay inside the tables
        new = torch.clamp(st.num_leaves, max=L - 1).view(1)
        pair = torch.cat([best, new])

        # ---- partition the parent's window (DataPartition::Split), the
        # window and the split read from device memory
        split = torch.cat([best, new, ci, do.view(1).to(torch.int64),
                           st.leaf_i.index_select(0, best)[0]])
        self.kernel_calls["partition_window"] += 1
        win = self.kernels.partition(
            st.bins_p, st.w_p, st.rid_p, st.lid_p, split, self._ftab, cb,
            mask_max=self._mask_max, scratch=st.scratch)
        lc_bag, c_bag = self._sync_counts(win[O_LBAG], win[O_BAG])

        # ---- smaller-child histogram + sibling subtraction; the smaller
        # child is chosen by BAGGED counts like the reference
        left_smaller = lc_bag <= (c_bag - lc_bag)
        small = torch.where(left_smaller, best, new)
        start = torch.where(left_smaller, win[O_LS:O_LS + 1],
                            win[O_RS:O_RS + 1])
        cnt = torch.where(left_smaller, win[O_LW:O_LW + 1],
                          win[O_RW:O_RW + 1])
        hist_small = self._child_hist(st, start, cnt, small)
        hist_large = st.hist_pool.index_select(0, best)[0] - hist_small
        hist_left = torch.where(left_smaller, hist_small, hist_large)
        hist_right = torch.where(left_smaller, hist_large, hist_small)
        hists = torch.stack([hist_left, hist_right])
        st.hist_pool.index_copy_(0, pair, torch.where(
            do, hists, st.hist_pool.index_select(0, pair)))

        # ---- children bookkeeping.  A forced split mirrors the reference:
        # the children's sums from GatherInfoForThreshold, their counts from
        # the partition (`leaf_splits.hpp:40-52`)
        if forced is not None:
            cf = torch.cat([cf[:CF_LCNT], lc_bag.to(cf.dtype).view(1),
                            cf[CF_RSG:CF_RCNT],
                            (c_bag - lc_bag).to(cf.dtype).view(1),
                            cf[CF_LOUT:]])
        child_depth = lrow[LF_DEPTH:LF_DEPTH + 1] + 1.0
        pmin, pmax = lrow[LF_MIN_C:LF_MIN_C + 1], lrow[LF_MAX_C:]
        lmin = rmin = pmin
        lmax = rmax = pmax
        mins = maxs = None
        if self.has_monotone:
            lmin, lmax, rmin, rmax = self._child_constraints(
                ci[CI_FEAT:CI_FEAT + 1], ci[CI_FLAGS:],
                cf[CF_LOUT:CF_LOUT + 1], cf[CF_ROUT:CF_ROUT + 1], pmin, pmax)
            mins, maxs = torch.cat([lmin, rmin]), torch.cat([lmax, rmax])
        rows = torch.stack([
            torch.cat([cf[CF_LSG:CF_LCNT + 1], cf[CF_LOUT:CF_LOUT + 1],
                       child_depth, lmin, lmax]),
            torch.cat([cf[CF_RSG:CF_RCNT + 1], cf[CF_ROUT:CF_ROUT + 1],
                       child_depth, rmin, rmax])])
        st.leaf_f.index_copy_(0, pair, torch.where(
            do, rows, st.leaf_f.index_select(0, pair)))
        st.leaf_i.index_copy_(0, pair, torch.where(
            do, win[O_LS:O_RW + 1].view(2, 2),
            st.leaf_i.index_select(0, pair)))

        # ---- children's best splits, both in one batched scan
        md = int(self.cfg.max_depth)
        depth_ok = True if md <= 0 else child_depth[0] < md
        cf2, ci2, cb2 = self._cand_rows(
            hists, torch.stack([cf[CF_LSG], cf[CF_RSG]]),
            torch.stack([cf[CF_LSH], cf[CF_RSH]]),
            torch.stack([cf[CF_LCNT], cf[CF_RCNT]]), st.fmask, depth_ok,
            mins, maxs)
        st.cand_f.index_copy_(0, pair, torch.where(
            do, cf2, st.cand_f.index_select(0, pair)))
        st.cand_i.index_copy_(0, pair, torch.where(
            do, ci2, st.cand_i.index_select(0, pair)))

        # ---- record for host tree assembly (JAX `:482-500`) at the
        # cursor; the bitset words widened to int64 with the counts
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
        cur = torch.clamp(st.num_leaves - 1, max=L - 2).view(1)
        st.rec_f.index_copy_(0, cur, torch.where(
            do, rec, st.rec_f.index_select(0, cur)[0])[None])
        st.rec_i.index_copy_(0, cur, torch.where(
            do, counts, st.rec_i.index_select(0, cur)[0])[None])
        st.num_leaves += do.to(torch.int64)

    def _forced_step(self, st: CompactState, i: int) -> None:
        """Forced split ``i`` (JAX `:672-690`) as a ``do``-gated step: done
        where it is valid and no earlier one aborted; an invalid one sets
        ``st.aborted`` (`serial_tree_learner.cpp:612-616`)."""
        leaf = self._forced[i].leaf
        lrow = st.leaf_f[leaf]
        hist = st.hist_pool[leaf][None]
        if self._bundle is not None:
            hist = self._unbundle_hist(hist, lrow[LF_SUM_G][None],
                                       lrow[LF_SUM_H][None],
                                       lrow[LF_CNT][None])
        cf, ci, cb, valid = self._forced_rows(i, hist[0], lrow)
        self._split_step(st, forced=(i, cf, ci, cb, valid & ~st.aborted))
        st.aborted |= ~valid

    # -- queueing the steps (the wave learner's passes too) ------------------

    def _queue(self, key: tuple, fn: Callable[[], None]) -> None:
        """Queue one step (pass): run ``fn`` eagerly, or replay its CUDA
        graph (captured on its first use in a tree that replays graphs)."""
        self.passes += 1
        if not self._live:
            fn()
            return
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(fn)
        graph, calls, launches = entry
        graph.replay()
        self.graph_launches += 1
        for name, d in calls.items():
            self.kernel_calls[name] += d
        native.credit(launches)

    def _capture(self, fn: Callable[[], None]) -> tuple:
        """Capture ``fn`` as a CUDA graph in the learner's memory pool (the
        capture runs nothing); returns it with the kernel calls and wrapper
        launches one replay makes.  A pass that cannot be captured raises."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        calls0 = dict(self.kernel_calls)
        graph = torch.cuda.CUDAGraph()
        try:
            # relaxed: a library call that queries the device while the
            # pass is recorded (torch.histc sizes its kernel from the free
            # memory) is allowed; a read of the capturing stream still fails
            _, launches = native.capture(graph, fn, self._graph_pool,
                                         "relaxed", self.device)
        finally:
            calls = {k: self.kernel_calls[k] - v for k, v in calls0.items()}
            self.kernel_calls.update(calls0)
        self.graph_captures += 1
        return graph, calls, launches

    # -- whole tree ----------------------------------------------------------

    def train_async(self, grad: torch.Tensor, hess: torch.Tensor,
                    bag: torch.Tensor,
                    feature_mask: Optional[torch.Tensor] = None
                    ) -> AsyncTree:
        """Grow one tree in the forced phase plus exactly ``num_leaves - 1``
        steps with no host read: the records and their exact integer columns
        packed as (L-1) rows of ``NUM_REC_FIELDS + rec_i_cols`` float64, the
        leaf id per original row (N,) int64 and the leaf outputs (L,) acc,
        all on the device."""
        if feature_mask is None:
            feature_mask = self._all_features
        before = (self.passes, self.graph_launches, self.graph_captures)
        self._live = self.use_graphs and self._trees > 0
        st = self._init_root(grad, hess, bag, feature_mask)
        for i in range(len(self._forced or ())):
            self._queue(("forced", i), lambda i=i: self._forced_step(st, i))
        for _ in range(self.num_leaves - 1):
            self._queue(("step",), lambda: self._split_step(st))
        leaf_id = torch.empty_like(st.rid_p).index_copy_(
            0, st.rid_p, st.lid_p.to(torch.int64))
        packed = torch.cat([st.rec_f.to(torch.float64),
                            st.rec_i.to(torch.float64)], dim=1).reshape(-1)
        self._trees += 1
        after = (self.passes, self.graph_launches, self.graph_captures)
        host = dict(zip(("steps", "graph_launches", "graph_captures"),
                        (a - b for a, b in zip(after, before))))
        return AsyncTree(packed, leaf_id, st.leaf_f[:, LF_OUT].clone(), host)

    def host_records(self, flat: np.ndarray, host_stats: Dict[str, int]):
        """(records (L-1, 17) float32, exact integer columns (L-1,
        rec_i_cols) int64: the bagged counts, then any bitset words) from a
        tree's packed records read to the host; the tree's counters go to
        ``tree_stats``."""
        out = flat.reshape(self.num_leaves - 1,
                           NUM_REC_FIELDS + self.rec_i_cols)
        rec_f = out[:, :NUM_REC_FIELDS].astype(np.float32)
        # every split it takes is grown and kept
        n = int((rec_f[:, 0] > 0.5).sum())
        self._tree_stats.append(dict(host_stats, total_splits=n,
                                     grow_splits=n, pops=n))
        return rec_f, out[:, NUM_REC_FIELDS:].astype(np.int64)

    def grow(self, grad: torch.Tensor, hess: torch.Tensor, bag: torch.Tensor,
             feature_mask: Optional[torch.Tensor] = None):
        """Grow one tree; returns (records (L-1, 17) f32 numpy, exact
        integer columns (L-1, rec_i_cols) int64 numpy: the bagged counts and
        any bitset words, leaf id per original row (N,) int64 tensor, leaf
        outputs (L,) acc tensor).  The records are the one host read of the
        tree."""
        tree = self.train_async(grad, hess, bag, feature_mask)
        flat = tree.records.cpu().numpy()
        self.host_syncs += 1
        rec_f, rec_i = self.host_records(flat, dict(tree.host_stats,
                                                    host_syncs=1))
        return rec_f, rec_i, tree.leaf_id, tree.leaf_out

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
    learner.  A parallel ``tree_learner`` gets its serial learner here (the
    wave learner is serial-only, as in the JAX package), which the GBDT
    swaps for the sharded one over a process group (``parallel/``)."""
    import warnings

    from .learner import MaskedTreeLearner
    from .learner_wave import WaveTreeLearner, wave_ineligible_reason

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
