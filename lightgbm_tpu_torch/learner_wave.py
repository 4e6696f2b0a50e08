"""Frontier-wave tree learner: batched speculative leaf-wise growth.

Port of ``lightgbm_tpu/learner_wave.py:WaveTPUTreeLearner``.  The sequential
compact learner splits one leaf per step and reads one small tensor to the
host per split; this learner grows a 255-leaf tree in about a dozen waves
while keeping exact best-first (leaf-wise) semantics:

  1. **Grow.**  Each wave splits the top-W positive-gain frontier leaves at
     once: one decide pass over the rows, one stable partition of every
     sortable window (``ops/partition.py``), the smaller children's
     histograms of all members in one segment-kernel launch
     (``ops/hist_segments.py``) with the siblings by subtraction, and all 2W
     children's best splits in one batched scan (``ops/scan.py``).
  2. **Trim.**  A greedy replay over the grown forest re-derives the
     reference's pop order (``serial_tree_learner.cpp:185-218``): split the
     available leaf with the largest gain, lowest leaf index on ties; the
     left child keeps the parent's index, the right child gets
     ``num_leaves``; stop after ``num_leaves - 1`` pops or when no gain is
     positive.
  3. **Correct.**  When the replay reaches a leaf the growth never split, the
     leaf (and up to ``tpu_wave_stall_batch - 1`` more of the likeliest next
     stalls) is split on the spot, and the replay resumes.  Slot and pool
     sizes make overflow impossible, so the tree is exactly the best-first
     tree: the records equal the compact learner's and the JAX package's.

What changes in eager torch (the function is ported, not the TPU mechanism):

  * The growth loop is a Python loop that reads ONE small tensor per wave:
    the number of positive-gain members (the loop condition) and the members'
    window widths, which size the launches.  Everything else stays on the
    device; ``host_syncs`` counts every blocking read.
  * The decide pass gathers per-row split parameters from a node-slot ->
    member table indexed by the row's leaf id (the JAX package routes them
    through an MXU mask-matmul because gathers are slow on a TPU), and takes
    exact counts with one small ``histc`` of (member, bagged, left) codes.
  * Members are chosen by a stable sort on (gain desc, slot asc), the order
    of ``lax.top_k``; each wave is sized by its valid member count, which
    selects the members the JAX package's adaptive width selects.
  * The replay runs on the host in plain Python over the node table, read
    once per replay pass; a stall correction runs on the device between
    passes.  The JAX package's batched device simulation is TPU latency
    work with the same pop order.
  * Partition mode only.  The JAX package on its TPU runs the partition
    kernel, which turns sort deferral off, so every sortable window is
    partitioned in the wave that splits it.  ``tpu_wave_pallas_partition``,
    ``tpu_wave_pallas_scan`` and ``tpu_wave_defer_sorts`` are accepted and
    change nothing the port computes (the trees are the same either way,
    ``tests/test_partition.py``).  Batched stall corrections rewrite leaf ids
    only (mask mode); the ``tpu_wave_stall_batch=1`` correction partitions a
    window above ``_stall_cutoff`` and freezes one below it.
  * ``gpu_use_dp`` keeps the plain float64 histograms and scan, as the JAX
    package keeps its kernels off in dp; the partition kernel still runs (a
    permutation does not care about precision).
  * The level-wise opening (``tpu_wave_open_levels``): the first levels
    split with no row moving (level d at width min(2**d, W)); each level's
    smaller-child histograms come from one multislot pass over every row
    (``ops/hist_multislot.py``), a slot per row from the leaf id.  One
    materialization then moves every row to its leaf's window through the
    partition kernel, in the order of the JAX package's stable sort on
    window starts, and the growth waves carry on in partition mode.
  * Quantized gradients (``tpu_quantized_grad=on``, ``ops/quant.py``): per
    tree the bagged gradients are rounded stochastically onto integer grids
    with power-of-two scales; the histograms sum the dequantized lanes with
    the count channel carried by the hessian lane, rescaled to effective
    rows; growth waves fold subtraction, pool writes, FixHistogram and both
    children's scans into one fused kernel (``ops/fused_scan.py``; not with
    EFB bundles, and not in stall corrections, as in the JAX package); leaf
    outputs are renewed from the retained float32 gradients.  ``on`` with
    ``gpu_use_dp`` or too many rows trains unquantized and keeps the reason
    in ``_quant_reason``, as the JAX package does.

Telemetry counters and constrained or categorical splits, which no learner
of the port carries yet, raise at the entry point
(``config.check_supported``).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .binning import MISSING_NAN, MISSING_ZERO
from .config import Config
from .dataset import _ConstructedDataset, _round_up, upload
from .learner import (CF_GAIN, CF_LCNT, CF_LOUT, CF_LSG, CF_LSH, CF_RCNT,
                      CF_ROUT, CF_RSG, CF_RSH, CI_FEAT, CI_FLAGS, CI_THR,
                      LF_CNT, LF_DEPTH, LF_MAX_C, LF_MIN_C, LF_OUT, NUM_CF,
                      NUM_CI, NUM_LF, NUM_REC_FIELDS, REC_LEFT_OUT,
                      REC_RIGHT_OUT, _FeatCand)
from .learner_compact import CompactTreeLearner
from .ops.fused_scan import fused_child_scans, fused_child_scans_plain
from .ops.hist_multislot import (build_histogram_multislot,
                                 build_histogram_multislot_plain)
from .ops.hist_packed import (build_histogram_packed,
                              build_histogram_packed_plain)
from .ops.hist_segments import (build_histogram_segments,
                                build_histogram_segments_plain)
from .ops.partition import (apply_partition, apply_partition_plain,
                            exclusive_cumsum)
from .ops.quant import quant_ineligible_reason, quantize_gradients
from .ops.scan import find_best_splits_batched
from .ops.split import calculate_leaf_output, find_best_splits


@dataclass(frozen=True)
class WaveKernels:
    """The six kernel functions the wave learner calls.  The defaults are
    the wrappers (kernel on a CUDA tensor, plain version on a CPU tensor);
    ``PLAIN_KERNELS`` grows the same tree through the plain versions on any
    device."""
    packed: Callable = build_histogram_packed
    segments: Callable = build_histogram_segments
    partition: Callable = apply_partition
    scan: Callable = find_best_splits_batched
    multislot: Callable = build_histogram_multislot
    fused: Callable = fused_child_scans


PLAIN_KERNELS = WaveKernels(build_histogram_packed_plain,
                            build_histogram_segments_plain,
                            apply_partition_plain,
                            find_best_splits,
                            build_histogram_multislot_plain,
                            fused_child_scans_plain)

# rows of the per-member parameter table the decide pass gathers from
(P_WIDX, P_SHIFT, P_MT, P_DB, P_NB, P_BOFF, P_BND, P_THR, P_DLEFT, P_LSLOT,
 P_RSLOT, P_SORT) = range(12)
NUM_P = 12


def _stall_extras_cap(budget: int) -> int:
    """Cap on speculative batch EXTRAS (members beyond the replay's stalled
    top) across the whole replay; it keeps the slot/pool reserve tight."""
    return min(budget - 1, 64)


def _resolve_stall_batch(cfg: Config) -> int:
    """``tpu_wave_stall_batch`` with -1 = auto (4)."""
    k = int(getattr(cfg, "tpu_wave_stall_batch", -1))
    if k < 0:
        k = 4
    return max(1, min(k, 16))


def _correction_reserve(cfg: Config, budget: int) -> int:
    """Worst-case replay correction splits, for slot and pool sizing: every
    stalled top maps to a distinct pop (<= budget), batch extras are capped
    by ``_stall_extras_cap``."""
    k = _resolve_stall_batch(cfg)
    return budget if k == 1 else budget + _stall_extras_cap(budget)


def _resolve_overshoot(cfg: Config, local_rows: int) -> float:
    """``tpu_wave_overshoot`` with -1 = auto: 0.0 with batched stall
    corrections, else 0.7 up to 2M rows and 0.25 above."""
    ov = float(cfg.tpu_wave_overshoot)
    if ov < 0:
        if _resolve_stall_batch(cfg) > 1:
            ov = 0.0
        else:
            ov = 0.7 if local_rows <= 2_000_000 else 0.25
    return ov


@dataclass
class WaveState:
    """One tree's device state (updated in place) and its host counters."""
    bins_p: torch.Tensor     # (Fw, N) int32 packed bins, permuted by window
    w_p: torch.Tensor        # (3, N) f32 (g*bag, h*bag, bag), permuted
    rid_p: torch.Tensor      # (N,) int64 original row id at each position
    lid_p: torch.Tensor      # (N,) int32 node slot at each position
    spare: tuple             # second set of the four lanes (partition target)
    node_i: torch.Tensor     # (M, 2) int64 window [start, width]
    node_f: torch.Tensor     # (M, NUM_LF) acc sums/cnt/out/depth/bounds
    cand_f: torch.Tensor     # (M, NUM_CF) acc best-split floats
    cand_i: torch.Tensor     # (M, NUM_CI) int64 feature/threshold/flags
    parent: torch.Tensor     # (M,) int64
    child0: torch.Tensor     # (M,) int64 left child slot (right = +1)
    hslot: torch.Tensor      # (M,) int64 histogram pool slot
    split_m: torch.Tensor    # (M,) bool node has been split
    cnt_i: torch.Tensor      # (M, 2) int64 exact bagged child counts
    hist_pool: torch.Tensor  # (H, F, B, 3) acc
    num_nodes: int = 1
    num_splits: int = 0
    stats: Dict[str, int] = field(default_factory=dict)


class WaveTreeLearner(CompactTreeLearner):
    """Frontier-wave serial learner (see the module docstring)."""

    #: batch extras must fit this many rows (``tpu_wave_vec_cap`` overrides)
    _VEC_CAP = 1 << 17

    def __init__(self, cfg: Config, data: _ConstructedDataset,
                 device: torch.device,
                 kernels: WaveKernels = WaveKernels()):
        super().__init__(cfg, data, device, histogram=kernels.packed)
        self.kernels = kernels
        self._init_wave_dims(cfg)
        f = self.num_features
        if self._bundle is not None:
            col = np.asarray(self._bundle.f_gcol, np.int64)
            goff = np.asarray(self._bundle.f_off, np.int64)
            bnd = np.asarray(self._bundle.f_bundled, np.int64)
        else:
            col = np.arange(f, dtype=np.int64)
            goff = np.zeros(f, np.int64)
            bnd = np.zeros(f, np.int64)
        tab = np.stack([col // 4, (col % 4) * 8,
                        self.np_missing.astype(np.int64),
                        self.np_default_bin.astype(np.int64),
                        self.np_num_bin.astype(np.int64), goff, bnd], 1)
        # per-feature decode columns P_WIDX..P_BND of the member table
        self._feat_tab = torch.from_numpy(tab).to(device)
        self._pos = torch.arange(self.n_pad, dtype=torch.int32, device=device)
        #: calls this learner made to each kernel function, over all trees;
        #: the ``_quant`` entries count the quant-mode calls a second time
        self.kernel_calls = {"hist_packed": 0, "hist_segments": 0,
                             "partition": 0, "split_scan": 0,
                             "hist_multislot": 0, "fused_scan": 0,
                             "hist_packed_quant": 0,
                             "hist_segments_quant": 0,
                             "hist_multislot_quant": 0}
        #: growth waves run the fused child-scan kernel
        #: (``ops/fused_scan.py``): quantized gradients without EFB bundles,
        #: as ``learner_wave.py:_fused_ok``.  The JAX package's 4 MB VMEM
        #: gate has no counterpart: the kernel holds one (feature, 256-bin)
        #: row per block, and every histogram here has at most 256 bins
        self._use_fused = self._quant and self._bundle is None
        #: per tree: waves, stall events, stall splits, replay passes, syncs
        self.tree_stats: List[Dict[str, int]] = []

    def _init_wave_dims(self, cfg: Config) -> None:
        """Slot and pool sizing, as ``learner_wave.py:_init_wave_dims``:
        growth performs at most ``grow_budget`` splits and the replay
        correction at most ``_correction_reserve`` more, so M node slots and
        H pool slots can never overflow."""
        self.budget = self.num_leaves - 1
        self.W = max(1, min(int(cfg.tpu_wave_width), self.budget))
        ov = _resolve_overshoot(cfg, self.n_pad)
        self.grow_budget = min(self.budget + int(np.ceil(self.budget * ov)),
                               2 * self.budget)
        self._stall_batch = _resolve_stall_batch(cfg)
        self._extras_cap = _stall_extras_cap(self.budget)
        vc = int(getattr(cfg, "tpu_wave_vec_cap", -1))
        self._vec_cap = self._VEC_CAP if vc <= 0 else vc
        # level-wise opening depth: the first open_levels levels split
        # without moving rows (-1 = auto = 0, as in the JAX package)
        ol = int(getattr(cfg, "tpu_wave_open_levels", -1))
        self.open_levels = max(0, min(ol, (self.budget + 1).bit_length() - 1))
        # quantized gradients (ops/quant.py): "on" quantizes where the
        # config is eligible and otherwise trains unquantized, keeping the
        # reason; "auto" stays off (the JAX package's gate)
        qg = str(getattr(cfg, "tpu_quantized_grad", "auto"))
        reason = quant_ineligible_reason(self.n_pad, self.hist_dp)
        self._quant = qg == "on" and reason is None
        if qg != "on" and reason is None:
            reason = f"tpu_quantized_grad={qg} (quantization is opt-in)"
        self._quant_reason = None if self._quant else reason
        self._q_scales = None      # (sg, sh) of the current tree
        self._q_raw = None         # (gb, hb) float32, kept for the renewal
        corr = _correction_reserve(cfg, self.budget)
        self.M = 1 + 2 * (self.grow_budget + corr)
        self.H = self.grow_budget + corr + 2
        # windows at or below the wave cutoff split in place (children share
        # the parent's span); a K=1 stall may only partition above the larger
        # of both cutoffs, so it never reorders a shared span
        self._wave_cutoff = int(cfg.tpu_wave_sort_cutoff)
        self._stall_cutoff = max(self._sort_cutoff, self._wave_cutoff)

    # -- split candidates ----------------------------------------------------

    def _feature_cands(self, hist, sum_g, sum_h, cnt, feature_mask):
        """Per-feature candidates of a batch of leaves through the batched
        scan (plain float64 ``find_best_splits`` in dp)."""
        if self.hist_dp:
            return super()._feature_cands(hist, sum_g, sum_h, cnt,
                                          feature_mask)
        hist = self._fix_histogram(hist, sum_g, sum_h, cnt)
        kw = {k: v for k, v in self._split_kwargs.items()
              if k != "skip_missing_scan"}
        self.kernel_calls["split_scan"] += 1
        return _FeatCand(*self.kernels.scan(
            hist, sum_g, sum_h, cnt, self.f_num_bin, self.f_missing,
            self.f_default_bin, feature_mask, **kw))

    # -- root ----------------------------------------------------------------

    def _init_root_wave(self, grad, hess, bag, feature_mask) -> WaveState:
        n, M, H, acc, dev = self.n_pad, self.M, self.H, self._acc, self.device
        if self._quant:
            # per-tree quantization (``learner_wave.py:429-463``): the lanes
            # carry the dequantized gq*sg, hq*sh; the count channel carries
            # the hessian mass over the mean mass per bagged row, m
            gb = (grad * bag).to(torch.float32)
            hb = (hess * bag).to(torch.float32)
            gd, hd, sg, sh = quantize_gradients(gb, hb, bag, 0,
                                                gb.abs().max(), hb.max())
            self._q_scales = (sg, sh)
            self._q_raw = (gb, hb)
            w = torch.stack([gd, hd, bag.to(torch.float32)])
            q_tot = torch.stack([gd.to(acc).sum(), hd.to(acc).sum(),
                                 bag.to(acc).sum()])
            inv_sh = 1.0 / sh
            mbar = torch.clamp(q_tot[1] * inv_sh, min=1.0) \
                / torch.clamp(q_tot[2], min=1.0)
            q_cnt = inv_sh / mbar
            self._q_rescale = torch.stack([torch.ones_like(q_cnt),
                                           torch.ones_like(q_cnt), q_cnt])
        else:
            w = torch.stack([grad * bag, hess * bag, bag]).to(torch.float32)
        bins = self.bins_packed().clone()
        rid = torch.arange(n, device=dev)
        lid = torch.zeros(n, dtype=torch.int32, device=dev)
        i64 = dict(dtype=torch.int64, device=dev)
        st = WaveState(
            bins_p=bins, w_p=w, rid_p=rid, lid_p=lid,
            spare=tuple(torch.empty_like(t) for t in (bins, w, rid, lid)),
            node_i=torch.zeros((M, 2), **i64),
            node_f=torch.zeros((M, NUM_LF), dtype=acc, device=dev),
            cand_f=torch.zeros((M, NUM_CF), dtype=acc, device=dev),
            cand_i=torch.zeros((M, NUM_CI), **i64),
            parent=torch.zeros(M, **i64), child0=torch.zeros(M, **i64),
            hslot=torch.zeros(M, **i64),
            split_m=torch.zeros(M, dtype=torch.bool, device=dev),
            cnt_i=torch.zeros((M, 2), **i64),
            hist_pool=torch.zeros((H, self._hist_cols, self._hist_nbins, 3),
                                  dtype=acc, device=dev),
            stats={"waves": 0, "open_levels": 0, "stall_events": 0,
                   "stall_splits": 0, "replay_passes": 0})
        if not self.hist_dp:
            self.kernel_calls["hist_packed"] += 1
            self.kernel_calls["hist_packed_quant"] += int(self._quant)
        root_hist = self._window_hist(st, 0, n, None)
        if self._quant:
            # root totals from the dequantized lanes, the count on the
            # count channel's scale
            sum_g, sum_h = q_tot[0], q_tot[1]
            cnt = (sum_h * q_cnt).to(acc)
        else:
            sum_g = (grad * bag).to(acc).sum()
            sum_h = (hess * bag).to(acc).sum()
            cnt = bag.to(acc).sum()
        cf, ci = self._cand_rows(root_hist[None], sum_g[None], sum_h[None],
                                 cnt[None], feature_mask, True)
        st.node_i[0, 1] = n
        st.node_f[:, LF_MIN_C] = float("-inf")
        st.node_f[:, LF_MAX_C] = float("inf")
        st.node_f[0, :LF_OUT] = torch.stack([sum_g, sum_h, cnt])
        st.cand_f[:, CF_GAIN] = float("-inf")
        st.cand_f[0] = cf[0]
        st.cand_i[0] = ci[0]
        st.hist_pool[0] = root_hist
        return st

    # -- splitting a set of frontier leaves ----------------------------------

    def _decide(self, st: WaveState, wi: torch.Tensor, params: torch.Tensor):
        """Per-row split decision for the rows of the K members ``wi``
        (``NumericalDecisionInner``, `tree.h:233-249`, with the EFB decode).
        ``params`` is the (NUM_P, K+1) member table; column K serves every
        row outside the members.  Returns (member index per row, K for
        outsiders; go_left; the table's columns gathered per row)."""
        k = wi.shape[0]
        n = self.n_pad
        member_of = torch.full((self.M,), k, dtype=torch.int32,
                               device=self.device)
        member_of[wi] = torch.arange(k, dtype=torch.int32, device=self.device)
        mi = member_of.index_select(0, st.lid_p)
        row = params.index_select(1, mi)                       # (NUM_P, N)
        word = st.bins_p.gather(0, row[P_WIDX].to(torch.int64).view(1, n))[0]
        code = (word >> row[P_SHIFT]) & 0xFF
        if self._bundle is not None:
            r = code - row[P_BOFF]
            in_r = (r >= 0) & (r < row[P_NB] - 1)
            dec = r + (r >= row[P_DB]).to(r.dtype)
            frow = torch.where(row[P_BND] == 1,
                               torch.where(in_r, dec, row[P_DB]), code)
        else:
            frow = code
        is_missing = ((row[P_MT] == MISSING_ZERO) & (frow == row[P_DB])) \
            | ((row[P_MT] == MISSING_NAN) & (frow == row[P_NB] - 1))
        go_left = torch.where(is_missing, row[P_DLEFT] == 1,
                              frow <= row[P_THR]) & (mi < k)
        return mi, go_left, row

    def _member_hists(self, st: WaveState, start, cnt, leaf,
                      rows_bound: int):
        """Histograms of K members' rows in one call (plain float64 in dp;
        the count channel rescaled in quant mode).  ``rows_bound`` bounds
        ``sum(cnt)`` on the host; it sizes the kernel's grid."""
        if self.hist_dp:
            h = build_histogram_segments_plain(
                st.bins_p, st.w_p, st.lid_p, start, cnt, leaf,
                num_bins=self._hist_nbins, dp=True)
            return h[:, :self._hist_cols]
        self.kernel_calls["hist_segments"] += 1
        self.kernel_calls["hist_segments_quant"] += int(self._quant)
        h = self.kernels.segments(st.bins_p, st.w_p, st.lid_p, start, cnt,
                                  leaf, num_bins=self._hist_nbins,
                                  rows_bound=rows_bound, quant=self._quant)
        return self._quant_count(h[:, :self._hist_cols])

    def _opening_hists(self, st: WaveState, sm_slot, k: int):
        """Smaller-child histograms of one opening level
        (``learner_wave.py:_opening_hists``): no row has moved, so one
        multislot pass over all rows, the slot of a row the member whose
        smaller child holds it (K for every other row)."""
        slot_of = torch.full((self.M,), k, dtype=torch.int32,
                             device=self.device)
        slot_of[sm_slot] = torch.arange(k, dtype=torch.int32,
                                        device=self.device)
        slot = slot_of.index_select(0, st.lid_p)
        if self.hist_dp:
            h = build_histogram_multislot_plain(
                st.bins_p, st.w_p, slot, num_bins=self._hist_nbins,
                n_slots=k, dp=True)
            return h[:, :self._hist_cols]
        self.kernel_calls["hist_multislot"] += 1
        self.kernel_calls["hist_multislot_quant"] += int(self._quant)
        h = self.kernels.multislot(st.bins_p, st.w_p, slot,
                                   num_bins=self._hist_nbins, n_slots=k,
                                   quant=self._quant)
        return self._quant_count(h[:, :self._hist_cols])

    def _split_members(self, st: WaveState, wi: torch.Tensor,
                       widths: Sequence[int], sortable: Sequence[bool],
                       feature_mask, opening: bool = False,
                       fused: bool = False) -> None:
        """Split the K frontier leaves ``wi`` at their best candidates, as
        one growth wave (``learner_wave.py:_wave_body``), one opening level
        (``opening``) or one replay correction (``_stall_split`` /
        ``_stall_split_batch``): decide, partition the sortable windows (the
        others freeze: children share the parent's span), smaller-child
        histograms in one call, sibling subtraction, pool writes, and the 2K
        children's bookkeeping with one batched scan.  ``widths`` are the
        members' window widths as the host read them; ``sortable`` is
        decided on the host.

        An opening level moves no row: every member's children get logical
        windows, the leaf ids are rewritten, and the smaller children's
        histograms come from one multislot pass over all rows.  ``fused``
        (a quantized growth wave) folds subtraction, pool writes,
        FixHistogram and both children's scans into one kernel."""
        dev, acc = self.device, self._acc
        k = wi.shape[0]
        nn, ns = st.num_nodes, st.num_splits
        if nn + 2 * k > self.M or 1 + ns + k > self.H:
            raise RuntimeError("wave learner slot reserve exhausted")
        ar = torch.arange(k, device=dev)
        lslot = nn + 2 * ar
        rslot = lslot + 1
        ci = st.cand_i.index_select(0, wi)
        win = st.node_i.index_select(0, wi)
        ps, cw = win[:, 0], win[:, 1]
        srt = upload(np.asarray(sortable, dtype=bool), dev)
        params = torch.cat([
            self._feat_tab.index_select(0, ci[:, CI_FEAT]),
            ci[:, CI_THR:CI_THR + 1], ci[:, CI_FLAGS:CI_FLAGS + 1] & 1,
            lslot[:, None], rslot[:, None], srt[:, None].to(torch.int64)], 1)
        params = torch.cat([params, params.new_zeros(1, NUM_P)]).t() \
            .to(torch.int32).contiguous()                      # (NUM_P, K+1)

        # ---- decide, exact counts, leaf-id rewrite
        mi, go_left, row = self._decide(st, wi, params)
        bag = st.w_p[2] > 0.5
        # exact counts per (member, bagged, left): one small histogram of
        # the codes 4*member + 2*bag + left (float64 counts are exact; the
        # bin centres keep the bin index exact on every device)
        code = (mi * 4 + bag * 2 + go_left).to(torch.float64) + 0.5
        cnt = torch.histc(code, bins=4 * (k + 1), min=0, max=4 * (k + 1)) \
            .to(torch.int64).view(k + 1, 2, 2)[:k]
        lc_bag = cnt[:, 1, 1]
        lc_w = cnt[:, 0, 1] + lc_bag
        c_bag = cnt[:, 1, 0] + lc_bag
        lid_new = torch.where(mi < k, torch.where(go_left, row[P_LSLOT],
                                                  row[P_RSLOT]), st.lid_p)

        # ---- stable partition of the sortable windows: dest = the child
        # window's start + the row's rank among its side's rows (an opening
        # level defers every move to _materialize)
        if any(sortable) and not opening:
            sort_r = row[P_SORT] == 1
            gl = sort_r & go_left
            gr = sort_r & ~go_left
            cl = exclusive_cumsum(gl)
            cr = exclusive_cumsum(gr)
            ps_s = torch.where(srt, ps, 0)
            base_l = ps - cl.index_select(0, ps_s)
            base_r = ps + lc_w - cr.index_select(0, ps_s)
            zero = base_l.new_zeros(1)
            bl = torch.cat([base_l, zero]).to(torch.int32)
            br = torch.cat([base_r, zero]).to(torch.int32)
            dest = torch.where(
                sort_r, torch.where(go_left, bl.index_select(0, mi) + cl,
                                    br.index_select(0, mi) + cr), self._pos)
            self.kernel_calls["partition"] += 1
            lanes = self.kernels.partition(st.bins_p, st.w_p, st.rid_p,
                                           lid_new, dest, out=st.spare)
            st.spare = (st.bins_p, st.w_p, st.rid_p, st.lid_p)
            st.bins_p, st.w_p, st.rid_p, st.lid_p = lanes
        else:
            st.lid_p = lid_new

        # ---- child windows: sortable members split [s, lc) / [s+lc, ..);
        # frozen members' children share the parent's span
        li = torch.stack([ps, torch.where(srt, lc_w, cw)], 1)
        ri = torch.stack([torch.where(srt, ps + lc_w, ps),
                          torch.where(srt, cw - lc_w, cw)], 1)

        # ---- smaller-child histograms (by bagged counts)
        left_small = lc_bag <= (c_bag - lc_bag)
        sm_slot = torch.where(left_small, lslot, rslot)
        if opening:
            h_small = self._opening_hists(st, sm_slot, k)
        else:
            sm_start = torch.where(srt & ~left_small, ps + lc_w, ps)
            sm_cnt = torch.where(srt, torch.where(left_small, lc_w,
                                                  cw - lc_w), cw)
            h_small = self._member_hists(st, sm_start, sm_cnt, sm_slot,
                                         sum(widths))
        ph = st.hslot.index_select(0, wi)
        rh = 1 + ns + ar

        # ---- children bookkeeping, their best splits in one batched scan
        def i2(a, b):                       # interleave K -> 2K
            return torch.stack([a, b], 1).reshape((2 * k,) + a.shape[1:])

        pcf = st.cand_f.index_select(0, wi)
        pnf = st.node_f.index_select(0, wi)
        cd = pnf[:, LF_DEPTH] + 1.0
        md = int(self.cfg.max_depth)
        depth_ok = True if md <= 0 else i2(cd < md, cd < md)
        sums2 = (i2(pcf[:, CF_LSG], pcf[:, CF_RSG]),
                 i2(pcf[:, CF_LSH], pcf[:, CF_RSH]),
                 i2(pcf[:, CF_LCNT], pcf[:, CF_RCNT]))
        if fused:
            kw = {k_: v for k_, v in self._split_kwargs.items()
                  if k_ != "skip_missing_scan"}
            self.kernel_calls["fused_scan"] += 1
            cands = self.kernels.fused(
                h_small, st.hist_pool, ph, rh, left_small, *sums2,
                self.f_num_bin, self.f_missing, self.f_default_bin,
                feature_mask, **kw)
            cf2, ci2 = self._pack_cands(cands, depth_ok)
        else:
            h_large = st.hist_pool.index_select(0, ph) - h_small
            lsm = left_small.view(k, 1, 1, 1)
            hl = torch.where(lsm, h_small, h_large)
            hr = torch.where(lsm, h_large, h_small)
            st.hist_pool.index_copy_(0, ph, hl)
            st.hist_pool[1 + ns:1 + ns + k] = hr
            cf2, ci2 = self._cand_rows(i2(hl, hr), *sums2, feature_mask,
                                       depth_ok)
        pmin, pmax = pnf[:, LF_MIN_C], pnf[:, LF_MAX_C]
        lf_l = torch.stack([pcf[:, CF_LSG], pcf[:, CF_LSH], pcf[:, CF_LCNT],
                            pcf[:, CF_LOUT], cd, pmin, pmax], 1)
        lf_r = torch.stack([pcf[:, CF_RSG], pcf[:, CF_RSH], pcf[:, CF_RCNT],
                            pcf[:, CF_ROUT], cd, pmin, pmax], 1)
        s2 = slice(nn, nn + 2 * k)
        st.node_i[s2] = i2(li, ri)
        st.node_f[s2] = i2(lf_l, lf_r).to(acc)
        st.cand_f[s2] = cf2
        st.cand_i[s2] = ci2
        st.parent[s2] = i2(wi, wi)
        st.hslot[s2] = i2(ph, rh)
        st.child0.index_copy_(0, wi, lslot)
        st.split_m[wi] = True
        st.cnt_i.index_copy_(0, wi, torch.stack([lc_bag, c_bag - lc_bag], 1))
        st.num_nodes += 2 * k
        st.num_splits += k

    # -- growth --------------------------------------------------------------

    def _select(self, st: WaveState, width: int):
        """The next wave's members: the top-``width`` frontier leaves by
        (gain desc, slot asc), read to the host with their window widths
        (one host read).  Returns (member count, the members' slots, their
        widths)."""
        nn = st.num_nodes
        g = torch.where(st.split_m[:nn], float("-inf"),
                        st.cand_f[:nn, CF_GAIN])
        gv, order = torch.sort(g, descending=True, stable=True)
        wi = order[:width]
        head = torch.cat([(gv[:width] > 0.0).sum().view(1),
                          st.node_i.index_select(0, wi)[:, 1]]).tolist()
        self.host_syncs += 1
        k = max(0, min(int(head[0]), self.grow_budget - st.num_splits))
        return k, wi[:k], head[1:1 + k]

    def _open(self, st: WaveState, feature_mask) -> None:
        """The level-wise opening (``learner_wave.py:1836-1844``): level d
        splits up to min(2**d, W) leaves without moving rows, then one
        materialization compacts every window.  A level with nothing to
        split ends the opening (every later level would be a no-op)."""
        opened = False
        for d in range(self.open_levels):
            k, wi, widths = self._select(st, min(1 << d, self.W))
            if k <= 0:
                break
            self._split_members(st, wi, widths, [True] * k, feature_mask,
                                opening=True)
            st.stats["waves"] += 1
            st.stats["open_levels"] += 1
            opened = True
        if opened:
            self._materialize(st)

    def _materialize(self, st: WaveState) -> None:
        """Move every row to its leaf's logical window
        (``learner_wave.py:_materialize_sort``): the stable order of the
        rows' window starts, the permutation the JAX package's stable sort
        on keys 2 * start produces, through the partition kernel."""
        start = st.node_i[:, 0].index_select(0, st.lid_p)
        perm = torch.sort(start, stable=True).indices
        dest = torch.empty_like(self._pos).index_copy_(0, perm, self._pos)
        self.kernel_calls["partition"] += 1
        lanes = self.kernels.partition(st.bins_p, st.w_p, st.rid_p,
                                       st.lid_p, dest, out=st.spare)
        st.spare = (st.bins_p, st.w_p, st.rid_p, st.lid_p)
        st.bins_p, st.w_p, st.rid_p, st.lid_p = lanes

    def _grow_waves(self, st: WaveState, feature_mask) -> None:
        """Growth waves until the budget is spent or no frontier gain is
        positive; one host read per wave."""
        while st.num_splits < self.grow_budget:
            k, wi, widths = self._select(st, self.W)
            if k <= 0:
                return
            self._split_members(st, wi, widths,
                                [c > self._wave_cutoff for c in widths],
                                feature_mask, fused=self._use_fused)
            st.stats["waves"] += 1

    # -- exact greedy replay -------------------------------------------------

    def _read_nodes(self, st: WaveState):
        """One blocking read of the node table the replay needs: gain,
        split flag, left child, window width and parent of every slot."""
        nn = st.num_nodes
        tab = torch.stack([st.cand_f[:nn, CF_GAIN].to(torch.float64),
                           st.split_m[:nn].to(torch.float64),
                           st.child0[:nn].to(torch.float64),
                           st.node_i[:nn, 1].to(torch.float64),
                           st.parent[:nn].to(torch.float64)]).cpu().numpy()
        self.host_syncs += 1
        st.stats["replay_passes"] += 1
        return (tab[0], tab[1] > 0.5, tab[2].astype(np.int64),
                tab[3].astype(np.int64), tab[4].astype(np.int64))

    def _replay(self, st: WaveState, feature_mask):
        """The reference's pop order over the grown forest
        (`serial_tree_learner.cpp:185-218`, `:505-520` for ties), splitting
        on demand when it reaches a leaf the growth never split.  Returns
        (final leaf slots, leaf index per slot, [(slot, leaf index)] in pop
        order, the parent table)."""
        budget, kb = self.budget, self._stall_batch
        refidx = np.full(self.M, -1, np.int64)
        refidx[0] = 0
        avail = {0}
        pops: List = []
        extras = 0
        while True:
            gains, split, child0, width, parent = self._read_nodes(st)
            heap = [(-gains[s], refidx[s], s) for s in avail]
            heapq.heapify(heap)
            top = -1
            while heap and len(pops) < budget:
                ng, ref, s = heap[0]
                if not -ng > 0.0:
                    break
                if not split[s]:
                    top = s
                    break
                heapq.heappop(heap)
                c0 = int(child0[s])
                right = len(pops) + 1
                pops.append((s, int(ref)))
                refidx[c0], refidx[c0 + 1] = ref, right
                avail.discard(s)
                avail.update((c0, c0 + 1))
                heapq.heappush(heap, (-gains[c0], ref, c0))
                heapq.heappush(heap, (-gains[c0 + 1], right, c0 + 1))
            if top < 0:
                return avail, refidx, pops, parent
            # ---- stall correction
            if kb == 1:
                members = [top]
                sortable = [self._bucket(int(width[top])) > self._stall_cutoff]
            else:
                # the top-kb replay-priority unsplit leaves; the first is the
                # stalled top, the extras are capped in count and span
                cands = sorted((s for s in avail
                                if not split[s] and gains[s] > 0.0),
                               key=lambda s: (-gains[s], refidx[s], s))[:kb]
                members = [cands[0]] + [
                    s for i, s in enumerate(cands[1:], 1)
                    if extras + i - 1 < self._extras_cap
                    and width[s] <= self._vec_cap]
                extras += len(members) - 1
                sortable = [False] * len(members)
            self._split_members(
                st, upload(np.asarray(members, np.int64), self.device),
                [int(width[s]) for s in members], sortable, feature_mask)
            st.stats["stall_events"] += 1
            st.stats["stall_splits"] += len(members)

    # -- whole tree ----------------------------------------------------------

    def grow(self, grad: torch.Tensor, hess: torch.Tensor, bag: torch.Tensor,
             feature_mask: Optional[torch.Tensor] = None):
        """Grow one tree; returns (records (L-1, 17) f32 numpy, exact bagged
        counts (L-1, 2) int64 numpy, leaf id per original row (N,) int64
        tensor, leaf outputs (L,) acc tensor), as the compact learner."""
        if feature_mask is None:
            feature_mask = self._all_features
        dev, budget = self.device, self.budget
        syncs0 = self.host_syncs
        st = self._init_root_wave(grad, hess, bag, feature_mask)
        self._open(st, feature_mask)
        self._grow_waves(st, feature_mask)
        final, refidx, pops, parent = self._replay(st, feature_mask)

        # ---- map every speculative leaf to its final ancestor
        nn = st.num_nodes
        fin = np.zeros(nn, bool)
        fin[list(final)] = True
        anc = np.where(fin, np.arange(nn), parent)
        for _ in range(max(1, (nn - 1).bit_length())):
            anc = anc[anc]
        slot2ref = upload(np.where(fin[anc], refidx[anc], 0), dev)
        leaf_id = torch.empty_like(st.rid_p)
        leaf_id[st.rid_p] = slot2ref.index_select(0, st.lid_p)
        fslots = np.flatnonzero(fin)
        leaf_out = torch.zeros(self.num_leaves, dtype=self._acc, device=dev)
        leaf_out[upload(refidx[fslots], dev)] = st.node_f.index_select(
            0, upload(fslots, dev))[:, LF_OUT]
        renewed = None
        if self._quant:
            renewed, has_h = self._renew_leaf_outputs(leaf_id)
            leaf_out = torch.where(has_h, renewed, leaf_out)

        # ---- records in pop order (rows past the pops repeat slot 0 with
        # REC_VALID = 0, as the JAX package emits them)
        nd = np.zeros(budget, np.int64)
        ref = np.zeros(budget, np.int64)
        if pops:
            nd[:len(pops)], ref[:len(pops)] = np.asarray(pops, np.int64).T
        ndt = upload(nd, dev)
        cf = st.cand_f.index_select(0, ndt).to(torch.float32)
        nf = st.node_f.index_select(0, ndt).to(torch.float32)
        vals = torch.stack([
            cf[:, CF_GAIN], cf[:, CF_LOUT], cf[:, CF_ROUT], cf[:, CF_LCNT],
            cf[:, CF_RCNT], nf[:, LF_OUT], nf[:, LF_CNT], cf[:, CF_LSH],
            cf[:, CF_RSH], cf[:, CF_LSG], cf[:, CF_RSG]], 1)
        out = torch.cat([st.cand_i.index_select(0, ndt).to(torch.float64),
                         vals.to(torch.float64),
                         st.cnt_i.index_select(0, ndt).to(torch.float64)],
                        1)
        if renewed is not None:
            # the renewed outputs ride the same read
            lv = torch.stack([renewed.to(torch.float64),
                              has_h.to(torch.float64)])
            flat = torch.cat([out.reshape(-1), lv.reshape(-1)]).cpu().numpy()
            lv = flat[out.numel():].reshape(2, self.num_leaves)
            out = flat[:out.numel()].reshape(tuple(out.shape))
        else:
            out = out.cpu().numpy()
        self.host_syncs += 1
        rec_f = np.zeros((budget, NUM_REC_FIELDS), np.float32)
        rec_f[:len(pops), 0] = 1.0
        rec_f[:, 1] = ref
        rec_f[:, 2] = out[:, CI_FEAT]
        rec_f[:, 3] = out[:, CI_THR]
        rec_f[:, 4] = out[:, CI_FLAGS].astype(np.int64) & 1
        rec_f[:, 5:NUM_REC_FIELDS - 1] = out[:, NUM_CI:NUM_CI + 11]
        rec_f[:, NUM_REC_FIELDS - 1] = \
            (out[:, CI_FLAGS].astype(np.int64) & 2) >> 1
        rec_i = out[:, NUM_CI + 11:].astype(np.int64)
        if renewed is not None:
            # pop i's left child keeps leaf number ref[i], its right child
            # is number i + 1 (``learner_wave.py:1966-1978``)
            val, has = lv[0].astype(np.float32), lv[1] > 0.5
            L = self.num_leaves
            vp = np.arange(budget) < len(pops)
            lref = np.clip(ref, 0, L - 1)
            rref = np.minimum(np.arange(budget) + 1, L - 1)
            rec_f[:, REC_LEFT_OUT] = np.where(vp & has[lref], val[lref],
                                              rec_f[:, REC_LEFT_OUT])
            rec_f[:, REC_RIGHT_OUT] = np.where(vp & has[rref], val[rref],
                                               rec_f[:, REC_RIGHT_OUT])
        st.stats["host_syncs"] = self.host_syncs - syncs0
        self.tree_stats.append(st.stats)
        return rec_f, rec_i, leaf_id, leaf_out

    def _renew_leaf_outputs(self, leaf_id: torch.Tensor):
        """Leaf-output renewal of the quantized recipe
        (``learner_wave.py:1926-1965``): per-leaf sums of the retained
        float32 gradients over the final leaves, each row rounded onto a
        power-of-two grid so the sums are exact integers, then the leaf
        outputs.  Returns (outputs (L,) float32, whether a leaf has hessian
        mass (L,))."""
        gb, hb = self._q_raw
        sg, sh = self._q_scales
        self._q_raw = None
        kb = max(30 - int(self.n_pad - 1).bit_length(), 1)
        qg = sg * (2.0 ** (3 - kb))       # sg * GMAX <= sg * 2**3
        qh = sh * (2.0 ** (4 - kb))       # sh * HMAX <= sh * 2**4
        L = self.num_leaves
        lgh = torch.zeros((2, L), dtype=torch.int64, device=self.device)
        lgh[0].index_add_(0, leaf_id, torch.round(gb / qg).to(torch.int64))
        lgh[1].index_add_(0, leaf_id, torch.round(hb / qh).to(torch.int64))
        lg = lgh[0].to(torch.float32) * qg
        lh = lgh[1].to(torch.float32) * qh
        has_h = lh > 0.0
        kw = self._split_kwargs
        out = calculate_leaf_output(lg, lh, kw["lambda_l1"], kw["lambda_l2"],
                                    kw["max_delta_step"]).to(torch.float32)
        return torch.where(has_h, out, 0.0), has_h


def wave_transient_bytes(cfg: Config, n_pad: int, f_pad: int, b: int
                         ) -> dict:
    """Working-set byte estimate of the wave learner, the JAX package's
    formula (``learner_wave.py:wave_transient_bytes``), so both packages
    make the same eligibility decision."""
    budget = max(int(cfg.num_leaves), 2) - 1
    W = min(int(cfg.tpu_wave_width), budget)
    grow = min(budget + int(np.ceil(budget
                                    * _resolve_overshoot(cfg, n_pad))),
               2 * budget)
    corr = _correction_reserve(cfg, budget)
    M = 1 + 2 * (grow + corr)
    h_bytes = (grow + corr + 2) * f_pad * b * 3 * 4
    scan_bytes = 2 * W * f_pad * b * 3 * 4
    m_pad = ((M + 127) // 128) * 128
    mask_bytes = min(n_pad, 1 << 20) * W * 4 + n_pad * 12
    lookup_bytes = min(n_pad, 1 << 17) * m_pad * 4
    sort_bytes = 2 * (f_pad // 4 + 6) * n_pad * 4
    k = _resolve_stall_batch(cfg)
    vc = int(getattr(cfg, "tpu_wave_vec_cap", -1))
    if vc <= 0:
        vc = WaveTreeLearner._VEC_CAP
    stall_vec_bytes = 0 if k == 1 else \
        k * min(vc, n_pad) * (f_pad // 4 + 4) * 4
    out = {"hist_pool_bytes": h_bytes, "child_scan_bytes": scan_bytes,
           "wave_mask_bytes": mask_bytes, "leaf_lookup_bytes": lookup_bytes,
           "sort_buffer_bytes": sort_bytes,
           "stall_vec_bytes": stall_vec_bytes}
    out["total_bytes"] = sum(out.values())
    return out


def wave_budget_reason(cfg: Config, n_pad: int, f_pad: int, b: int
                       ) -> Optional[str]:
    """Shape and byte-budget gates of the wave learner."""
    if f_pad // 4 > 64:
        return f"{f_pad} padded columns > 256 (per-row word extraction is " \
               "a masked sum over words)"
    total = wave_transient_bytes(cfg, n_pad, f_pad, b)["total_bytes"]
    if total > int(cfg.tpu_wave_max_bytes):
        return "estimated working set %.1f GB > tpu_wave_max_bytes %.1f GB" \
            % (total / 2**30, int(cfg.tpu_wave_max_bytes) / 2**30)
    return None


def wave_ineligible_reason(cfg: Config, data: _ConstructedDataset
                           ) -> Optional[str]:
    """Why the wave learner cannot run this config (None = eligible); sizing
    uses the bundled (EFB) column layout when a bundle exists."""
    if cfg.tree_learner != "serial":
        return f"tree_learner={cfg.tree_learner} (wave is serial-only)"
    if data.max_num_bin > 256:
        return f"max_num_bin={data.max_num_bin} > 256 (bin codes must pack " \
               "4-per-word)"
    bundle = getattr(data, "bundle", None)
    if bundle is not None:
        f_pad = _round_up(bundle.num_groups, data.FEATURE_TILE)
        b = max(int(data.max_num_bin), int(bundle.max_group_bin))
        if b > 256:
            return f"EFB bundle max bin {b} > 256"
    else:
        f_pad = data.bins.shape[0]
        b = int(data.max_num_bin)
    return wave_budget_reason(cfg, int(data.num_data_padded), f_pad, b)
