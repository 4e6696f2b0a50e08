"""Frontier-wave tree learner: batched speculative leaf-wise growth.

Port of ``lightgbm_tpu/learner_wave.py:WaveTPUTreeLearner``.  The sequential
compact learner splits one leaf per step, 254 steps for a 255-leaf tree;
this learner grows such a tree in about a dozen waves while keeping exact
best-first (leaf-wise) semantics:

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
     positive (``ops/replay.py``, the ``csrc/replay.cu`` kernel on the card).
  3. **Correct.**  When the replay reaches a leaf the growth never split, the
     leaf (and up to ``tpu_wave_stall_batch - 1`` more of the likeliest next
     stalls) is split on the spot, and the replay resumes.  Slot and pool
     sizes make overflow impossible, so the tree is exactly the best-first
     tree: the records equal the compact learner's and the JAX package's.

The tree stays on the device, as the JAX package's ``_train_tree_wave``
keeps it inside one program: no blocking host read between the root
histogram and the records.  What changes in eager torch (the function is
ported, not the TPU mechanism):

  * Every split pass has a fixed shape: a growth wave takes W members, the
    opening's level d min(2**d, W), a stall correction
    ``tpu_wave_stall_batch``; a device ``valid`` mask marks the real ones,
    and an invalid member reads and writes a dump slot (node slot M, pool
    slot H), as the JAX ``_wave_body``'s invalid lanes write out of bounds.
    The node and split counts are 0-d device tensors.  Whether a pass
    partitions is static: growth waves always do (rows of windows at or
    below ``tpu_wave_sort_cutoff`` keep their place), batched corrections
    never, a ``tpu_wave_stall_batch=1`` correction always (identity for the
    rows it does not sort).  The slot-reserve check is a device flag read
    with the records.
  * The loop control reads a one-element "continue" flag one pass behind:
    after pass i is queued its flag is copied (non-blocking, pinned memory)
    and pass i+1 is queued before the host waits for that copy, so the card
    never drains.  Pass i+1 is a device no-op when pass i ended its phase
    (every member invalid; the replay kernel returns at once).  These waits
    are ``flag_waits`` in ``tree_stats``, apart from ``host_syncs``.
  * The replay is one kernel launch per pass (``ops/replay.py``), its state
    carried on the device between passes; the final leaves, the leaf ids,
    the leaf outputs, the records in pop order and the quantized renewal
    are formed on the device (``_emit_tree_wave``), and ``grow`` reads
    records, counts and counters in one tensor.  ``train_async`` returns
    them unread for the pipelined boosting loop.
  * On a CUDA card (float32, the default kernels) every split pass is
    captured once per learner as a CUDA graph over buffers allocated once
    per learner, and replayed from the second tree on: one
    ``cudaGraphLaunch`` per growth wave, opening level, correction and
    replay pass.  The partition's ping-pong between the two lane sets takes
    two captures of each partitioning pass; its parity is known on the
    host.  A pass that fails to capture raises.  ``kernel_calls`` and the
    wrappers' ``.launches`` count each replay times the launches captured
    in it.  ``gpu_use_dp`` (whose plain float64 segment histogram reads
    windows on the host) and the plain kernels run the same passes
    eagerly, as the CPU does.
  * The decide pass gathers per-row split parameters from a node-slot ->
    member table indexed by the row's leaf id (the JAX package routes them
    through an MXU mask-matmul because gathers are slow on a TPU), and takes
    exact counts with one small ``histc`` of (member, bagged, left) codes.
  * Members are chosen by a stable sort on (gain desc, slot asc), the order
    of ``lax.top_k``; the JAX package's adaptive width (a W=8 body for a
    small frontier) selects the same members and is not carried over.
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
    window starts, and the growth waves carry on in partition mode.  Every
    level and the materialization run (an empty level is a no-op, and with
    no split the materialization is the identity).
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

  * Categorical features (``learner_wave.py:136, 505, 700-754``): the
    batched scan takes the numerical features and ``split_cat``
    (``ops/split_cat.py``) writes the categorical columns of the same
    candidates with a (W,) bin bitset each; the node table keeps the
    winner's bitset (``cand_b``), the decide pass gathers a member's word
    at ``bin >> 5`` and tests bit ``bin & 31`` (a categorical row ignores
    the missing rule), and the records carry the popped nodes' bitsets.
    The fused child-scan kernel stays off (as ``_fused_ok`` is through the
    JAX ``_use_scan``), so quantized trees with categorical features run
    the unfused quant path.

  * Monotone constraints and ``feature_contri`` penalties
    (``learner_wave.py:553-571``): every split pass computes its children's
    value bounds from the parent's (``node_f[:, LF_MIN_C / LF_MAX_C]``,
    ``_child_constraints``) before their scan and hands them, interleaved,
    to the batched scan and ``split_cat``, whose kernels clip to them and
    apply the penalty on the card; the bounds stay on the device, so the
    graphs and the one host read per tree are unchanged.  The fused
    child-scan kernel stays off, as the JAX ``_use_scan`` is off under
    constraints (``scan_pallas.py:scan_ineligible_reason``): a quantized
    constrained tree runs the quant segment histogram and the constrained
    ``split_scan``.

With ``telemetry`` on, the boosting loop maps these per-tree counters
(``DEVICE_STATS``, read with the records) onto the report's device counter
names (``observability/telemetry.py``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .binning import MISSING_NAN, MISSING_ZERO
from .config import Config
from .dataset import _ConstructedDataset, _round_up
from .learner import (CF_GAIN, CF_LCNT, CF_LOUT, CF_LSG, CF_LSH, CF_RCNT,
                      CF_ROUT, CF_RSG, CF_RSH, CI_FEAT, CI_FLAGS, CI_THR,
                      LF_CNT, LF_DEPTH, LF_MAX_C, LF_MIN_C, LF_OUT, NUM_CF,
                      NUM_CI, NUM_LF, NUM_REC_FIELDS, REC_LEFT_OUT,
                      REC_RIGHT_OUT, AsyncTree, _FeatCand)
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
from .ops.replay import (CTL_FLAG, CTL_PASSES, CTL_POPS, FLAG_STALL,
                         NUM_CTL, replay_pass, replay_pass_plain)
from .ops.scan import find_best_splits_batched
from .ops.split import calculate_leaf_output, find_best_splits
from .ops.split_cat import (categorical_candidates,
                            categorical_candidates_plain)


@dataclass(frozen=True)
class WaveKernels:
    """The eight kernel functions the wave learner calls.  The defaults are
    the wrappers (kernel on a CUDA tensor, plain version on a CPU tensor);
    ``PLAIN_KERNELS`` grows the same tree through the plain versions on any
    device."""
    packed: Callable = build_histogram_packed
    segments: Callable = build_histogram_segments
    partition: Callable = apply_partition
    scan: Callable = find_best_splits_batched
    multislot: Callable = build_histogram_multislot
    fused: Callable = fused_child_scans
    replay: Callable = replay_pass
    cat: Callable = categorical_candidates


PLAIN_KERNELS = WaveKernels(build_histogram_packed_plain,
                            build_histogram_segments_plain,
                            apply_partition_plain,
                            find_best_splits,
                            build_histogram_multislot_plain,
                            fused_child_scans_plain,
                            replay_pass_plain,
                            categorical_candidates_plain)

# rows of the per-member parameter table the decide pass gathers from
(P_WIDX, P_SHIFT, P_MT, P_DB, P_NB, P_BOFF, P_BND, P_THR, P_DLEFT, P_LSLOT,
 P_RSLOT, P_SORT, P_CAT) = range(13)
NUM_P = 13

# device counters of one tree (int64), read with its records
ST_WAVES, ST_OPEN, ST_OVERFLOW = range(3)
NUM_ST = 3
#: the counters after the records in ``AsyncTree.records``: the three above,
#: then the replay's passes, stall events, stall splits and error flag
#: with telemetry on, two more: the split count after growth and after the
#: replay's corrections (``observability/telemetry.py``)
TELEMETRY_STATS = ("grow_splits", "total_splits")
DEVICE_STATS = ("waves", "open_levels", "slot_overflow", "replay_passes",
                "stall_events", "stall_splits", "replay_error")

# which members of a split pass partition their window
SORT_ALL, SORT_WAVE, SORT_NONE, SORT_STALL = range(4)


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
    """The learner's device state, allocated once per learner and reset per
    tree (a CUDA graph replays on fixed addresses); every tensor is updated
    in place.  Rows live in two lane sets: ``lanes[par]`` is current, and a
    partition writes the other.  Node slot M and pool slot H are the dump
    slots an invalid pass member reads and writes."""
    lanes: tuple             # 2 x (bins (Fw, N) int32, w (3, N) f32,
                             #      rid (N,) int64, lid (N,) int32)
    node_i: torch.Tensor     # (M+1, 2) int64 window [start, width]
    node_f: torch.Tensor     # (M+1, NUM_LF) acc sums/cnt/out/depth/bounds
    cand_f: torch.Tensor     # (M+1, NUM_CF) acc best-split floats
    cand_i: torch.Tensor     # (M+1, NUM_CI) int64 feature/threshold/flags
    cand_b: Optional[torch.Tensor]  # (M+1, W) int32 bitsets, or None
                                    # without categorical features
    parent: torch.Tensor     # (M+1,) int64
    child0: torch.Tensor     # (M+1,) int64 left child slot (right = +1)
    hslot: torch.Tensor      # (M+1,) int64 histogram pool slot
    split_m: torch.Tensor    # (M+1,) bool node has been split
    cnt_i: torch.Tensor      # (M+1, 2) int64 exact bagged child counts
    hist_pool: torch.Tensor  # (H+1, F, B, 3) acc
    num_nodes: torch.Tensor  # () int64
    num_splits: torch.Tensor  # () int64
    counters: torch.Tensor   # (NUM_ST,) int64
    flag: torch.Tensor       # (1,) int32 growth goes on (1) or ends (0)
    avail: torch.Tensor      # (M,) uint8 replay: available slots
    refidx: torch.Tensor     # (M,) int32 replay: leaf index per slot
    poprec: torch.Tensor     # (L-1, 2) int32 replay: (slot, leaf) per pop
    rctl: torch.Tensor       # (NUM_CTL,) int32 replay counters and flag
    members: torch.Tensor    # (stall_batch,) int64 the correction's members
    mvalid: torch.Tensor     # (stall_batch,) bool
    fmask: torch.Tensor      # (F,) bool the tree's feature mask
    par: int = 0

    @property
    def bins_p(self) -> torch.Tensor:
        return self.lanes[self.par][0]

    @property
    def w_p(self) -> torch.Tensor:
        return self.lanes[self.par][1]

    @property
    def rid_p(self) -> torch.Tensor:
        return self.lanes[self.par][2]

    @property
    def lid_p(self) -> torch.Tensor:
        return self.lanes[self.par][3]

    @property
    def spare(self) -> tuple:
        return self.lanes[1 - self.par]


class _FlagRing:
    """A pass's one-element continue flag, copied to the host without
    blocking right after the pass is queued and read one pass later: on a
    CUDA device into pinned memory behind an event, so the read waits only
    for that pass while the next one is already queued."""

    def __init__(self, device: torch.device, size: int = 4):
        self.cuda = device.type == "cuda"
        self.host = torch.zeros(size, dtype=torch.int32,
                                pin_memory=self.cuda)
        self.events = [torch.cuda.Event() for _ in range(size)] \
            if self.cuda else None
        self.waits = 0

    def post(self, i: int, flag: torch.Tensor) -> None:
        j = i % self.host.numel()
        self.host[j:j + 1].copy_(flag, non_blocking=True)
        if self.cuda:
            self.events[j].record()

    def read(self, i: int) -> int:
        j = i % self.host.numel()
        if self.cuda:
            self.events[j].synchronize()
        self.waits += 1
        return int(self.host[j])


class WaveTreeLearner(CompactTreeLearner):
    """Frontier-wave serial learner (see the module docstring).  On a CUDA
    device with the default kernels and float32 passes, every tree after the
    first replays its split passes as CUDA graphs."""

    #: batch extras must fit this many rows (``tpu_wave_vec_cap`` overrides)
    _VEC_CAP = 1 << 17

    def __init__(self, cfg: Config, data: _ConstructedDataset,
                 device: torch.device,
                 kernels: WaveKernels = WaveKernels()):
        super().__init__(cfg, data, device)
        self.kernels = kernels
        self.split_cat = kernels.cat
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
        i64 = dict(dtype=torch.int64, device=device)
        self._pos = torch.arange(self.n_pad, dtype=torch.int32, device=device)
        self._iota_m = torch.arange(self.M, **i64)
        self._iota_m1 = torch.arange(self.M + 1, **i64)
        self._iota_w = torch.arange(self.W, **i64)
        self._iota_b = torch.arange(self.budget, **i64)
        self._win_sizes_t = torch.tensor(self._win_sizes, **i64)
        #: calls this learner made to each kernel function, over all trees;
        #: the ``_quant`` entries count the quant-mode calls a second time
        self.kernel_calls = {"hist_packed": 0, "hist_segments": 0,
                             "partition": 0, "split_scan": 0,
                             "hist_multislot": 0, "fused_scan": 0,
                             "replay": 0, "split_cat": 0,
                             "hist_packed_quant": 0,
                             "hist_segments_quant": 0,
                             "hist_multislot_quant": 0}
        #: growth waves run the fused child-scan kernel
        #: (``ops/fused_scan.py``): quantized gradients without EFB bundles
        #: or categorical features, as ``learner_wave.py:_fused_ok`` (its
        #: ``_use_scan`` is off with categoricals).  The JAX package's 4 MB
        #: VMEM gate has no counterpart: the kernel holds one (feature,
        #: 256-bin) row per block, and every histogram here has at most 256
        #: bins
        self._use_fused = self._quant and self._bundle is None \
            and not self.has_categorical and not self.has_monotone \
            and not self.has_penalty
        self.use_graphs = device.type == "cuda" and not self.hist_dp \
            and kernels == WaveKernels()
        self._st: Optional[WaveState] = None
        self._ring = _FlagRing(device)
        #: telemetry's split counts ride the records (``TELEMETRY_STATS``);
        #: without telemetry the device work is unchanged
        self._telem = bool(cfg.telemetry)
        self._grow_n = torch.zeros(1, dtype=torch.int64, device=device) \
            if self._telem else None

    def memory_gauges(self) -> dict:
        """The working-set byte breakdown for the telemetry report's
        ``gauges.wave_working_set``: ``wave_transient_bytes``, the formula
        the eligibility gate uses, over this learner's own dimensions (its
        rows, which a sharded learner's shard holds, its packed columns,
        histogram bins and columns)."""
        return wave_transient_bytes(self.cfg, self.n_pad, self.fw * 4,
                                    self._hist_nbins, self.has_categorical,
                                    self._hist_cols)

    def _init_wave_dims(self, cfg: Config) -> None:
        """Slot and pool sizing, as ``learner_wave.py:_init_wave_dims``:
        growth performs at most ``grow_budget`` splits and the replay
        correction at most ``_correction_reserve`` more, so M node slots and
        H pool slots can never overflow (``wave_dims``)."""
        d = wave_dims(cfg, self.n_pad)
        self.budget, self.W = d.budget, d.W
        self.grow_budget = d.grow_budget
        self._stall_batch = d.stall_batch
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
        reason = quant_ineligible_reason(self._dataset_rows(), self.hist_dp)
        self._quant = qg == "on" and reason is None
        if qg != "on" and reason is None:
            reason = f"tpu_quantized_grad={qg} (quantization is opt-in)"
        self._quant_reason = None if self._quant else reason
        self._q_scales = None      # (sg, sh) of the current tree
        self._q_mbar = None        # mean hessian mass per bagged row
        self._q_raw = None         # (gb, hb) float32, kept for the renewal
        self._corr = d.corr
        self.M, self.H = d.M, d.H
        # windows at or below the wave cutoff split in place (children share
        # the parent's span); a K=1 stall may only partition above the larger
        # of both cutoffs, so it never reorders a shared span
        self._wave_cutoff = int(cfg.tpu_wave_sort_cutoff)
        self._stall_cutoff = max(self._sort_cutoff, self._wave_cutoff)

    # -- split candidates ----------------------------------------------------

    def _feature_cands(self, hist, sum_g, sum_h, cnt, feature_mask,
                       min_c=None, max_c=None):
        """Per-feature candidates of a batch of leaves through the batched
        scan, the categorical columns through ``split_cat`` (plain float64
        in dp); ``min_c`` / ``max_c`` (K,) the leaves' value bounds."""
        if self.hist_dp:
            return super()._feature_cands(hist, sum_g, sum_h, cnt,
                                          feature_mask, min_c, max_c)
        hist = self._fix_histogram(hist, sum_g, sum_h, cnt)
        min_c, max_c = self._leaf_bounds(min_c, max_c, hist.shape[0])
        kw = {k: v for k, v in self._split_kwargs.items()
              if k != "skip_missing_scan"}
        self.kernel_calls["split_scan"] += 1
        num = self.kernels.scan(
            hist, sum_g, sum_h, cnt, self.f_num_bin, self.f_missing,
            self.f_default_bin, self._num_features_of(feature_mask),
            self.f_monotone, min_c, max_c, penalty=self.f_penalty, **kw)
        return self._with_categorical(num, hist, sum_g, sum_h, cnt,
                                      feature_mask, min_c, max_c)

    # -- state and root ------------------------------------------------------

    def _alloc_state(self) -> WaveState:
        n, M, H, acc, dev = self.n_pad, self.M, self.H, self._acc, self.device
        bins = self.bins_packed()

        def lanes():
            return (torch.empty_like(bins),
                    torch.empty((3, n), dtype=torch.float32, device=dev),
                    torch.empty(n, dtype=torch.int64, device=dev),
                    torch.empty(n, dtype=torch.int32, device=dev))

        i64 = dict(dtype=torch.int64, device=dev)
        kb = self._stall_batch
        return WaveState(
            lanes=(lanes(), lanes()),
            node_i=torch.zeros((M + 1, 2), **i64),
            node_f=torch.zeros((M + 1, NUM_LF), dtype=acc, device=dev),
            cand_f=torch.zeros((M + 1, NUM_CF), dtype=acc, device=dev),
            cand_i=torch.zeros((M + 1, NUM_CI), **i64),
            cand_b=torch.zeros((M + 1, self.cat_W), dtype=torch.int32,
                               device=dev) if self.has_categorical else None,
            parent=torch.zeros(M + 1, **i64),
            child0=torch.zeros(M + 1, **i64),
            hslot=torch.zeros(M + 1, **i64),
            split_m=torch.zeros(M + 1, dtype=torch.bool, device=dev),
            cnt_i=torch.zeros((M + 1, 2), **i64),
            hist_pool=torch.zeros((H + 1, self._pool_cols,
                                   self._hist_nbins, 3), dtype=acc,
                                  device=dev),
            num_nodes=torch.zeros((), **i64),
            num_splits=torch.zeros((), **i64),
            counters=torch.zeros(NUM_ST, **i64),
            flag=torch.zeros(1, dtype=torch.int32, device=dev),
            avail=torch.zeros(M, dtype=torch.uint8, device=dev),
            refidx=torch.zeros(M, dtype=torch.int32, device=dev),
            poprec=torch.zeros((self.budget, 2), dtype=torch.int32,
                               device=dev),
            rctl=torch.zeros(NUM_CTL, dtype=torch.int32, device=dev),
            members=torch.zeros(kb, **i64),
            mvalid=torch.zeros(kb, dtype=torch.bool, device=dev),
            fmask=torch.zeros(self.num_features, dtype=torch.bool,
                              device=dev))

    def _init_root_wave(self, grad, hess, bag, feature_mask) -> WaveState:
        """Reset the learner's state for a new tree (allocated on the first)
        and fill in the root: its lanes, histogram and best split."""
        n, M, H, acc = self.n_pad, self.M, self.H, self._acc
        if self._st is None:
            self._st = self._alloc_state()
        st = self._st
        st.par = 0
        self._coll_ctx = ("root", "tree")
        if self._quant:
            # per-tree quantization (``learner_wave.py:429-463``): the lanes
            # carry the dequantized gq*sg, hq*sh; the count channel carries
            # the hessian mass over the mean mass per bagged row, m
            gb = (grad * bag).to(torch.float32)
            hb = (hess * bag).to(torch.float32)
            mx = self._global_max(torch.stack([gb.abs().max(), hb.max()]))
            gd, hd, sg, sh = quantize_gradients(
                gb, hb, bag, self._global_row_offset(), mx[0], mx[1])
            self._q_scales = (sg, sh)
            self._q_raw = (gb, hb)
            w = torch.stack([gd, hd, bag.to(torch.float32)])
            q_tot = self._global_scalar(torch.stack([
                gd.to(acc).sum(), hd.to(acc).sum(), bag.to(acc).sum()]))
            inv_sh = 1.0 / sh
            mbar = torch.clamp(q_tot[1] * inv_sh, min=1.0) \
                / torch.clamp(q_tot[2], min=1.0)
            self._q_mbar = mbar
            q_cnt = inv_sh / mbar
            resc = torch.stack([torch.ones_like(q_cnt),
                                torch.ones_like(q_cnt), q_cnt])
            # one buffer for the learner's life: the graphs read it
            if self._q_rescale is None:
                self._q_rescale = torch.empty_like(resc)
            self._q_rescale.copy_(resc)
        else:
            w = torch.stack([grad * bag, hess * bag, bag]).to(torch.float32)
        bins, w_p, rid, lid = st.lanes[0]
        bins.copy_(self.bins_packed())
        w_p.copy_(w)
        torch.arange(n, out=rid)
        lid.zero_()
        st.fmask.copy_(feature_mask)
        for t in (st.node_i, st.node_f, st.cand_i, st.parent, st.child0,
                  st.hslot, st.split_m, st.cnt_i, st.num_splits,
                  st.counters, st.flag, st.avail, st.poprec, st.rctl,
                  st.mvalid):
            t.zero_()
        # (fill_ on views: a Python scalar stored into a CUDA tensor by
        # indexing goes through a blocking copy)
        st.num_nodes.fill_(1)
        st.hslot[M:].fill_(H)
        st.refidx.fill_(-1)
        st.refidx[:1].fill_(0)
        st.avail[:1].fill_(1)
        st.members.fill_(M)
        self.kernel_calls["hist_packed"] += int(not self.hist_dp)
        self.kernel_calls["hist_packed_quant"] += int(
            self._quant and not self.hist_dp)
        root_hist = self._root_hist(st)
        if self._quant:
            # root totals from the dequantized lanes, the count on the
            # count channel's scale
            sum_g, sum_h = q_tot[0], q_tot[1]
            cnt = (sum_h * q_cnt).to(acc)
        else:
            sum_g = self._global_scalar((grad * bag).to(acc).sum())
            sum_h = self._global_scalar((hess * bag).to(acc).sum())
            cnt = self._global_scalar(bag.to(acc).sum())
        cf, ci, cb = self._cand_rows(root_hist[None], sum_g[None],
                                     sum_h[None], cnt[None], st.fmask, True)
        st.node_i[:1, 1].fill_(n)
        st.node_f[:, LF_MIN_C].fill_(float("-inf"))
        st.node_f[:, LF_MAX_C].fill_(float("inf"))
        st.node_f[0, :LF_OUT] = torch.stack([sum_g, sum_h, cnt])
        st.cand_f.zero_()
        st.cand_f[:, CF_GAIN].fill_(float("-inf"))
        st.cand_f[0] = cf[0]
        st.cand_i[0] = ci[0]
        if cb is not None:
            st.cand_b.zero_()
            st.cand_b[0] = cb[0]
        st.hist_pool[0] = root_hist
        return st

    # -- splitting a set of frontier leaves ----------------------------------

    def _decide(self, lanes, wi: torch.Tensor, params: torch.Tensor,
                bits: Optional[torch.Tensor] = None):
        """Per-row split decision for the rows of the K members ``wi``
        (``NumericalDecisionInner``, `tree.h:233-249`, with the EFB decode;
        ``CategoricalDecisionInner``, `tree.h:270-277`, where the member's
        split is categorical).  ``params`` is the (NUM_P, K+1) member table;
        column K serves every row outside the members; ``bits`` (K+1, W)
        int32 are the members' bitsets.  Returns (member index per row, K
        for outsiders; go_left; the table's columns gathered per row)."""
        bins_p, lid_p = lanes[0], lanes[3]
        k = wi.shape[0]
        member_of = torch.full((self.M + 1,), k, dtype=torch.int32,
                               device=self.device)
        member_of[wi] = torch.arange(k, dtype=torch.int32, device=self.device)
        mi = member_of.index_select(0, lid_p)
        row = params.index_select(1, mi)                       # (NUM_P, N)
        word = self._row_words(bins_p, row[P_WIDX])
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
                              frow <= row[P_THR])
        if bits is not None:
            # the member's word at bin >> 5, bit bin & 31; no missing rule
            w = bits.shape[1]
            # (an outsider's code may be a bundle code past the bitset)
            word = bits.reshape(-1).index_select(0, (
                mi * w + torch.clamp(frow >> 5, max=w - 1)).to(torch.int64))
            go_left = torch.where(row[P_CAT] == 1,
                                  ((word >> (frow & 31)) & 1) == 1, go_left)
        return mi, go_left & (mi < k), row

    def _row_words(self, bins_p: torch.Tensor, widx: torch.Tensor
                   ) -> torch.Tensor:
        """Each row's packed word at word row ``widx`` (the decide pass's
        read; a 2-D learner's words live on one feature column)."""
        return bins_p.gather(0, widx.to(torch.int64).view(1, -1))[0]

    def _sync_counts3(self, counts: torch.Tensor) -> torch.Tensor:
        """(2, K) [left bagged, bagged] counts of a wave's members from the
        local rows' (one collective for the wave)."""
        return counts

    def _replicated_spans(self, spans: torch.Tensor) -> torch.Tensor:
        """Window widths the replay's batched-stall gate reads; a row
        shard's windows are its own, so a sharded learner takes their
        maximum over the shards (JAX ``learner_wave.py:1338``)."""
        return spans

    def _global_row_offset(self) -> int:
        """The first local row's global index (stochastic rounding keys on
        the global row)."""
        return 0

    def _scan_scope(self, feature_mask=None):
        """The feature metadata a split scan reads for the duration of the
        block, and the feature mask it takes (a sharded learner's slices
        of both; None: the tree's own)."""
        return contextlib.nullcontext()

    def _merge_cands(self, cf, ci, cb):
        """Per-leaf best rows of this learner's features -> the global ones
        (a sharded learner's all-gather and argmax)."""
        return cf, ci, cb

    def _member_hists(self, bins, w, lid, start, cnt, leaf):
        """Histograms of K members' rows in one call (plain float64 in dp;
        the count channel rescaled in quant mode).  The kernel's grid is
        sized from ``n_pad``, a bound on ``sum(cnt)`` known with no read
        (``ops/hist_segments.py:segment_grid``)."""
        bins = self._hist_bins(bins)
        if self.hist_dp:
            h = build_histogram_segments_plain(
                bins, w, lid, start, cnt, leaf, num_bins=self._hist_nbins,
                dp=True)
            return h[:, :self._hist_cols]
        self.kernel_calls["hist_segments"] += 1
        self.kernel_calls["hist_segments_quant"] += int(self._quant)
        h = self.kernels.segments(bins, w, lid, start, cnt, leaf,
                                  num_bins=self._hist_nbins,
                                  rows_bound=self.n_pad, quant=self._quant)
        return self._quant_count(h[:, :self._hist_cols])

    def _opening_hists(self, bins, w, lid, sm_slot, k: int):
        """Smaller-child histograms of one opening level
        (``learner_wave.py:_opening_hists``): no row has moved, so one
        multislot pass over all rows, the slot of a row the member whose
        smaller child holds it (K for every other row)."""
        slot_of = torch.full((self.M + 1,), k, dtype=torch.int32,
                             device=self.device)
        slot_of[sm_slot] = torch.arange(k, dtype=torch.int32,
                                        device=self.device)
        slot = slot_of.index_select(0, lid)
        bins = self._hist_bins(bins)
        if self.hist_dp:
            h = build_histogram_multislot_plain(
                bins, w, slot, num_bins=self._hist_nbins, n_slots=k, dp=True)
            return h[:, :self._hist_cols]
        self.kernel_calls["hist_multislot"] += 1
        self.kernel_calls["hist_multislot_quant"] += int(self._quant)
        h = self.kernels.multislot(bins, w, slot, num_bins=self._hist_nbins,
                                   n_slots=k, quant=self._quant)
        return self._quant_count(h[:, :self._hist_cols])

    def _bucket_t(self, cnt: torch.Tensor) -> torch.Tensor:
        """``_bucket`` on device counts: the smallest window bucket >= cnt
        (the largest for a larger count)."""
        i = torch.bucketize(cnt, self._win_sizes_t)
        return self._win_sizes_t.index_select(
            0, torch.clamp(i, max=len(self._win_sizes) - 1))

    def _split_members(self, st: WaveState, wi: torch.Tensor,
                       valid: torch.Tensor, rule: int, opening: bool = False,
                       fused: bool = False, partition: bool = False) -> None:
        """Split the valid ones of the K frontier leaves ``wi`` at their
        best candidates, as one growth wave (``learner_wave.py:_wave_body``),
        one opening level (``opening``) or one replay correction
        (``_stall_split`` / ``_stall_split_batch``): decide, partition the
        sortable windows (``rule``; the others freeze: children share the
        parent's span), smaller-child histograms in one call, sibling
        subtraction, pool writes, and the 2K children's bookkeeping with
        one batched scan.  Every shape is fixed by K; invalid members read
        and write the dump slots.  ``partition`` (static) runs the partition
        kernel into the other lane set, the identity for rows no sortable
        member holds; the caller then flips ``st.par``.

        An opening level moves no row: every member's children get logical
        windows, the leaf ids are rewritten, and the smaller children's
        histograms come from one multislot pass over all rows.  ``fused``
        (a quantized growth wave) folds subtraction, pool writes,
        FixHistogram and both children's scans into one kernel."""
        acc, M, H = self._acc, self.M, self.H
        k = wi.shape[0]
        cur = st.lanes[st.par]
        vi = valid.to(torch.int64)
        nv = vi.sum()
        pos = torch.cumsum(vi, 0) - vi
        nn, ns = st.num_nodes, st.num_splits
        # the slot-reserve check, read with the records (the clamps keep an
        # overflowing tree's writes inside the tables until then)
        st.counters[ST_OVERFLOW] += ((nn + 2 * nv > M)
                                     | (1 + ns + nv > H)).to(torch.int64)
        wi = torch.where(valid, wi, M)
        lslot = torch.where(valid, torch.clamp(nn + 2 * pos, max=M - 2), M)
        rslot = torch.where(valid, lslot + 1, M)
        ci = st.cand_i.index_select(0, wi)
        win = st.node_i.index_select(0, wi)
        ps, cw = win[:, 0], win[:, 1]
        if rule == SORT_ALL:
            srt = valid
        elif rule == SORT_WAVE:
            srt = valid & (cw > self._wave_cutoff)
        elif rule == SORT_STALL:
            srt = valid & (self._bucket_t(cw) > self._stall_cutoff)
        else:
            srt = torch.zeros_like(valid)
        params = torch.cat([
            self._feat_tab.index_select(0, ci[:, CI_FEAT]),
            ci[:, CI_THR:CI_THR + 1], ci[:, CI_FLAGS:CI_FLAGS + 1] & 1,
            lslot[:, None], rslot[:, None], srt[:, None].to(torch.int64),
            ci[:, CI_FLAGS:CI_FLAGS + 1] >> 1], 1)
        params = torch.cat([params, params.new_zeros(1, NUM_P)]).t() \
            .to(torch.int32).contiguous()                      # (NUM_P, K+1)
        bits = None
        if st.cand_b is not None:
            bits = st.cand_b.index_select(0, wi)
            bits = torch.cat([bits, bits.new_zeros(1, self.cat_W)])

        # ---- decide, exact counts, leaf-id rewrite
        mi, go_left, row = self._decide(cur, wi, params, bits)
        bag = cur[1][2] > 0.5
        # exact counts per (member, bagged, left): one small histogram of
        # the codes 4*member + 2*bag + left (float64 counts are exact; the
        # bin centres keep the bin index exact on every device)
        code = (mi * 4 + bag * 2 + go_left).to(torch.float64) + 0.5
        cnt = torch.histc(code, bins=4 * (k + 1), min=0, max=4 * (k + 1)) \
            .to(torch.int64).view(k + 1, 2, 2)[:k]
        lc_w = cnt[:, 0, 1] + cnt[:, 1, 1]
        lc_bag = cnt[:, 1, 1]
        c_bag = cnt[:, 1, 0] + lc_bag
        # the bagged counts of the whole dataset (left rows are window
        # geometry, the shard's own)
        if rule in (SORT_NONE, SORT_STALL):
            lc_bag, c_bag = self._sync_counts(lc_bag, c_bag)
        else:
            lc_bag, c_bag = self._sync_counts3(torch.stack([lc_bag, c_bag]))
        lid_new = torch.where(mi < k, torch.where(go_left, row[P_LSLOT],
                                                  row[P_RSLOT]), cur[3])

        # ---- stable partition of the sortable windows: dest = the child
        # window's start + the row's rank among its side's rows; rows of
        # no sortable member stay (an opening level defers every move to
        # _materialize, a batched correction moves none)
        if partition:
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
            nxt = st.lanes[1 - st.par]
            self.kernel_calls["partition"] += 1
            self.kernels.partition(cur[0], cur[1], cur[2], lid_new, dest,
                                   out=nxt)
            bins, w, lid = nxt[0], nxt[1], nxt[3]
        else:
            cur[3].copy_(lid_new)
            bins, w, lid = cur[0], cur[1], cur[3]

        # ---- child windows: sortable members split [s, lc) / [s+lc, ..);
        # frozen members' children share the parent's span
        li = torch.stack([ps, torch.where(srt, lc_w, cw)], 1)
        ri = torch.stack([torch.where(srt, ps + lc_w, ps),
                          torch.where(srt, cw - lc_w, cw)], 1)

        # ---- smaller-child histograms (by bagged counts)
        left_small = lc_bag <= (c_bag - lc_bag)
        sm_slot = torch.where(left_small, lslot, rslot)
        if opening:
            h_small = self._opening_hists(bins, w, lid, sm_slot, k)
        else:
            sm_start = torch.where(valid & srt & ~left_small, ps + lc_w,
                                   torch.where(valid, ps, 0))
            sm_cnt = torch.where(srt, torch.where(left_small, lc_w,
                                                  cw - lc_w), cw)
            sm_cnt = torch.where(valid, sm_cnt, 0)
            h_small = self._member_hists(bins, w, lid, sm_start, sm_cnt,
                                         sm_slot)
        h_small = self._reduce_hist_batch(h_small)
        ph = st.hslot.index_select(0, wi)
        rh = torch.where(valid, torch.clamp(1 + ns + pos, max=H - 1), H)

        # ---- children bookkeeping, their best splits in one batched scan
        def i2(a, b):                       # interleave K -> 2K
            return torch.stack([a, b], 1).reshape((2 * k,) + a.shape[1:])

        pcf = st.cand_f.index_select(0, wi)
        pnf = st.node_f.index_select(0, wi)
        # the children's value bounds (monotone propagation,
        # ``learner_wave.py:553-571``), before their scans
        lmin = rmin = pnf[:, LF_MIN_C]
        lmax = rmax = pnf[:, LF_MAX_C]
        mins2 = maxs2 = None
        if self.has_monotone:
            lmin, lmax, rmin, rmax = self._child_constraints(
                ci[:, CI_FEAT], ci[:, CI_FLAGS], pcf[:, CF_LOUT],
                pcf[:, CF_ROUT], lmin, lmax)
            mins2, maxs2 = i2(lmin, rmin), i2(lmax, rmax)
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
            with self._scan_scope() as fmask:
                cands = self.kernels.fused(
                    h_small, st.hist_pool, ph, rh, left_small, *sums2,
                    self.f_num_bin, self.f_missing, self.f_default_bin,
                    st.fmask if fmask is None else fmask, **kw)
                cf2, ci2, cb2 = self._pack_cands(_FeatCand(*cands),
                                                 depth_ok)
            cf2, ci2, cb2 = self._merge_cands(cf2, ci2, cb2)
        else:
            h_large = st.hist_pool.index_select(0, ph) - h_small
            lsm = left_small.view(k, 1, 1, 1)
            hl = torch.where(lsm, h_small, h_large)
            hr = torch.where(lsm, h_large, h_small)
            st.hist_pool.index_copy_(0, ph, hl)
            st.hist_pool.index_copy_(0, rh, hr)
            cf2, ci2, cb2 = self._cand_rows(i2(hl, hr), *sums2, st.fmask,
                                            depth_ok, mins2, maxs2)
        lf_l = torch.stack([pcf[:, CF_LSG], pcf[:, CF_LSH], pcf[:, CF_LCNT],
                            pcf[:, CF_LOUT], cd, lmin, lmax], 1)
        lf_r = torch.stack([pcf[:, CF_RSG], pcf[:, CF_RSH], pcf[:, CF_RCNT],
                            pcf[:, CF_ROUT], cd, rmin, rmax], 1)
        s2 = i2(lslot, rslot)
        st.node_i.index_copy_(0, s2, i2(li, ri))
        st.node_f.index_copy_(0, s2, i2(lf_l, lf_r).to(acc))
        st.cand_f.index_copy_(0, s2, cf2.to(acc))
        st.cand_i.index_copy_(0, s2, ci2)
        if cb2 is not None:
            st.cand_b.index_copy_(0, s2, cb2)
        st.parent.index_copy_(0, s2, i2(wi, wi))
        st.hslot.index_copy_(0, s2, i2(ph, rh))
        st.child0.index_copy_(0, wi, lslot)
        st.split_m.index_copy_(0, wi, valid)
        st.cnt_i.index_copy_(0, wi, torch.stack([lc_bag, c_bag - lc_bag], 1))
        st.num_nodes += 2 * nv
        st.num_splits += nv

    # -- the split passes ----------------------------------------------------

    def _pool_gains(self, st: WaveState) -> torch.Tensor:
        """(M,) gains of the unsplit nodes, -inf elsewhere
        (``learner_wave.py:_pool_gains``)."""
        alive = (self._iota_m < st.num_nodes) & ~st.split_m[:self.M]
        return torch.where(alive, st.cand_f[:self.M, CF_GAIN],
                           float("-inf"))

    def _wave_pass(self, st: WaveState, width: int, opening: bool) -> None:
        """One growth wave (W members; its flag says whether growth goes
        on, the JAX ``gcond``) or one opening level: the top-``width``
        frontier leaves by (gain desc, slot asc), valid where the gain is
        positive and the growth budget lasts."""
        self._coll_ctx = ("grow_wave", "wave")
        gv, order = torch.sort(self._pool_gains(st), descending=True,
                               stable=True)
        valid = (gv[:width] > 0.0) \
            & (self._iota_w[:width] < self.grow_budget - st.num_splits)
        self._split_members(st, order[:width], valid,
                            SORT_ALL if opening else SORT_WAVE,
                            opening=opening,
                            fused=self._use_fused and not opening,
                            partition=not opening)
        any_v = valid.any()
        st.counters[ST_WAVES] += any_v
        if opening:
            st.counters[ST_OPEN] += any_v
        else:
            st.flag.copy_(((st.num_splits < self.grow_budget)
                           & (self._pool_gains(st).max() > 0.0)).view(1))

    def _materialize(self, st: WaveState) -> None:
        """Move every row to its leaf's logical window
        (``learner_wave.py:_materialize_sort``): the stable order of the
        rows' window starts, the permutation the JAX package's stable sort
        on keys 2 * start produces, through the partition kernel."""
        cur, nxt = st.lanes[st.par], st.lanes[1 - st.par]
        start = st.node_i[:, 0].index_select(0, cur[3])
        perm = torch.sort(start, stable=True).indices
        dest = torch.empty_like(self._pos).index_copy_(0, perm, self._pos)
        self.kernel_calls["partition"] += 1
        self.kernels.partition(cur[0], cur[1], cur[2], cur[3], dest, out=nxt)

    def _replay_pass(self, st: WaveState) -> None:
        """One pass of the exact greedy replay (``ops/replay.py``)."""
        M = self.M
        self._coll_ctx = ("stall_correction", "stall_event")
        spans = self._replicated_spans(st.node_i[:M, 1])
        self.kernel_calls["replay"] += 1
        self.kernels.replay(
            st.cand_f[:M, CF_GAIN], st.split_m[:M], st.child0[:M],
            spans, st.avail, st.refidx, st.poprec, st.rctl,
            st.members, st.mvalid, budget=self.budget,
            stall_batch=self._stall_batch, extras_cap=self._extras_cap,
            vec_cap=self._vec_cap, pad_slot=M)

    def _correct_pass(self, st: WaveState) -> None:
        """The stall correction the last replay pass asked for (its members
        and valid mask on the device; all invalid after the replay ended)."""
        kb1 = self._stall_batch == 1
        self._coll_ctx = ("stall_correction", "stall_event")
        self._split_members(st, st.members, st.mvalid,
                            SORT_STALL if kb1 else SORT_NONE, partition=kb1)

    # -- queueing the passes -------------------------------------------------

    def _drive(self, run: Callable[[int], None], limit: int,
               flag: Callable[[], torch.Tensor], go_on: int,
               what: str) -> None:
        """Queue passes ``run(0), run(1), ...`` until one's flag (the
        one-element tensor ``flag()`` holds after it) is not ``go_on``.
        The flag of pass i is read after pass i+1 is queued, so the phase
        ends with one pass queued past its last, a device no-op."""
        ring = self._ring
        run(0)
        ring.post(0, flag())
        i = 0
        while True:
            if i + 1 >= limit:
                raise RuntimeError(f"wave learner: {what} did not end "
                                   f"within {limit} passes")
            run(i + 1)
            ring.post(i + 1, flag())
            if ring.read(i) != go_on:
                return
            i += 1

    def _grow_tree(self, st: WaveState) -> None:
        """Every split pass of one tree: the opening levels and the
        materialization, the growth waves until their flag ends them, then
        replay passes and corrections until the replay is done."""
        q = self._queue
        for d in range(self.open_levels):
            q(("open", d, st.par),
              lambda d=d: self._wave_pass(st, min(1 << d, self.W), True))
        if self.open_levels:
            q(("materialize", st.par), lambda: self._materialize(st))
            st.par ^= 1

        def wave(_):
            q(("wave", st.par, self._use_fused),
              lambda: self._wave_pass(st, self.W, False))
            st.par ^= 1

        self._drive(wave, self.grow_budget + 2, lambda: st.flag, 1,
                    "growth")
        if self._telem:
            self._grow_n.copy_(st.num_splits.view(1))
        kb1 = self._stall_batch == 1

        def stall(_):
            q(("replay",), lambda: self._replay_pass(st))
            q(("correct", st.par), lambda: self._correct_pass(st))
            if kb1:
                st.par ^= 1

        self._drive(stall, self._corr + 3,
                    lambda: st.rctl[CTL_FLAG:CTL_FLAG + 1], FLAG_STALL,
                    "the replay")

    # -- whole tree ----------------------------------------------------------

    def _emit(self, st: WaveState):
        """Records and leaf mapping on the device (``_emit_tree_wave``):
        every speculative leaf mapped to its final ancestor by pointer
        doubling, the leaf id of every row, the leaf outputs (renewed in
        quant mode), the records in pop order (rows past the pops repeat
        slot 0 with REC_VALID = 0, as the JAX package emits them) and the
        tree's counters, packed into one float64 tensor."""
        M, L, acc, dev = self.M, self.num_leaves, self._acc, self.device
        f32 = torch.float32
        final = st.avail.to(torch.bool)
        final1 = torch.cat([final, final.new_zeros(1)])
        anc = torch.where(final1, self._iota_m1, st.parent)
        for _ in range(max(1, M.bit_length())):
            anc = anc.index_select(0, anc)
        ref = st.refidx.to(torch.int64)
        ref1 = torch.cat([ref, ref.new_zeros(1)])
        slot2ref = torch.where(final1.index_select(0, anc),
                               ref1.index_select(0, anc), 0)
        leaf_id = torch.empty_like(st.rid_p).index_copy_(
            0, st.rid_p, slot2ref.index_select(0, st.lid_p))
        leaf_out = torch.zeros(L + 1, dtype=acc, device=dev).index_copy_(
            0, torch.where(final, ref, L), st.node_f[:M, LF_OUT])[:L]
        renewed = None
        if self._quant:
            renewed, has_h = self._renew_leaf_outputs(leaf_id)
            leaf_out = torch.where(has_h, renewed, leaf_out)

        vp = self._iota_b < st.rctl[CTL_POPS]
        nd = torch.where(vp, st.poprec[:, 0].to(torch.int64), 0)
        pref = torch.where(vp, st.poprec[:, 1].to(torch.int64), 0)
        cf = st.cand_f.index_select(0, nd).to(f32)
        nf = st.node_f.index_select(0, nd).to(f32)
        ci = st.cand_i.index_select(0, nd)
        rec_f = torch.stack([
            vp.to(f32), pref.to(f32), ci[:, CI_FEAT].to(f32),
            ci[:, CI_THR].to(f32), (ci[:, CI_FLAGS] & 1).to(f32),
            cf[:, CF_GAIN], cf[:, CF_LOUT], cf[:, CF_ROUT], cf[:, CF_LCNT],
            cf[:, CF_RCNT], nf[:, LF_OUT], nf[:, LF_CNT], cf[:, CF_LSH],
            cf[:, CF_RSH], cf[:, CF_LSG], cf[:, CF_RSG],
            ((ci[:, CI_FLAGS] & 2) >> 1).to(f32)], 1)
        if renewed is not None:
            # pop i's left child keeps leaf number ref[i], its right child
            # is number i + 1 (``learner_wave.py:1966-1978``)
            lref = torch.clamp(pref, 0, L - 1)
            rref = torch.clamp(self._iota_b + 1, max=L - 1)
            val = renewed.to(f32)
            rec_f[:, REC_LEFT_OUT] = torch.where(
                vp & has_h.index_select(0, lref), val.index_select(0, lref),
                rec_f[:, REC_LEFT_OUT])
            rec_f[:, REC_RIGHT_OUT] = torch.where(
                vp & has_h.index_select(0, rref), val.index_select(0, rref),
                rec_f[:, REC_RIGHT_OUT])
        rec_i = st.cnt_i.index_select(0, nd)
        if st.cand_b is not None:
            # the popped nodes' bitsets, widened exactly (`:1896`)
            rec_i = torch.cat([rec_i, st.cand_b.index_select(0, nd)
                               .to(torch.int64) & 0xFFFFFFFF], 1)
        f64 = torch.float64
        tail = [st.counters, st.rctl[CTL_PASSES:]]
        if self._telem:
            tail += [self._grow_n, st.num_splits.view(1)]
        packed = torch.cat([rec_f.reshape(-1).to(f64),
                            rec_i.reshape(-1).to(f64)]
                           + [t.to(f64) for t in tail])
        return packed, leaf_id, leaf_out

    def train_async(self, grad: torch.Tensor, hess: torch.Tensor,
                    bag: torch.Tensor,
                    feature_mask: Optional[torch.Tensor] = None
                    ) -> AsyncTree:
        """Grow one tree with no blocking host read: the packed records
        (``host_records`` reads them), the leaf id per original row (N,)
        int64 and the leaf outputs (L,), all on the device."""
        if feature_mask is None:
            feature_mask = self._all_features
        before = (self._ring.waits, self.passes, self.graph_launches,
                  self.graph_captures)
        self._live = self.use_graphs and self._trees > 0
        st = self._init_root_wave(grad, hess, bag, feature_mask)
        self._grow_tree(st)
        packed, leaf_id, leaf_out = self._emit(st)
        self._trees += 1
        after = (self._ring.waits, self.passes, self.graph_launches,
                 self.graph_captures)
        host = dict(zip(("flag_waits", "passes", "graph_launches",
                         "graph_captures"),
                        (a - b for a, b in zip(after, before))))
        return AsyncTree(packed, leaf_id, leaf_out, host)

    def host_records(self, flat: np.ndarray, host_stats: Dict[str, int]):
        """(records (L-1, 17) float32, exact integer columns (L-1,
        rec_i_cols) int64: the bagged counts, then any bitset words) from a
        tree's packed records read to the host; its counters go to
        ``tree_stats``.  Raises if the tree ran out of slots."""
        b, nf, ni = self.budget, NUM_REC_FIELDS, self.rec_i_cols
        rec_f = flat[:b * nf].reshape(b, nf).astype(np.float32)
        rec_i = flat[b * nf:b * (nf + ni)].reshape(b, ni).astype(np.int64)
        names = DEVICE_STATS + (TELEMETRY_STATS if self._telem else ())
        dev = dict(zip(names,
                       flat[b * (nf + ni):].astype(np.int64).tolist()))
        over, err = dev.pop("slot_overflow"), dev.pop("replay_error")
        if over or err:
            raise RuntimeError("wave learner slot reserve exhausted")
        self._tree_stats.append(dict(
            dev, pops=int((rec_f[:, 0] > 0.5).sum()), **host_stats))
        return rec_f, rec_i

    def grow(self, grad: torch.Tensor, hess: torch.Tensor, bag: torch.Tensor,
             feature_mask: Optional[torch.Tensor] = None):
        """Grow one tree; returns (records (L-1, 17) f32 numpy, exact
        integer columns (L-1, rec_i_cols) int64 numpy, leaf id per original
        row (N,) int64 tensor, leaf outputs (L,) acc tensor), as the compact
        learner: one host read."""
        tree = self.train_async(grad, hess, bag, feature_mask)
        flat = tree.records.cpu().numpy()
        self.host_syncs += 1
        rec_f, rec_i = self.host_records(flat, dict(tree.host_stats,
                                                    host_syncs=1))
        return rec_f, rec_i, tree.leaf_id, tree.leaf_out

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
        kb = max(30 - int(self._dataset_rows() - 1).bit_length(), 1)
        qg = sg * (2.0 ** (3 - kb))       # sg * GMAX <= sg * 2**3
        qh = sh * (2.0 ** (4 - kb))       # sh * HMAX <= sh * 2**4
        L = self.num_leaves
        lgh = torch.zeros((2, L), dtype=torch.int64, device=self.device)
        lgh[0].index_add_(0, leaf_id, torch.round(gb / qg).to(torch.int64))
        lgh[1].index_add_(0, leaf_id, torch.round(hb / qh).to(torch.int64))
        lgh = self._global_scalar(lgh)
        lg = lgh[0].to(torch.float32) * qg
        lh = lgh[1].to(torch.float32) * qh
        has_h = lh > 0.0
        kw = self._split_kwargs
        out = calculate_leaf_output(lg, lh, kw["lambda_l1"], kw["lambda_l2"],
                                    kw["max_delta_step"]).to(torch.float32)
        return torch.where(has_h, out, 0.0), has_h


class WaveDims(NamedTuple):
    """The wave learner's shape fields, as the JAX learner sizes them."""
    budget: int         # splits of a tree, num_leaves - 1
    W: int              # members of a growth wave
    grow_budget: int    # splits growth may perform
    corr: int           # correction splits the replay may add
    M: int              # node slots
    H: int              # histogram pool slots
    stall_batch: int    # members of a correction


def wave_dims(cfg: Config, n_pad: int) -> WaveDims:
    """(``learner_wave.py:_init_wave_dims``) the slot and pool sizes for
    ``n_pad`` rows: growth performs at most ``grow_budget`` splits and the
    replay correction at most ``corr`` more, so M node slots and H pool
    slots can never overflow."""
    budget = max(int(cfg.num_leaves), 2) - 1
    ov = _resolve_overshoot(cfg, n_pad)
    grow = min(budget + int(np.ceil(budget * ov)), 2 * budget)
    corr = _correction_reserve(cfg, budget)
    return WaveDims(budget, max(1, min(int(cfg.tpu_wave_width), budget)),
                    grow, corr, 1 + 2 * (grow + corr), grow + corr + 2,
                    _resolve_stall_batch(cfg))


#: bytes per row a split pass holds beyond the (NUM_P, N) int32 member
#: table gathered per row, at its widest: the member index, the left and
#: bag masks, the float64 count codes, the new leaf ids, the partition's
#: flags, ranks and destinations, the EFB decode and the categorical
#: probe (35 to 40 measured on the CPU, ``tests/test_torch_wave.py``)
SPLIT_ROW_BYTES = 48
#: per row of a tree's root: the weighted lanes stacked and summed (20)
ROOT_ROW_BYTES = 24
#: per row of the emission: the leaf id per row and its gather (16)
EMIT_ROW_BYTES = 16
#: with quantized gradients: the float32 gradients kept for the renewal
#: (held across the tree), the root with the quantizer's temporaries (75)
#: and the emission with the renewal's (20)
QUANT_STATE_ROW_BYTES = 8
QUANT_ROOT_ROW_BYTES = 80
QUANT_EMIT_ROW_BYTES = 24
#: per row of the opening's materialization: the rows' window starts,
#: their stable sort (keys, indices, the card's radix double buffers),
#: the destinations (24 on the CPU, which has no double buffers)
MATERIALIZE_ROW_BYTES = 60
#: (K, F, B, 3) child histogram batches live in a split pass: the smaller
#: children (1), the parents' pool rows (1), the larger children (1), the
#: left and right children (2), both interleaved for the scan (2) and
#: FixHistogram's two rewrites of those (4)
CHILD_HIST_BATCHES = 11

#: the state's terms in ``wave_transient_bytes``
STATE_TERMS = ("lane_bytes", "bins_bytes", "hist_pool_bytes",
               "node_table_bytes", "quant_state_bytes")
#: its passes replayed as CUDA graphs (their transients share the graphs'
#: private pool) and those run eagerly every tree (the allocator's pool)
GRAPHED_PASSES = ("split_pass_bytes", "materialize_pass_bytes",
                  "replay_pass_bytes")
EAGER_PASSES = ("root_pass_bytes", "emit_pass_bytes")


def wave_transient_bytes(cfg: Config, n_pad: int, f_pad: int, b: int,
                         categorical: bool = False,
                         hist_cols: Optional[int] = None) -> dict:
    """The device bytes the port's wave learner holds for one tree at
    ``n_pad`` rows, ``f_pad`` packed columns, ``hist_cols`` histogram
    columns (the used features or EFB groups; ``f_pad`` if not given) and
    ``b`` histogram bins: its state, allocated once (the two lane sets,
    the codes and packed words, the histogram pool, the node tables), plus
    the widest of its passes that replay as CUDA graphs and the widest of
    those that run eagerly (the root and the emission): the two sets of
    transients live in different pools, and a pass's temporaries are
    freed before the next pass starts.  No leaf lookup: the JAX package's
    formula counts an (N, M) one-hot lookup table
    (``learner_wave.py:wave_transient_bytes``) that the port never builds,
    as it gathers.  ``tests/test_torch_wave.py`` holds each term against a
    CPU learner's tensors; ``chip_smoke.py`` phase ``wave_4095`` and
    ``profiling/wave_memory.py`` hold the total against the card's peak
    over a tree."""
    from .ops.hist_full import SMS
    from .ops.hist_multislot import multislot_plan
    from .ops.hist_packed import packed_plan
    from .ops.hist_segments import segment_grid
    from .ops.replay import replay_plan
    from .ops.split_cat import cat_words

    d = wave_dims(cfg, n_pad)
    acc = 8 if (cfg.gpu_use_dp or cfg.tpu_double_precision) else 4
    k = max(d.W, d.stall_batch)
    cols = f_pad if hist_cols is None else int(hist_cols)
    unit = f_pad * b * 3                     # one kernel output, entries
    m1 = d.M + 1
    node_cols = 2 * 8 + NUM_LF * acc + NUM_CF * acc + NUM_CI * 8 \
        + 3 * 8 + 1 + 2 * 8 + (cat_words(b) * 4 if categorical else 0)
    node = m1 * node_cols + d.M * (1 + 4) + d.budget * 2 * 4 \
        + 2 * 8 + NUM_ST * 8 + 4 + NUM_CTL * 4 + d.stall_batch * 9 + f_pad
    fw = f_pad // 4
    plan = packed_plan(fw, n_pad, b)
    packed = unit * (1 + (plan.nchunks if plan.nchunks > 1 else 0)) * 4
    segments = (segment_grid(n_pad, SMS) + k) * unit * 4
    ol = int(getattr(cfg, "tpu_wave_open_levels", -1))
    ol = max(0, min(ol, (d.budget + 1).bit_length() - 1))
    multislot = 0
    for lvl in range(ol):
        ks = min(1 << lvl, d.W)
        ms = multislot_plan(fw, ks, n_pad, b)
        multislot = max(multislot, ks * unit * 4 * (
            1 + (ms.nchunks if ms.nchunks > 1 else 0)))
    quant = str(getattr(cfg, "tpu_quantized_grad", "auto")) == "on" \
        and quant_ineligible_reason(n_pad, acc == 8) is None
    out = {"lane_bytes": 2 * n_pad * (f_pad + 12 + 8 + 4) + 4 * n_pad,
           "bins_bytes": 2 * n_pad * f_pad,
           "hist_pool_bytes": (d.H + 1) * cols * b * 3 * acc,
           "node_table_bytes": node,
           "quant_state_bytes": n_pad * QUANT_STATE_ROW_BYTES if quant
           else 0,
           "split_pass_bytes": n_pad * (NUM_P * 4 + SPLIT_ROW_BYTES)
           + CHILD_HIST_BATCHES * k * unit * acc + max(segments, multislot),
           "materialize_pass_bytes": n_pad * MATERIALIZE_ROW_BYTES if ol
           else 0,
           "replay_pass_bytes": replay_plan(d.M, d.budget).scratch,
           "root_pass_bytes": n_pad * (QUANT_ROOT_ROW_BYTES if quant
                                       else ROOT_ROW_BYTES) + packed,
           # (its per-node temporaries, the ancestors and the records,
           # stay below the node tables' size)
           "emit_pass_bytes": n_pad * (QUANT_EMIT_ROW_BYTES if quant
                                       else EMIT_ROW_BYTES) + node}
    out["total_bytes"] = sum(out[t] for t in STATE_TERMS) \
        + max(out[t] for t in GRAPHED_PASSES) \
        + max(out[t] for t in EAGER_PASSES)
    return out


def wave_budget_reason(cfg: Config, n_pad: int, f_pad: int, b: int,
                       categorical: bool = False,
                       hist_cols: Optional[int] = None) -> Optional[str]:
    """Shape and byte-budget gates of the wave learner: the port's own
    byte estimate (``wave_transient_bytes``) against
    ``tpu_wave_max_bytes``."""
    if f_pad // 4 > 64:
        return f"{f_pad} padded columns > 256 (per-row word extraction is " \
               "a masked sum over words)"
    total = wave_transient_bytes(cfg, n_pad, f_pad, b, categorical,
                                 hist_cols)["total_bytes"]
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
        cols = bundle.num_groups
    else:
        f_pad = data.bins.shape[0]
        b = int(data.max_num_bin)
        cols = data.num_used_features
    _, _, _, is_cat = data.feature_meta_arrays()
    return wave_budget_reason(cfg, int(data.num_data_padded), f_pad, b,
                              bool(is_cat.any()), cols)
