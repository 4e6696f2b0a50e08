"""Data-parallel and voting-parallel compact learners over row shards.

Port of ``lightgbm_tpu/parallel/compact_sharded.py``
(``DataParallelTreeLearner``, `data_parallel_tree_learner.cpp:49-254`):
every rank owns a row shard and grows the compact learner's tree over its
LOCAL rows (the windowed partition, the root and the smaller child's
histograms are the serial learner's kernels on the shard), with two
exchanges per split, as the JAX shard body makes them:

  * histograms: the local (F, B, 3) histogram is reduce-scattered over the
    padded feature axis (``Mesh.psum_scatter``), so each rank sums, pools
    and scans one feature slice (`data_parallel_tree_learner.cpp:146-161`);
  * best split: each rank scans its slice (the feature metadata of the
    slice handed to ``split_scan`` / ``split_cat`` through their
    arguments), packs its winner into fixed-width rows, and one all-gather
    plus an argmax picks the global winner (``SyncUpGlobalBestSplit``,
    `parallel_tree_learner.h:186-209`).  Ties break toward the lowest
    global feature index: slices are contiguous and ascending in rank.

Leaf sums and bagged counts are summed over the shards; every other value
the tree's control reads is replicated, so every rank writes the same
records and assembles the same host tree.  The windowed partition's mode
(mask or sort) is chosen per rank from its own window: it moves only that
rank's rows and changes no histogram, count or decision.

``ShardedVotingLearner`` is PV-Tree (`voting_parallel_tree_learner.cpp:
166-345`): the pool stays local and unreduced; per child each rank votes
its local top-``top_k`` features, one all-gather of the votes elects the
global top-2k (low index breaking ties), and only the elected features'
histograms are reduce-scattered and scanned.

The sharded learners run their steps eagerly (no CUDA graph): a gloo
collective cannot be captured, and NCCL's would pin the group to the
graph; ``graph_launches`` stays 0.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..config import Config
from ..dataset import _ConstructedDataset
from ..learner import CF_GAIN, CI_FEAT
from ..learner_compact import CompactTreeLearner
from ..ops.hist_packed import ROW_QUANTUM, pack_bin_words
from ..ops.quant import exchange_tier, pack_hist_words, unpack_hist_words
from .sharding import Mesh, row_axis


class ShardedSeams:
    """The collectives at the serial learners' seams for row-sharded data
    (a mixin ahead of the serial learner in the MRO).  Subclasses set the
    axes and the feature slice; ``self.mesh`` is the rank grid."""

    _supports_bundle = False
    #: the ``rules_for_mode`` table this learner rides
    _placement_mode = "data"
    #: the fused child-scan kernel reads the pool and the reduced smaller
    #: children, both of the rank's feature slice
    _fused_sharded = True

    def __init__(self, cfg: Config, data: _ConstructedDataset, mesh: Mesh,
                 device: torch.device, **kw):
        self.mesh = mesh
        self._set_geometry(data)
        super().__init__(cfg, data, device, **kw)
        self.use_graphs = False
        self._use_fused = getattr(self, "_use_fused", False) \
            and self._fused_sharded
        self._hist_cols = self._local_cols
        self._pool_cols = self.fs
        self._init_meta()

    # -- geometry ------------------------------------------------------------

    def _set_geometry(self, data: _ConstructedDataset) -> None:
        """1-D data mode: rows over the mesh, the reduced histogram's
        features over the same ranks."""
        self.axis = row_axis(self.mesh)
        self.D = self.mesh.axis_size(self.axis)
        self.row_shards = self.D
        n = int(data.num_data_padded)
        if n % self.D:
            raise ValueError(f"padded rows {n} not divisible by mesh size "
                             f"{self.D}")
        self.f_pad = int(data.bins.shape[0])
        if self.f_pad % self.D:
            raise ValueError(f"padded features {self.f_pad} not divisible "
                             f"by mesh size {self.D}")
        self.fs = self.f_pad // self.D           # scanned features per rank
        self._local_cols = self.f_pad            # columns of a local hist
        self.f_off = self.mesh.axis_index(self.axis) * self.fs

    def _local_rows(self) -> int:
        """Rows of the lanes: this rank's block of the rows (ceil(N / ranks),
        the row rule's block) padded to the kernels' row quantum with rows
        that are in no bag, as the dataset pads its rows."""
        k = -(-self.n_global // self.row_shards)
        return -(-k // ROW_QUANTUM) * ROW_QUANTUM

    def _dataset_rows(self) -> int:
        return self.n_global

    def _row_range(self):
        """This rank's rows of the padded dataset (its block under the row
        rule of ``rules_for_mode``)."""
        n, d = self.n_global, self.row_shards
        k = -(-n // d)
        i = self.mesh.axis_index(self.axis) if d > 1 else 0
        lo = min(i * k, n)
        return lo, min(lo + k, n)

    def _code_rows(self) -> np.ndarray:
        """The feature rows of the bin codes this rank holds."""
        return self.data.bins

    def _codes(self) -> np.ndarray:
        """The bin codes this rank's lanes hold: its feature rows of its
        rows, then code 0 on the padding rows."""
        lo, hi = self._row_range()
        codes = self._code_rows()[:, lo:hi]
        if hi - lo < self.n_pad:
            codes = np.concatenate([codes, np.zeros(
                (codes.shape[0], self.n_pad - (hi - lo)), codes.dtype)], 1)
        return codes

    def train_async(self, grad, hess, bag, feature_mask=None):
        """The serial learner's tree on this rank's rows (grad, hess, bag
        of its block; the lanes' padding rows in no bag), its leaf ids cut
        back to the block."""
        lo, hi = self._row_range()
        pad = self.n_pad - (hi - lo)
        if pad:
            grad, hess, bag = (torch.cat([a, a.new_zeros(pad)])
                               for a in (grad, hess, bag))
        tree = super().train_async(grad, hess, bag, feature_mask)
        return tree._replace(leaf_id=tree.leaf_id[:hi - lo])

    def bins_packed(self) -> torch.Tensor:
        if self._bins_packed is None:
            src = torch.from_numpy(np.ascontiguousarray(self._codes()))
            self._bins_packed = pack_bin_words(src.to(self.device))
        return self._bins_packed

    # -- the feature metadata of the scanned slice ---------------------------

    def _init_meta(self) -> None:
        """Feature metadata padded to f_pad (padding features have no bins,
        no mask and never win), whole and as this rank's slice."""
        f, fp = self.num_features, self.f_pad
        dev = self.device

        def pad(a, fill=0):
            out = np.full(fp, fill, dtype=a.dtype)
            out[:f] = a
            return out

        _, _, _, is_cat = self.data.feature_meta_arrays()
        full = dict(num_bin=pad(self.np_num_bin), missing=pad(self.np_missing),
                    default_bin=pad(self.np_default_bin),
                    monotone=pad(self.np_monotone),
                    penalty=pad(self.f_penalty.cpu().numpy()
                                if self.has_penalty
                                else np.ones(f, np.float32), 1.0),
                    is_cat=pad(is_cat.astype(bool), False))
        self._meta_full = self._meta_of(full, 0, fp)
        self._meta_slice = self._meta_of(full, self.f_off, self.f_off + self.fs)
        self._fmask_pad = torch.zeros(fp, dtype=torch.bool, device=dev)

    def _meta_of(self, full, lo: int, hi: int) -> dict:
        dev = self.device
        t = {k: torch.from_numpy(np.ascontiguousarray(v[lo:hi])).to(dev)
             for k, v in full.items()}
        is_cat = full["is_cat"][lo:hi]
        meta = dict(f_num_bin=t["num_bin"], f_missing=t["missing"],
                    f_default_bin=t["default_bin"],
                    f_monotone=t["monotone"] if self.has_monotone else None,
                    f_penalty=t["penalty"] if self.has_penalty else None,
                    has_categorical=bool(is_cat.any()))
        if meta["has_categorical"]:
            meta.update(_is_cat_t=t["is_cat"], _num_mask=~t["is_cat"],
                        _cat_cols=torch.from_numpy(np.flatnonzero(is_cat)
                                                   .astype(np.int32)).to(dev))
        return meta

    def _padded_mask(self, feature_mask: torch.Tensor) -> torch.Tensor:
        """The tree's (F,) feature mask on the padded feature axis."""
        fm = self._fmask_pad.clone()
        fm[:self.num_features] = feature_mask
        return fm

    @contextlib.contextmanager
    def _meta_scope(self, meta: dict):
        saved = {k: getattr(self, k, None) for k in meta}
        saved["has_categorical"] = self.has_categorical
        for k in ("_is_cat_t", "_num_mask", "_cat_cols"):
            saved.setdefault(k, getattr(self, k, None))
        try:
            for k, v in meta.items():
                setattr(self, k, v)
            yield
        finally:
            for k, v in saved.items():
                setattr(self, k, v)

    @contextlib.contextmanager
    def _scan_scope(self, feature_mask=None):
        """The split scan sees this rank's feature slice: its metadata and
        its part of the tree's feature mask."""
        if feature_mask is None:
            feature_mask = self._st.fmask
        fm = self._padded_mask(feature_mask)[self.f_off:self.f_off + self.fs]
        with self._meta_scope(self._meta_slice):
            yield fm

    # -- exchange seams ------------------------------------------------------

    def _coll(self, op: str, x: torch.Tensor, axis, **kw) -> torch.Tensor:
        """Issue one mesh collective and record its site."""
        self._rec_coll(op, x)
        return getattr(self.mesh, op)(x, axis, **kw)

    def _global_scalar(self, v):
        return self._coll("psum", v, self.axis)

    def _global_max(self, v):
        return self._coll("pmax", v, self.axis)

    def _sync_counts(self, lc_bag, c_bag):
        # exact integer counts, sent as int32 as the JAX seam sends them
        return tuple(self._coll("psum", c.to(torch.int32), self.axis)
                     .to(c.dtype) for c in (lc_bag, c_bag))

    def _sync_counts3(self, counts):
        return self._coll("psum", counts.to(torch.int32), self.axis) \
            .to(counts.dtype)

    def _replicated_spans(self, spans):
        return self._coll("pmax", spans.to(torch.int32), self.axis) \
            .to(spans.dtype)

    def _global_row_offset(self) -> int:
        return self._row_range()[0]

    def _reduce_hist(self, local_hist):
        return self._exchange(local_hist, 0)

    def _reduce_hist_batch(self, local_hists):
        return self._exchange(local_hists, 1)

    def _wire_words(self) -> bool:
        """Quantized histograms travel as integer units (the JAX int16
        tier) when every reduced channel provably fits 16 bits."""
        return bool(self._quant) and exchange_tier(self.n_global) == "int16"

    def _exchange(self, h: torch.Tensor, dim: int) -> torch.Tensor:
        """One histogram reduce-scatter over the data axis.  On the int16
        tier the gradient and hessian units of a bin travel packed in one
        int32 word (``ops/quant.py:pack_hist_words``; neither gloo nor NCCL
        reduces int16), the count channel rebuilt from the hessian units:
        the floats are bitwise the serial learner's."""
        if self._wire_words():
            sg, sh = self._q_scales
            words = pack_hist_words(h, 1.0 / sg, 1.0 / sh)
            words = self._coll("psum_scatter", words, self.axis, dim=dim)
            return unpack_hist_words(words, sg, sh, 1.0 / self._q_mbar)
        return self._coll("psum_scatter", h, self.axis, dim=dim)

    # -- the exchange-window probe ------------------------------------------

    def _unledgered(self, op: str, axis, **kw):
        """A mesh collective ``fn(x)`` that stays out of the mesh's counters
        and the ledger: the probe measures the seam, it is not the run's."""
        def fn(x):
            saved = (self.mesh.calls, self.mesh.bytes, self.mesh.seconds)
            try:
                return getattr(self.mesh, op)(x, axis, **kw)
            finally:
                self.mesh.calls, self.mesh.bytes, self.mesh.seconds = saved
        return fn

    def exchange_probe(self):
        """(fn, args): the seam's representative collective for
        ``SampledSync.probe_exchange`` (JAX ``compact_sharded.py:544``),
        the root histogram's reduce-scatter over the data axis on a zero
        (F, B, 3) buffer."""
        h = torch.zeros((self._local_cols, self.num_bins_padded, 3),
                        dtype=self._acc, device=self.device)
        return self._unledgered("psum_scatter", self.axis, dim=0), (h,)

    # -- the global best split ----------------------------------------------

    def _cand_rows(self, hist, sum_g, sum_h, cnt, feature_mask, depth_ok,
                   min_c=None, max_c=None):
        """(K, fs, B, 3) reduced histograms of this rank's slice -> the
        replicated per-leaf best rows."""
        with self._scan_scope(feature_mask) as fm:
            c = self._feature_cands(hist, sum_g, sum_h, cnt, fm, min_c, max_c)
            cf, ci, cb = self._pack_cands(c, depth_ok)
        return self._merge_cands(cf, ci, cb)

    def _gather_rows(self, cf, ci, cb, axis):
        """One all-gather each of the fixed-width winner rows (the bitset
        rows too, zeros without categorical features, as the JAX seam
        sends them)."""
        if cb is None:
            cb = torch.zeros((cf.shape[0], self.cat_W), dtype=torch.int32,
                             device=cf.device)
        return (self._coll("all_gather", cf, axis),
                self._coll("all_gather", ci.to(torch.int32), axis)
                .to(torch.int64),
                self._coll("all_gather", cb, axis))

    def _merge_cands(self, cf, ci, cb, lowest_feature: bool = False):
        """This rank's winners -> the global ones: the slice's feature index
        made global, all rows gathered, the argmax over ranks; with
        ``lowest_feature`` an explicit lowest-feature tie-break (slices not
        ascending in gathered order)."""
        ci = torch.cat([ci[:, :1] + self.f_off, ci[:, 1:]], 1)
        cf_all, ci_all, cb_all = self._gather_rows(cf, ci, cb,
                                                   self._merge_axis())
        return self._pick_winner(cf_all, ci_all, cb_all, lowest_feature)

    def _merge_axis(self):
        return self.axis

    def _pick_winner(self, cf_all, ci_all, cb_all, lowest_feature):
        gains = cf_all[:, :, CF_GAIN]                        # (D, K)
        if lowest_feature:
            at_max = gains == gains.max(0, keepdim=True).values
            feat = torch.where(at_max, ci_all[:, :, CI_FEAT], 1 << 40)
            win = torch.argmin(feat, 0)
        else:
            win = torch.argmax(gains, 0)                     # first max
        k = torch.arange(gains.shape[1], device=gains.device)
        cb = cb_all[win, k]
        return cf_all[win, k], ci_all[win, k], \
            cb if self.has_categorical else None

    # -- forced splits -------------------------------------------------------

    def _forced_hist(self, st, i: int) -> torch.Tensor:
        """(F, B, 3) histogram of forced split ``i``'s leaf with its
        feature's row from the rank that pools it (a masked psum, as JAX
        ``_forced_hrow``; the other rows are zero and unread)."""
        fs = self._forced[i]
        fi = fs.feature_inner
        owner, loc = divmod(fi, self.fs)
        mine = owner == self.mesh.axis_index(self.axis)
        row = st.hist_pool[fs.leaf, loc if mine else 0] * float(mine)
        row = self._coll("psum", row, self.axis)
        hist = torch.zeros((self.num_features,) + tuple(row.shape),
                           dtype=row.dtype, device=row.device)
        hist[fi] = row
        return hist

    def _forced_step(self, st, i: int) -> None:
        lrow = st.leaf_f[self._forced[i].leaf]
        cf, ci, cb, valid = self._forced_rows(i, self._forced_hist(st, i),
                                              lrow)
        self._split_step(st, forced=(i, cf, ci, cb, valid & ~st.aborted))
        st.aborted |= ~valid


class ShardedCompactLearner(ShardedSeams, CompactTreeLearner):
    """``tree_learner=data`` on the compact learner: one row shard per
    rank, histograms reduce-scattered over the features."""


class VotingSeams:
    """PV-Tree voting (see the module docstring), for the compact and the
    wave learner; the pool is the rank's local, unreduced histograms."""

    _placement_mode = "voting"
    _fused_sharded = False

    def _init_voting(self, cfg: Config) -> None:
        self._pool_cols = self.f_pad
        k2 = max(2 * int(cfg.top_k), self.D)
        k2 = min(((k2 + self.D - 1) // self.D) * self.D, self.f_pad)
        self.k_vote = min(int(cfg.top_k), self.f_pad)
        self.k2 = k2
        self.k2s = k2 // self.D              # elected features per rank

    def _reduce_hist(self, local_hist):
        return local_hist

    def _reduce_hist_batch(self, local_hists):
        return local_hists

    def _forced_hist(self, st, i: int) -> torch.Tensor:
        # the pool row of the forced feature, summed over the shards
        fs = self._forced[i]
        row = self._coll("psum", st.hist_pool[fs.leaf, fs.feature_inner],
                         self.axis)
        hist = torch.zeros((self.num_features,) + tuple(row.shape),
                           dtype=row.dtype, device=row.device)
        hist[fs.feature_inner] = row
        return hist

    def _cand_rows(self, hist, sum_g, sum_h, cnt, feature_mask, depth_ok,
                   min_c=None, max_c=None):
        """(K, f_pad, B, 3) local histograms -> the replicated best rows:
        LocalVoting, GlobalVoting, the elected features' exchange and scan,
        the global winner (lowest feature index on ties)."""
        k, fp, d = hist.shape[0], self.f_pad, self.mesh.axis_index(self.axis)
        fm = self._padded_mask(feature_mask)
        # ---- LocalVoting: rank features on this rank's rows, the local
        # totals read off feature 0's bins
        loc = hist[:, 0].sum(1)                               # (K, 3)
        with self._meta_scope(self._meta_full):
            # (no value bounds in the vote, as JAX ``LocalVoting``)
            g_loc = self._feature_cands(hist, loc[:, 0], loc[:, 1],
                                        loc[:, 2], fm).gain
        # lax.top_k's order: gain descending, the lower index first on ties
        vals, votes = torch.sort(g_loc, dim=1, descending=True, stable=True)
        vals, votes = vals[:, :self.k_vote], votes[:, :self.k_vote]
        all_votes = self._coll("all_gather", votes.to(torch.int32),
                               self.axis).to(torch.int64)
        all_vals = self._coll("all_gather", vals, self.axis)
        valid = ~torch.isneginf(all_vals)                      # (D, K, k)
        counts = torch.zeros((k, fp), dtype=torch.int64, device=hist.device)
        counts.scatter_add_(1, all_votes.permute(1, 0, 2).reshape(k, -1),
                            valid.permute(1, 0, 2).reshape(k, -1)
                            .to(torch.int64))
        # ---- GlobalVoting: top-2k by count, the lower index on ties
        score = counts * fp - torch.arange(fp, device=hist.device)
        sel = torch.sort(torch.argsort(score, dim=1, descending=True,
                                       stable=True)[:, :self.k2], 1).values
        # ---- CopyLocalHistogram: only the elected features' histograms
        # cross the wire, then this rank scans its part of them
        idx = sel[:, :, None, None].expand(-1, -1, hist.shape[2], 3)
        red = self._exchange(torch.gather(hist, 1, idx), 1)   # (K, k2s, B, 3)
        mine = sel[:, d * self.k2s:(d + 1) * self.k2s]
        full = torch.zeros_like(hist)
        full.scatter_(1, mine[:, :, None, None].expand_as(red), red)
        elected = torch.zeros((k, fp), dtype=torch.bool, device=hist.device)
        elected.scatter_(1, mine, True)
        with self._meta_scope(self._meta_full):
            c = self._feature_cands(full, sum_g, sum_h, cnt,
                                    elected & fm[None, :], min_c, max_c)
            cf, ci, cb = self._pack_cands(c, depth_ok)
        cf_all, ci_all, cb_all = self._gather_rows(cf, ci, cb, self.axis)
        return self._pick_winner(cf_all, ci_all, cb_all, True)


class ShardedVotingLearner(VotingSeams, ShardedCompactLearner):
    """``tree_learner=voting`` on the compact learner."""

    def __init__(self, cfg: Config, data: _ConstructedDataset, mesh: Mesh,
                 device: torch.device, **kw):
        super().__init__(cfg, data, mesh, device, **kw)
        self._init_voting(cfg)

