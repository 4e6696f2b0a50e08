"""GBDT: the boosting loop, synchronous and pipelined.

Port of ``lightgbm_tpu/boosting/gbdt.py`` (``GBDT::TrainOneIter``,
`gbdt.cpp:333-413`): boost-from-average, gradients, bagging, feature
sampling, one tree per class, shrinkage, score updates for the training and
validation sets, metric output with early-stopping bookkeeping, and model
text.  The scores live on the booster's device as
(K, N_pad) float32; the gradients of every class come from one call per
iteration (``_gradients``: multiclass softmax's jointly over the (K, N_pad)
score); the training score is updated from the learner's leaf partition,
the validation scores by a device traversal of the new tree over the
validation set's bin codes.  An objective that renews its leaves (L1,
quantile, MAPE) reads the class's score and the tree's leaf ids to the host
once per tree, renews the host tree, and the training score is updated from
the renewed host leaf values.  ``Booster.predict`` routes as the JAX
package's does: a batch with rows x trees >= 200,000, or any call with
``pred_early_stop``, goes to ``predictor.DevicePredictor`` on the booster's
device (text-loaded boosters through a bin schema rebuilt from the model
text), a smaller batch walks the host trees (``Tree.predict``, numpy).

The loop pipelines under the JAX package's conditions (``_can_pipeline``: a
variant that allows it, no validation set, no leaf renewal, every class
trained, a learner with ``train_async``): each tree is grown with no
blocking host read, the training score is updated on the device from the
learner's leaf partition
(``score + float32(lr) * leaf_out[leaf_id]`` rounded once, as XLA fuses the
JAX ``_score_add_leaf``), the
packed records go to pinned host memory without blocking, and host trees
are assembled lazily, ``tpu_pipeline_flush_depth`` iterations behind
(``_flush_pending``, also whenever ``models`` is read), with the deferred
stop check and the rollback of post-stop trees out of the training score.
The JAX package's fused path (one XLA program per iteration) is the same
sequence in eager torch and is this path.  Every learner of the port has
``train_async``.

Telemetry (``telemetry=true``, JAX `gbdt.py:259-263, 333-400, 512-632`):
``train_one_iter`` times the ``iteration`` phase (the report's
``iterations`` ring) and, inside it, ``gradients``, ``bagging``,
``tree_train`` (synchronous loop), ``tree_dispatch`` (pipelined),
``score_update`` and ``pipeline_flush`` (with a ``tree_assemble`` span per
queued tree when a tracer is attached); ``telemetry_sync_every=N``
brackets every Nth iteration with device syncs
(``observability/attribution.py``); the learners' per-tree counters feed
the report's device counters (``get_telemetry``).  With telemetry off the
timers are inert and the device work is unchanged.

The hooks the variants (``goss.py``, ``dart.py``, ``rf.py``) and the engine
stand on, as the JAX ``GBDT`` has them: ``train_one_iter`` takes external
gradients (a custom objective's), padded and uploaded once; ``_sample``
sits between the gradients and the trees in both loops (bagging here,
GOSS's selection in its subclass); the host bag mask is built lazily
(``_np_bag``); every in-place edit of a tree bumps ``_model_version``,
which keys the cached ``DevicePredictor``; ``_add_tree_score_train``
traverses the training rows' codes on the device (DART's drops,
``rollback_one_iter``, continued training); ``refit_leaf_preds`` and
``dump_model`` are the JAX package's.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..binning import BIN_CATEGORICAL, kEpsilon
from ..config import Config
from ..dataset import Dataset, _ConstructedDataset, upload
from ..learner import TreeLearner
from ..learner_compact import create_tree_learner
from ..parallel.sharding import PARALLEL_MODES
from ..metrics import Metric
from ..objectives import ObjectiveFunction, create_objective
from ..observability import SampledSync, Telemetry, force_sync
from ..ops.histogram import read_codes
from ..ops.split import calculate_leaf_output
from ..tree import Tree

K_MODEL_VERSION = "v2"
#: rows x trees from which ``predict_raw`` traverses on the device
DEVICE_PREDICT_MIN_WORK = 200_000


class ScoreUpdater:
    """Running raw scores for one dataset (`src/boosting/score_updater.hpp`),
    (K, N_pad) float32 on ``device``."""

    def __init__(self, data: _ConstructedDataset, num_class: int,
                 device: torch.device):
        self.data = data
        self.device = device
        self.num_class = num_class
        self.num_data = data.num_data
        score = np.zeros((num_class, data.num_data_padded), dtype=np.float32)
        self.has_init_score = False
        init = data.metadata.init_score
        if init is not None:
            self.has_init_score = True
            init = np.asarray(init, dtype=np.float32)
            if len(init) == self.num_data * num_class:
                score[:, :self.num_data] = init.reshape(num_class,
                                                        self.num_data)
            else:
                score[:, :self.num_data] = init[None, :self.num_data]
        self.score = upload(score, device)

    def add_constant(self, val: float, class_id: int) -> None:
        self.score[class_id] += float(np.float32(val))

    def add_by_leaf_id(self, leaf_values: torch.Tensor,
                       leaf_id: torch.Tensor, class_id: int) -> None:
        """Train-side update: the (shrunk, float32) leaf values gathered by
        the learner's final leaf partition (`score_updater.hpp:74-96`)."""
        self.score[class_id] += leaf_values[leaf_id]

    def add_by_tree(self, tree: Tree, class_id: int) -> None:
        """Valid-side update: traverse the tree over this dataset's bin
        codes on the device (`score_updater.hpp:97-105`)."""
        if tree.num_leaves <= 1:
            self.add_constant(float(tree.leaf_value[0]), class_id)
            return
        self.score[class_id] += traverse_tree_binned(self.data, tree,
                                                     self.device)

    def np_score(self) -> np.ndarray:
        """(n, K) raw scores on the host (unpadded)."""
        s = self.score[:, :self.num_data].cpu().numpy()
        return s.T if self.num_class > 1 else s[0]


def rebind_tree_to_dataset(tree: Tree, data) -> None:
    """Reconstruct the inner (bin-space) split fields of a deserialized
    tree: ``split_feature_inner`` / ``threshold_in_bin`` are not part of the
    model text format (`src/io/tree.cpp:207-240`); the reference rebuilds
    them on load the same way (real feature index -> used-feature slot, real
    threshold -> bin via the mapper's upper bounds)."""
    if not getattr(tree, "needs_rebind", False):
        return
    from ..tree import _in_bitset

    real2inner = {int(j): k for k, j in enumerate(data.used_feature_map)}
    tree._cat_bitsets_inner = {}
    for nd in range(tree.num_leaves - 1):
        real = int(tree.split_feature[nd])
        inner = real2inner.get(real)
        if inner is None:
            raise ValueError(
                f"Model splits on feature {real} which is trivial/unused in "
                "the training data; cannot continue training on this dataset")
        tree.split_feature_inner[nd] = inner
        if not (tree.decision_type[nd] & 1):  # numerical
            tree.threshold_in_bin[nd] = data.bin_mappers[inner].value_to_bin(
                float(tree.threshold[nd]))
        else:
            # categorical: rebuild the inner (bin-space) bitset from the
            # stored category-value bitset via the mapper
            cat_idx = int(tree.threshold[nd])
            tree.threshold_in_bin[nd] = cat_idx
            lo, hi = tree.cat_boundaries[cat_idx], \
                tree.cat_boundaries[cat_idx + 1]
            mapper = data.bin_mappers[inner]
            bins = {mapper.categorical_2_bin[c]
                    for c in mapper.categorical_2_bin
                    if c >= 0 and _in_bitset(tree.cat_threshold, lo, hi, c)}
            tree._cat_bitsets_inner[cat_idx] = bins
    tree.needs_rebind = False


def traverse_tree_binned(data: _ConstructedDataset, tree: Tree,
                         device: torch.device) -> torch.Tensor:
    """Inner-bin traversal (``NumericalDecisionInner``, `tree.h:233-249`;
    ``CategoricalDecisionInner``, `tree.h:270-277`, a probe of the node's
    bin bitset, as the JAX ``_traverse_jit``) of every row of a binned
    dataset; returns each row's leaf value (float32).  The per-node arrays
    go to the device in non-blocking uploads."""
    ni = tree.num_leaves - 1
    num_bin, missing, default_bin, _ = data.feature_meta_arrays()
    feat = tree.split_feature_inner[:ni].astype(np.int64)
    is_cat = (tree.decision_type[:ni] & 1) != 0
    nodes = np.stack([
        feat, tree.threshold_in_bin[:ni], missing[feat], default_bin[feat],
        num_bin[feat] - 1, (tree.decision_type[:ni] & 2) != 0,
        tree.left_child[:ni], tree.right_child[:ni], is_cat]) \
        .astype(np.int64)
    nodes = upload(nodes, device)
    leaf_value = upload(tree.leaf_value[:tree.num_leaves].astype(np.float32),
                        device)
    feat_d, thr, mt, dbin, nanbin, dleft, left, right, cat_d = nodes
    cat_bits = None
    if is_cat.any():
        # the inner (bin-space) bitsets, (ni, W) words
        w = (int(data.max_num_bin) + 31) // 32
        words = np.zeros((ni, w), np.int64)
        inner = getattr(tree, "_cat_bitsets_inner", {})
        for nd in np.flatnonzero(is_cat):
            for b in inner.get(int(tree.threshold_in_bin[nd]), ()):
                words[nd, b // 32] |= 1 << (b % 32)
        cat_bits = upload(words.reshape(-1), device)
    bins = data.device_bins(device)
    n = bins.shape[1]
    rows = torch.arange(n, device=device)
    node = torch.zeros(n, dtype=torch.int64, device=device)
    for _ in range(int(tree.leaf_depth[:tree.num_leaves].max())):
        nd = torch.clamp(node, min=0)        # leaves are encoded negative
        fv = read_codes(bins, (feat_d[nd], rows))
        m = mt[nd]
        is_missing = ((m == 1) & (fv == dbin[nd])) | \
                     ((m == 2) & (fv == nanbin[nd]))
        go_left = torch.where(is_missing, dleft[nd] != 0, fv <= thr[nd])
        if cat_bits is not None:
            word = cat_bits[nd * w + torch.clamp(fv >> 5, max=w - 1)]
            go_left = torch.where(cat_d[nd] != 0,
                                  ((word >> (fv & 31)) & 1) == 1, go_left)
        nxt = torch.where(go_left, left[nd], right[nd])
        node = torch.where(node < 0, node, nxt)
    leaf = torch.where(node < 0, ~node, 0)
    return leaf_value[leaf]


class GBDT:
    """Reference `src/boosting/gbdt.h:24`: the synchronous loop."""

    name = "gbdt"
    #: DART edits earlier trees every iteration and turns the pipeline off
    _supports_pipeline = True

    def __init__(self, cfg: Config, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.iter_ = 0
        # queued pipelined trees: (model index, host records, their copy's
        # event, the learner's host counters, the iteration's init score
        # and shrinkage rate)
        self._pending: List[tuple] = []
        self._stopped = False
        #: bumped by every in-place edit of a tree (DART, rollback, refit):
        #: part of the cached DevicePredictor's key
        self._model_version = 0
        self._models: List[Optional[Tree]] = []
        self.train_data: Optional[_ConstructedDataset] = None
        self.objective: Optional[ObjectiveFunction] = None
        self.num_tree_per_iteration = 1
        self.shrinkage_rate = cfg.learning_rate
        self.max_feature_idx = 0
        self.label_idx = 0
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self.learner: Optional[TreeLearner] = None
        self.train_score: Optional[ScoreUpdater] = None
        self.valid_scores: List[ScoreUpdater] = []
        self.valid_names: List[str] = []
        self.training_metrics: List[Metric] = []
        self.valid_metrics: List[List[Metric]] = []
        self.best_score: List[List[float]] = []
        self.best_iter: List[List[int]] = []
        self.best_msg: List[List[str]] = []
        self.class_need_train: List[bool] = []
        # the JAX package's host draws, so the bag and feature masks are the
        # same numbers in both packages
        self._bag_rng = np.random.RandomState(cfg.bagging_seed)
        self._feat_rng = np.random.RandomState(cfg.feature_fraction_seed)
        self.average_output = False
        self.pandas_categorical = None
        self.eval_history: Dict[str, Dict[str, List[float]]] = {}
        self.host_syncs = 0     # blocking reads of scores by the loop
        #: of those, the reads of the leaf renewal (one per renewed tree)
        self.renew_reads = 0
        #: waits for a pipelined tree's record copy, in ``_flush_pending``
        self.pipeline_waits = 0
        self._device_predictor = None    # (key, DevicePredictor) cache
        self._pred_schema = None         # 1-tuple cache (loaded boosters)
        self.device_predictions = 0      # predict_raw calls on the device
        self.telemetry = Telemetry(bool(cfg.telemetry), device)
        #: the sampled-sync bracket: inert unless telemetry and
        #: telemetry_sync_every > 0
        self._sync_sampler = SampledSync(self.telemetry,
                                         int(cfg.telemetry_sync_every))
        self._tel_trees = 0     # learner tree_stats entries fed to telemetry
        # parallel tree learning (``parallel/``): the mesh, the mode, and
        # the placement of the row-aligned arrays (None: every row here)
        self._mesh = None
        self._parallel_mode = None
        self._rows = None

    # -- pipelined tree materialization (`gbdt.py:300-424`) ------------------

    @property
    def models(self) -> List[Tree]:
        self._flush_pending()
        return self._models

    @models.setter
    def models(self, value) -> None:
        self._flush_pending()
        self._models = list(value)

    def _flush_pending(self, keep: int = 0) -> None:
        """Assemble the host trees of the pipelined iterations queued so
        far but the newest ``keep``, then run the deferred stop check
        (`gbdt.cpp:379-387` in the synchronous loop): the first flushed
        iteration in which no class split ends training, and every later
        iteration's trees are rolled back out of the training score (a
        traversal of the training rows' codes) and dropped."""
        pend = self._pending
        if not pend or len(pend) <= keep:
            return
        if keep > 0:
            pend, self._pending = pend[:-keep], pend[-keep:]
        else:
            self._pending = []
        tel = self.telemetry
        t_flush = time.perf_counter()
        first = len(self._models)
        for entry in pend:
            first = min(first, self._assemble_entry(entry))
        k = max(self.num_tree_per_iteration, 1)
        for it in range(first // k, len(self._models) // k):
            trees = self._models[it * k:(it + 1) * k]
            if trees and all(t is not None and t.num_leaves <= 1
                             for t in trees):
                # the queued iterations after the stop updated the score
                # too: assemble them so the rollback covers every tree
                tail, self._pending = self._pending, []
                for entry in tail:
                    self._assemble_entry(entry)
                # iteration 0's constant trees stay, as in the synchronous
                # loop; everything after the stop iteration goes
                drop_from = max(it, 1) * k
                for di in range(drop_from, len(self._models)):
                    t = self._models[di]
                    if t is not None and t.num_leaves > 1:
                        t.apply_shrinkage(-1.0)
                        self.train_score.score[di % k] += self._local(
                            traverse_tree_binned(self.train_data, t,
                                                 self.device))
                del self._models[drop_from:]
                self.iter_ = it
                self._stopped = True
                warnings.warn("Stopped training because there are no more "
                              "leaves that meet the split requirements")
                break
        if tel.enabled:
            tel.add_phase_time("pipeline_flush",
                               time.perf_counter() - t_flush, t0=t_flush)
            tel.inc("pipeline_flushes")
            tel.inc("trees_assembled", len(pend))

    def _assemble_entry(self, entry) -> int:
        """Build one queued pipelined tree into ``self._models`` (waiting
        for its record copy); returns its model index."""
        idx, host, event, host_stats, init_sc, rate = entry
        if event is not None:
            event.synchronize()
        self.pipeline_waits += 1
        # a span only when telemetry is on: an attached recorder on a
        # telemetry-off booster records nothing
        tr = self.telemetry.tracer if self.telemetry.enabled else None
        t0 = time.perf_counter()
        rec_f, rec_i = self.learner.host_records(
            host.numpy(), dict(host_stats, host_syncs=0))
        tree = self.learner.assemble_host(rec_f, rec_i)
        if tr is not None:
            tr.add_complete("tree_assemble", t0, time.perf_counter() - t0,
                            cat="train", args={"model_index": int(idx)})
        if tree.num_leaves > 1:
            # the rate its score update used (the JAX package takes the
            # rate at flush time, so a schedule's queued trees get the
            # last one: ROADMAP.md Queue C)
            tree.apply_shrinkage(rate)
            if abs(init_sc) > kEpsilon:
                tree.leaf_value[:tree.num_leaves] += init_sc
                tree.shrinkage = 1.0
        elif idx < self.num_tree_per_iteration:
            # nothing splittable on the very first iteration: the
            # boost-from-average constant model, its output added to the
            # training score as the synchronous loop adds it
            tree.leaf_value[0] = init_sc
            if abs(init_sc) > kEpsilon:
                self.train_score.add_constant(
                    init_sc, idx % self.num_tree_per_iteration)
        self._models[idx] = tree
        return idx

    # -- GBDT::Init (`gbdt.cpp:45-137`) -------------------------------------

    def init(self, train_data: Dataset, objective: Optional[ObjectiveFunction],
             training_metrics: Sequence[Metric] = ()) -> None:
        data = train_data.constructed
        self.train_data = data
        self.objective = objective
        self.num_tree_per_iteration = (
            objective.num_model_per_iteration if objective is not None
            else max(self.cfg.num_class, 1))
        if objective is not None:
            objective.init(data.metadata, data.num_data, data.num_data_padded)
        self.learner = create_tree_learner(self.cfg, data, self.device)
        if self.cfg.forcedsplits_filename:
            # the forced-split tree, parsed once against the bin mappers
            # (`gbdt.py:440-451`); the factory has moved the wave learner's
            # config to the compact learner
            from ..forced import load_forced_splits
            forced = load_forced_splits(self.cfg.forcedsplits_filename, data)
            if forced and len(forced) > self.cfg.num_leaves - 1:
                import warnings
                warnings.warn(
                    f"forced-splits tree has {len(forced)} splits but "
                    f"num_leaves={self.cfg.num_leaves} allows "
                    f"{self.cfg.num_leaves - 1}; truncating in BFS order")
                forced = forced[:self.cfg.num_leaves - 1]
            self.learner.set_forced_splits(forced)
        if hasattr(self.learner, "on_stats_read"):
            # reading the learner's per-tree counters decodes queued trees
            self.learner.on_stats_read = self._flush_pending
        self.train_score = ScoreUpdater(data, self.num_tree_per_iteration,
                                        self.device)
        self.training_metrics = list(training_metrics)
        self.max_feature_idx = data.num_total_features - 1
        self.feature_names = list(data.feature_names)
        self.feature_infos = feature_infos(data.bin_mappers,
                                           data.used_feature_map,
                                           data.num_total_features)
        # a DataFrame's category lists, stored in the model text
        self.pandas_categorical = getattr(train_data, "pandas_categorical",
                                          None)
        self.class_need_train = [
            objective.class_need_train(k) if objective is not None else True
            for k in range(self.num_tree_per_iteration)]
        self.num_data = data.num_data
        base = np.zeros(data.num_data_padded, dtype=np.float32)
        base[:data.num_data] = 1.0
        self._np_bag_mask = base       # the host copy the renewal reads
        self._bag_mask = upload(base, self.device)   # 0 on padded rows
        self._valid_rows = self._bag_mask
        self._full_fmask = torch.ones(data.num_used_features,
                                      dtype=torch.bool, device=self.device)
        if self.cfg.tree_learner in PARALLEL_MODES:
            self._start_parallel()

    def _start_parallel(self) -> None:
        """Shard over the process group's ranks (JAX `gbdt.py:470-483`);
        in a world of one rank the serial learner trains, with a line that
        says so.  In a pod the mesh is checked for host alignment
        (``multihost.mesh_for_config``)."""
        from ..parallel.multihost import mesh_for_config
        from ..parallel.sharding import init_from_env, world_size
        init_from_env(self.cfg, self.device)
        if world_size() > 1:
            from ..parallel.learners import apply_parallel_sharding
            apply_parallel_sharding(self, mesh_for_config(self.cfg),
                                    self.cfg.tree_learner)
        elif int(getattr(self.cfg, "verbosity", 1)) >= 1:
            print(f"[lightgbm_tpu_torch] tree_learner="
                  f"{self.cfg.tree_learner}: no process group of more than "
                  f"one rank, training serially (start one process per card, "
                  f"e.g. torchrun --nproc-per-node N)")

    # -- row placement under a parallel mode --------------------------------

    def _local(self, arr: torch.Tensor, name: str = "rows") -> torch.Tensor:
        """This rank's rows of a whole row-aligned array."""
        return arr if self._rows is None else self._rows.place(name, arr)

    def _global(self, arr: torch.Tensor, name: str = "rows") -> torch.Tensor:
        """The whole row-aligned array from every rank's rows."""
        if self._rows is None:
            return arr
        return self._rows.gather(name, arr,
                                 self.train_data.num_data_padded)

    def add_valid_data(self, valid_data: Dataset, name: str,
                       metrics: Sequence[Metric]) -> None:
        data = valid_data.constructed
        vs = ScoreUpdater(data, self.num_tree_per_iteration, self.device)
        # the trees the model already holds (an init model's included),
        # as `gbdt.cpp` AddValidDataset replays them; the JAX package
        # starts the score from zero (ROADMAP Queue C)
        for idx, tree in enumerate(self.models):
            vs.add_by_tree(tree, idx % self.num_tree_per_iteration)
        self.valid_scores.append(vs)
        self.valid_names.append(name)
        self.valid_metrics.append(list(metrics))
        self.best_score.append([-math.inf] * len(metrics))
        self.best_iter.append([0] * len(metrics))
        self.best_msg.append([""] * len(metrics))

    # -- bagging and feature sampling ---------------------------------------

    def _bagging(self, iter_: int) -> None:
        """`gbdt.cpp:180-241`: a fresh bag every ``bagging_freq`` rounds."""
        cfg = self.cfg
        if cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0 \
                and iter_ % cfg.bagging_freq == 0:
            with self.telemetry.phase("bagging"):
                n = self.num_data
                bag_cnt = int(cfg.bagging_fraction * n)
                idx = self._bag_rng.choice(n, bag_cnt, replace=False)
                mask = np.zeros(self.train_data.num_data_padded,
                                dtype=np.float32)
                mask[idx] = 1.0
                self._np_bag_mask = mask
                self._bag_mask = self._local(upload(mask, self.device))

    def _np_bag(self) -> np.ndarray:
        """The host copy of the bag mask, read from the device only when a
        renewal needs it (GOSS leaves it on the device)."""
        if self._np_bag_mask is None:
            self.host_syncs += 1
            self._np_bag_mask = self._global(self._bag_mask).cpu().numpy()
        return self._np_bag_mask

    def _sample(self, grads: List[tuple]) -> List[tuple]:
        """The row sampling between the gradients and the trees, in both
        loops: bagging here; GOSS selects rows and amplifies their
        gradients."""
        self._bagging(self.iter_)
        return grads

    def _feature_sample(self) -> torch.Tensor:
        """Per-tree feature_fraction sampling (`serial_tree_learner.cpp:255-283`)."""
        f = self.train_data.num_used_features
        frac = self.cfg.feature_fraction
        if frac >= 1.0:
            return self._full_fmask
        used = max(1, int(round(f * frac)))
        idx = self._feat_rng.choice(f, used, replace=False)
        mask = np.zeros(f, dtype=bool)
        mask[idx] = True
        return upload(mask, self.device)

    # -- one boosting iteration (`gbdt.cpp:333-413`) -------------------------

    def _can_pipeline(self) -> bool:
        """The JAX package's conditions (`gbdt.py:727-734`)."""
        return (self._supports_pipeline
                and self.objective is not None
                and not getattr(self.objective, "needs_renew_tree_output",
                                False)
                and not self.valid_scores
                and all(self.class_need_train)
                and self.train_data.num_used_features > 0
                and hasattr(self.learner, "train_async"))

    def _gradients(self) -> List[tuple]:
        """(grad, hess) per class from the objective (`gbdt.cpp:149`), for
        both loops: multiclass softmax's jointly over the (K, N_pad) score
        (``get_gradients_all``, as `gbdt.py:569-570`), every other objective
        class by class."""
        score = self.train_score.score
        if self._rows is not None and not self.objective.row_local:
            # a query's documents may lie on several ranks: the whole
            # score in, this rank's rows of the gradients out
            score = self._global(score, "score")
            return [(self._local(g), self._local(h)) for g, h in
                    (self.objective.get_gradients(score[k], k)
                     for k in range(self.num_tree_per_iteration))]
        if self.objective.name == "multiclass":
            g, h = self.objective.get_gradients_all(score)
            return list(zip(g, h))
        return [self.objective.get_gradients(score[k], k)
                for k in range(self.num_tree_per_iteration)]

    def _renew_tree_output(self, tree: Tree, leaf_id: torch.Tensor,
                           class_id: int) -> None:
        """The objective's leaf renewal (`gbdt.py:809-820`) on the tree
        before shrinkage: class ``class_id``'s training score before this
        tree's update and the tree's leaf ids come to the host in one
        blocking read (counted in ``host_syncs`` and ``renew_reads``)."""
        both = torch.stack([self._global(self.train_score.score[class_id])
                            .to(torch.float64),
                            self._global(leaf_id).to(torch.float64)])
        both = both.cpu().numpy()
        self.host_syncs += 1
        self.renew_reads += 1
        self.objective.renew_tree_output(
            tree, both[0, :self.num_data].astype(np.float32),
            both[1].astype(np.int64), self._np_bag())

    def _pad_external_gradients(self, gradients, hessians) -> List[tuple]:
        """A custom objective's (K * n,) or (K, n) gradients and hessians,
        class-major as the reference takes them, padded to N_pad with
        zeros and uploaded in one copy (JAX ``gbdt.py:594-603``)."""
        k = self.num_tree_per_iteration
        both = np.zeros((2, k, self.train_data.num_data_padded), np.float32)
        for i, a in enumerate((gradients, hessians)):
            a = np.asarray(a, dtype=np.float32).reshape(k, -1)
            both[i, :, :a.shape[1]] = a
        both = upload(both, self.device)
        return [(self._local(g), self._local(h))
                for g, h in zip(both[0], both[1])]

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """Returns True when training cannot continue (no splittable leaves;
        in the pipelined loop found up to ``tpu_pipeline_flush_depth``
        iterations late, the later ones rolled back).  ``gradients`` and
        ``hessians`` (a custom objective's) replace the objective's.  With
        telemetry the iteration is timed, and every
        ``telemetry_sync_every``-th one is bracketed: the queue drained
        first, each leg synced, the whole iteration synced."""
        tel = self.telemetry
        if not tel.enabled:
            return self._train_one_iter(gradients, hessians)
        ss = self._sync_sampler
        if ss.sampled(self.iter_):
            ss.drain(self.train_score.score)
            ss.active = True
            t0 = time.perf_counter()
            try:
                with tel.phase("iteration"):
                    ret = self._train_one_iter(gradients, hessians)
                    force_sync(self.train_score.score)
            finally:
                ss.active = False
            tel.add_phase_time("sync.iteration", time.perf_counter() - t0,
                               t0=t0)
            ss.probe_exchange(self.learner)
            return ret
        with tel.phase("iteration"):
            return self._train_one_iter(gradients, hessians)

    def _train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One boosting iteration (the variants override this)."""
        if self._stopped:
            return True
        k_trees = self.num_tree_per_iteration
        if gradients is None or hessians is None:
            init_scores = [self._boost_from_average(k)
                           for k in range(k_trees)]
            t0 = time.perf_counter()
            with self.telemetry.phase("gradients"):
                grads = self._gradients()
            self._sync_sampler.leg("gradients", t0,
                                   [a for pair in grads for a in pair])
        else:
            init_scores = [0.0] * k_trees
            grads = self._pad_external_gradients(gradients, hessians)
        grads = self._sample(grads)
        if self._can_pipeline():
            return self._train_trees_pipelined(grads, init_scores)
        return self._train_trees(grads, init_scores)

    def _train_trees(self, grads: List[tuple], init_scores) -> bool:
        """The synchronous per-class tree loop (`gbdt.cpp:348-413`), shared
        by GBDT, GOSS and DART."""
        renew = self.objective is not None \
            and self.objective.needs_renew_tree_output
        tel, ss = self.telemetry, self._sync_sampler
        should_continue = False
        for k, (grad, hess) in enumerate(grads):
            new_tree = Tree(2)
            if self.class_need_train[k] \
                    and self.train_data.num_used_features > 0:
                t0 = time.perf_counter()
                with tel.phase("tree_train"):
                    new_tree, leaf_id, leaf_out = self.learner.train(
                        grad, hess, self._bag_mask, self._feature_sample())
                ss.leg("tree_train", t0, (leaf_id, leaf_out))
            if new_tree.num_leaves > 1:
                should_continue = True
                # score_update covers the whole post-tree leg (renewal,
                # training and validation scores), as in the JAX package
                t0 = time.perf_counter()
                with tel.phase("score_update"):
                    self._update_scores(new_tree, leaf_id, leaf_out, k,
                                        renew)
                ss.leg("score_update", t0, [self.train_score.score]
                       + [vs.score for vs in self.valid_scores])
                if abs(init_scores[k]) > kEpsilon:
                    new_tree.leaf_value[:new_tree.num_leaves] += init_scores[k]
                    new_tree.shrinkage = 1.0
            elif len(self.models) < self.num_tree_per_iteration:
                # constant tree for the never-trained / unsplittable case
                if not self.class_need_train[k] and self.objective is not None:
                    output = self.objective.boost_from_score(k)
                else:
                    output = init_scores[k]
                new_tree = Tree(2)
                new_tree.num_leaves = 1
                new_tree.leaf_value[0] = output
                self.train_score.add_constant(output, k)
                for vs in self.valid_scores:
                    vs.add_constant(output, k)
            self.models.append(new_tree)
        if not should_continue:
            import warnings
            warnings.warn("Stopped training because there are no more leaves "
                          "that meet the split requirements")
            if len(self.models) > self.num_tree_per_iteration:
                del self.models[-self.num_tree_per_iteration:]
            return True
        self.iter_ += 1
        return False

    def _update_scores(self, new_tree: Tree, leaf_id: torch.Tensor,
                       leaf_out: torch.Tensor, k: int, renew: bool) -> None:
        """The synchronous loop's post-tree leg: the leaf renewal, the
        shrinkage, the training score by leaf id, the validation scores by
        traversal."""
        if renew:
            self._renew_tree_output(new_tree, leaf_id, k)
        new_tree.apply_shrinkage(self.shrinkage_rate)
        if renew:
            # the renewed host leaf values, as float32
            lv = upload(new_tree.leaf_value[:new_tree.num_leaves]
                        .astype(np.float32), self.device)
        else:
            # the host tree's leaf values are float32(f32 output * rate in
            # float64); the same numbers are formed on the device
            lv = (torch.nan_to_num(leaf_out.to(torch.float32), nan=0.0)
                  .to(torch.float64) * self.shrinkage_rate).to(torch.float32)
        self.train_score.add_by_leaf_id(lv, leaf_id, k)
        for vs in self.valid_scores:
            vs.add_by_tree(new_tree, k)

    def _train_trees_pipelined(self, grads: List[tuple], init_scores
                               ) -> bool:
        """One iteration with no blocking host read
        (``_train_trees_pipelined``, `gbdt.py:736-779`, and the fused path
        of `gbdt.py:687-725`, the same sequence here): per class the tree is
        grown by ``train_async``, the training score updated on the device
        as ``_score_add_leaf`` (`gbdt.py:232-235`) does, and the packed
        records copied to pinned host memory behind an event; then the host
        trees of the iteration ``tpu_pipeline_flush_depth`` back are
        assembled (``0``: all of them every 16 iterations)."""
        k_trees = self.num_tree_per_iteration
        cuda = self.device.type == "cuda"
        lr = float(np.float32(self.shrinkage_rate))
        tel, ss = self.telemetry, self._sync_sampler
        for k, (grad, hess) in enumerate(grads):
            t0 = time.perf_counter()
            with tel.phase("tree_dispatch"):
                tree = self.learner.train_async(grad, hess, self._bag_mask,
                                                self._feature_sample())
            ss.leg("tree_build", t0, (tree.records, tree.leaf_id,
                                      tree.leaf_out))
            t0 = time.perf_counter()
            with tel.phase("score_update"):
                # score + float32(lr) * leaf_out with one rounding, the
                # fused multiply-add XLA makes of ``_score_add_leaf``: the
                # product of two float32 numbers is exact in float64
                lo = tree.leaf_out.to(torch.float32).index_select(
                    0, tree.leaf_id).to(torch.float64)
                score = self.train_score.score[k]
                score.copy_((score.to(torch.float64) + lr * lo)
                            .to(torch.float32))
                event = None
                host = tree.records
                if cuda:
                    host = torch.empty(host.shape, dtype=host.dtype,
                                       pin_memory=True)
                    host.copy_(tree.records, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
            ss.leg("score_update", t0, (score,))
            self._pending.append((len(self._models), host, event,
                                  tree.host_stats, init_scores[k],
                                  self.shrinkage_rate))
            self._models.append(None)
        self.iter_ += 1
        depth = int(getattr(self.cfg, "tpu_pipeline_flush_depth", 8))
        if depth > 0:
            self._flush_pending(keep=depth * k_trees)
        elif len(self._pending) >= 16 * k_trees:
            self._flush_pending()
        return self._stopped

    # -- telemetry (observability/) ------------------------------------------

    def get_telemetry(self, light: bool = False) -> Dict[str, Any]:
        """The JSON telemetry report (``observability/schema.json``).  The
        default flushes the pipelined queue first, so the report covers
        every tree dispatched; ``light=True`` reads only what is decoded
        already and never waits on the device
        (``callback.record_telemetry``)."""
        if not light:
            self._flush_pending()
        tel = self.telemetry
        learner = self.learner
        stats = getattr(learner, "_tree_stats", None)
        if stats is not None:
            for d in stats[self._tel_trees:]:
                tel.device_telem(d)
            self._tel_trees = len(stats)
        if tel.enabled:
            tel.set_provenance(
                tree_learner=str(self.cfg.tree_learner),
                learner=type(learner).__name__ if learner is not None
                else None)
            if self._sync_sampler.every > 0:
                tel.set_distributed(sync_every=self._sync_sampler.every)
            if self._mesh is not None:
                tel.set_provenance(mesh_shape=str(dict(zip(
                    self._mesh.axis_names, self._mesh.shape))))
        gauges = {}
        if learner is not None:
            gauges["learner"] = type(learner).__name__
        mesh = self._mesh
        return tel.report(
            extra_gauges=gauges,
            ledger=None if mesh is None else getattr(learner, "_ledger",
                                                     None),
            transport=None if mesh is None else mesh.transport(self.device))

    def _boost_from_average(self, class_id: int) -> float:
        """`gbdt.cpp:309-331`."""
        if self._models or self.train_score.has_init_score \
                or self.objective is None:
            return 0.0
        if not (self.cfg.boost_from_average
                or self.train_data.num_used_features == 0):
            return 0.0
        init_score = self.objective.boost_from_score(class_id)
        if abs(init_score) > kEpsilon:
            self.train_score.add_constant(init_score, class_id)
            for vs in self.valid_scores:
                vs.add_constant(init_score, class_id)
            return init_score
        return 0.0

    # -- eval / early stop (`gbdt.cpp:432-533`) ------------------------------

    def eval_and_check_early_stopping(self, log=None) -> bool:
        msg = self.output_metric(self.iter_, log)
        if msg:
            if log:
                log(f"Early stopping at iteration {self.iter_}, the best "
                    f"iteration round is "
                    f"{self.iter_ - self.cfg.early_stopping_round}")
            drop = self.cfg.early_stopping_round * self.num_tree_per_iteration
            del self.models[-drop:]
            return True
        return False

    def output_metric(self, iter_: int, log=None) -> str:
        cfg = self.cfg
        need_output = (iter_ % cfg.metric_freq) == 0
        ret = ""
        msg_lines: List[str] = []
        if need_output:
            for m in self.training_metrics:
                for name, val in m.eval(self.metric_score(self.train_score),
                                        self.objective):
                    line = f"Iteration:{iter_}, training {name} : {val:g}"
                    if log:
                        log(line)
                    self.eval_history.setdefault("training", {}).setdefault(
                        name, []).append(val)
                    if cfg.early_stopping_round > 0:
                        msg_lines.append(line)
        meet = []
        if need_output or cfg.early_stopping_round > 0:
            for i, metrics in enumerate(self.valid_metrics):
                for j, m in enumerate(metrics):
                    results = m.eval(self.metric_score(self.valid_scores[i]),
                                     self.objective)
                    dname = self.valid_names[i]
                    for name, val in results:
                        line = f"Iteration:{iter_}, valid_{i+1} {name} : {val:g}"
                        if need_output and log:
                            log(line)
                        self.eval_history.setdefault(dname, {}).setdefault(
                            name, []).append(val)
                        if cfg.early_stopping_round > 0:
                            msg_lines.append(line)
                    if not ret and cfg.early_stopping_round > 0:
                        factor = 1.0 if m.is_higher_better else -1.0
                        cur = factor * results[-1][1]
                        if cur > self.best_score[i][j]:
                            self.best_score[i][j] = cur
                            self.best_iter[i][j] = iter_
                            meet.append((i, j))
                        elif iter_ - self.best_iter[i][j] \
                                >= cfg.early_stopping_round:
                            ret = self.best_msg[i][j]
        for i, j in meet:
            self.best_msg[i][j] = "\n".join(msg_lines)
        return ret

    def metric_score(self, updater: ScoreUpdater) -> np.ndarray:
        """Host copy of a score updater's scores (one blocking read); the
        training score gathered from every rank's rows under a parallel
        mode, so every rank evaluates the whole training set."""
        self.host_syncs += 1
        if updater is self.train_score and self._rows is not None:
            s = self._global(updater.score, "score")[:, :self.num_data] \
                .cpu().numpy()
            return s.T if updater.num_class > 1 else s[0]
        return updater.np_score()

    # -- prediction ----------------------------------------------------------

    def _num_models_for(self, num_iteration: int) -> int:
        if num_iteration <= 0:
            return len(self.models)
        return min(len(self.models),
                   num_iteration * self.num_tree_per_iteration)

    def predict_raw(self, X: np.ndarray, num_iteration: int = -1
                    ) -> np.ndarray:
        """The JAX package's rule (`gbdt.py:990-1030`): rows x trees >=
        ``DEVICE_PREDICT_MIN_WORK`` or ``pred_early_stop`` traverse every
        tree on the device in bin space (trained boosters bin against the
        training mappers, text-loaded ones against a schema rebuilt from the
        model text); smaller batches walk the host trees.  Trees pending a
        rebind never take the device path."""
        X = np.ascontiguousarray(X, dtype=np.float64)
        n = X.shape[0]
        k = self.num_tree_per_iteration
        num_models = self._num_models_for(num_iteration)
        cfg = self.cfg
        big = num_models > 0 and (n * num_models >= DEVICE_PREDICT_MIN_WORK
                                  or cfg.pred_early_stop)
        pred_data = self.train_data
        if pred_data is None and big:
            pred_data = self._prediction_schema()
        if pred_data is not None and big and not any(
                getattr(t, "needs_rebind", False)
                for t in self.models[:num_models]):
            from ..predictor import DevicePredictor
            key = (num_models, self._model_version, cfg.pred_early_stop,
                   cfg.pred_early_stop_freq, cfg.pred_early_stop_margin)
            if self._device_predictor is None \
                    or self._device_predictor[0] != key:
                self._device_predictor = (key, DevicePredictor(
                    self, pred_data, num_iteration,
                    pred_early_stop=cfg.pred_early_stop,
                    pred_early_stop_freq=cfg.pred_early_stop_freq,
                    pred_early_stop_margin=cfg.pred_early_stop_margin))
            self.device_predictions += 1
            return self._device_predictor[1].predict_raw(X)
        out = np.zeros((n, k), dtype=np.float64)
        for i in range(num_models):
            out[:, i % k] += self.models[i].predict(X)
        return out[:, 0] if k == 1 else out

    def _prediction_schema(self):
        """Synthetic bin schema for a dataset-less (text-loaded) booster,
        built once and cached; None when reconstruction is not possible
        (the host path then serves, with a warning)."""
        if self._pred_schema is None:
            from ..predictor import reconstruct_bin_schema
            try:
                self._pred_schema = (reconstruct_bin_schema(self),)
            except Exception as e:  # unexpected model text shapes
                import warnings
                warnings.warn("could not reconstruct a device bin schema "
                              f"from the model text ({e}); predictions use "
                              "the host path")
                self._pred_schema = (None,)
        return self._pred_schema[0]

    def predict(self, X: np.ndarray, num_iteration: int = -1,
                raw_score: bool = False, pred_leaf: bool = False
                ) -> np.ndarray:
        if pred_leaf:
            X = np.ascontiguousarray(X, dtype=np.float64)
            return np.stack([self.models[i].predict_leaf_index(X) for i in
                             range(self._num_models_for(num_iteration))],
                            axis=1)
        raw = self.predict_raw(X, num_iteration)
        if raw_score or self.objective is None:
            return raw
        return self.objective.convert_output(raw)

    @property
    def num_iterations_trained(self) -> int:
        return len(self.models) // max(self.num_tree_per_iteration, 1)

    # -- in-place edits of the trees ----------------------------------------

    def _add_tree_score_train(self, tree: Tree, class_id: int) -> None:
        """Add ``tree``'s current leaf values to the training score: a
        device traversal of the training rows' codes (a constant for a
        one-leaf tree)."""
        if tree.num_leaves > 1:
            self.train_score.score[class_id] += self._local(
                traverse_tree_binned(self.train_data, tree, self.device))
        else:
            self.train_score.add_constant(float(tree.leaf_value[0]),
                                          class_id)

    def rollback_one_iter(self) -> None:
        """`gbdt.cpp:414-431`: drop the last iteration's trees and take
        their output out of the training and validation scores (JAX
        ``gbdt.py:1067-1087``).  Reading ``models`` flushes the pipelined
        queue first."""
        if self.iter_ <= 0:
            return
        k = self.num_tree_per_iteration
        models = self.models
        self._model_version += 1
        for cid in range(k):
            tree = models[len(models) - k + cid]
            tree.apply_shrinkage(-1.0)
            self._add_tree_score_train(tree, cid)
            for vs in self.valid_scores:
                vs.add_by_tree(tree, cid)
        del models[-k:]
        self.iter_ -= 1

    def refit_leaf_preds(self, leaf_preds: np.ndarray,
                         decay_rate: float = 0.9) -> None:
        """Refit every tree's leaf values on this booster's training data
        (`gbdt.cpp` RefitTree, JAX ``gbdt.py:1190-1228``): per iteration
        the gradients at the running score, per-leaf gradient and hessian
        sums (``index_add_`` in float64 on the device, one read per tree),
        ``decay * old + (1 - decay) * new * shrinkage``, and the new leaf
        values added to the score."""
        models = self.models
        self._model_version += 1
        k = max(self.num_tree_per_iteration, 1)
        n = self.num_data
        if leaf_preds.shape != (n, len(models)):
            raise ValueError(f"leaf predictions of shape {leaf_preds.shape}"
                             f", want ({n}, {len(models)})")
        cfg = self.cfg
        lp_all = upload(np.ascontiguousarray(leaf_preds.T, dtype=np.int64),
                        self.device)
        self.train_score.score.zero_()
        for it in range(len(models) // k):
            grads = self._gradients()
            for tid in range(k):
                mi = it * k + tid
                tree = models[mi]
                nl = tree.num_leaves
                lp = lp_all[mi]
                g, h = (self._global(a) for a in grads[tid])
                sums = torch.zeros((2, nl), dtype=torch.float64,
                                   device=self.device)
                sums.index_add_(1, lp, torch.stack([g[:n], h[:n]])
                                .to(torch.float64))
                sums = sums.cpu()
                self.host_syncs += 1
                new_out = calculate_leaf_output(
                    sums[0], sums[1] + kEpsilon, float(cfg.lambda_l1),
                    float(cfg.lambda_l2), float(cfg.max_delta_step)).numpy()
                old = tree.leaf_value[:nl]
                tree.leaf_value[:nl] = (decay_rate * old
                                        + (1.0 - decay_rate)
                                        * new_out * tree.shrinkage)
                lv = upload(tree.leaf_value[:nl].astype(np.float32),
                            self.device)
                add = torch.zeros(self.train_data.num_data_padded,
                                  dtype=lv.dtype, device=self.device)
                add[:n] = lv.index_select(0, lp)
                self.train_score.score[tid] += self._local(add)

    def dump_model(self, start_iteration: int = 0, num_iteration: int = -1
                   ) -> Dict:
        """The model as a JSON-able dict, the reference ``DumpModel``
        schema (`gbdt_model_text.cpp:15-60`, JAX ``gbdt.py:1159``)."""
        k = max(self.num_tree_per_iteration, 1)
        models = self.models
        total_iteration = len(models) // k
        start_iteration = min(max(start_iteration, 0), total_iteration)
        num_used = len(models)
        if num_iteration > 0:
            num_used = min((start_iteration + num_iteration) * k, num_used)
        out = {"name": "tree", "version": K_MODEL_VERSION,
               "num_class": max(self.cfg.num_class, 1),
               "num_tree_per_iteration": self.num_tree_per_iteration,
               "label_index": self.label_idx,
               "max_feature_idx": self.max_feature_idx,
               "average_output": self.average_output}
        if self.objective is not None:
            out["objective"] = self.objective.to_string()
        out["feature_names"] = list(self.feature_names)
        out["tree_info"] = [dict(tree_index=i - start_iteration * k,
                                 **models[i].to_json())
                            for i in range(start_iteration * k, num_used)]
        return out

    # -- serialization (`gbdt_model_text.cpp:244-341`) -----------------------

    def save_model_to_string(self, start_iteration: int = 0,
                             num_iteration: int = -1) -> str:
        out = [self.name]
        out.append(f"version={K_MODEL_VERSION}")
        out.append(f"num_class={max(self.cfg.num_class, 1)}")
        out.append(f"num_tree_per_iteration={self.num_tree_per_iteration}")
        out.append(f"label_index={self.label_idx}")
        out.append(f"max_feature_idx={self.max_feature_idx}")
        if self.objective is not None:
            out.append(f"objective={self.objective.to_string()}")
        if self.average_output:
            out.append("average_output")
        out.append("feature_names=" + " ".join(self.feature_names))
        out.append("feature_infos=" + " ".join(self.feature_infos))

        num_used = len(self.models)
        total_iter = num_used // max(self.num_tree_per_iteration, 1)
        start_iteration = min(max(start_iteration, 0), total_iter)
        if num_iteration > 0:
            num_used = min((start_iteration + num_iteration)
                           * self.num_tree_per_iteration, num_used)
        start_model = start_iteration * self.num_tree_per_iteration
        tree_strs = []
        for i in range(start_model, num_used):
            s = f"Tree={i - start_model}\n" + self.models[i].to_string() + "\n"
            tree_strs.append(s)
        out.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
        out.append("")
        body = "\n".join(out) + "\n" + "".join(tree_strs)
        body += "end of trees\n"
        imps = self.feature_importance("split")
        pairs = [(int(v), self.feature_names[i])
                 for i, v in enumerate(imps) if v > 0]
        pairs.sort(key=lambda p: -p[0])
        body += "\nfeature importances:\n"
        for v, name in pairs:
            body += f"{name}={v}\n"
        import json as _json
        body += "\npandas_categorical:%s\n" % _json.dumps(
            self.pandas_categorical, default=str)
        return body

    def save_model_to_file(self, filename: str, start_iteration: int = 0,
                           num_iteration: int = -1) -> None:
        """Atomic write: a temporary file in the target directory, then
        ``os.replace``."""
        import os
        import tempfile

        s = self.save_model_to_string(start_iteration, num_iteration)
        d = os.path.dirname(os.path.abspath(filename))
        fd, tmp = tempfile.mkstemp(
            prefix=os.path.basename(filename) + ".", suffix=".tmp", dir=d)
        try:
            with os.fdopen(fd, "w") as fh:
                fh.write(s)
            os.replace(tmp, filename)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def load_model_from_string(self, s: str) -> "GBDT":
        """`gbdt_model_text.cpp:343-440`."""
        for line in s.rsplit("\n", 3)[1:]:
            if line.startswith("pandas_categorical:"):
                import json as _json
                try:
                    self.pandas_categorical = _json.loads(
                        line[len("pandas_categorical:"):])
                except ValueError:
                    self.pandas_categorical = None
        lines, trees_part = s.split("tree_sizes=", 1)
        header: Dict[str, str] = {}
        for line in lines.strip().split("\n"):
            if "=" in line:
                k, v = line.split("=", 1)
                header[k] = v
            elif line.strip() == "average_output":
                self.average_output = True
        self.num_tree_per_iteration = int(header.get("num_tree_per_iteration",
                                                     1))
        self.cfg.num_class = int(header.get("num_class", 1))
        self.label_idx = int(header.get("label_index", 0))
        self.max_feature_idx = int(header.get("max_feature_idx", 0))
        self.feature_names = header.get("feature_names", "").split()
        self.feature_infos = header.get("feature_infos", "").split()
        if "objective" in header and self.objective is None:
            self.cfg.objective = _objective_from_string(header["objective"],
                                                        self.cfg)
            self.objective = create_objective(self.cfg, self.device)
        self.models = []
        body = trees_part.split("\n", 1)[1]
        for block in body.split("Tree=")[1:]:
            tree_txt = block.split("\n\n")[0]
            tree_txt = tree_txt.split("end of trees")[0]
            tree_txt = tree_txt.split("\n", 1)[1]  # drop the tree index line
            self.models.append(Tree.from_string(tree_txt))
        self.iter_ = len(self.models) // max(self.num_tree_per_iteration, 1)
        return self

    def feature_importance(self, importance_type: str = "split",
                           num_iteration: int = -1) -> np.ndarray:
        out = np.zeros(self.max_feature_idx + 1, dtype=np.float64)
        for i in range(self._num_models_for(num_iteration)):
            t = self.models[i]
            for nd in range(t.num_leaves - 1):
                if importance_type == "split":
                    out[t.split_feature[nd]] += 1.0
                else:
                    out[t.split_feature[nd]] += max(t.split_gain[nd], 0.0)
        return out


def feature_infos(bin_mappers, used_feature_map,
                  num_total_features: int) -> List[str]:
    """``feature_infos`` strings: [min:max] per used numerical feature, the
    categories in bin order joined by ``:`` per categorical one, ``none``
    for the unused ones (`dataset.cpp` SaveModelToString feature info)."""
    out = ["none"] * num_total_features
    for k, m in enumerate(bin_mappers):
        if m.bin_type == BIN_CATEGORICAL:
            info = ":".join(str(c) for c in m.bin_2_categorical)
        else:
            info = f"[{m.min_val:g}:{m.max_val:g}]"
        out[int(used_feature_map[k])] = info
    return out


def _objective_from_string(s: str, cfg: Config) -> str:
    parts = s.split()
    name = parts[0]
    for tok in parts[1:]:
        if ":" in tok:
            k, v = tok.split(":", 1)
            try:
                setattr(cfg, k, type(getattr(cfg, k, 0.0))(v))
            except (TypeError, ValueError):
                pass
    return {"xentropy": "cross_entropy", "xentlambda": "cross_entropy_lambda"
            }.get(name, name)
