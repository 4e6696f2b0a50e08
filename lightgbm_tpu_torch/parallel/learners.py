"""Parallel tree learning: the router and the masked learner under sharding.

Port of ``lightgbm_tpu/parallel/learners.py``.  The reference's three
parallel learners (data-parallel `data_parallel_tree_learner.cpp:49-254`,
feature-parallel `feature_parallel_tree_learner.cpp:29-73`, voting-parallel
`voting_parallel_tree_learner.cpp:166-345`) and the JAX package's 2-D
hybrid run as one process per rank over a ``torch.distributed`` group
(``sharding.py``).  ``apply_parallel_sharding`` swaps a GBDT's serial
learner for the sharded one its mode and gates allow, with the JAX
router's log lines, and places the boosting loop's row-aligned arrays
(``rules_for_mode``): score, valid-row and bag masks and the objective's
label arrays keep this rank's rows.

Where every fast path is refused (data past 256 bins, or the shape gates)
the masked learner trains under sharding (``ShardedMaskedLearner``, JAX
`:194-238`): ``hist_full`` over the rank's rows (data, voting) or its
feature slice (feature), the histogram summed (or gathered) over the
ranks, so every rank scans the same full histogram.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from ..dataset import _ConstructedDataset
from ..learner import MaskedTreeLearner
from .sharding import (AXIS_DATA, AXIS_FEATURE, Mesh, default_mesh_shape_2d,
                       feature_axis, make_mesh, row_axis, rules_for_mode,
                       world_size)


def _route_log(cfg, msg: str) -> None:
    """Learner-selection telemetry, as the serial factory's: a user with
    eight cards and an off-by-one row count is told the slow path ran."""
    if int(getattr(cfg, "verbosity", 1)) >= 1:
        print(f"[lightgbm_tpu_torch] {msg}")


def _fast_gate_reason(data, mesh_size: int) -> Optional[str]:
    """Why the sharded compact/wave path cannot run (None = eligible)."""
    if data.max_num_bin > 256:
        return f"max_num_bin={data.max_num_bin} > 256"
    if data.num_data_padded % mesh_size:
        return (f"padded row count {data.num_data_padded} not divisible by "
                f"mesh size {mesh_size}")
    if data.bins.shape[0] % mesh_size:
        return (f"padded feature count {data.bins.shape[0]} not divisible "
                f"by mesh size {mesh_size}")
    return None


class ShardedMaskedLearner(MaskedTreeLearner):
    """The masked learner under a parallel mode: ``data`` / ``voting`` hold
    the rank's rows and sum each ``hist_full`` histogram over the ranks;
    ``feature`` holds every row, builds the histogram of its feature slice
    and gathers the others'.  The scans then run on the same full
    histogram on every rank."""

    def __init__(self, cfg: Config, data: _ConstructedDataset, mesh: Mesh,
                 device: torch.device, mode: str = "data"):
        super().__init__(cfg, data, device)
        self.mesh = mesh
        self.mode = mode
        self._placement_mode = mode
        self.use_graphs = False
        if mode in ("data", "voting"):
            # the rank's rows; a row count that does not divide leaves the
            # last rank the shorter block (``PlacementRules.place``)
            self.axis = row_axis(mesh)
            self.row_shards = mesh.axis_size(self.axis)
            self.bins = rules_for_mode(mode, mesh).place("bins", self.bins) \
                .contiguous()
        elif mode == "feature":
            self.axis = feature_axis(mesh)
            self.row_shards = 1
            d = mesh.axis_size(self.axis)
            self.fsz = -(-self.num_features // d)
            self.f_lo = min(mesh.axis_index(self.axis) * self.fsz,
                            self.num_features)
        else:
            raise ValueError(f"unknown parallel mode: {mode}")

    def _coll(self, op: str, x: torch.Tensor, axis) -> torch.Tensor:
        self._rec_coll(op, x)
        return getattr(self.mesh, op)(x, axis)

    def _hist_codes(self) -> torch.Tensor:
        if self.mode == "feature":
            return self.bins[self.f_lo:self.f_lo + self.fsz]
        return self.bins

    def _reduce_hist(self, h: torch.Tensor) -> torch.Tensor:
        """The summed histogram of every rank's rows (data), or every
        rank's feature slice gathered (feature; the last one padded to one
        width)."""
        if self.mode != "feature":
            return self._coll("psum", h, self.axis)
        if h.shape[0] < self.fsz:
            h = torch.cat([h, h.new_zeros((self.fsz - h.shape[0],)
                                          + tuple(h.shape[1:]))])
        full = self._coll("all_gather", h, self.axis)
        return full.reshape((-1,) + tuple(h.shape[1:]))[:self.num_features]

    def _global_scalar(self, v):
        if self.mode == "feature":
            return v
        return self._coll("psum", v, self.axis)

    def _sync_counts(self, lc_bag, c_bag):
        if self.mode == "feature":
            return lc_bag, c_bag
        return tuple(self._coll("psum", c.to(torch.int32), self.axis)
                     .to(c.dtype) for c in (lc_bag, c_bag))


def apply_parallel_sharding(gbdt, mesh: Mesh, mode: str) -> None:
    """Swap a GBDT's learner for the sharded one of ``mode`` on ``mesh``
    (the JAX router's gates and log lines) and place its row arrays."""
    gbdt._flush_pending()
    learner = gbdt.learner
    cfg, data, dev = learner.cfg, learner.data, gbdt.device
    forced = getattr(learner, "_forced", None)
    mesh_size = mesh.size
    if mode == "data_feature":
        from .wave2d_sharded import (ShardedWave2DLearner,
                                     wave2d_ineligible_reason)
        if len(mesh.axis_names) < 2:
            mesh = make_mesh(shape=default_mesh_shape_2d(mesh_size),
                             axis_names=(AXIS_DATA, AXIS_FEATURE))
        reason = ("forced splits ride the sequential sharded learner"
                  if forced else wave2d_ineligible_reason(cfg, data, mesh))
        if reason is None:
            shp = dict(zip(mesh.axis_names, mesh.shape))
            _route_log(cfg, f"tree_learner=data_feature: using "
                            f"ShardedWave2DLearner over a "
                            f"{shp[AXIS_DATA]}x{shp[AXIS_FEATURE]} "
                            f"(data x feature) mesh")
            _install(gbdt, ShardedWave2DLearner(cfg, data, mesh, dev), mesh,
                     mode)
            return
        _route_log(cfg, f"tree_learner=data_feature: 2D hybrid ineligible "
                        f"({reason}); falling back to tree_learner=data over "
                        f"a flat {mesh_size}-device mesh")
        apply_parallel_sharding(gbdt, make_mesh(mesh_size), "data")
        return
    fast_reason = _fast_gate_reason(data, mesh_size) \
        if mode in ("data", "voting") else None
    if mode in ("data", "voting") and fast_reason is None:
        from .compact_sharded import ShardedCompactLearner, \
            ShardedVotingLearner
        from .wave_sharded import (ShardedVotingWaveLearner,
                                   ShardedWaveLearner, wave_sharded_eligible)
        wave_ok = not forced and wave_sharded_eligible(cfg, data, mesh_size)
        if mode == "voting":
            cls = ShardedVotingWaveLearner if wave_ok \
                else ShardedVotingLearner
        else:
            cls = ShardedWaveLearner if wave_ok else ShardedCompactLearner
        if not wave_ok:
            why = "forced splits ride the sequential sharded learner" \
                if forced else "shape/byte gates, see wave_sharded_eligible"
            _route_log(cfg, f"tree_learner={mode}: wave-sharded learner "
                            f"ineligible ({why}); using the sequential "
                            f"{cls.__name__}")
        else:
            _route_log(cfg, f"tree_learner={mode}: using {cls.__name__} over "
                            f"{mesh_size} devices")
        _install(gbdt, cls(cfg, data, mesh, dev), mesh, mode, forced)
        return
    if mode == "feature" and data.max_num_bin <= 256:
        from ..learner_wave import wave_budget_reason
        from .feature_sharded import (FeatureShardedCompactLearner,
                                      FeatureShardedWaveLearner,
                                      feature_sharded_eligible)
        if feature_sharded_eligible(cfg, data, mesh_size):
            # rows are whole on every rank: the wave variant must pass the
            # serial wave gates at the full row count and width
            wave_ok = (not forced and cfg.tpu_learner in ("auto", "wave")
                       and wave_budget_reason(
                           cfg, int(data.num_data_padded), data.bins.shape[0],
                           int(data.max_num_bin)) is None)
            cls = FeatureShardedWaveLearner if wave_ok \
                else FeatureShardedCompactLearner
            _route_log(cfg, f"tree_learner=feature: using {cls.__name__} "
                            f"over {mesh_size} devices")
            _install(gbdt, cls(cfg, data, mesh, dev), mesh, mode, forced)
            return
    if mode in ("data", "voting"):
        _route_log(cfg, f"tree_learner={mode}: sharded compact/wave path "
                        f"ineligible ({fast_reason}); falling back to the "
                        f"masked GSPMD learner")
    elif mode == "feature":
        why = (f"max_num_bin={data.max_num_bin} > 256"
               if data.max_num_bin > 256
               else "feature_sharded_eligible gates failed")
        _route_log(cfg, f"tree_learner=feature: feature-sharded path "
                        f"ineligible ({why}); falling back to the masked "
                        f"GSPMD learner")
    else:
        raise ValueError(f"unknown parallel mode: {mode}")
    _install(gbdt, ShardedMaskedLearner(
        cfg, data, mesh, dev, "data" if mode == "voting" else mode),
        mesh, mode, forced)


def _install(gbdt, learner, mesh: Mesh, mode: str, forced=None) -> None:
    if forced:
        learner.set_forced_splits(forced)
    if hasattr(learner, "on_stats_read"):
        learner.on_stats_read = gbdt._flush_pending
    gbdt.learner = learner
    gbdt._mesh = mesh
    gbdt._parallel_mode = mode
    _place_row_arrays(gbdt, mesh, mode)


def _place_row_arrays(gbdt, mesh: Mesh, mode: str) -> None:
    """Keep this rank's rows of the boosting loop's row-aligned arrays
    (score, valid-row and bag masks, the objective's label arrays); the
    rule table decides, so ``feature`` keeps every row."""
    rules = rules_for_mode(mode, mesh)
    gbdt._rows = rules
    gbdt._valid_rows = rules.place("valid_rows", gbdt._valid_rows)
    gbdt._bag_mask = rules.place("bag_mask", gbdt._bag_mask)
    gbdt.train_score.score = rules.place("score", gbdt.train_score.score) \
        .contiguous()
    obj = gbdt.objective
    if obj is not None:
        obj.place_rows(rules)


def make_data_parallel(gbdt, num_devices: Optional[int] = None) -> Mesh:
    """``tree_learner=data`` over every rank."""
    mesh = make_mesh(num_devices)
    apply_parallel_sharding(gbdt, mesh, "data")
    return mesh


def make_feature_parallel(gbdt, num_devices: Optional[int] = None) -> Mesh:
    """``tree_learner=feature`` over every rank."""
    mesh = make_mesh(num_devices)
    apply_parallel_sharding(gbdt, mesh, "feature")
    return mesh


def make_hybrid_parallel(gbdt, shape=None) -> Mesh:
    """``tree_learner=data_feature`` over a 2-D (data, feature) mesh, auto
    factored over the ranks when ``shape`` is omitted."""
    if shape is None:
        shape = default_mesh_shape_2d(world_size())
    mesh = make_mesh(shape=shape, axis_names=(AXIS_DATA, AXIS_FEATURE))
    apply_parallel_sharding(gbdt, mesh, "data_feature")
    return mesh

