"""Data- and voting-parallel frontier-wave learners over row shards.

Port of ``lightgbm_tpu/parallel/wave_sharded.py``: the frontier-wave
learner (``learner_wave.py``) with the row-sharded seams of
``compact_sharded.py`` (the reference templates its parallel learners over
its fastest serial learner, `data_parallel_tree_learner.cpp:257-258`):

  * every rank runs a wave's decide pass and stable partition over its
    LOCAL rows (the ``partition`` kernel on the shard) and one
    ``hist_segments`` launch for the W smaller children of its rows;
  * the W member histograms are reduce-scattered over the features in ONE
    collective per wave, the siblings subtracted in the rank's pool slice,
    and the 2W children's best splits come from slice scans (the
    ``split_scan`` kernel, or with quantized gradients the ``fused_scan``
    kernel, on the slice) merged by one all-gather;
  * the member counts of a wave are summed in one collective; the node and
    candidate tables stay replicated, so the greedy replay (the ``replay``
    kernel) is identical on every rank with no communication, apart from
    the widths its batched-stall gate reads: a rank's windows are its own,
    so the gate takes their maximum over the ranks (``_replicated_spans``,
    the JAX package's ``pmax`` fix of its high-severity finding).

Every decision the host takes (the pass flags, the replay's end) is read
from replicated tensors, so the ranks queue the same passes and meet in
the same collectives.  The slot sizing (``wave_dims``) uses the shard's
rows, as ``wave_sharded_eligible`` sizes the byte gate.
"""

from __future__ import annotations

import torch

from ..config import Config
from ..dataset import _ConstructedDataset
from ..learner_wave import WaveTreeLearner, wave_budget_reason
from .compact_sharded import ShardedSeams, VotingSeams
from .sharding import Mesh


class ShardedWaveLearner(ShardedSeams, WaveTreeLearner):
    """``tree_learner=data`` on the frontier-wave learner (see the module
    docstring)."""


class ShardedVotingWaveLearner(VotingSeams, ShardedWaveLearner):
    """``tree_learner=voting`` on the frontier-wave learner: the pool stays
    local and unreduced, and every wave's 2W children each run the PV-Tree
    election inside the one batched candidate scan."""

    def __init__(self, cfg: Config, data: _ConstructedDataset, mesh: Mesh,
                 device: torch.device, **kw):
        super().__init__(cfg, data, mesh, device, **kw)
        self._init_voting(cfg)


def wave_sharded_eligible(cfg: Config, data: _ConstructedDataset,
                          mesh_size: int) -> bool:
    """The serial wave gates at the per-rank shard length (no EFB: the
    sharded path never bundles); the pool is sized at the full feature
    width, exact for voting's local pool and conservative for data's."""
    if cfg.tpu_learner not in ("auto", "wave"):
        return False
    if data.max_num_bin > 256:
        return False
    if data.num_data_padded % max(mesh_size, 1):
        return False
    if data.bins.shape[0] % max(mesh_size, 1):
        return False
    return wave_budget_reason(
        cfg, int(data.num_data_padded) // max(mesh_size, 1),
        data.bins.shape[0], int(data.max_num_bin)) is None
