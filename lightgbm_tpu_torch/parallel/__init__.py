"""Parallel tree learning over processes, on one host or a pod of hosts.

Port of ``lightgbm_tpu/parallel/``.  One process per rank over a
``torch.distributed`` process group: ``sharding.py`` (meshes, placement,
collectives, the backend rule), the sharded learners
(``compact_sharded.py``, ``wave_sharded.py``, ``feature_sharded.py``,
``wave2d_sharded.py``), the router (``learners.py``), the rank launcher
(``launch.py``) and the pod (``multihost.py``: the LGBT_* contract, the
store-backed ``DistributedNet`` and its heartbeat).
"""

from .sharding import (AXIS_DATA, AXIS_FEATURE, PARALLEL_MODES, Mesh,
                       PlacementRules, make_mesh, mesh_for_config,
                       parse_mesh_shape, row_axis, rules_for_mode)
from .mesh import shard_dataset
from . import multihost
from .learners import (make_data_parallel, make_feature_parallel,
                       make_hybrid_parallel, apply_parallel_sharding)

__all__ = ["AXIS_DATA", "AXIS_FEATURE", "PARALLEL_MODES", "Mesh",
           "PlacementRules", "make_mesh", "mesh_for_config",
           "parse_mesh_shape", "row_axis", "rules_for_mode", "shard_dataset",
           "make_data_parallel", "make_feature_parallel",
           "make_hybrid_parallel", "apply_parallel_sharding", "multihost"]
