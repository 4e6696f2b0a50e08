"""Dataset placement shims (deprecated), as ``lightgbm_tpu/parallel/mesh.py``.

``make_mesh`` lives in ``sharding.py`` and is re-exported here;
``shard_dataset`` and ``row_sharding`` are the JAX package's round-3
helpers, kept as thin aliases of the rule-driven placement
(``rules_for_mode``) that warn when called.
"""

from __future__ import annotations

import warnings

import numpy as np

from .sharding import (AXIS_DATA, AXIS_FEATURE, Mesh,  # noqa: F401
                       feature_axis, make_mesh, mesh_for_config,
                       parse_mesh_shape, row_axis, rules_for_mode)


def _deprecated(old: str, new: str) -> None:
    warnings.warn(f"lightgbm_tpu_torch.parallel.mesh.{old} is deprecated; "
                  f"use {new} (parallel/sharding.py)", DeprecationWarning,
                  stacklevel=3)


def shard_dataset(data, mesh: Mesh, mode: str = "data") -> np.ndarray:
    """DEPRECATED: use ``rules_for_mode(mode, mesh).place("bins", ...)``.
    This rank's block of a constructed dataset's (F, N) bin codes; for
    ``feature`` the round-3 layout, a block of the feature rows."""
    _deprecated("shard_dataset", "rules_for_mode(mode, mesh).place")
    if mode == "feature":
        f = data.bins.shape[0]
        d = mesh.axis_size(feature_axis(mesh))
        k = -(-f // d)
        lo = min(mesh.axis_index(feature_axis(mesh)) * k, f)
        return data.bins[lo:lo + k]
    if mode not in ("data", "voting", "data_feature"):
        raise ValueError(f"unknown parallel mode {mode}")
    return rules_for_mode(mode, mesh).place("bins", data.bins)


def row_sharding(mesh: Mesh) -> str:
    """DEPRECATED: use ``row_axis(mesh)``; the axis that splits rows."""
    _deprecated("row_sharding", "row_axis")
    return row_axis(mesh)
