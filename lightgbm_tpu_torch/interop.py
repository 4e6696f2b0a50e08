"""Carry a dataset or a trained model from lightgbm_tpu into the port.

A GBDT's state is its bin mappers, its binned matrix and its trees.  Both
functions take plain numpy arrays and dicts (``BinMapper.to_dict()`` form,
the ``Tree`` field arrays), never JAX objects, so a caller can export them
from a JAX process and load them where JAX is absent.  The model-text route
(``Booster(model_str=...)``) works as well.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .binning import BinMapper
from .config import Config, resolve_device
from .dataset import Dataset, Metadata, _ConstructedDataset
from .engine import Booster
from .boosting.gbdt import GBDT, feature_infos
from .objectives import create_objective
from .tree import Tree


def _num_total(used_feature_map: np.ndarray,
               num_total_features: Optional[int]) -> int:
    if num_total_features is not None:
        return int(num_total_features)
    return int(used_feature_map.max(initial=-1)) + 1


def _names(feature_names: Optional[List[str]], total: int) -> List[str]:
    return list(feature_names) if feature_names else \
        [f"Column_{i}" for i in range(total)]


def _constructed(bins: np.ndarray, bin_mappers: Sequence[Dict],
                 used_feature_map: np.ndarray, num_data: int,
                 num_total_features: Optional[int], cfg: Config,
                 feature_names: Optional[List[str]]) -> _ConstructedDataset:
    c = _ConstructedDataset()
    c.bins = np.array(bins, copy=True)
    c.bin_mappers = [BinMapper.from_dict(d) for d in bin_mappers]
    c.used_feature_map = np.asarray(used_feature_map, dtype=np.int32)
    c.num_data = int(num_data)
    c.num_data_padded = int(c.bins.shape[1])
    c.num_total_features = _num_total(c.used_feature_map, num_total_features)
    c.feature_names = _names(feature_names, c.num_total_features)
    c.max_num_bin = max((m.num_bin for m in c.bin_mappers), default=1)
    c.config = cfg
    c.metadata = Metadata(c.num_data)
    return c


def dataset_from_jax_arrays(bins: np.ndarray, bin_mappers: List[Dict],
                            used_feature_map: np.ndarray, label: np.ndarray,
                            num_data: int, *, device,
                            num_total_features: Optional[int] = None,
                            feature_names: Optional[List[str]] = None,
                            params: Optional[Dict] = None) -> Dataset:
    """A port ``Dataset`` bitwise equal to a JAX ``_ConstructedDataset`` with
    these ``bins`` (features_padded, rows_padded), mappers and labels; its
    bin codes are uploaded to ``device`` at once.  EFB bundling is re-derived
    from the bins under ``params``, as the JAX package derives it."""
    cfg = Config.from_params(params or {})
    c = _constructed(bins, bin_mappers, used_feature_map, num_data,
                     num_total_features, cfg, feature_names)
    c.metadata.set_label(np.asarray(label)[:c.num_data])
    c._maybe_bundle(cfg)
    c.device_bins(torch.device(device))
    return Dataset._from_constructed(c, params)


def booster_from_jax_arrays(trees: List[Dict[str, np.ndarray]],
                            bin_mappers: List[Dict], objective: str, *,
                            used_feature_map: np.ndarray,
                            num_total_features: Optional[int] = None,
                            feature_names: Optional[List[str]] = None,
                            params: Optional[Dict] = None) -> Booster:
    """A port ``Booster`` holding the JAX ``Tree`` arrays ``trees`` (one dict
    per tree: ``num_leaves``, ``split_feature``, ``threshold``,
    ``decision_type``, ``left_child``, ``leaf_value``, ... as the attributes
    of ``lightgbm_tpu.tree.Tree``).  ``bin_mappers`` and ``used_feature_map``
    give the model text its feature infos; prediction walks the trees.  A
    multiclass model needs ``num_class`` in ``params``: its trees come in
    iteration order, K per iteration."""
    params = dict(params or {})
    params.setdefault("objective", objective)
    cfg = Config.from_params(params)
    device = resolve_device(cfg)
    gbdt = GBDT(cfg, device)
    mappers = [BinMapper.from_dict(d) for d in bin_mappers]
    used = np.asarray(used_feature_map, dtype=np.int32)
    total = _num_total(used, num_total_features)
    gbdt.objective = create_objective(cfg, device)
    # K trees per iteration for multiclass models (``num_class`` in params)
    gbdt.num_tree_per_iteration = (
        gbdt.objective.num_model_per_iteration if gbdt.objective is not None
        else max(cfg.num_class, 1))
    gbdt.max_feature_idx = total - 1
    gbdt.feature_names = _names(feature_names, total)
    gbdt.feature_infos = feature_infos(mappers, used, total)
    gbdt.models = [_tree_from_arrays(t) for t in trees]
    gbdt.iter_ = len(gbdt.models)
    return Booster._from_gbdt(params, gbdt)


def _tree_from_arrays(arrays: Dict[str, np.ndarray]) -> Tree:
    nl = int(np.asarray(arrays["num_leaves"]))
    t = Tree(max(nl, 2, int(np.asarray(arrays.get("max_leaves", nl)))))
    t.num_leaves = nl
    for name, val in arrays.items():
        if name in ("num_leaves", "max_leaves"):
            continue
        cur = getattr(t, name, None)
        if isinstance(cur, np.ndarray):
            val = np.asarray(val, dtype=cur.dtype)
            cur[:len(val)] = val[:len(cur)]
        elif name in ("shrinkage", "num_cat"):
            setattr(t, name, type(cur)(np.asarray(val)))
        elif name in ("cat_boundaries", "cat_threshold"):
            setattr(t, name, [int(v) for v in np.asarray(val).ravel()])
    return t
