"""Shard re-deal for elastic membership changes.

Port of ``lightgbm_tpu/elastic/redeal.py``.  When a membership epoch
shrinks, the dead host's rows must land on the survivors.  An in-memory
Dataset cannot do this: the rows a host loaded are all it will ever have.
A ``two_round`` file source can: the file outlives every host, so each
epoch re-runs the two-pass loader with ``rank`` / ``num_machines`` taken
from the current membership, and the mod-dealing
(``global_row % num_machines == rank``) re-deals every row, the dead
rank's included, with no per-row bookkeeping.

The pass-1 bin sample is drawn from the whole file with the config's seed,
so every rank of every epoch derives the same mapper table without a
collective; the binned shards are then exchanged over the pod's
``DistributedNet`` (one ``set`` a rank) and reassembled in global row order
on every host (:func:`assemble_global`).  The assembled dataset equals a
single-host ``two_round`` construction of the same file but for its
padding, so the trained trees do not depend on the epoch's shard layout:
resuming epoch k's snapshot under epoch k+1's membership changes only the
ranks the rows are laid over, never the rows.

Cost: each host streams the whole file but bins only its 1/M of the rows,
then holds the whole binned matrix (uint8) after the exchange.  The
exchange moves O(n * f) bytes through the store: fine at the drills' sizes,
and a limit for large pods (which would exchange over the process group).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from ..config import Config
from ..dataset import Metadata, _ConstructedDataset


def _round_up(v: int, m: int) -> int:
    return ((int(v) + m - 1) // m) * m


def construct_elastic(path: str, params: Optional[dict], cfg: Config,
                      categorical: Sequence[int] = (),
                      feature_names: Optional[List[str]] = None,
                      info=None, net=None) -> _ConstructedDataset:
    """Elastic construction of ``path``: the two-pass stream of this rank's
    mod-dealt shard, then the global reassembly over the pod's net.  Rank
    and machines come from the live process group (the current membership),
    never from the config, which still describes the original launch."""
    from ..parallel.multihost import DistributedNet
    from ..reliability.metrics import rel_inc

    if cfg.pre_partition:
        raise ValueError(
            "elastic=true cannot re-deal pre_partition=true shards: each "
            "host's file holds ONLY its rows, so a dead host's rows are "
            "unreachable — use a shared data file (pre_partition=false)")
    if net is None:
        net = DistributedNet(cfg, namespace="redeal")
    shard = _ConstructedDataset.from_stream(
        path, params, cfg, categorical=categorical,
        feature_names=feature_names, rank=net.rank,
        num_machines=net.num_machines, info=info)
    if net.num_machines <= 1:
        return shard
    rel_inc("elastic.redeal_rows", int(shard.num_data))
    return assemble_global(shard, net)


def assemble_global(shard: _ConstructedDataset,
                    net) -> _ConstructedDataset:
    """Exchange the mod-dealt binned shards and reassemble the whole
    dataset in global row order on every rank (``shard`` is changed in
    place and returned).  Rows pad to a multiple of ``tpu_row_block`` and of
    the world, features to a multiple of ``FEATURE_TILE`` and of the world,
    so ``sharding.PlacementRules.place`` splits both evenly over the
    current epoch's ranks, whatever the survivor count."""
    if getattr(shard.metadata, "query_boundaries", None) is not None:
        raise ValueError(
            "elastic re-deal does not support ranking query groups yet — "
            "whole-query dealing changes per-rank row counts across "
            "epochs; train lambdarank non-elastically")
    n = int(shard.num_data_global)
    n_local = int(shard.num_data)
    weights = getattr(shard.metadata, "weights", None)
    payload = (np.asarray(shard.global_rows, dtype=np.int64),
               np.ascontiguousarray(shard.bins[:, :n_local]),
               np.asarray(shard.metadata.label, dtype=np.float64),
               None if weights is None else np.asarray(weights))
    parts = net.allgather(payload)

    cfg = shard.config
    world = max(int(net.num_machines), 1)
    block = max(int(cfg.tpu_row_block), 128)
    n_pad = _round_up(max(n, 1), math.lcm(block, world))
    f_pad = _round_up(int(shard.bins.shape[0]),
                      math.lcm(_ConstructedDataset.FEATURE_TILE, world))
    bins = np.zeros((f_pad, n_pad), dtype=shard.bins.dtype)
    labels = np.zeros(n, dtype=np.float64)
    wout = None
    covered = 0
    for rows, b, lab, w in parts:
        bins[:b.shape[0], rows] = b
        labels[rows] = lab
        if w is not None:
            if wout is None:
                wout = np.zeros(n, dtype=np.float64)
            wout[rows] = w
        covered += len(rows)
    if covered != n:
        raise ValueError(f"re-deal reassembly covered {covered} rows, "
                         f"expected {n} — shards overlap or are missing")
    shard.bins = bins
    shard.num_data = n
    shard.num_data_padded = n_pad
    shard.metadata = Metadata(n)
    shard.metadata.set_label(labels)
    if wout is not None:
        shard.metadata.set_weights(wout)
    # a full-coverage dataset now, not a shard
    shard.global_rows = np.arange(n, dtype=np.int64)
    shard.row_offset = 0
    shard.num_data_global = n
    # caches derived from the shard's layout
    shard._device_bins = {}
    shard._feature_meta = None
    return shard
