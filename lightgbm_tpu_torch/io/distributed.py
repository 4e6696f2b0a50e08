"""Distributed bin finding and row-sharded loading.

Port of ``lightgbm_tpu/io/distributed.py`` (host code, copied), the
analogue of the reference's multi-machine dataset construction:

  * distributed FindBin (`src/io/dataset_loader.cpp:873-955`): machines
    split the feature range, each finds bins for its feature slice, and the
    serialized BinMappers are allgathered so every machine ends with the
    same global mapper table;
  * ``CheckOrPartition`` (`include/LightGBM/dataset.h:82`,
    `src/io/dataset_loader.cpp:133-170`): with ``pre_partition=false`` each
    machine keeps the rows with ``global_row % num_machines == rank`` while
    reading (whole query groups with a ``.query`` sidecar), so no host
    materializes the full matrix.

As in the JAX package, the per-host samples are drawn from one global index
sequence and allgathered before bin finding (``bin_construct_sample_cnt``
rows), so the mappers equal single-host binning whatever the sharding, and
the EFB bundles found on that global sample are the same on every rank.

The network seam is an injectable allgather: ``LoopbackCluster`` runs N
simulated hosts on threads; ``parallel/multihost.py:DistributedNet`` (the
pod's ``TCPStore``) and ``io/net.py:SocketNet`` (TCP) back the same three
calls (allgather / sync_min / sync_max) across processes.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..binning import BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper, kZeroThreshold
from ..config import Config
from ..dataset import Metadata, _ConstructedDataset


class LoopbackCluster:
    """Runs ``num_machines`` simulated hosts on threads with a barrier-based
    allgather — the in-process stand-in for `Network::Allgather`
    (`src/network/network.cpp`)."""

    def __init__(self, num_machines: int):
        self.num_machines = num_machines
        self._barrier = threading.Barrier(num_machines)
        self._slots: List = [None] * num_machines

    def run(self, fn: Callable, per_rank_args: Sequence) -> List:
        """Run ``fn(net, *per_rank_args[rank])`` on every rank; returns the
        per-rank results (exceptions re-raised)."""
        results: List = [None] * self.num_machines
        errors: List = [None] * self.num_machines

        def worker(rank: int):
            try:
                results[rank] = fn(_LoopbackNet(self, rank),
                                   *per_rank_args[rank])
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors[rank] = e
                try:
                    self._barrier.abort()
                except Exception:
                    pass

        threads = [threading.Thread(target=worker, args=(r,))
                   for r in range(self.num_machines)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # a rank failure aborts the barrier, so OTHER ranks die with a
        # secondary BrokenBarrierError — surface the root cause(s) instead.
        # MULTIPLE ranks can fail for independent reasons in one run (e.g.
        # two ranks fed corrupt shards); raising only the first would lose
        # the rest, so every root cause is aggregated into the message.
        root = [(r, e) for r, e in enumerate(errors)
                if e is not None
                and not isinstance(e, threading.BrokenBarrierError)]
        if len(root) == 1:
            raise root[0][1]
        if root:
            summary = "; ".join(
                f"rank {r}: {type(e).__name__}: {e}" for r, e in root)
            msg = f"{len(root)} ranks failed — {summary}"
            try:
                agg = type(root[0][1])(msg)
            except Exception:   # exception types with exotic signatures
                agg = RuntimeError(msg)
            raise agg from root[0][1]
        for e in errors:
            if e is not None:
                raise e
        return results


class _LoopbackNet:
    """Per-rank handle onto a LoopbackCluster (the `Network` role)."""

    def __init__(self, cluster: LoopbackCluster, rank: int):
        self._c = cluster
        self.rank = rank
        self.num_machines = cluster.num_machines

    def allgather(self, obj) -> List:
        c = self._c
        c._slots[self.rank] = obj
        c._barrier.wait()
        out = list(c._slots)
        c._barrier.wait()  # don't overwrite slots before everyone copied
        return out

    def sync_min(self, v: int) -> int:
        return min(self.allgather(int(v)))

    def sync_max(self, v: int) -> int:
        return max(self.allgather(int(v)))


def _gather(net, obj, what: str) -> List:
    """``net.allgather`` with construction-phase context: a collective
    failure (dead rank, deadline, abort broadcast — `io/net.py`) surfaces
    WHERE in bin construction it happened and on which rank, so a
    multi-process post-mortem starts from one log line."""
    try:
        return net.allgather(obj)
    except ConnectionError as e:
        raise ConnectionError(
            f"distributed construction failed at the {what} allgather on "
            f"rank {net.rank}: {e}") from e


def partition_rows(num_rows: int, rank: int, num_machines: int,
                   pre_partition: bool) -> np.ndarray:
    """Row indices owned by ``rank`` — ``CheckOrPartition``
    (`src/io/dataset_loader.cpp:133-170`): pre-partitioned data is used
    as-is; otherwise rows are dealt round-robin by global row index."""
    if pre_partition:
        return np.arange(num_rows, dtype=np.int64)
    return np.arange(rank, num_rows, num_machines, dtype=np.int64)


def partition_queries(group_sizes: np.ndarray, rank: int,
                      num_machines: int):
    """Query-aware dealing — ``Metadata::CheckOrPartition``
    (`src/io/metadata.cpp`, `include/LightGBM/dataset.h:82`): ranking data
    is dealt by QUERY (query q → machine ``q % num_machines``) so no group
    is ever torn across machines.  Returns (owned_row_indices,
    owned_group_sizes)."""
    sizes = np.asarray(group_sizes, dtype=np.int64).reshape(-1)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    owned_q = np.arange(rank, len(sizes), num_machines, dtype=np.int64)
    rows = np.concatenate(
        [np.arange(starts[q], starts[q + 1], dtype=np.int64)
         for q in owned_q]) if len(owned_q) else np.zeros(0, np.int64)
    return rows, sizes[owned_q]


def load_partitioned_file(path: str, params: Dict, rank: int,
                          num_machines: int, pre_partition: bool = False):
    """Read a text data file keeping only this rank's rows (mod-partition
    unless ``pre_partition``); lines owned by other ranks are never parsed,
    so peak memory is the shard, not the file.

    Returns (matrix, label, weight, group, global_rows) — ``global_rows``
    maps local row k to its global data-row index (for
    ``distributed_construct``'s sample alignment).  Sidecar ``.weight`` /
    ``.query`` files are read from the ORIGINAL path; weights are subset to
    the owned rows.  With a ``.query`` sidecar the mod-partition deals
    WHOLE QUERY GROUPS (query q → machine q mod num_machines —
    ``Metadata::CheckOrPartition``, `src/io/metadata.cpp`), so distributed
    lambdarank works on non-pre-split data.
    """
    from .parser import _load_sidecar, load_data_file

    if pre_partition or num_machines == 1:
        mat, label, weight, group = load_data_file(path, params)
        return mat, label, weight, group, np.arange(len(mat), dtype=np.int64)

    params = dict(params or {})
    has_header = str(params.get("header", params.get("has_header", "false"))
                     ).lower() in ("true", "1")
    # ranking sidecar first: it decides the dealing (by query, not by row)
    full_group = _load_sidecar(path + ".query")
    owned_sorted = None
    qgroup = None
    if full_group is not None:
        owned_q_rows, qgroup = partition_queries(full_group, rank,
                                                 num_machines)
        owned_sorted = owned_q_rows      # ascending (whole-query ranges)
    # stream: only OWNED lines are kept, so peak memory is the shard
    header = None
    shard_lines = []
    n_data = 0
    optr = 0
    with open(path, "r") as fh:
        for ln in fh:
            if not ln.strip():
                continue
            if has_header and header is None:
                header = ln
                continue
            if owned_sorted is not None:
                if optr < len(owned_sorted) and owned_sorted[optr] == n_data:
                    shard_lines.append(ln)
                    optr += 1
            elif n_data % num_machines == rank:
                shard_lines.append(ln)
            n_data += 1
    if owned_sorted is not None:
        # the reference errors on ANY query-sum/data-row mismatch
        # (`Metadata::CheckOrPartition`); checking the total on EVERY rank
        # also keeps an overcount from stranding non-tail ranks in the
        # subsequent collectives
        qsum = int(np.sum(full_group))
        if qsum != n_data:
            raise ValueError(
                f"query file rows ({qsum}) != data rows ({n_data})")
        owned = owned_sorted
    else:
        owned = partition_rows(n_data, rank, num_machines,
                               pre_partition=False)
    if header is not None:
        shard_lines = [header] + shard_lines

    import io as _io
    import os
    import tempfile
    fd, tmp = tempfile.mkstemp(suffix=os.path.splitext(path)[1] or ".csv")
    try:
        with _io.open(fd, "w") as out:
            out.writelines(shard_lines)
        mat, label, weight, group = load_data_file(tmp, params)
    finally:
        os.unlink(tmp)
    # sidecars live next to the ORIGINAL file, not the temp shard
    full_weight = _load_sidecar(path + ".weight")
    weight = full_weight[owned] if full_weight is not None else None
    return mat, label, weight, qgroup, owned


def _feature_ranges(num_features: int, num_machines: int):
    """The reference's contiguous feature split
    (`dataset_loader.cpp:879-891`)."""
    step = max((num_features + num_machines - 1) // num_machines, 1)
    start = [0] * num_machines
    length = [0] * num_machines
    for i in range(num_machines - 1):
        length[i] = min(step, num_features - start[i])
        length[i] = max(length[i], 0)
        start[i + 1] = start[i] + length[i]
    length[num_machines - 1] = num_features - start[num_machines - 1]
    return start, length


def distributed_construct(net, shard: np.ndarray, cfg: Config,
                          categorical: Sequence[int] = (),
                          feature_names: Optional[List[str]] = None,
                          label: Optional[np.ndarray] = None,
                          group: Optional[np.ndarray] = None,
                          global_rows: Optional[np.ndarray] = None,
                          ) -> _ConstructedDataset:
    """Construct this rank's row shard of a dataset with globally-identical
    bin mappers (see module docstring).  ``shard`` is the LOCAL row block
    ``(n_local, F)``; ``global_rows`` maps local row k to its global row
    index (default: ranks own contiguous blocks in rank order — pass the
    indices from ``load_partitioned_file`` for mod-partitioned shards).
    Returns a `_ConstructedDataset` over just those rows with
    ``global_rows``/``num_data_global`` recording the placement."""
    shard = np.ascontiguousarray(shard, dtype=np.float64)
    n_local, f_local = shard.shape

    # ---- global shape agreement (fail fast on column disagreement)
    fs = _gather(net, int(f_local), "feature-count")
    if len(set(fs)) != 1:
        raise ValueError(f"ranks disagree on feature count: {fs}")
    f = fs[0]
    counts = _gather(net, int(n_local), "row-count")
    n_total = int(sum(counts))
    offset = int(sum(counts[:net.rank]))
    if global_rows is None:
        global_rows = np.arange(offset, offset + n_local, dtype=np.int64)
    else:
        global_rows = np.asarray(global_rows, dtype=np.int64).reshape(-1)
        if len(global_rows) != n_local:
            raise ValueError("global_rows length != shard rows")

    # ---- one GLOBAL sample sequence; each rank contributes its rows
    if n_total > cfg.bin_construct_sample_cnt:
        rng = np.random.RandomState(cfg.data_random_seed)
        sample_idx = np.sort(rng.choice(n_total, cfg.bin_construct_sample_cnt,
                                        replace=False))
    else:
        sample_idx = np.arange(n_total)
    order = np.argsort(global_rows, kind="stable")
    sorted_rows = global_rows[order]
    pos = np.searchsorted(sorted_rows, sample_idx)
    hit = (pos < n_local)
    hit[hit] = sorted_rows[pos[hit]] == sample_idx[hit]
    local_pick = order[pos[hit]]
    local_sample = shard[local_pick]
    parts = _gather(net, (local_sample, sample_idx[hit]),
                    "global-sample")
    gidx = np.concatenate([p[1] for p in parts]) if parts else np.zeros(0)
    stacked = np.concatenate([p[0] for p in parts if len(p[0])], axis=0) \
        if any(len(p[0]) for p in parts) else np.zeros((0, f))
    # re-sort to global row order so the sample matrix is byte-identical to
    # the single-host `mat[sample_idx]` regardless of the shard layout
    sample = stacked[np.argsort(gidx, kind="stable")]
    total_sample_cnt = len(sample)

    # ---- each rank finds bins for its feature range over the full sample
    categorical = set(int(c) for c in categorical)
    start, length = _feature_ranges(f, net.num_machines)
    my_lo = start[net.rank]
    my_hi = my_lo + length[net.rank]
    local_mappers: List[Dict] = []
    for j in range(my_lo, my_hi):
        m = BinMapper()
        col = sample[:, j]
        col = col[(np.abs(col) > kZeroThreshold) | np.isnan(col)]
        m.find_bin(col, total_sample_cnt=total_sample_cnt,
                   max_bin=cfg.max_bin, min_data_in_bin=cfg.min_data_in_bin,
                   min_split_data=cfg.min_data_in_leaf,
                   bin_type=BIN_CATEGORICAL if j in categorical
                   else BIN_NUMERICAL,
                   use_missing=cfg.use_missing,
                   zero_as_missing=cfg.zero_as_missing)
        local_mappers.append(m.to_dict())

    # ---- allgather serialized mappers (the `BinMapper::CopyTo` +
    # `Network::Allgather` step, `dataset_loader.cpp:917-950`)
    gathered = _gather(net, json.dumps(local_mappers), "bin-mapper")
    all_mappers = [BinMapper.from_dict(d)
                   for part in gathered for d in json.loads(part)]
    assert len(all_mappers) == f

    # ---- assemble the local shard dataset (identical mapper table on
    # every rank; only the rows differ)
    ds = _ConstructedDataset()
    ds.config = cfg
    ds.num_data = n_local
    ds.num_total_features = f
    ds.feature_names = list(feature_names) if feature_names \
        else [f"Column_{i}" for i in range(f)]
    ds.metadata = Metadata(n_local)
    if label is not None:
        ds.metadata.set_label(np.asarray(label).reshape(-1))
    if group is not None and len(group):
        ds.metadata.set_group(np.asarray(group).reshape(-1))
    keep = [j for j, m in enumerate(all_mappers) if not m.is_trivial]
    ds.bin_mappers = [all_mappers[j] for j in keep]
    ds.used_feature_map = np.asarray(keep, dtype=np.int32)
    # is_reference_linked=True skips the LOCAL exclusivity scan (bundles
    # from local rows would disagree across ranks); rank-identical bundles
    # are derived from the GLOBAL sample below instead
    ds._bin_all(shard, cfg, is_reference_linked=True)
    # ---- EFB from the allgathered GLOBAL sample (the reference bundles
    # from sampled indices, `src/io/dataset.cpp:139` FastFeatureBundling):
    # the sample is the same global sequence on every rank, so the greedy
    # exclusivity grouping is the same everywhere.  The gates are the
    # serial learners' (`dataset.py:_maybe_bundle`): the sharded learners
    # consume unbundled columns (``_supports_bundle = False``)
    if cfg.enable_bundle and cfg.tree_learner == "serial" \
            and cfg.tpu_learner in ("auto", "wave", "compact") \
            and ds.max_num_bin <= 256 \
            and len(ds.bin_mappers) > 1 and total_sample_cnt > 0:
        from ..efb import apply_bundles, find_bundles

        class _SampleView:
            """find_bundles duck-type over the GLOBAL sample's bins."""
            num_data = total_sample_cnt
            num_used_features = len(ds.bin_mappers)
            bin_mappers = ds.bin_mappers
            bins = np.stack([m.values_to_bins(sample[:, int(j)])
                             for j, m in zip(ds.used_feature_map,
                                             ds.bin_mappers)])

        groups = find_bundles(_SampleView, cfg)
        if any(len(g) > 1 for g in groups):
            ds.bundle = apply_bundles(ds, groups)
    ds.global_rows = global_rows
    ds.row_offset = offset          # contiguous-layout convenience
    ds.num_data_global = n_total
    return ds
