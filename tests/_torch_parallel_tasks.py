"""Rank tasks of tests/test_torch_parallel.py, run in spawned ranks.

A spawned rank imports this module to find its task; it must not import
JAX (the test module's process has), so the tasks live here, apart from
the tests, and import only the port.
"""

from __future__ import annotations

import contextlib
import io
import os
import time

import numpy as np
import torch
import torch.distributed as dist

CPU = torch.device("cpu")

LEARNERS = {
    "ShardedCompactLearner": "compact_sharded",
    "ShardedVotingLearner": "compact_sharded",
    "ShardedWaveLearner": "wave_sharded",
    "ShardedVotingWaveLearner": "wave_sharded",
    "FeatureShardedCompactLearner": "feature_sharded",
    "FeatureShardedWaveLearner": "feature_sharded",
    "ShardedWave2DLearner": "wave2d_sharded",
    "ShardedMaskedLearner": "learners",
}


def _dataset(params, X, y):
    import lightgbm_tpu_torch as lt
    ds = lt.Dataset(X, label=y, params=dict(params, device_type="cpu"))
    ds.construct()
    return ds.constructed


def learner_records(cls_name, params, X, y, grad, hess, bag, mesh_shape,
                    mode=None, device="cpu"):
    """One tree of a sharded learner from the given padded float32 grad,
    hess and bag: (records, exact counts, leaf id of every row gathered
    over the row shards, leaf outputs, the ledger's sites, kernel calls,
    the local histogram of the root as the pool holds it)."""
    import importlib

    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.parallel.sharding import (make_mesh,
                                                      rules_for_mode)
    data = _dataset(params, X, y)
    cfg = Config.from_params(dict(params, device_type="cpu"))
    mesh = make_mesh(shape=mesh_shape) if len(mesh_shape) > 1 \
        else make_mesh(mesh_shape[0])
    mod = importlib.import_module("lightgbm_tpu_torch.parallel."
                                  + LEARNERS[cls_name])
    cls = getattr(mod, cls_name)
    dev = torch.device(device)
    if cls_name == "ShardedMaskedLearner":
        learner = cls(cfg, data, mesh, dev, mode)
    else:
        learner = cls(cfg, data, mesh, dev)
    rules = rules_for_mode(mode or learner._placement_mode, mesh)
    g, h, b = (rules.place("grad", torch.from_numpy(a).to(dev))
               for a in (grad, hess, bag))
    rec_f, rec_i, leaf_id, leaf_out = learner.grow(g, h, b)
    leaf_id, leaf_out = leaf_id.cpu(), leaf_out.cpu()
    if mode != "feature" and learner._placement_mode != "feature":
        leaf_id = mesh.all_gather(leaf_id, learner.axis).reshape(-1) \
            if getattr(learner, "row_shards", 1) > 1 else leaf_id
    return dict(rec_f=rec_f, rec_i=rec_i, leaf_id=leaf_id.numpy(),
                leaf_out=leaf_out.numpy(),
                sites=list(learner._ledger.sites()),
                kernel_calls=dict(learner.kernel_calls),
                launches=_launches(),
                device=str(learner.device),
                pool0=(learner._st.hist_pool[0].cpu().numpy()
                       if hasattr(learner, "_st") and learner._st is not None
                       else None),
                f_off=getattr(learner, "f_off", 0),
                stats=list(getattr(learner, "_tree_stats", [])))


def _launches():
    """The launches each kernel wrapper counted in this rank."""
    from lightgbm_tpu_torch.ops.hist_packed import build_histogram_packed
    from lightgbm_tpu_torch.ops.hist_segments import build_histogram_segments
    from lightgbm_tpu_torch.ops.partition import apply_partition
    from lightgbm_tpu_torch.ops.replay import replay_pass
    from lightgbm_tpu_torch.ops.scan import find_best_splits_batched
    return {f.__name__: int(getattr(f, "launches", 0)) for f in (
        build_histogram_packed, build_histogram_segments, apply_partition,
        replay_pass, find_best_splits_batched)}


def train_model(params, X, y, rounds, Xp=None):
    """``lt.train`` on every rank; (model text, predictions of ``Xp``, the
    report's collectives section, the learner's class name)."""
    import lightgbm_tpu_torch as lt
    p = dict(params, device_type="cpu")
    bst = lt.train(p, lt.Dataset(X, label=y, params=p), rounds,
                   verbose_eval=False)
    rep = bst.get_telemetry() if p.get("telemetry") else None
    pred = bst.predict(X if Xp is None else Xp)
    if rep is not None:
        from lightgbm_tpu_torch.observability import validate_report
        rep["collectives"]["report_errors"] = validate_report(rep)
    return dict(text=bst.model_to_string(), pred=pred,
                collectives=None if rep is None else rep["collectives"],
                learner=type(bst.gbdt.learner).__name__)


def rank_info():
    return dist.get_rank(), dist.get_world_size(), dist.get_backend()


def die_in_collective(flag_path, timeout_s):
    """Rank 1 dies; rank 0 enters an all-reduce with it and must raise
    (not hang) within the group's timeout: it writes what it saw to
    ``flag_path`` and re-raises."""
    if dist.get_rank() == 1:
        time.sleep(0.5)
        os._exit(3)
    t0 = time.monotonic()
    try:
        x = torch.ones(4)
        dist.all_reduce(x)
        dist.all_reduce(x)
    except Exception as e:
        with open(flag_path, "w") as f:
            f.write(f"{time.monotonic() - t0:.3f} {type(e).__name__}")
        raise
    raise AssertionError("the all-reduce with a dead rank returned")


def survivor(rank, world, port, flag_path, timeout_s):
    """A rank of a group started without a pool, so nothing but the group's
    timeout ends a wait: ``die_in_collective`` on rank ``rank``."""
    from lightgbm_tpu_torch.parallel.launch import init_group
    torch.set_num_threads(1)
    init_group(rank, world, port, "gloo", timeout_s)
    die_in_collective(flag_path, timeout_s)


def local_device():
    """This rank's LOCAL_RANK and LOCAL_WORLD_SIZE, and the card
    ``resolve_device`` gives it on a host that reports four cards."""
    from unittest import mock

    from lightgbm_tpu_torch.config import Config, resolve_device
    with mock.patch("torch.cuda.is_available", return_value=True), \
            mock.patch("torch.cuda.device_count", return_value=4):
        dev = resolve_device(Config.from_params({"device_type": "cuda"}))
    return (os.environ["LOCAL_RANK"], os.environ["LOCAL_WORLD_SIZE"],
            str(dev))


def router_lines(params, X, y):
    """The router's lines (``tree_learner=...``) a Booster prints."""
    import lightgbm_tpu_torch as lt
    p = dict(params, device_type="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lt.Booster(p, lt.Dataset(X, label=y, params=p))
    return [ln.split("] ", 1)[1] for ln in buf.getvalue().splitlines()
            if ln.startswith("[lightgbm_tpu_torch] tree_learner=")]


def place_and_gather(n):
    """This rank's block of arange(n) under the row rule, and the whole
    array gathered back."""
    from lightgbm_tpu_torch.parallel.sharding import make_mesh, rules_for_mode
    rules = rules_for_mode("data", make_mesh())
    block = rules.place("rows", torch.arange(n))
    return block.numpy(), rules.gather("rows", block, n).numpy()


def fail_on_rank(rank):
    """Raise on rank ``rank`` only; the others return."""
    if dist.get_rank() == rank:
        raise ValueError(f"a failure on rank {rank}")
    return dist.get_rank()


def train_crash_resume(params, X, y, rounds, workdir):
    """An uninterrupted run, and a run killed by ``train.crash`` after its
    third iteration (snapshots every two) then resumed: both model texts."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.reliability import faults
    p = dict(params, device_type="cpu")

    def run(extra):
        q = dict(p, **extra)
        return lt.train(q, lt.Dataset(X, label=y, params=q), rounds,
                        verbose_eval=False).model_to_string()

    whole = run({"output_model": os.path.join(workdir, "whole.txt")})
    snap = {"output_model": os.path.join(workdir, "m.txt"),
            "snapshot_freq": 2}
    try:
        run(dict(snap, fault_spec="train.crash:nth=3"))
    except faults.InjectedFault:
        pass
    else:
        raise AssertionError("train.crash did not fire")
    faults.reset()
    return whole, run(dict(snap, resume=True))
