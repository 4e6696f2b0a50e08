"""Crash-safe resume of the port's training (``reliability/resume.py``).

Ports ``tests/test_reliability.py:231-314``: a run killed after some
iterations and relaunched with ``resume`` writes the model text of an
uninterrupted run, byte for byte, with bagging and ``feature_fraction``
too (the state sidecar restores the live scores and the random streams);
snapshot retention, a fingerprint mismatch and a truncated snapshot are
held as in the JAX package, whose snapshot files the port's names and
sidecars follow.  The synchronous loop (a validation set) and the
pipelined one differ after the first tree (ROADMAP.md "Facts about the
reference"), so each resumed run is held against the same loop's
uninterrupted run, on the wave and the compact learner.  One case kills
the run through the ``train.crash`` fault point.
"""

import os

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu.reliability import resume as jresume
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.reliability import faults
from lightgbm_tpu_torch.reliability.metrics import rel_get, rel_reset
from lightgbm_tpu_torch.reliability.resume import (find_resume_snapshot,
                                                   list_snapshots,
                                                   validate_snapshot)

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

_TRAIN_P = {"objective": "regression", "num_leaves": 15,
            "min_data_in_leaf": 5, "verbosity": -1, "device_type": "cpu"}
_BAGGED = {"bagging_fraction": 0.8, "bagging_freq": 1,
           "feature_fraction": 0.7}


@pytest.fixture(autouse=True)
def _clean_state():
    rel_reset()
    faults.reset()
    yield
    faults.reset()


def _data(n=400, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    y = X[:, 0] + 0.5 * X[:, 1] ** 2 + rng.randn(n) * 0.1
    return X, y


def _train(X, y, rounds, loop="pipelined", **extra):
    p = dict(_TRAIN_P, **extra)
    valid = None
    if loop == "sync":
        # a validation set keeps the synchronous loop
        valid = [lt.Dataset(X[:100], label=y[:100])]
    bst = lt.train(p, lt.Dataset(X, label=y), rounds, valid_sets=valid,
                   verbose_eval=False)
    assert bst.gbdt._can_pipeline() == (loop == "pipelined")
    return bst


@pytest.mark.parametrize("learner", ["wave", "compact"])
@pytest.mark.parametrize("loop", ["pipelined", "sync"])
def test_resume_bit_identical_model_text(tmp_path, loop, learner):
    """Killed at iteration 4 of 8 (snapshots every 2), relaunched with
    resume: the model text equals an uninterrupted 8-iteration run's."""
    X, y = _data()
    out = str(tmp_path / "model.txt")
    kw = dict(loop=loop, tpu_learner=learner)
    full = _train(X, y, 8, **kw).model_to_string()
    _train(X, y, 4, output_model=out, snapshot_freq=2, **kw)
    assert [it for it, _ in list_snapshots(out)] == [2, 4]
    resumed = _train(X, y, 8, output_model=out, snapshot_freq=2,
                     resume=True, **kw)
    assert resumed.num_trees() == 8
    assert resumed.model_to_string() == full
    assert rel_get("resume_runs") == 1


@pytest.mark.parametrize("learner", ["wave", "compact"])
@pytest.mark.parametrize("loop", ["pipelined", "sync"])
def test_resume_bit_identical_with_bagging(tmp_path, loop, learner):
    """The random streams (bagging, feature_fraction) resume exactly."""
    X, y = _data()
    out = str(tmp_path / "model.txt")
    kw = dict(_BAGGED, loop=loop, tpu_learner=learner)
    full = _train(X, y, 8, **kw).model_to_string()
    _train(X, y, 5, output_model=out, snapshot_freq=3, **kw)
    resumed = _train(X, y, 8, output_model=out, snapshot_freq=3,
                     resume=True, **kw)
    assert resumed.model_to_string() == full


@pytest.mark.parametrize("learner", ["wave", "compact"])
def test_train_crash_then_resume(tmp_path, learner):
    """``train.crash:nth=3`` kills a bagged run after its third iteration,
    the snapshot of iteration 2 written; the resumed run equals the
    uninterrupted one."""
    X, y = _data(seed=1)
    out = str(tmp_path / "model.txt")
    kw = dict(_BAGGED, tpu_learner=learner)
    full = _train(X, y, 6, **kw).model_to_string()
    with pytest.raises(faults.InjectedFault,
                       match="train.crash at iteration 3"):
        _train(X, y, 6, output_model=out, snapshot_freq=2,
               fault_spec="train.crash:nth=3", **kw)
    assert [it for it, _ in list_snapshots(out)] == [2]
    assert rel_get("fault.train.crash") == 1
    faults.reset()
    resumed = _train(X, y, 6, output_model=out, snapshot_freq=2,
                     resume=True, **kw)
    assert resumed.model_to_string() == full


def test_snapshot_retention_keeps_last_k(tmp_path):
    X, y = _data(n=200)
    out = str(tmp_path / "model.txt")
    _train(X, y, 6, output_model=out, snapshot_freq=1, snapshot_keep=2)
    assert [it for it, _ in list_snapshots(out)] == [5, 6]
    # the sidecars go with their snapshots
    leftovers = [f for f in os.listdir(tmp_path)
                 if "snapshot_iter" in f
                 and not (f.endswith("_5") or f.endswith("_6")
                          or "_5." in f or "_6." in f)]
    assert leftovers == []
    assert rel_get("snapshots_pruned") == 4
    # the JAX package lists the same files
    assert jresume.list_snapshots(out) == list_snapshots(out)


def test_resume_rejects_fingerprint_mismatch(tmp_path):
    """A snapshot of another training config is never resumed."""
    X, y = _data(n=200)
    out = str(tmp_path / "model.txt")
    _train(X, y, 4, output_model=out, snapshot_freq=2)
    other = Config.from_params(dict(_TRAIN_P, learning_rate=0.31))
    with pytest.warns(UserWarning, match="skipping snapshot"):
        assert find_resume_snapshot(out, other) is None
    assert rel_get("snapshots_rejected.fingerprint_mismatch") == 2
    found = find_resume_snapshot(out, Config.from_params(dict(_TRAIN_P)))
    assert found is not None and found[0] == 4
    # the JAX package reads the port's snapshot as a complete model
    assert jresume.validate_snapshot(found[1]) == (True, "ok")


def test_truncated_snapshot_falls_back_to_older(tmp_path):
    X, y = _data(n=200)
    out = str(tmp_path / "model.txt")
    _train(X, y, 4, output_model=out, snapshot_freq=2)
    snaps = dict(list_snapshots(out))
    text = open(snaps[4]).read()
    open(snaps[4], "w").write(text[:len(text) // 3])
    ok, reason = validate_snapshot(snaps[4])
    assert not ok and "truncated" in reason
    assert jresume.validate_snapshot(snaps[4]) == (ok, reason)
    with pytest.warns(UserWarning, match="skipping snapshot"):
        found = find_resume_snapshot(out, Config.from_params(dict(_TRAIN_P)))
    assert found is not None and found[0] == 2
