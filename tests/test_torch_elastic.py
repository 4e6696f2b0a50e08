"""Port elastic pod training vs lightgbm_tpu's elastic package.

``lightgbm_tpu_torch/elastic/`` (membership epochs on the pod's store, the
re-deal, the per-epoch worker and the per-host controller) and the elastic
halves of ``reliability/resume.py`` and the telemetry report, held against
the JAX package's ``tests/test_multihost.py`` elastic tests:

  * the membership-epoch record, the fingerprint split, an elastic resume
    across a topology change, the in-memory warning and the report's
    ``elastic`` section, each against the JAX function on the same input;
  * the 3 -> 2 shrink drill: three host agents (``run_host``) over one
    ``two_round`` CSV, host 1's worker killed at its 5th collective; the
    survivors finish every round with equal models, within 2e-3 AUC of
    the uninterrupted three-host run, history ``[[0, 1, 2], [0, 2]]``;
  * the below-``elastic_min_ranks`` drill, which is terminal.

Every agent is a subprocess of ``tests/_torch_multihost_worker.py``; the
agents never touch a device (``torch.cuda.is_initialized()`` stays false).
"""

import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.elastic import MembershipEpoch as JEpoch
from lightgbm_tpu.elastic.epoch import coordinator_for_epoch as jcoord
from lightgbm_tpu.reliability import resume as jresume
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.elastic import MembershipEpoch
from lightgbm_tpu_torch.elastic.epoch import coordinator_for_epoch
from lightgbm_tpu_torch.observability import validate_report
from lightgbm_tpu_torch.observability.telemetry import Telemetry
from lightgbm_tpu_torch.parallel.launch import free_port
from lightgbm_tpu_torch.reliability.metrics import rel_get, rel_reset
from lightgbm_tpu_torch.reliability.resume import (config_fingerprint,
                                                   find_resume_snapshot,
                                                   topology_fingerprint)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_multihost import run_pod  # noqa: E402

torch.set_num_threads(1)

ITERS = 6


def _write_train_csv(path, seed=0, n=600, f=30):
    """The JAX drills' problem as a CSV (label first): an elastic run needs
    a file source, which alone can re-deal a dead host's rows."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + np.sin(X[:, 1]) + 0.3 * rng.randn(n) > 0).astype(float)
    with open(path, "w") as fh:
        for i in range(n):
            fh.write(",".join([repr(float(y[i]))] +
                              [repr(float(v)) for v in X[i]]) + "\n")
    return X, y


def _auc(y, score):
    """Tie-averaged rank AUC."""
    y = np.asarray(y) > 0
    s = np.asarray(score, dtype=np.float64)
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(len(s), dtype=np.float64)
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and s[order[j + 1]] == s[order[i]]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    n1 = int(y.sum())
    n0 = len(y) - n1
    return (ranks[y].sum() - n1 * (n1 + 1) / 2.0) / (n1 * n0)


def _elastic_specs(tmp_path, nproc, data, name, **extra):
    port = free_port()
    return [dict(job="elastic", rank=r, num_hosts=nproc, port=port,
                 data=data, iters=ITERS, workdir=str(tmp_path / name),
                 telemetry_out=str(tmp_path / f"{name}_telem_h{r}.json"),
                 out=str(tmp_path / f"{name}_r{r}.json"), **extra)
            for r in range(nproc)]


# -- in-process pieces ---------------------------------------------------------

def test_membership_epoch_roundtrip():
    """The record, its rank rule and the epoch's address equal the JAX
    package's."""
    kw = dict(epoch=3, members=[0, 2, 5], dead_hosts=[1],
              coordinator="127.0.0.1:12424")
    e = MembershipEpoch(**kw)
    assert MembershipEpoch.from_dict(e.to_dict()) == e
    assert e.to_dict() == JEpoch(**kw).to_dict()
    assert e.rank_of(5) == JEpoch(**kw).rank_of(5) == 2
    assert coordinator_for_epoch("127.0.0.1", 12421, 3) \
        == jcoord("127.0.0.1", 12421, 3) == "127.0.0.1:12424"


def test_fingerprint_splits_semantics_from_topology():
    """A world-shape change moves only the topology fingerprint; the
    elastic knobs move neither; a semantic change moves the config one (the
    JAX package's split, checked the same way)."""
    base = {"objective": "binary", "num_leaves": 7, "learning_rate": 0.1}
    shapes = [dict(base),
              dict(base, coordinator_address="127.0.0.1:1", num_hosts=2,
                   process_id=1),
              dict(base, learning_rate=0.3),
              dict(base, elastic=True, elastic_epoch=4,
                   elastic_max_recoveries=9)]

    def pattern(cfg_cls, fp, topo):
        c = [cfg_cls.from_params(dict(p)) for p in shapes]
        return ([fp(c[0]) == fp(x) for x in c[1:]],
                [topo(c[0]) == topo(x) for x in c[1:]])

    mine = pattern(Config, config_fingerprint, topology_fingerprint)
    assert mine == pattern(JConfig, jresume.config_fingerprint,
                           jresume.topology_fingerprint)
    assert mine == ([True, False, True], [False, True, True])


def test_elastic_resume_accepts_topology_change(tmp_path):
    """A snapshot of another world shape is refused for a plain resume and
    taken, with a warning and ``snapshots_resumed_after_shrink``, for an
    elastic one, as in the JAX package."""
    rng = np.random.RandomState(42)
    X = rng.randn(200, 4)
    y = (X[:, 0] > 0).astype(float)
    base = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 10,
            "verbosity": -1}
    out = str(tmp_path / "model.txt")
    p = dict(base, output_model=out, snapshot_freq=2, device_type="cpu")
    lt.train(p, lt.Dataset(X, label=y, params=p), 4, verbose_eval=False)
    shrunk = dict(base, coordinator_address="127.0.0.1:1", num_hosts=2,
                  process_id=0, device_type="cpu")
    with pytest.warns(UserWarning, match="different topology"):
        assert find_resume_snapshot(
            out, Config.from_params(dict(shrunk))) is None
    rel_reset()
    with pytest.warns(UserWarning, match="elastic resume"):
        found = find_resume_snapshot(
            out, Config.from_params(dict(shrunk, elastic=True)))
    assert found is not None and found[0] == 4
    assert rel_get("snapshots_resumed_after_shrink") == 1


def test_elastic_inmemory_dataset_warns_cannot_redeal():
    """``elastic=true`` on an in-memory Dataset warns, as the JAX package
    does, that it cannot re-deal rows after a shrink."""
    X = np.random.RandomState(1).randn(50, 3)
    y = (X[:, 0] > 0).astype(float)
    params = {"objective": "binary", "verbosity": -1, "elastic": True}
    msgs = []
    for ds in (lt.Dataset(X, label=y, params=dict(params,
                                                  device_type="cpu")),
               lj.Dataset(X, label=y, params=params)):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            ds.construct()
        msgs.append([str(w.message) for w in got
                     if w.category is RuntimeWarning])
    assert msgs[0] == msgs[1] and "CANNOT re-deal" in msgs[0][0]


def test_telemetry_elastic_section_schema():
    """``set_elastic`` lands the optional ``elastic`` section, absent by
    default, and the report validates against the schema, as the JAX
    report does."""
    from lightgbm_tpu.observability.telemetry import Telemetry as JTel
    tel, jtel = Telemetry(True), JTel(True)
    assert "elastic" not in tel.report() and "elastic" not in jtel.report()
    for t in (tel, jtel):
        t.set_elastic(epoch=1, members=2, recoveries=1, ranks_lost=1)
    rep = tel.report()
    assert rep["schema_version"] == 11
    assert rep["elastic"] == jtel.report()["elastic"]
    assert validate_report(rep) == []


def test_several_ranks_a_host_are_refused(monkeypatch, tmp_path):
    """This slice runs one rank a host: an agent under
    ``LOCAL_WORLD_SIZE > 1`` raises naming its ROADMAP.md Queue A item
    before it starts a worker."""
    from lightgbm_tpu_torch.elastic import run_host
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError,
                       match="Queue A: elastic training with several ranks "
                             "per host"):
        run_host({"elastic": True}, str(tmp_path / "none.csv"), 2,
                 host_id=0, num_hosts=2, workdir=str(tmp_path / "w"))
    assert not (tmp_path / "w").exists()


# -- the drills ---------------------------------------------------------------

@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """The uninterrupted three-host run and the run that loses host 1."""
    tmp = tmp_path_factory.mktemp("elastic")
    data = str(tmp / "train.csv")
    X, y = _write_train_csv(data)
    ref = run_pod(_elastic_specs(tmp, 3, data, "ref"), timeout_s=300)
    specs = _elastic_specs(tmp, 3, data, "chaos",
                           trace_out=str(tmp / "chaos_trace.json"))
    # host 1's worker dies at its 5th collective: the re-deal's allgather
    # is #1, so this is the heartbeat before iteration 4 (snapshots of
    # iterations 1-3 exist); armed in host 1's agent only, so the new
    # rank 1 (host 2) is never killed
    specs[1]["faults"] = "net.crash:rank=1:nth=5"
    chaos = run_pod(specs, timeout_s=300)
    return {"X": X, "y": y, "ref": ref, "chaos": chaos, "specs": specs}


def test_uninterrupted_elastic_run(drill):
    models = []
    for rank, (rc, rep, tail) in drill["ref"].items():
        assert rc == 0 and rep is not None and rep["ok"], \
            f"agent {rank} failed (rc={rc}):\n{tail[-3000:]}\n{rep}"
        assert rep["recoveries"] == 0 and len(rep["history"]) == 1
        assert rep["iterations"] == ITERS
        assert rep["cuda_initialized"] is False
        models.append(rep["model"])
    assert models[0] == models[1] == models[2]
    bst = lt.Booster(model_str=models[0], params={"device_type": "cpu"})
    assert bst.num_trees() == ITERS
    assert _auc(drill["y"], bst.predict(drill["X"])) > 0.8


def test_shrink_survives_rank_death(drill):
    """3 -> 2: host 1's agent reports its worker's exit 17; hosts 0 and 2
    negotiate epoch 1 over epoch 0's store, re-deal the rows, resume from
    the last snapshot and finish every round with the same model, within
    2e-3 AUC of the uninterrupted run, with the counters, the report's
    ``elastic`` section and the controller's recovery spans."""
    rc1, rep1, tail1 = drill["chaos"][1]
    assert rc1 == 0 and rep1 is not None, tail1[-2000:]
    assert rep1["ok"] is False and rep1["error_kind"] == "host_dead"
    assert rep1["rc"] == 17
    for rank in (0, 2):
        rc, rep, tail = drill["chaos"][rank]
        assert rc == 0 and rep is not None and rep["ok"], \
            f"survivor {rank} failed (rc={rc}):\n{tail[-3000:]}\n{rep}"
        assert rep["recoveries"] == 1 and rep["ranks_lost"] == 1
        assert [e["members"] for e in rep["history"]] == [[0, 1, 2], [0, 2]]
        assert rep["history"][1]["dead_hosts"] == [1]
        assert rep["iterations"] == ITERS
        assert rep["rel_counters"].get("elastic.recoveries") == 1
        assert rep["rel_counters"].get("elastic.ranks_lost") == 1
        assert rep["worker_counters"].get(
            "snapshots_resumed_after_shrink", 0) >= 1
        assert rep["worker_counters"].get("resume_runs", 0) >= 1
        assert rep["cuda_initialized"] is False
        sec = rep["report_elastic"]
        assert sec["epochs"] == 2 and sec["members"] == [0, 2]
        assert sec["recoveries"] == 1 and sec["ranks_lost"] == 1
        assert sec["redeal_rows"] > 0 and sec["recovery_wall_s"] > 0.0
        with open(drill["specs"][rank]["telemetry_out"]) as fh:
            report = json.load(fh)
        assert validate_report(report) == []
        assert report["elastic"]["recoveries"] == 1
        tpath = f"{drill['specs'][rank]['trace_out']}.elastic_h{rank}"
        with open(tpath) as fh:
            names = {ev.get("name") for ev in json.load(fh)["traceEvents"]}
        assert {"elastic.epoch", "elastic.recovery"} <= names
    m0, m2 = drill["chaos"][0][1]["model"], drill["chaos"][2][1]["model"]
    assert m0 == m2, "survivors diverged after the shrink"
    ref = lt.Booster(model_str=drill["ref"][0][1]["model"],
                     params={"device_type": "cpu"})
    got = lt.Booster(model_str=m0, params={"device_type": "cpu"})
    auc_ref = _auc(drill["y"], ref.predict(drill["X"]))
    auc = _auc(drill["y"], got.predict(drill["X"]))
    assert abs(auc - auc_ref) < 2e-3, (auc, auc_ref)


def test_below_min_ranks_is_terminal(tmp_path):
    """Two hosts with ``elastic_min_ranks=2``: losing host 1 leaves one
    rank, below the floor, and the survivor's controller raises the
    terminal error with the whole epoch history instead of training on."""
    data = str(tmp_path / "train.csv")
    _write_train_csv(data, n=300, f=10)
    specs = _elastic_specs(tmp_path, 2, data, "floor", min_ranks=2)
    specs[1]["faults"] = "net.crash:rank=1:nth=2"
    pod = run_pod(specs, timeout_s=240)
    rc1, rep1, _ = pod[1]
    assert rc1 == 0 and rep1["error_kind"] == "host_dead" \
        and rep1["rc"] == 17
    rc0, rep0, tail0 = pod[0]
    assert rc0 == 0 and rep0 is not None, tail0[-3000:]
    assert rep0["ok"] is False and rep0["error_kind"] == "terminal"
    assert "below elastic_min_ranks=2" in rep0["error"]
    assert "Epoch history:" in rep0["error"]
    assert [e["members"] for e in rep0["history"]] == [[0, 1], [0]]
    assert rep0["history"][1]["dead_hosts"] == [1]
    assert rep0["rel_counters"].get("elastic.recoveries") == 1
