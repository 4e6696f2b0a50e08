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
  * the below-``elastic_min_ranks`` drill, which is terminal;
  * several ranks a host (``LOCAL_WORLD_SIZE = 2``): the agent's spec and
    its two workers, the host failing as a whole, the rank-to-host mapping
    of the negotiation against the JAX function, the anchor host's death
    terminal; an uninterrupted 2 hosts x 2 ranks run byte-equal to a 4 x 1
    run of the same world and held against JAX ``train`` on a 4-device
    mesh; the 3 x 2 drill that kills host 1's local rank 1 (global rank
    3): host 1 fails whole, hosts 0 and 2 finish as the one-rank drill
    does.

Every agent is a subprocess of ``tests/_torch_multihost_worker.py``; the
agents never touch a device (``torch.cuda.is_initialized()`` stays false).
"""

import json
import os
import pickle
import sys
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.elastic import MembershipEpoch as JEpoch
from lightgbm_tpu.elastic.epoch import coordinator_for_epoch as jcoord
from lightgbm_tpu.elastic.epoch import negotiate_next_epoch as jnegotiate
from lightgbm_tpu.parallel.learners import apply_parallel_sharding
from lightgbm_tpu.parallel.sharding import make_mesh as jmesh
from lightgbm_tpu.reliability import resume as jresume
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.elastic import (EXIT_CONTROL_LOST, MembershipEpoch,
                                        negotiate_next_epoch)
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
import _torch_multihost_worker as worker  # noqa: E402
from test_torch_multihost import _structure, run_pod  # noqa: E402

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
    """Several ranks a host now train: an agent under
    ``LOCAL_WORLD_SIZE=2`` writes a spec with the local layout and starts
    two workers, each with its ``LOCAL_RANK`` and a log of its own.  When
    local rank 1 exits 17 with no verdict, the host fails as a whole: local
    rank 0 is killed and reaped, and the agent raises ``ElasticHostDead``
    with rc 17."""
    from lightgbm_tpu_torch.elastic import ElasticHostDead, controller
    from lightgbm_tpu_torch.elastic import run_host
    started = []

    class FakeWorker:
        def __init__(self, argv, env, stdout, stderr):
            self.argv, self.env, self.log = argv, env, stdout.name
            self.returncode = 17 if env["LOCAL_RANK"] == "1" else None
            self.killed = self.waited = False
            started.append(self)

        def poll(self):
            return self.returncode

        def kill(self):
            self.killed, self.returncode = True, -9

        def wait(self):
            self.waited = True
            return self.returncode

    monkeypatch.setattr(controller.subprocess, "Popen", FakeWorker)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ElasticHostDead, match="local rank 1 died") as err:
        run_host({"elastic": True, "coordinator_address": "127.0.0.1:1"},
                 str(tmp_path / "none.csv"), 2, host_id=1, num_hosts=2,
                 workdir=str(tmp_path / "w"))
    assert err.value.rc == 17
    spec_path = str(tmp_path / "w" / "h1" / "e0" / "spec.json")
    with open(spec_path) as fh:
        spec = json.load(fh)
    assert spec["local_world_size"] == 2 and spec["host_id"] == 1
    assert spec["membership"]["members"] == [0, 1]
    assert [w.env["LOCAL_RANK"] for w in started] == ["0", "1"]
    assert all(w.env["LOCAL_WORLD_SIZE"] == "2" and w.argv[-1] == spec_path
               for w in started)
    assert [os.path.basename(w.log) for w in started] \
        == ["worker.log", "worker.l1.log"]
    assert started[0].killed and not started[1].killed
    assert started[0].waited and started[1].waited


class _FakeStore:
    """The port's store calls (``set`` / ``wait`` / ``get``) on a dict."""

    def __init__(self, kv):
        self.kv = dict(kv)

    def set(self, key, value):
        self.kv[key] = value

    def wait(self, keys, timeout):
        if any(k not in self.kv for k in keys):
            raise RuntimeError(f"wait timed out after {timeout}")

    def get(self, key):
        return self.kv[key]


class _FakeClient:
    """The JAX coordination client's calls on a dict."""

    def __init__(self, kv):
        self.kv = dict(kv)

    def key_value_set_bytes(self, key, value):
        self.kv[key] = value

    def blocking_key_value_get_bytes(self, key, deadline_ms):
        if key not in self.kv:
            raise RuntimeError(f"deadline {deadline_ms} ms")
        return self.kv[key]


@pytest.mark.parametrize("members,port_dead,jax_dead,silent", [
    ([0, 1, 2], [3], [1], None),
    ([0, 1, 2], [2, 3], [1], None),
    ([0, 2, 5], [2], [1], None),
    ([0, 2, 5], [5], [2], 2),
    ([0, 1, 2], [3, 6], [1, 3], None),
], ids=["local1", "whole_host", "host_ids", "silent_peer", "out_of_range"])
def test_negotiation_maps_ranks_to_hosts_as_jax(members, port_dead,
                                                 jax_dead, silent):
    """At two ranks a host, the anchor's negotiation over the dead global
    ranks of one host agrees the record JAX ``negotiate_next_epoch`` agrees
    over that host's one process rank, on the same members and the same
    peers' acks (a peer that never acks is dead too), and posts the same
    ack."""
    nxt = "elastic/e1"
    peers = {}
    for h in members[1:]:
        if h == silent:
            continue
        peers[f"{nxt}/ack/h{h}"] = pickle.dumps(
            {"host": h, "dead_hosts": [members[jax_dead[0]]]})
        peers[f"{nxt}/got/h{h}"] = pickle.dumps(True)
    kw = dict(epoch=0, members=members, coordinator="127.0.0.1:12421")
    store, client = _FakeStore(peers), _FakeClient(peers)
    mine = negotiate_next_epoch(MembershipEpoch(**kw), 0, port_dead,
                                deadline_s=0.01, store=store,
                                ranks_per_host=2)
    theirs = jnegotiate(JEpoch(**kw), 0, jax_dead, deadline_s=0.01,
                        client=client)
    assert mine.to_dict() == theirs.to_dict()
    assert members[jax_dead[0]] in mine.dead_hosts
    ack = f"{nxt}/ack/h0"
    assert pickle.loads(store.kv[ack]) == pickle.loads(client.kv[ack])
    assert pickle.loads(store.kv[f"{nxt}/record"]) == theirs.to_dict()


def test_death_on_the_anchor_host_is_terminal(monkeypatch, tmp_path):
    """A dead rank on host ``members[0]`` (its local rank 1, at two ranks a
    host): that host's local rank 0 holds the epoch's store, so a
    survivor's recovery writes the ``control_plane_lost`` verdict and exits
    ``EXIT_CONTROL_LOST`` without negotiating, as the JAX package's
    process 0 takes its coordination service with it."""
    from lightgbm_tpu_torch.elastic import worker as eworker
    from lightgbm_tpu_torch.parallel.multihost import RankDeathError

    class Exited(Exception):
        pass

    def fake_exit(code):
        raise Exited(code)

    def no_negotiation(*args, **kwargs):
        raise AssertionError("negotiated over a dead anchor's store")

    monkeypatch.setattr(eworker.os, "_exit", fake_exit)
    monkeypatch.setattr(eworker, "negotiate_next_epoch", no_negotiation)
    spec = {"verdict_path": str(tmp_path / "verdict.json"),
            "negotiate_deadline_s": 0.01}
    epoch = MembershipEpoch(epoch=0, members=[0, 1, 2],
                            coordinator="127.0.0.1:1")
    with pytest.raises(Exited) as ex:
        eworker._recover(spec, epoch, 2, 2,
                         RankDeathError("rank 1 died", dead_ranks=[1]))
    assert ex.value.args[0] == EXIT_CONTROL_LOST
    with open(spec["verdict_path"]) as fh:
        verdict = json.load(fh)
    assert verdict["kind"] == "control_plane_lost" \
        and verdict["failed_epoch"] == 0


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


# -- several ranks a host ------------------------------------------------------

@pytest.fixture(scope="module")
def local_pods(tmp_path_factory):
    """The uninterrupted 2 hosts x 2 ranks run beside a 4 x 1 run of the same
    world (started together), then the 3 x 2 run that loses host 1's local
    rank 1, all over one CSV."""
    tmp = tmp_path_factory.mktemp("elastic_local")
    data = str(tmp / "train.csv")
    X, y = _write_train_csv(data)
    two = _elastic_specs(tmp, 2, data, "l2x2", local=2)
    four = _elastic_specs(tmp, 4, data, "l4x1")
    with ThreadPoolExecutor(2) as ex:
        runs = [ex.submit(run_pod, specs, 300) for specs in (two, four)]
        res2, res4 = [r.result() for r in runs]
    specs = _elastic_specs(tmp, 3, data, "l3x2", local=2,
                           trace_out=str(tmp / "l3x2_trace.json"))
    # global rank 3 is host 1's local rank 1, not its leader: its 5th
    # collective is the heartbeat before iteration 4 (the re-deal's
    # allgather is #1); armed in host 1's agent, inherited by both of its
    # workers, fired by the global rank
    specs[1]["faults"] = "net.crash:rank=3:nth=5"
    chaos = run_pod(specs, timeout_s=300)
    return {"X": X, "y": y, "two": res2, "four": res4, "chaos": chaos,
            "specs": specs, "tmp": tmp}


def _ok_models(run, hosts):
    models = []
    for rank in hosts:
        rc, rep, tail = run[rank]
        assert rc == 0 and rep is not None and rep["ok"], \
            f"agent {rank} failed (rc={rc}):\n{tail[-3000:]}\n{rep}"
        assert rep["cuda_initialized"] is False
        assert rep["left_running"] == []
        models.append(rep["model"])
    return models


def test_two_ranks_a_host_train_as_four_hosts(local_pods):
    """2 hosts x 2 ranks: every worker and agent succeeds, the two hosts'
    models are byte-identical, and byte-identical to the 4 x 1 elastic run
    of the same world (the renumbering and the re-deal over 4 ranks)."""
    two = _ok_models(local_pods["two"], (0, 1))
    four = _ok_models(local_pods["four"], (0, 1, 2, 3))
    assert two[0] == two[1]
    assert all(m == two[0] for m in four)
    for rank in (0, 1):
        rep = local_pods["two"][rank][1]
        assert rep["recoveries"] == 0 and rep["iterations"] == ITERS
        assert [e["members"] for e in rep["history"]] == [[0, 1]]
        edir = local_pods["tmp"] / "l2x2" / f"h{rank}" / "e0"
        assert (edir / "worker.l1.log").exists()
        assert (edir / "result.l1.json").exists()


def test_two_ranks_a_host_held_against_jax_mesh(local_pods):
    """The 2 x 2 elastic model against JAX ``train`` on a 4-device mesh over
    the same rows, as the 2 x 2 pod is held: the same trees, predictions
    within 1e-5."""
    X, y = local_pods["X"], local_pods["y"]
    params = worker.pod_params("data")
    bst = lj.Booster(params, lj.Dataset(X, label=y, params=params))
    apply_parallel_sharding(bst.gbdt, jmesh(4), "data")
    for _ in range(ITERS):
        bst.update()
    text = local_pods["two"][0][1]["model"]
    assert _structure(text) == _structure(bst.model_to_string())
    got = lt.Booster(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_allclose(got.predict(X), bst.predict(X), rtol=1e-5,
                               atol=1e-5)


def test_rank_death_takes_its_host_out(local_pods):
    """3 hosts x 2 ranks, global rank 3 (host 1's local rank 1) killed: host
    1's agent reports its exit 17 with none of its workers left; hosts 0
    and 2 shrink to ``[0, 2]`` as the one-rank drill does (one recovery,
    one host lost), finish every round with equal models, resumed from
    their snapshots, with the report's ``elastic`` section and the
    recovery spans, within 2e-3 AUC of the uninterrupted 2 x 2 model."""
    chaos = local_pods["chaos"]
    rc1, rep1, tail1 = chaos[1]
    assert rc1 == 0 and rep1 is not None, tail1[-2000:]
    assert rep1["ok"] is False and rep1["error_kind"] == "host_dead"
    assert rep1["rc"] == 17 and "local rank 1" in rep1["error"]
    assert rep1["left_running"] == []
    models = _ok_models(chaos, (0, 2))
    assert models[0] == models[1], "survivors diverged after the shrink"
    for rank in (0, 2):
        rep = chaos[rank][1]
        assert rep["recoveries"] == 1 and rep["ranks_lost"] == 1
        assert [e["members"] for e in rep["history"]] == [[0, 1, 2], [0, 2]]
        assert rep["history"][1]["dead_hosts"] == [1]
        assert rep["iterations"] == ITERS
        assert rep["rel_counters"].get("elastic.ranks_lost") == 1
        assert rep["worker_counters"].get(
            "snapshots_resumed_after_shrink", 0) >= 1
        sec = rep["report_elastic"]
        assert sec["epochs"] == 2 and sec["members"] == [0, 2]
        assert sec["recoveries"] == 1 and sec["ranks_lost"] == 1
        with open(local_pods["specs"][rank]["telemetry_out"]) as fh:
            assert validate_report(json.load(fh)) == []
        tpath = f"{local_pods['specs'][rank]['trace_out']}.elastic_h{rank}"
        with open(tpath) as fh:
            names = {ev.get("name") for ev in json.load(fh)["traceEvents"]}
        assert {"elastic.epoch", "elastic.recovery"} <= names
    X, y = local_pods["X"], local_pods["y"]
    ref = lt.Booster(model_str=local_pods["two"][0][1]["model"],
                     params={"device_type": "cpu"})
    got = lt.Booster(model_str=models[0], params={"device_type": "cpu"})
    assert got.num_trees() == ITERS
    auc_ref, auc = _auc(y, ref.predict(X)), _auc(y, got.predict(X))
    assert abs(auc - auc_ref) < 2e-3, (auc, auc_ref)
