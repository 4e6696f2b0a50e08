"""Port multi-host pods vs lightgbm_tpu's multi-host contract and models.

A pod is emulated on this machine: every rank is a subprocess of
``tests/_torch_multihost_worker.py`` (which imports only the port), given
the LGBT_* environment and ``LOCAL_WORLD_SIZE`` / ``LOCAL_RANK``, joined
over gloo on 127.0.0.1.  Held here:

  * (a) the contract: ``resolve_multihost`` gives the JAX package's tuples
    and errors, ``host_layout``, and the layout of an elastic pod with
    several ranks a host;
  * (b) 2 hosts x 2 ranks train ``data`` and ``data_feature`` for six
    iterations: every rank's model the same, equal to a 4-rank ``RankPool``
    run and held against JAX ``train`` on a 4-device mesh (structure equal,
    predictions within 1e-5), one heartbeat an iteration, the
    ``DistributedNet`` seam's allgather / sync / barrier;
  * (c) the chaos drill: 3 hosts, ``net.crash:rank=1:nth=3``; rank 1 exits
    17 and the survivors name it within the deadline;
  * (d) pod observability: rank 1's injected sleep named by the straggler
    gauges on every rank, the per-rank traces merged well-nested, and
    ``estimate_clock_offset`` / ``merge_pod_trace`` equal to the JAX
    functions on the same inputs.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
from lightgbm_tpu.observability import podtrace as jpod
from lightgbm_tpu.parallel import multihost as jmh
from lightgbm_tpu.parallel.learners import apply_parallel_sharding
from lightgbm_tpu.parallel.sharding import make_mesh as jmesh
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.observability import podtrace
from lightgbm_tpu_torch.parallel import multihost
from lightgbm_tpu_torch.parallel.launch import RankPool, free_port

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_multihost_worker.py")
sys.path.insert(0, HERE)
import _torch_multihost_worker as worker  # noqa: E402

torch.set_num_threads(1)

MODES = ("data", "data_feature")
ENV_KEYS = (multihost.ENV_COORDINATOR, multihost.ENV_NUM_HOSTS,
            multihost.ENV_PROCESS_ID, "LOCAL_WORLD_SIZE", "LOCAL_RANK",
            "WORLD_SIZE", "RANK", "LGBT_FAULTS")


def _clean_env():
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE),
               OMP_NUM_THREADS="1")
    for k in ENV_KEYS:
        env.pop(k, None)
    return env


def run_pod(specs, timeout_s, envs=None):
    """One worker per spec, all started together; {rank: (exit code,
    report or None, output tail)}."""
    procs = []
    for i, spec in enumerate(specs):
        env = _clean_env()
        env.update((envs or [{}] * len(specs))[i])
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, json.dumps(spec)], env=env,
            cwd=os.path.dirname(HERE), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        tails = [p.communicate(timeout=timeout_s)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {}
    for spec, p, tail in zip(specs, procs, tails):
        report = None
        if os.path.exists(spec["out"]):
            with open(spec["out"]) as fh:
                report = json.load(fh)
        out[spec["rank"]] = (p.returncode, report, tail)
    return out


def _structure(text):
    keep = ("split_feature=", "threshold=", "left_child=", "right_child=",
            "num_leaves=", "decision_type=")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


# -- (a) the contract -------------------------------------------------------

class _Cfg:
    def __init__(self, **kw):
        self.coordinator_address = kw.get("coordinator_address", "")
        self.num_hosts = kw.get("num_hosts", 1)
        self.process_id = kw.get("process_id", -1)
        self.elastic = kw.get("elastic", False)


@pytest.fixture
def no_mh_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)


def _resolved(mod, cfg):
    try:
        return mod.resolve_multihost(cfg)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("kw,env", [
    ({}, {}),
    ({"coordinator_address": "10.0.0.1:1234", "num_hosts": 4,
      "process_id": 2}, {}),
    ({}, {"LGBT_COORDINATOR": "h:1", "LGBT_NUM_HOSTS": "2",
          "LGBT_PROCESS_ID": "1"}),
    ({"num_hosts": 2}, {}),
    ({"coordinator_address": "h:1", "num_hosts": 2}, {}),
    ({"coordinator_address": "h:1", "num_hosts": 2, "process_id": 2}, {}),
    ({"coordinator_address": "h:1"}, {"LGBT_NUM_HOSTS": "3",
                                      "LGBT_PROCESS_ID": "0"}),
], ids=["single", "full", "env", "hosts_only", "no_process_id",
        "out_of_range", "env_fills_gaps"])
def test_resolve_multihost_equals_jax(no_mh_env, monkeypatch, kw, env):
    """The JAX package's ``test_multihost.py:543-578`` cases: the same
    (coordinator, hosts, process id) tuple, or the same error."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mine, theirs = _resolved(multihost, _Cfg(**kw)), _resolved(jmh, _Cfg(**kw))
    assert mine == theirs
    if kw == {} and env == {}:
        assert multihost.resolve_multihost(None) is None \
            == jmh.resolve_multihost(None)


def test_rank_death_error_and_uninitialized_net(no_mh_env):
    """``RankDeathError`` is a ``ConnectionError`` carrying the verdict, as
    the JAX one; a net without a pod raises; a single host's layout is
    (1, 0, 1)."""
    err = multihost.RankDeathError("r1 died", dead_ranks=[1, 3], epoch=2)
    assert isinstance(err, ConnectionError)
    assert (err.dead_ranks, err.epoch) == ([1, 3], 2)
    with pytest.raises(RuntimeError, match="not initialized"):
        multihost.DistributedNet(rank=0, num_machines=1, deadline_s=1.0)
    assert multihost.host_layout() == (1, 0, 1)
    assert multihost.net_for_run(Config()) is None


def test_elastic_with_several_local_ranks_is_refused(no_mh_env,
                                                     monkeypatch):
    """Elastic pods run several ranks a host now: under ``elastic=true`` and
    ``LOCAL_WORLD_SIZE=2`` the layout resolves to ``(2, pid, 2)`` and the
    rank to ``pid * 2 + LOCAL_RANK`` (the store and the group stubbed, so
    none is started)."""
    import torch.distributed as dist

    from lightgbm_tpu_torch.parallel import sharding
    joined = {}

    def fake_store(host, port, world, is_master, **kw):
        joined["store"] = (host, port, world, is_master)
        return "store"

    def fake_group(store, rank, world, device, timeout):
        joined["group"] = (store, rank, world)

    monkeypatch.setattr(dist, "TCPStore", fake_store)
    monkeypatch.setattr(sharding, "init_group", fake_group)
    for name, value in (("_initialized", False), ("_store", None),
                        ("_layout", None)):
        monkeypatch.setattr(multihost, name, value)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    cfg = Config.from_params({"coordinator_address": "127.0.0.1:1",
                              "num_hosts": 2, "process_id": 1,
                              "elastic": True})
    assert multihost.initialize_from_config(cfg)
    assert multihost.host_layout() == (2, 1, 2)
    assert multihost.host_rank() == 1
    assert joined == {"store": ("127.0.0.1", 1, 4, False),
                      "group": ("store", 3, 4)}


# -- (b) the 2 x 2 pod --------------------------------------------------------

@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """One 2-host x 2-rank pod: both modes, the net exercise and the
    observability run; with the 4-rank pool's models beside it."""
    tmp = tmp_path_factory.mktemp("pod")
    port = free_port()
    specs, envs = [], []
    for host in range(2):
        for local in range(2):
            rank = host * 2 + local
            specs.append(dict(
                job="train", rank=rank, modes=list(MODES), observe=True,
                straggle_s=0.25, out=str(tmp / f"r{rank}.json"),
                trace_out=str(tmp / "pod_trace.json"),
                telemetry_out=str(tmp / "telem_r{rank}.json")))
            envs.append({multihost.ENV_COORDINATOR: f"127.0.0.1:{port}",
                         multihost.ENV_NUM_HOSTS: "2",
                         multihost.ENV_PROCESS_ID: str(host),
                         "LOCAL_WORLD_SIZE": "2", "LOCAL_RANK": str(local)})
    t0 = time.monotonic()
    out = run_pod(specs, timeout_s=300, envs=envs)
    secs = time.monotonic() - t0
    for rank, (rc, report, tail) in out.items():
        assert rc == 0 and report is not None, \
            f"rank {rank} failed (rc={rc}):\n{tail[-3000:]}"
    X, y = worker.problem()
    with RankPool(4, "gloo", timeout_s=120) as pool:
        ref = {m: pool.run(worker.train_model,
                           worker.pod_params(m, telemetry=True,
                                             telemetry_sync_every=2),
                           X, y, worker.ITERS)
               for m in MODES}
    return {"ranks": out, "pool": ref, "tmp": tmp, "seconds": secs}


def test_pod_layout_and_backend(pod):
    """Global rank = process_id * L + LOCAL_RANK; four ranks on one machine
    without cards take gloo (the world's cards decide)."""
    for rank, (_rc, rep, _t) in pod["ranks"].items():
        assert rep["rank"] == rank and rep["world"] == 4
        assert rep["backend"] == "gloo"
        assert rep["layout"] == [2, rank // 2, 2]


@pytest.mark.parametrize("mode", MODES)
def test_pod_models_equal_pool_and_each_other(pod, mode):
    """Every rank of the pod trains the same model text, byte for byte the
    model of one host's 4-rank pool (the same world and placement), with
    one heartbeat an iteration."""
    texts = [rep["modes"][mode]["text"]
             for _rc, rep, _t in pod["ranks"].values()]
    assert len(set(texts)) == 1
    assert all(r["text"] == texts[0] for r in pod["pool"][mode])
    want = {"data": "ShardedWaveLearner",
            "data_feature": "ShardedWave2DLearner"}[mode]
    for _rc, rep, _t in pod["ranks"].values():
        got = rep["modes"][mode]
        assert got["learner"] == want
        assert got["heartbeats"] == worker.ITERS
        # the exchange-window probe ran on the sampled iterations
        assert got["gauges"]["exchange_probe_ms"] > 0


@pytest.mark.parametrize("mode", MODES)
def test_pod_models_held_against_jax_mesh(pod, mode):
    """The pod's model against JAX ``train`` on a 4-device mesh, as
    ``tests/test_torch_parallel.py`` holds ``lt.train``: the same trees,
    predictions within 1e-5."""
    X, y = worker.problem()
    params = worker.pod_params(mode)
    ds = lj.Dataset(X, label=y, params=params)
    bst = lj.Booster(params, ds)
    mesh = jmesh(shape=(2, 2)) if mode == "data_feature" else jmesh(4)
    apply_parallel_sharding(bst.gbdt, mesh, mode)
    for _ in range(worker.ITERS):
        bst.update()
    rep = pod["ranks"][0][1]["modes"][mode]
    assert _structure(rep["text"]) == _structure(bst.model_to_string())
    np.testing.assert_allclose(rep["pred"], bst.predict(X), rtol=1e-5,
                               atol=1e-5)


def test_pod_distributed_net_seam(pod):
    """The store-backed ``DistributedNet``: allgather in rank order, the
    hosts' sync_min / sync_max, a barrier (JAX: ``[["hello", 0], ...]``,
    100 and 101)."""
    for _rc, rep, _t in pod["ranks"].values():
        assert rep["net"]["allgather"] == [["hello", r] for r in range(4)]
        assert rep["net"]["sync_min"] == 100
        assert rep["net"]["sync_max"] == 101


def test_torchrun_nnodes_reaches_the_same_code(pod, tmp_path):
    """``torchrun --nnodes 2 --nproc-per-node 2`` (no LGBT_* keys): the
    ranks join through ``sharding.init_from_env``, the heartbeat rides
    torchrun's store, and the model is the LGBT_* pod's."""
    port = free_port()
    spec = dict(job="train", modes=["data"],
                out=str(tmp_path / "t{rank}.json"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2",
         "--node-rank", str(node), "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(port), WORKER,
         json.dumps(spec)], env=_clean_env(), cwd=os.path.dirname(HERE),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for node in range(2)]
    tails = [p.communicate(timeout=180)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], tails[0][-3000:]
    want = pod["ranks"][0][1]["modes"]["data"]["text"]
    for rank in range(4):
        with open(tmp_path / f"t{rank}.json") as fh:
            rep = json.load(fh)
        assert rep["rank"] == rank and rep["layout"] == [2, rank // 2, 2]
        assert rep["modes"]["data"]["text"] == want
        assert rep["modes"]["data"]["heartbeats"] == worker.ITERS
        assert rep["net"]["sync_max"] == 101


# -- (d) pod observability ----------------------------------------------------

def _well_nested(events):
    stacks = {}
    for ev in events:
        if ev.get("ph") not in ("B", "E"):
            continue
        st = stacks.setdefault((ev["pid"], ev["tid"]), [])
        if ev["ph"] == "B":
            st.append(ev["name"])
        else:
            assert st and st[-1] == ev["name"], ev
            st.pop()
    assert all(not s for s in stacks.values())


def test_pod_straggler_named_on_every_rank(pod):
    """Rank 1 sleeps 0.25 s in every step: the heartbeat's step times name
    it on every rank, past the 1.3 bar, with a straggler warning; the
    report's pod facts and the clock handshake (rank 0's offset 0)."""
    for rank, (_rc, rep, _t) in pod["ranks"].items():
        obs = rep["observe"]
        dist = obs["distributed"]
        assert dist["process_count"] == 4 and dist["process_index"] == rank
        assert obs["provenance"]["num_hosts"] == 2
        assert obs["provenance"]["process_index"] == rank // 2
        assert obs["provenance"]["emulated"] is True
        assert dist["slowest_rank"] == 1, dist
        assert dist["skew_ratio"] > 1.3, dist
        assert set(dist["rank_step_s"]) == {"0", "1", "2", "3"}
        assert dist["rank_step_s"]["1"] > 0.25
        assert obs["counters"].get("straggler_warnings", 0) >= 1
        clk = dist["clock"]
        assert clk["method"] == "kv-ping-midpoint"
        if rank == 0:
            assert clk["offset_us"] == 0.0


def test_pod_traces_merge_well_nested(pod):
    """Every rank wrote ``<trace_out>.rank<r>``; the merge is one Chrome
    trace with every rank's iteration and heartbeat spans, well nested and
    in time order."""
    base = str(pod["tmp"] / "pod_trace.json")
    paths = [f"{base}.rank{r}" for r in range(4)]
    assert all(os.path.exists(p) for p in paths)
    out = str(pod["tmp"] / "merged.json")
    assert podtrace.main([out] + paths) == 0
    with open(out) as fh:
        merged = json.load(fh)
    assert merged["otherData"]["pod_merge"] is True
    assert merged["otherData"]["process_count"] == 4
    events = merged["traceEvents"]
    for rank in range(4):
        names = {ev["name"] for ev in events
                 if ev.get("pid") == rank and ev.get("ph") == "B"}
        assert {"iteration", "heartbeat"} <= names, rank
    _well_nested(events)
    ts = [ev["ts"] for ev in events if ev.get("ph") in ("B", "E", "i")]
    assert ts == sorted(ts)


class _FakeNet:
    """Just enough of ``DistributedNet`` for the clock handshake: a fixed
    rank 0 stamp sequence."""

    def __init__(self, rank, stamps):
        self.rank, self.num_machines = rank, 2
        self._stamps = iter(stamps)

    def allgather(self, obj):
        return [("clk", 0, next(self._stamps)), obj]


@pytest.mark.parametrize("rank", [0, 1])
def test_clock_offset_and_merge_equal_jax(rank, monkeypatch, tmp_path):
    """``estimate_clock_offset`` on a fake net and ``merge_pod_trace`` on
    the same inputs give the JAX functions' outputs."""
    clock = iter(np.arange(0.0, 100.0, 0.125))
    stamps = [5.0, 9.5, 12.25, 20.0, 31.0, 40.5, 50.0, 61.0]
    seq = [next(clock) for _ in range(16)]

    def run(mod):
        it = iter(seq)
        monkeypatch.setattr(time, "perf_counter", lambda: next(it))
        return mod.estimate_clock_offset(_FakeNet(rank, stamps))

    assert run(podtrace) == run(jpod)
    monkeypatch.undo()
    traces = []
    for r, (off, epoch) in enumerate([(0.0, 10.0), (250.0, 11.0)]):
        traces.append({
            "traceEvents": [
                {"name": "thread_name", "ph": "M", "pid": 7, "tid": 1,
                 "args": {"name": "main"}},
                {"name": "iteration", "ph": "B", "pid": 7, "tid": 1,
                 "ts": 5.0 + r},
                {"name": "heartbeat", "ph": "B", "pid": 7, "tid": 1,
                 "ts": 6.0 + r},
                {"name": "heartbeat", "ph": "E", "pid": 7, "tid": 1,
                 "ts": 9.0 + r},
                {"name": "iteration", "ph": "E", "pid": 7, "tid": 1,
                 "ts": 20.0}],
            "otherData": {"rank": r, "aligned_epoch_us": epoch * 1e6,
                          "clock_offset_us": off, "clock_rtt_us": 3.0}})
    mine = podtrace.merge_pod_trace(traces, out=str(tmp_path / "m.json"))
    assert mine == jpod.merge_pod_trace(traces)
    with open(tmp_path / "m.json") as fh:
        assert json.load(fh) == mine


# -- (c) the chaos drill --------------------------------------------------

@pytest.mark.chaos(timeout=180)
def test_host_crash_names_dead_rank(tmp_path):
    """3 hosts heartbeat over the store; ``net.crash:rank=1:nth=3`` kills
    rank 1 at its third collective (exit 17).  Every survivor raises a
    ``RankDeathError`` naming rank 1 and the collective within the
    deadline, and the reliability counters tick."""
    deadline = 8.0
    port = free_port()
    specs = [dict(job="chaos", rank=r, num_hosts=3, port=port, beats=6,
                  deadline_s=deadline, out=str(tmp_path / f"r{r}.json"))
             for r in range(3)]
    envs = [{"LGBT_FAULTS": "net.crash:rank=1:nth=3"}] * 3
    pod = run_pod(specs, timeout_s=150, envs=envs)
    rc1, report1, tail1 = pod[1]
    assert rc1 == 17, f"crashed rank exited {rc1}, not 17:\n{tail1[-2000:]}"
    assert report1 is None
    for rank in (0, 2):
        rc, report, tail = pod[rank]
        assert rc == 0 and report is not None, \
            f"survivor {rank} failed (rc={rc}):\n{tail[-3000:]}"
        err = report["survived_error"]
        assert err and "rank(s) 1" in err and "never posted" in err, err
        assert "multihost collective #3" in err, err
        assert report["dead_ranks"] == [1]
        assert report["elapsed_s"] < 3 * deadline + 10
        ctr = report["rel_counters"]
        assert ctr.get("net.multihost_collective_timeouts", 0) >= 1
        assert ctr.get("net.multihost_peers_dead", 0) >= 1
