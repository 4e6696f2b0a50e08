"""The port's serving fleet against lightgbm_tpu's, on the CPU.

The same model text is served by the JAX ``FleetServer`` (two replicas on
two virtual CPU devices) and by the port's (a CPU booster's two replicas
on the CPU): their scores, raw and converted, agree within 1e-6 on fuzz
rows over the binary and the pickle framing, and clients of either package
talk to gateways of either.  The rest ports ``tests/test_fleet.py``: least-loaded dispatch and
async chunking, the ``serving.replica_fault`` ejection, survival and
recovery (the replicas' clock is driven by the test), a rolling promotion
and a fleet rollback with zero dropped requests, a rejection by the shadow
gate, the wire ``swap``, the report and ``stats_out``, tenant caps, and
the tenant, drift and replica series of the metrics op and the HTTP scrape
(names equal JAX's).  ``python -m lightgbm_tpu_torch serve
serve_replicas=2 autopilot=true`` runs end to end.

Nothing here waits on a wall-clock bound: threads are joined, progress is
read from counters and events, and every socket has a timeout.
"""

import os
import re
import socket
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
from lightgbm_tpu.serving import FleetServer as JFleet
from lightgbm_tpu.serving import ServingClient as JClient
from lightgbm_tpu.reliability import degrade as jdegrade

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.observability import validate_report
from lightgbm_tpu_torch.reliability import degrade, faults
from lightgbm_tpu_torch.serving import (FleetServer, MicroBatcher, ReplicaSet,
                                        ServingClient, ServingStats)
from lightgbm_tpu_torch.serving.fleet import replicas as replicas_mod

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = {"device_type": "cpu"}
#: one 64-row bucket: the JAX fleets compile one program per replica
ONE_BUCKET = dict(min_bucket=64, max_batch_rows=64, deadline_ms=1.0)
TWO_CPUS = [torch.device("cpu")] * 2


def _train_rows(rng, n=1500):
    X = np.column_stack([
        rng.randn(n),
        rng.randint(0, 12, n).astype(float),          # categorical
        rng.randn(n) * 10,
        np.where(rng.rand(n) < 0.4, 0.0, rng.randn(n)),
    ])
    X[::13, 0] = np.nan
    X[::7, 1] = np.nan
    y = (np.nan_to_num(X[:, 0]) + (X[:, 1] % 3 == 1) > 0.5).astype(float)
    return X, y


def _fuzz(rng, n):
    """Float32-representable rows (the binary frames carry float32) with
    NaN, unseen, negative and fractional categories."""
    X = np.column_stack([
        rng.randn(n),
        rng.randint(-3, 25, n).astype(float),
        rng.randn(n) * 10,
        np.where(rng.rand(n) < 0.4, 0.0, rng.randn(n)),
    ])
    X[::11, 0] = np.nan
    X[::5, 1] = np.nan
    X[0, 1] = 7.5
    return X.astype(np.float32).astype(np.float64)


def _train(seed, trees, **params):
    X, y = _train_rows(np.random.RandomState(seed))
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "min_data_in_leaf": 10, **CPU, **params}
    return lt.train(p, lt.Dataset(X, label=y, categorical_feature=[1]),
                    trees, verbose_eval=False)


def _host_raw(bst, X):
    out = np.zeros(len(X))
    for t in bst.gbdt.models:
        out += t.predict(np.ascontiguousarray(X, dtype=np.float64))
    return out


@pytest.fixture(scope="module")
def bst_a():
    return _train(7, 8)


@pytest.fixture(scope="module")
def bst_b():
    return _train(8, 4, num_leaves=7, learning_rate=0.3)


@pytest.fixture(autouse=True)
def _pristine_faults():
    faults.reset()
    yield
    faults.reset()


def _fleet(bst, **kw):
    kw.setdefault("port", 0)
    for k, v in ONE_BUCKET.items():
        kw.setdefault(k, v)
    return FleetServer(booster=bst, replicas=kw.pop("replicas", 2),
                       **kw).start()


def _jfleet(text, **kw):
    return JFleet(booster=lj.Booster(model_str=text), replicas=2, port=0,
                  **ONE_BUCKET, **kw).start()


# -- parity with the JAX fleet ------------------------------------------------

@pytest.mark.serving(timeout=300)
@pytest.mark.parametrize("protocol", ["binary", "pickle"])
def test_fleet_scores_equal_jax_fleet(bst_a, protocol):
    """One model text, both fleets, the same fuzz rows over one framing:
    raw and converted scores within 1e-6, requests of 1 to 150 rows (the
    150-row one chunked across batches)."""
    text = bst_a.model_to_string()
    rng = np.random.RandomState(1)
    jsrv = _jfleet(text)
    psrv = _fleet(lt.Booster(model_str=text, params=dict(CPU)))
    try:
        with JClient("127.0.0.1", jsrv.port, protocol=protocol,
                     timeout=60) as jc, \
                ServingClient("127.0.0.1", psrv.port, protocol=protocol,
                              timeout=60) as pc:
            assert pc.protocol == protocol
            for raw in (True, False):
                for n in (1, 37, 64, 150):
                    Xt = _fuzz(rng, n)
                    want = np.asarray(jc.predict(Xt, raw_score=raw))
                    got = np.asarray(pc.predict(Xt, raw_score=raw))
                    assert got.shape == want.shape == (n,)
                    np.testing.assert_allclose(got, want, rtol=1e-6,
                                               atol=1e-6)
            h = pc.health()
            assert h["ready"] and h["replicas"] == 2
            assert h["replicas_healthy"] == 2 and h["device_errors"] == {}
    finally:
        psrv.stop()
        jsrv.stop()


@pytest.mark.serving(timeout=300)
def test_clients_of_either_package_talk_to_either_gateway(bst_a):
    """The JAX client against the port's gateway and the port's client
    against the JAX gateway, over the binary and the pickle framing:
    ping, predict, health, stats and the metrics op."""
    text = bst_a.model_to_string()
    rng = np.random.RandomState(2)
    Xt = _fuzz(rng, 20)
    want = _host_raw(bst_a, Xt)
    psrv = _fleet(bst_a)
    jsrv = _jfleet(text)
    try:
        for client, srv in ((JClient, psrv), (ServingClient, jsrv)):
            for protocol in ("binary", "pickle"):
                with client("127.0.0.1", srv.port, protocol=protocol,
                            timeout=60) as c:
                    assert c.ping() is True
                    np.testing.assert_allclose(
                        np.asarray(c.predict(Xt, raw_score=True)), want,
                        rtol=1e-6, atol=1e-6)
                    assert c.health()["replicas"] == 2
                    rep = c.stats()
                    assert len(rep["serving"]["replicas"]) == 2
                    assert "lgbt_serving_replica_healthy:1 1" in c.metrics()
    finally:
        psrv.stop()
        jsrv.stop()


@pytest.mark.serving(timeout=300)
def test_series_names_equal_jax(bst_a, bst_b):
    """Two tenants, a drift baseline and a shifted window on both fleets:
    the tenant, drift and replica series of the metrics op and of the HTTP
    scrape carry the JAX gateway's names and labels, and the drift section
    names the shifted feature."""
    rng = np.random.RandomState(3)
    windows = [(_fuzz(rng, 48), _fuzz(rng, 16)) for _ in range(3)]
    shifted = []
    for _ in range(3):
        X = _fuzz(rng, 48)
        X[:, 0] = np.nan_to_num(X[:, 0]) + 6.0
        shifted.append(X)
    pages = {}
    for pkg, make, client in (
            ("jax", lambda: _jfleet(bst_a.model_to_string(),
                                    record_rows=512, drift_min_rows=32),
             JClient),
            ("port", lambda: _fleet(bst_a, record_rows=512,
                                    drift_min_rows=32), ServingClient)):
        srv = make()
        try:
            alt = bst_b if pkg == "port" else \
                lj.Booster(model_str=bst_b.model_to_string())
            srv.replicas.load("alt", booster=alt)
            with client("127.0.0.1", srv.port, protocol="binary",
                        timeout=60) as c:
                for Xd, Xa in windows:
                    c.predict(Xd)
                    c.predict(Xa, model="alt")
                assert srv.capture_drift_baseline("default") is True
                for X in shifted:
                    c.predict(X)
                rep = c.stats()
                op_page = c.metrics()
            status, http_page = _http_get(srv.port, "/metrics")
            assert status == 200
            assert _http_get(srv.port, "/nope")[0] == 404
        finally:
            srv.stop()
        assert rep["drift"]["drifted"] is True
        assert "Column_0" in rep["drift"]["top_features"]
        assert {t["model"] for t in rep["serving"]["tenants"]} == \
            {"default", "alt"}
        pages[pkg] = (_series(op_page), _series(http_page))
    assert pages["port"] == pages["jax"]
    assert any(s.startswith("lgbt_serving_drift_feature_psi")
               for s in pages["port"][0])


def _series(page):
    """The tenant, drift and replica series of a Prometheus page: each
    sample's name and labels, without its value."""
    keep = ("lgbt_serving_tenant_", "lgbt_serving_drift_",
            "lgbt_serving_replica_")
    return sorted(ln.rsplit(" ", 1)[0] for ln in page.splitlines()
                  if ln.startswith(keep))


def _http_get(port, path):
    """(status, body) of one plain-HTTP request to the gateway's port."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(f"GET {path} HTTP/1.0\r\nHost: t\r\n\r\n".encode())
        buf = b""
        while True:
            d = s.recv(65536)
            if not d:
                break
            buf += d
    head, _, body = buf.partition(b"\r\n\r\n")
    return int(head.split()[1]), body.decode()


# -- dispatch -----------------------------------------------------------------

@pytest.mark.serving
def test_least_loaded_dispatch_and_async_chunking(bst_a):
    rs = ReplicaSet(replicas=2, devices=TWO_CPUS, max_batch_rows=64,
                    min_bucket=32, deadline_ms=1.0, warmup=False)
    try:
        rs.load("default", booster=bst_a)
        r0, r1 = rs.replicas
        # the lower in-flight count wins, ties go to the lower index
        assert rs.pick() is r0
        with r0._lock:
            r0._inflight = 3
        assert rs.pick() is r1
        with r0._lock:
            r0._inflight = 0
        # an oversize request is chunked to the batch budget and the
        # callback fires once with the re-aggregated scores
        X = _fuzz(np.random.RandomState(4), 150)
        done = threading.Event()
        out = {}

        def cb(handle):
            out["scores"], out["error"] = handle.result, handle.error
            done.set()

        rs.dispatch(X, "default", cb)
        assert done.wait(60)
        assert out["error"] is None
        np.testing.assert_allclose(np.asarray(out["scores"]),
                                   _host_raw(bst_a, X), rtol=1e-6, atol=1e-6)
        snap = rs.section()
        assert [s["index"] for s in snap] == [0, 1]
        assert snap[0]["dispatched"] == 1 and snap[0]["completed"] == 1
        assert [s["device"] for s in snap] == ["cpu", "cpu"]
    finally:
        rs.stop()


@pytest.mark.serving
def test_malformed_request_answers_an_error_and_frees_its_slot(bst_a):
    """A request with the wrong feature count (binary and pickle) answers
    an error frame, counts as an error, and leaves no replica and no
    admission slot in flight."""
    srv = _fleet(bst_a)
    try:
        for protocol in ("binary", "pickle"):
            with ServingClient("127.0.0.1", srv.port, timeout=60,
                               protocol=protocol) as c:
                with pytest.raises(RuntimeError, match="features"):
                    c.predict(np.zeros((3, 7)))
                assert c.health()["inflight"] == 0
        assert [r.inflight for r in srv.replicas.replicas] == [0, 0]
        assert srv.stats.errors == 2
    finally:
        srv.stop()


def test_fleet_without_cards_needs_devices(bst_a, monkeypatch):
    """No CUDA device and no ``devices``: the fleet refuses instead of
    carrying on on the CPU; a CPU booster's fleet serves on the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="device_count"):
        ReplicaSet(replicas=2)
    srv = bst_a.to_server(replicas=2, port=0, **ONE_BUCKET)
    try:
        assert isinstance(srv, FleetServer)
        assert [r.device.type for r in srv.replicas.replicas] == \
            ["cpu", "cpu"]
    finally:
        srv.stop()


@pytest.mark.serving
def test_batcher_submit_async_rejects_oversize_and_calls_back():
    b = MicroBatcher(lambda Xpad, m: Xpad[:m, 0], num_features=2,
                     max_batch_rows=32, deadline_ms=1.0, min_bucket=8,
                     stats=ServingStats()).start()
    try:
        with pytest.raises(ValueError, match="dispatch layer"):
            b.submit_async(np.zeros((100, 2)), lambda h: None)
        done = threading.Event()
        got = []
        b.submit_async(np.arange(6.0).reshape(3, 2),
                       lambda h: (got.append(h.result), done.set()))
        assert done.wait(30)
        np.testing.assert_array_equal(got[0], [0.0, 2.0, 4.0])
    finally:
        b.stop()


def test_tenant_admission_equals_jax():
    """A scripted acquire/release sequence over two tenants: the same
    admissions, in-flight counts and snapshots as the JAX package's."""
    ours, theirs = degrade.TenantAdmission(2), jdegrade.TenantAdmission(2)
    script = [("a", "acq"), ("a", "acq"), ("a", "acq"), ("b", "acq"),
              ("a", "rel"), ("a", "acq"), ("b", "rel"), ("b", "rel"),
              ("c", "acq")]
    for name, op in script:
        if op == "acq":
            assert ours.try_acquire(name) == theirs.try_acquire(name)
        else:
            ours.release(name)
            theirs.release(name)
        assert ours.inflight(name) == theirs.inflight(name)
    assert ours.snapshot() == theirs.snapshot()


# -- chaos: replica ejection and recovery -------------------------------------

@pytest.mark.chaos
def test_replica_fault_eject_survive_recover(bst_a, monkeypatch):
    """``serving.replica_fault`` on replica 0 re-scores its batches on the
    host (no request fails) and ejects it; replica 1 carries the traffic
    while 0 is out; once the cooldown has passed on the replicas' clock,
    the next dispatch re-admits it."""
    now = [1000.0]
    monkeypatch.setattr(replicas_mod, "time", types.SimpleNamespace(
        monotonic=lambda: now[0], perf_counter=time.perf_counter,
        sleep=time.sleep))
    srv = _fleet(bst_a, recovery_s=5.0)
    try:
        faults.arm("serving.replica_fault:rank=0:count=-1")
        Xt = _fuzz(np.random.RandomState(5), 6)
        want = _host_raw(bst_a, Xt)
        with ServingClient("127.0.0.1", srv.port, timeout=60,
                           protocol="binary", retries=0) as c:
            np.testing.assert_allclose(
                np.asarray(c.predict(Xt, raw_score=True)), want,
                rtol=1e-6, atol=1e-6)
            snap = srv.replicas.section()
            assert snap[0]["ejections"] == 1 and not snap[0]["healthy"]
            assert snap[0]["device_failures"] == 1 and snap[1]["healthy"]
            assert c.health()["replicas_healthy"] == 1
            for _ in range(4):
                np.testing.assert_allclose(
                    np.asarray(c.predict(Xt, raw_score=True)), want,
                    rtol=1e-6, atol=1e-6)
            snap = srv.replicas.section()
            assert snap[1]["dispatched"] == 4 and snap[0]["dispatched"] == 1
            assert srv.stats.fallback_batches == 1
            faults.disarm()
            now[0] += 5.0                    # the cooldown has passed
            c.predict(Xt)
            snap = srv.replicas.section()
            assert snap[0]["healthy"] and snap[0]["dispatched"] == 2
            assert c.health()["replicas_healthy"] == 2
            rep = c.stats()
        assert validate_report(rep) == []
        assert rep["serving"]["errors"] == 0
        assert rep["reliability"]["counters"]["serve.replica_ejections"] == 1
        assert rep["reliability"]["counters"]["serve.replica_recoveries"] == 1
    finally:
        faults.reset()
        srv.stop()


# -- rolling promotion --------------------------------------------------------

class _Hammer:
    """Client threads (binary and pickle alternately, no retries) sending
    predicts until stopped; ``wait_progress`` waits until every client has
    answered ``n`` more requests."""

    def __init__(self, port, clients=4):
        self.port = port
        self.counts = [0] * clients
        self.failures = []
        self.cond = threading.Condition()
        self.stop = threading.Event()
        self.threads = [threading.Thread(target=self._run, args=(i,))
                        for i in range(clients)]
        for t in self.threads:
            t.start()

    def _run(self, i):
        rng = np.random.RandomState(300 + i)
        try:
            with ServingClient("127.0.0.1", self.port, timeout=60,
                               protocol="binary" if i % 2 else "pickle",
                               retries=0) as c:
                while not self.stop.is_set():
                    s = np.asarray(c.predict(_fuzz(rng, 5)))
                    assert s.shape == (5,) and np.all(np.isfinite(s))
                    with self.cond:
                        self.counts[i] += 1
                        self.cond.notify_all()
        except Exception as e:
            with self.cond:
                self.failures.append((i, repr(e)))
                self.cond.notify_all()

    def wait_progress(self, n=3):
        with self.cond:
            base = list(self.counts)
            assert self.cond.wait_for(
                lambda: self.failures or all(
                    c >= b + n for c, b in zip(self.counts, base)), 120)
        assert self.failures == []

    def join(self):
        self.stop.set()
        for t in self.threads:
            t.join(60)
            assert not t.is_alive()


@pytest.mark.lifecycle(timeout=300)
def test_rolling_promotion_and_rollback_drop_nothing(bst_a, bst_b):
    """Prepare everywhere, the per-replica shadow gate, the rolling commit
    and the fleet rollback under four clients without retries: no request
    fails, every client progresses through each stage, and the scores
    after the rollback are the incumbent's again."""
    srv = _fleet(bst_a, record_rows=64)
    rng = np.random.RandomState(6)
    hammer = None
    try:
        with ServingClient("127.0.0.1", srv.port, timeout=60) as c:
            for _ in range(4):
                c.predict(_fuzz(rng, 8))        # the shadow gate's rows
        hammer = _Hammer(srv.port)
        hammer.wait_progress()
        out = srv.promote_rolling(model_str=bst_b.model_to_string(),
                                  divergence_max=1e9, latency_max_ratio=1e9)
        assert out["committed"], out
        assert out["shadow"]["passed"] and out["shadow"]["rows"] == 64
        assert [g["passed"] for g in out["gates"]] == [True, True]
        assert out["versions"] == {0: 2, 1: 2}
        assert all(s["models"] == {"default": 2}
                   for s in srv.replicas.section())
        hammer.wait_progress()
        back = srv.rollback_fleet()
        assert back["restored"] == {1: 1, 0: 1}
        assert srv.replicas.versions() == {"default": 1}
        hammer.wait_progress()
        hammer.join()
        assert hammer.failures == []
        Xt = _fuzz(rng, 10)
        with ServingClient("127.0.0.1", srv.port, timeout=60,
                           protocol="binary") as c:
            np.testing.assert_allclose(
                np.asarray(c.predict(Xt, raw_score=True)),
                _host_raw(bst_a, Xt), rtol=1e-6, atol=1e-6)
        assert srv.stats.errors == 0
    finally:
        if hammer is not None:
            hammer.join()
        srv.stop()


@pytest.mark.lifecycle
def test_shadow_gate_rejects_before_any_commit(bst_a, bst_b):
    """A candidate that diverges past the gate is rejected on replica 0's
    prepared copy: no replica ever serves it."""
    srv = _fleet(bst_a, record_rows=64)
    try:
        with ServingClient("127.0.0.1", srv.port, timeout=60) as c:
            for _ in range(4):
                c.predict(_fuzz(np.random.RandomState(7), 8))
        out = srv.promote_rolling(model_str=bst_b.model_to_string(),
                                  divergence_max=0.0)
        assert not out["committed"] and out["aborted_replica"] == 0
        assert out["restored"] == {}
        assert out["shadow"]["passed"] is False
        assert srv.replicas.versions() == {"default": 1}
        assert all(s["models"] == {"default": 1}
                   for s in srv.replicas.section())
    finally:
        srv.stop()


@pytest.mark.lifecycle
def test_shadow_gate_judges_a_given_window_with_its_metric(bst_a, bst_b):
    """The autopilot's route: candidates ``prepare_all`` built, judged on an
    explicit labelled window with the recorder off.  A metric floor no
    model clears rejects on replica 0 with the metric gate named; a floor
    every model clears commits those very candidates, each replica's gate
    having scored the window."""
    srv = _fleet(bst_a)
    X, y = _train_rows(np.random.RandomState(9), 48)
    try:
        prepared = srv.replicas.prepare_all(model_str=bst_b.model_to_string())
        kw = dict(prepared=prepared, X=X, labels=y, metric="auc",
                  divergence_max=1e9, latency_max_ratio=1e9)
        out = srv.promote_rolling(metric_floor=1.5, **kw)
        assert not out["committed"] and out["aborted_replica"] == 0
        assert out["restored"] == {}
        gate = out["shadow"]["gates"]["metric"]
        assert not gate["passed"] and gate["name"] == "auc"
        assert any("auc" in r for r in out["shadow"]["reasons"])
        assert srv.replicas.versions() == {"default": 1}
        out = srv.promote_rolling(metric_floor=0.0, **kw)
        assert out["committed"], out
        assert [g["passed"] for g in out["gates"]] == [True, True]
        assert out["shadow"]["rows"] == 48
        assert out["shadow"]["gates"]["metric"]["value"] > 0.5
        assert [r.registry.get() for r in srv.replicas.replicas] == prepared
    finally:
        srv.stop()


@pytest.mark.serving
def test_fleet_swap_over_the_wire_is_rolling(bst_a, bst_b, tmp_path):
    """The wire ``swap`` goes through the rolling promotion; a bad payload
    answers an error frame and counts against the tenant; the report (also
    the ``stats_out`` snapshot) validates."""
    stats_out = tmp_path / "fleet_stats.json"
    srv = _fleet(bst_a, stats_out=str(stats_out), stats_interval_s=3600)
    try:
        Xt = _fuzz(np.random.RandomState(8), 10)
        with ServingClient("127.0.0.1", srv.port, timeout=60,
                           protocol="binary") as c:
            np.testing.assert_allclose(
                np.asarray(c.predict(Xt, raw_score=True)),
                _host_raw(bst_a, Xt), rtol=1e-6, atol=1e-6)
            assert c.swap(bst_b.model_to_string()) == 2
            np.testing.assert_allclose(
                np.asarray(c.predict(Xt, raw_score=True)),
                _host_raw(bst_b, Xt), rtol=1e-6, atol=1e-6)
            with pytest.raises(RuntimeError):
                c.swap("garbage")
            rep = c.stats()
    finally:
        srv.stop()
    assert validate_report(rep) == []
    assert {t["model"]: t for t in rep["serving"]["tenants"]}[
        "default"]["errors"] == 1
    import json
    on_disk = json.loads(stats_out.read_text())
    assert validate_report(on_disk) == []
    assert len(on_disk["serving"]["replicas"]) == 2


@pytest.mark.serving
def test_tenant_cap_sheds_the_hot_tenant(bst_a):
    """``tenant_max_inflight=1`` while the tenant's one admitted request is
    held in the device path: a second request of that tenant sheds with
    ``scope: tenant`` (the global gate has room) and counts on the tenant;
    once released, the first request answers."""
    srv = _fleet(bst_a, tenant_max_inflight=1)
    gate, entered = threading.Event(), threading.Event()
    for r in srv.replicas.replicas:
        model = r.registry.get()

        def held(Xpad, m, _run=model.predict_padded):
            entered.set()
            assert gate.wait(60)
            return _run(Xpad, m)
        model.predict_padded = held
    Xt = _fuzz(np.random.RandomState(9), 3)
    got = []

    def first():
        with ServingClient("127.0.0.1", srv.port, timeout=60) as c:
            got.append(np.asarray(c.predict(Xt, raw_score=True)))

    t = threading.Thread(target=first)
    try:
        t.start()
        assert entered.wait(60)
        with ServingClient("127.0.0.1", srv.port, timeout=60,
                           protocol="binary") as c:
            with pytest.raises(Exception, match="overloaded") as ei:
                c.predict(Xt)
        gate.set()
        t.join(60)
        assert not t.is_alive()
        np.testing.assert_allclose(got[0], _host_raw(bst_a, Xt), rtol=1e-6,
                                   atol=1e-6)
        assert getattr(ei.value, "capacity", 1) == 1
        tenants = {t["model"]: t for t in srv.stats.tenants_section()}
        assert tenants["default"]["tenant_shed"] == 1
        assert tenants["default"]["shed"] == 1
    finally:
        gate.set()
        t.join(60)
        srv.stop()


# -- CLI ----------------------------------------------------------------------

@pytest.mark.serving(timeout=300)
def test_cli_fleet_with_autopilot(tmp_path, bst_a):
    """``python -m lightgbm_tpu_torch serve serve_replicas=2
    lifecycle_record_rows=... autopilot=true data=...`` on the CPU: two
    replicas answer equal to the host trees, the report carries the
    replicas and the autopilot section, and the drift baselines file lands
    beside the model."""
    X, y = _train_rows(np.random.RandomState(10), 400)
    X = np.nan_to_num(X)
    data = tmp_path / "train.csv"
    np.savetxt(data, np.column_stack([y, X]), delimiter=",")
    model = tmp_path / "model.txt"
    bst_a.save_model(str(model))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "lightgbm_tpu_torch", "serve",
         f"input_model={model}", "serve_port=0", "serve_replicas=2",
         "serve_min_bucket=64", "serve_max_batch_rows=64",
         "lifecycle_record_rows=256", "autopilot=true", f"data={data}",
         "autopilot_interval_s=3600", "device_type=cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path))
    lines = []
    try:
        port = None
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r" at [\d.]+:(\d+) with 2 replica", line)
            if m:
                port = int(m.group(1))
            if "Autopilot armed" in line:
                break
        assert port, "".join(lines)
        Xt = _fuzz(np.random.RandomState(11), 40)
        with ServingClient("127.0.0.1", port, timeout=120) as c:
            np.testing.assert_allclose(
                np.asarray(c.predict(Xt, raw_score=True)),
                _host_raw(bst_a, Xt), rtol=1e-6, atol=1e-6)
            rep = c.stats()
            c.shutdown()
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    assert proc.returncode == 0, "".join(lines)
    assert validate_report(rep) == []
    assert len(rep["serving"]["replicas"]) == 2
    assert rep["autopilot"]["enabled"] and rep["autopilot"]["triggered"] == 0
