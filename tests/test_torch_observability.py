"""The port's serving observability and reliability against lightgbm_tpu's.

Each ported module holds against the JAX module on the same inputs: the
latency histogram's percentiles and Prometheus buckets, ``prometheus_text``,
the schema file (byte for byte), a port report under both validators, the
fault spec's parse and the refusal of the points the port does not carry.
Then ports of ``tests/test_reliability.py`` (overload sheds with structured
frames and recovers; a device fault falls back to the host, counted) and of
``tests/test_tracing.py`` (a trace id through a live server, the ``metrics``
op, ``stats_out`` snapshots), on the CPU (``device_type=cpu``).
"""

import json
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from lightgbm_tpu.observability import LatencyHistogram as JHistogram
from lightgbm_tpu.observability import validate_report as jvalidate
from lightgbm_tpu.observability.metrics_export import \
    prometheus_text as jprometheus_text
from lightgbm_tpu.reliability import faults as jfaults

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.io.net import recv_frame, send_frame
from lightgbm_tpu_torch.observability import (LatencyHistogram,
                                              TraceRecorder, new_trace_id,
                                              prometheus_text,
                                              validate_report)
from lightgbm_tpu_torch.reliability import (faults, rel_counters, rel_get,
                                            rel_reset)
from lightgbm_tpu_torch.serving import ServerOverloaded, ServingClient

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = {"device_type": "cpu"}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.disarm()
    rel_reset()
    yield
    faults.disarm()


def _train(rng, trees=8, n=2000, f=6):
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "min_data_in_leaf": 10, **CPU}
    return lt.train(p, lt.Dataset(X, label=y), trees, verbose_eval=False)


# -- the modules against the JAX modules -------------------------------------

@pytest.mark.parametrize("window", [8192, 50])
def test_latency_histogram_equals_jax(window):
    rng = np.random.RandomState(window)
    mine, theirs = LatencyHistogram(window=window), JHistogram(window=window)
    for ms in np.concatenate([rng.exponential(3.0, 400), [0.0, 0.1, 1e6]]):
        mine.record(ms)
        theirs.record(ms)
    assert mine.percentiles((50, 90, 95, 99, 99.9)) == \
        theirs.percentiles((50, 90, 95, 99, 99.9))
    assert mine.snapshot() == theirs.snapshot()
    assert mine.cumulative_buckets() == theirs.cumulative_buckets()
    assert mine.prometheus_lines("x_seconds", 'model="m"') == \
        theirs.prometheus_lines("x_seconds", 'model="m"')


def test_prometheus_text_equals_jax():
    rng = np.random.RandomState(1)
    counters = {"serving_requests_total": 17, "weird name/x": 3.5,
                "reliability_fault.serve.predict.fail_total": 2}
    gauges = {"serving_qps": 123.456789, "serving_inflight": 0,
              "serving_model_version:default": 2}
    mine, theirs = LatencyHistogram(), JHistogram()
    for ms in rng.exponential(2.0, 100):
        mine.record(ms)
        theirs.record(ms)
    assert prometheus_text(counters, gauges, {"lat_seconds": mine}) == \
        jprometheus_text(counters, gauges, {"lat_seconds": theirs})


def test_schema_is_the_jax_schema_byte_for_byte():
    mine = REPO / "lightgbm_tpu_torch" / "observability" / "schema.json"
    theirs = REPO / "lightgbm_tpu" / "observability" / "schema.json"
    assert mine.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("spec", [
    "serve.predict.fail:count=-1",
    "serve.predict.delay:seconds=0.25:count=-1;serve.predict.fail:nth=3",
    "net.recv.corrupt_len:len=99\nserve.predict.fail:rank=2:count=2",
    " ; serve.predict.delay ; "])
def test_fault_spec_parses_as_jax(spec):
    mine, theirs = faults.parse_spec(spec), jfaults.parse_spec(spec)
    assert [(c.point, c.rank, c.nth, c.count, c.args) for c in mine] == \
        [(c.point, c.rank, c.nth, c.count, c.args) for c in theirs]


@pytest.mark.parametrize("spec", ["bad=1", "serve.predict.fail:oops"])
def test_bad_fault_spec_raises_as_jax(spec):
    with pytest.raises(ValueError):
        jfaults.parse_spec(spec)
    with pytest.raises(ValueError):
        faults.parse_spec(spec)


@pytest.mark.parametrize("point,title", [
    ("train.crash:nth=3", "reliability and training observability"),
    ("net.send.drop:rank=1", "multi-GPU and multi-host"),
    ("net.send.delay:rank=2:seconds=3", "multi-GPU and multi-host"),
    ("net.send.truncate:rank=1", "multi-GPU and multi-host"),
    ("net.crash:rank=1:nth=2", "multi-GPU and multi-host"),
    ("serving.replica_fault:rank=1", "serving and lifecycle")])
def test_unported_fault_points_raise_their_titles(point, title, monkeypatch):
    with pytest.raises(NotImplementedError, match=f"Queue A: {title}"):
        faults.arm("serve.predict.fail;" + point)
    with pytest.raises(NotImplementedError, match=title):
        lt.Booster(model_str=_MODEL_TEXT[0],
                   params=dict(CPU, fault_spec=point)).to_server(port=0)
    monkeypatch.setenv(faults.ENV_VAR, point)
    faults.reset()
    with pytest.raises(NotImplementedError, match=title):
        faults.load()


_MODEL_TEXT = []


@pytest.fixture(scope="module", autouse=True)
def _model_text():
    _MODEL_TEXT.append(_train(np.random.RandomState(3), trees=2)
                       .model_to_string())
    yield


@pytest.mark.parametrize("params", [{"telemetry": True},
                                    {"snapshot_freq": 2},
                                    {"fault_spec": "serve.predict.fail"},
                                    {"trace_out": "t.json"},
                                    {"stats_out": "s.json"}])
def test_training_keeps_refusing_observability(rng, params):
    X = rng.randn(200, 3)
    y = (X[:, 0] > 0).astype(float)
    p = {"objective": "binary", "verbosity": -1, **CPU, **params}
    with pytest.raises(NotImplementedError,
                       match="reliability and training observability"):
        lt.train(p, lt.Dataset(X, label=y), 1, verbose_eval=False)


@pytest.mark.serving
def test_port_report_validates_under_both_schemas(rng, tmp_path):
    """A live server's report (serving, reliability, provenance and memory
    sections), its ``telemetry_out`` file and a Chrome trace."""
    bst = _train(rng)
    out, trace = tmp_path / "report.json", tmp_path / "trace.json"
    server = lt.Booster(model_str=bst.model_to_string(),
                        params=dict(CPU, telemetry_out=str(out),
                                    trace_out=str(trace))).serve(port=0)
    try:
        with ServingClient(server.host, server.port) as c:
            c.predict(rng.randn(40, 6))
            rep = c.stats()
    finally:
        server.stop()
    assert validate_report(rep) == [] and jvalidate(rep) == []
    on_disk = json.loads(out.read_text())
    assert validate_report(on_disk) == [] and jvalidate(on_disk) == []
    assert rep["provenance"]["platform"] == "cpu"
    assert rep["distributed"]["memory"]["devices"] == [] or \
        torch.cuda.is_initialized()
    ev = json.loads(trace.read_text())["traceEvents"]
    assert {"serve.request", "serve.batch", "serve_bin"} <= \
        {e["name"] for e in ev}


# -- tests/test_reliability.py -----------------------------------------------

def _serve_booster(rng):
    X = rng.randn(600, 4)
    y = (X[:, 0] + X[:, 1] > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 10,
         "verbosity": -1, **CPU}
    return lt.train(p, lt.Dataset(X, label=y, params=dict(p)), 5,
                    verbose_eval=False), X


@pytest.mark.chaos
def test_serving_overload_sheds_structured_and_recovers(rng):
    """Overload sheds with structured ``{"error": "overloaded"}`` frames
    (never a dropped connection), the readiness probe stays accurate, and
    service recovers with no bucket entry outside the warmed ones."""
    bst, X = _serve_booster(rng)
    server = bst.serve(port=0, max_batch_rows=64, min_bucket=32,
                       deadline_ms=1.0, max_inflight=2)
    try:
        with ServingClient(server.host, server.port) as probe:
            assert probe.health()["ready"] is True
            misses_before = probe.stats()["serving"]["compile_cache"][
                "misses"]
        faults.arm("serve.predict.delay:seconds=0.25:count=-1")
        results = []
        lock = threading.Lock()

        def hammer():
            with ServingClient(server.host, server.port, timeout=30) as c:
                send_frame(c._sock, {"op": "predict",
                                     "data": X[:4], "raw_score": True})
                resp = recv_frame(c._sock)
                with lock:
                    results.append(resp)

        ts = [threading.Thread(target=hammer) for _ in range(10)]
        for t in ts:
            t.start()
        with ServingClient(server.host, server.port) as probe:
            h = probe.health()
            assert h["ready"] is True and h["capacity"] == 2
        for t in ts:
            t.join(timeout=30)
            assert not t.is_alive()
        assert len(results) == 10, "every request got a structured frame"
        shed = [r for r in results if not r.get("ok")]
        served = [r for r in results if r.get("ok")]
        assert shed and served
        assert all(r["error"] == "overloaded" and r["shed"] for r in shed)
        faults.disarm()
        with ServingClient(server.host, server.port) as c:
            assert c.predict(X[:8], raw_score=True).shape == (8,)
            h = c.health()
            assert h["ready"] is True and h["shedding"] is False
            rep = c.stats()
            srv = rep["serving"]
            assert srv["shed"] == len(shed)
            assert srv["compile_cache"]["misses"] == misses_before
            assert rep["reliability"]["counters"]["serve.requests_shed"] \
                == len(shed)
            assert validate_report(rep) == []
    finally:
        faults.disarm()
        server.stop()


@pytest.mark.chaos
def test_serving_device_fault_host_fallback(rng):
    """A failing device predict path degrades to the host traversal:
    correct scores, counted fallbacks, no failed request."""
    bst, X = _serve_booster(rng)
    server = bst.serve(port=0, max_batch_rows=64, min_bucket=32)
    try:
        faults.arm("serve.predict.fail:count=-1")
        with ServingClient(server.host, server.port) as c:
            got = c.predict(X[:16], raw_score=True)
            want = np.zeros(16)
            for t in bst.gbdt.models:
                want += t.predict(np.ascontiguousarray(X[:16]))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            rep = c.stats()
        assert rep["serving"]["fallback_batches"] >= 1
        assert rep["serving"]["fallback_rows"] >= 16
        assert rep["serving"]["errors"] == 0
        assert rel_get("serve.host_fallback_batches") >= 1
        assert rep["reliability"]["counters"]["fault.serve.predict.fail"] >= 1
    finally:
        faults.disarm()
        server.stop()


@pytest.mark.chaos
def test_corrupt_length_prefix_closes_the_connection(rng):
    """``net.recv.corrupt_len``: the server's frame guard refuses the
    length, counts it and drops the connection; the client reconnects."""
    bst, X = _serve_booster(rng)
    server = bst.serve(port=0, max_batch_rows=64, min_bucket=64)
    try:
        with ServingClient(server.host, server.port, retries=0,
                           protocol="pickle") as c:
            assert c.ping()
            faults.arm("net.recv.corrupt_len")
            with pytest.raises(ConnectionError):
                c.ping()
            assert c.ping()
        assert rel_counters()["net.frames_rejected_oversize"] == 1
    finally:
        faults.disarm()
        server.stop()


# -- tests/test_tracing.py ---------------------------------------------------

@pytest.mark.serving
def test_trace_id_propagation_through_live_server(rng, tmp_path):
    """One trace_id links the request span, its micro-batch span and the
    batch's stage spans; shed responses echo the id."""
    bst = _train(rng)
    trace_path = tmp_path / "serve_trace.json"
    server = bst.serve(port=0, min_bucket=32, max_batch_rows=64,
                       trace=True, trace_out=str(trace_path))
    tid = new_trace_id()
    try:
        with ServingClient(server.host, server.port, timeout=60) as c:
            got = np.asarray(c.predict(rng.randn(5, 6), trace_id=tid))
            assert got.shape == (5,)
            resp = c._call({"op": "predict", "data": rng.randn(3, 6),
                            "raw_score": False, "trace_id": "echo-42"})
            assert resp["trace_id"] == "echo-42"
            while server.admission.try_acquire():
                pass
            with pytest.raises(ServerOverloaded) as ei:
                c.predict(rng.randn(2, 6), trace_id="shed-1")
            assert ei.value.trace_id == "shed-1"
    finally:
        server.stop()
    trace = json.loads(trace_path.read_text())
    linked = {"serve.request": 0, "serve.batch": 0,
              "serve_bin": 0, "serve_traverse": 0, "serve_queue": 0}
    for e in trace["traceEvents"]:
        if e.get("ph") != "B":
            continue
        t = e.get("args", {}).get("trace_id")
        if t == tid or (isinstance(t, list) and tid in t):
            if e["name"] in linked:
                linked[e["name"]] += 1
    assert all(v >= 1 for v in linked.values()), linked
    rep = server.report()
    assert validate_report(rep) == []
    assert rep["serving"]["latency_ms"]["count"] >= 2


@pytest.mark.serving
def test_metrics_op_prometheus_snapshot(rng):
    bst = _train(rng)
    server = bst.serve(port=0, min_bucket=32, max_batch_rows=64)
    try:
        with ServingClient(server.host, server.port, timeout=60) as c:
            c.predict(rng.randn(4, 6))
            text = c.metrics()
    finally:
        server.stop()
    assert "# TYPE lgbt_serving_requests_total counter" in text
    assert "lgbt_serving_requests_total 1" in text
    assert 'lgbt_serving_request_latency_seconds_bucket{le="+Inf"} 1' in text
    assert "lgbt_serving_batch_occupancy" in text
    assert "lgbt_serving_inflight" in text
    assert 'lgbt_serving_tenant_requests_total{model="default"} 1' in text


@pytest.mark.serving
def test_stats_out_periodic_snapshots(rng, tmp_path):
    """``stats_out``: periodic atomic schema-validated snapshots appear
    without any socket op, and a final one lands at stop."""
    bst = _train(rng)
    out = tmp_path / "stats.json"
    server = bst.serve(port=0, min_bucket=32, max_batch_rows=64,
                       stats_out=str(out), stats_interval_s=0.2)
    try:
        with ServingClient(server.host, server.port, timeout=60) as c:
            c.predict(rng.randn(3, 6))
        deadline = time.monotonic() + 30
        while not out.exists() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert out.exists(), "no snapshot within 30s at 0.2s interval"
        assert validate_report(json.loads(out.read_text())) == []
    finally:
        server.stop()
    final = json.loads(out.read_text())
    assert validate_report(final) == [] and jvalidate(final) == []
    assert final["serving"]["requests"] >= 1


def test_span_nesting_ring_wrap_and_export():
    """``TraceRecorder`` as ``tests/test_tracing.py`` holds the JAX one:
    nested B/E pairs, newest spans kept past capacity, drop count."""
    r = TraceRecorder(True, capacity=4)
    with r.span("outer", args={"k": 1}):
        with r.span("mid"):
            with r.span("inner", trace_id="t"):
                pass
    ev = [e for e in r.export()["traceEvents"] if e["ph"] in "BE"]
    assert [(e["ph"], e["name"]) for e in ev] == [
        ("B", "outer"), ("B", "mid"), ("B", "inner"),
        ("E", "inner"), ("E", "mid"), ("E", "outer")]
    for i in range(10):
        with r.span(f"s{i}"):
            pass
    assert len(r) == 4 and r.dropped == 9
    assert {s[0] for s in r.spans()} == {"s6", "s7", "s8", "s9"}
    off = TraceRecorder(False)
    with off.span("x"):
        pass
    assert len(off) == 0 and off.export()["otherData"]["spans_recorded"] == 0


def test_no_socket_left_open_after_stop(rng):
    """``stop`` closes the listener: a connect after it is refused."""
    bst = _train(rng, trees=2)
    server = bst.serve(port=0, min_bucket=32, max_batch_rows=32)
    port = server.port
    server.stop()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2).close()
