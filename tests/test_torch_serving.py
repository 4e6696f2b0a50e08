"""The port's prediction server against lightgbm_tpu's, on the CPU.

The same model text is served by the JAX ``PredictionServer`` and by the
port's (``device_type=cpu``: ``bin_plain`` and the eager traversal, the
graph path's CPU twin): their scores, raw and converted, agree within 1e-6
on fuzz rows (NaN, unseen, negative and fractional categories) for a binary
model with a categorical column and a 3-class model.  Clients of either
package talk to servers of either; the binary wire codecs encode the JAX
module's bytes and decode them.  The rest ports ``tests/test_serving.py``:
the batcher's coalescing, deadline and oversize chunking, registry
hot-swap and rollback, the round trip and its schema, no new bucket entry
after warmup, hot-swap over the wire and the CLI end to end.

The JAX servers compile one jit per bucket on the CPU, so they get a single
bucket (``min_bucket = max_batch_rows = 64``).
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
from lightgbm_tpu.observability import validate_report as jvalidate
from lightgbm_tpu.serving import PredictionServer as JServer
from lightgbm_tpu.serving import ServingClient as JClient
from lightgbm_tpu.serving.fleet import wire as jwire

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.observability import validate_report
from lightgbm_tpu_torch.serving import (MicroBatcher, ModelRegistry,
                                        PredictionServer, ServingClient,
                                        ServingStats)
from lightgbm_tpu_torch.serving.fleet import wire

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = {"device_type": "cpu"}
#: the JAX servers' single bucket (one jit compile each)
ONE_BUCKET = dict(min_bucket=64, max_batch_rows=64, deadline_ms=1.0)


def _train_matrix(rng, n=2500):
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


def _fuzz_matrix(rng, n=700):
    X = np.column_stack([
        rng.randn(n),
        rng.randint(-3, 25, n).astype(float),         # unseen + negative cats
        rng.randn(n) * 10,
        np.where(rng.rand(n) < 0.4, 0.0, rng.randn(n)),
    ])
    X[::11, 0] = np.nan
    X[::5, 1] = np.nan
    X[3 % n, 1] = 7.9                                 # fractional category
    return X


def _train(rng, trees=10, num_class=1, **params):
    X, y = _train_matrix(rng)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "min_data_in_leaf": 10, **CPU}
    if num_class > 1:
        y = (np.nan_to_num(X[:, 0] * 2).astype(int) % num_class).astype(float)
        p.update(objective="multiclass", num_class=num_class)
    p.update(params)
    return lt.train(p, lt.Dataset(X, label=y, categorical_feature=[1]),
                    trees, verbose_eval=False)


def _host_raw(gbdt, X):
    X = np.ascontiguousarray(X, dtype=np.float64)
    k = max(gbdt.num_tree_per_iteration, 1)
    out = np.zeros((X.shape[0], k))
    for i, t in enumerate(gbdt.models):
        out[:, i % k] += t.predict(X)
    return out[:, 0] if k == 1 else out


def _port_text_booster(text):
    return lt.Booster(model_str=text, params=dict(CPU))


# -- the port against the JAX server -----------------------------------------

@pytest.mark.serving
@pytest.mark.parametrize("num_class", [1, 3])
def test_scores_equal_jax_server(rng, num_class):
    """One model text, both servers, the same fuzz rows: raw and converted
    scores within 1e-6 (every request through a 64-row bucket)."""
    text = _train(rng, trees=8, num_class=num_class).model_to_string()
    Xt = _fuzz_matrix(rng, 200)
    jsrv = JServer(booster=lj.Booster(model_str=text), port=0,
                   **ONE_BUCKET).start()
    psrv = PredictionServer(booster=_port_text_booster(text), port=0,
                            **ONE_BUCKET).start()
    try:
        with JClient("127.0.0.1", jsrv.port) as jc, \
                ServingClient("127.0.0.1", psrv.port) as pc:
            for raw in (True, False):
                for n in (1, 37, 64, 200):
                    want = np.asarray(jc.predict(Xt[:n], raw_score=raw))
                    got = np.asarray(pc.predict(Xt[:n], raw_score=raw))
                    assert got.shape == want.shape
                    np.testing.assert_allclose(got, want, rtol=1e-6,
                                               atol=1e-6)
            if num_class > 1:
                rows = np.asarray(pc.predict(Xt))
                np.testing.assert_allclose(rows.sum(1), 1.0, atol=1e-12)
    finally:
        psrv.stop()
        jsrv.stop()


@pytest.mark.serving
def test_clients_and_servers_of_both_packages_interoperate(rng):
    """The JAX client against the port's server and the port's client
    against the JAX server: ping, predict, stats and swap, over the pickle
    framing both negotiate (a threaded server refuses the binary probe)."""
    bst1 = _train(rng, trees=6)
    bst2 = _train(rng, trees=3, num_leaves=7, learning_rate=0.3)
    Xt = _fuzz_matrix(rng, 30)
    t1, t2 = bst1.model_to_string(), bst2.model_to_string()
    psrv = bst1.serve(port=0, **ONE_BUCKET)
    jsrv = JServer(booster=lj.Booster(model_str=t1), port=0,
                   **ONE_BUCKET).start()
    try:
        for client, srv, validate in ((JClient, psrv, validate_report),
                                      (ServingClient, jsrv, jvalidate)):
            with client("127.0.0.1", srv.port) as c:
                assert c.ping() is True
                np.testing.assert_allclose(
                    np.asarray(c.predict(Xt, raw_score=True)),
                    _host_raw(bst1.gbdt, Xt), rtol=1e-6, atol=1e-6)
                assert c.protocol == "pickle"
                rep = c.stats()
                assert validate(rep) == []
                assert rep["serving"]["requests"] == 1
                assert c.swap(t2) == 2
                np.testing.assert_allclose(
                    np.asarray(c.predict(Xt, raw_score=True)),
                    _host_raw(bst2.gbdt, Xt), rtol=1e-6, atol=1e-6)
                assert c.health()["versions"] == {
                    "default": {"version": 2, "previous": 1}}
    finally:
        psrv.stop()
        jsrv.stop()


@pytest.mark.parametrize("seed", range(4))
def test_wire_frames_equal_jax_bytes(seed):
    """A seeded sweep of request and response frames: the port encodes the
    JAX module's bytes and decodes them."""
    rng = np.random.RandomState(seed)
    n, f = rng.randint(1, 50), rng.randint(1, 30)
    X = rng.randn(n, f) * 10.0 ** rng.randint(-3, 4)
    X[rng.rand(n, f) < 0.1] = np.nan
    name = ["default", "m", "mødel-ß"][seed % 3]
    tid = ["", "abc", "0123456789abcdef", "x" * 20][seed]
    scores = rng.randn(n) if seed % 2 else rng.randn(n, 3)
    body = {"model": name, "model_str": "tree\n" * seed,
            "v": np.float64(1.5), "k": np.int64(seed),
            "a": np.arange(3)}
    pairs = [
        (wire.encode_predict_request(X, name),
         jwire.encode_predict_request(X, name)),
        (wire.encode_predict_response(scores),
         jwire.encode_predict_response(scores)),
        (wire.encode_json(body), jwire.encode_json(body)),
        (wire.pack_frame(wire.OP_PREDICT, b"xyz" * seed,
                         wire.FLAG_RAW_SCORE, tid),
         jwire.pack_frame(jwire.OP_PREDICT, b"xyz" * seed,
                          jwire.FLAG_RAW_SCORE, tid)),
        (wire.error_frame("boom", tid), jwire.error_frame("boom", tid)),
        (wire.shed_frame(3, 4, tid, name, "tenant"),
         jwire.shed_frame(3, 4, tid, name, "tenant")),
    ]
    for mine, theirs in pairs:
        assert mine == theirs
    Xd, nd = wire.decode_predict_request(
        jwire.encode_predict_request(X, name))
    np.testing.assert_array_equal(Xd, X.astype(np.float32).astype(np.float64))
    assert nd == name
    np.testing.assert_array_equal(
        wire.decode_predict_response(jwire.encode_predict_response(scores)),
        scores)
    frame = jwire.pack_frame(jwire.OP_STATS, jwire.encode_json(body), 0, tid)
    op, flags, t, length = wire.unpack_header(frame[:wire.HEADER_SIZE])
    assert (op, flags, t, length) == jwire.unpack_header(
        frame[:jwire.HEADER_SIZE])
    assert wire.decode_json(frame[wire.HEADER_SIZE:]) == \
        jwire.decode_json(frame[jwire.HEADER_SIZE:])
    shed = jwire.shed_frame(3, 4, tid, name, "tenant")
    assert wire.response_to_dict(*wire.unpack_header(
        shed[:wire.HEADER_SIZE])[:3], shed[wire.HEADER_SIZE:]) == \
        jwire.response_to_dict(*jwire.unpack_header(
            shed[:jwire.HEADER_SIZE])[:3], shed[jwire.HEADER_SIZE:])
    with pytest.raises(wire.WireError):
        wire.unpack_header(b"LGBX" + frame[4:wire.HEADER_SIZE])
    with pytest.raises(wire.WireError):
        wire.unpack_header(frame[:wire.HEADER_SIZE], max_bytes=1)


# -- micro-batcher (tests/test_serving.py) -----------------------------------

@pytest.mark.serving
def test_batcher_coalesces_concurrent_requests(rng):
    stats = ServingStats()
    calls = []

    def predict_fn(Xpad, m):
        calls.append((Xpad.shape[0], m))
        return Xpad[:m, 0] * 2.0

    b = MicroBatcher(predict_fn, num_features=3, max_batch_rows=128,
                     deadline_ms=120.0, min_bucket=16, stats=stats).start()
    try:
        Xs = [rng.randn(5, 3), rng.randn(7, 3), rng.randn(4, 3)]
        out = [None] * 3
        threads = [threading.Thread(
            target=lambda i=i: out.__setitem__(i, b.submit(Xs[i], timeout=30)))
            for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
            assert not t.is_alive()
        for i in range(3):
            np.testing.assert_allclose(out[i], Xs[i][:, 0] * 2.0)
        # all three coalesced into one padded power-of-two batch
        assert calls == [(16, 16)] and stats.batches == 1
        assert stats.requests == 3 and stats.rows == 16
    finally:
        b.stop()


@pytest.mark.serving
def test_batcher_deadline_and_oversize_chunking(rng):
    stats = ServingStats()
    calls = []

    def predict_fn(Xpad, m):
        calls.append(Xpad.shape[0])
        return Xpad[:m, 0]

    b = MicroBatcher(predict_fn, num_features=2, max_batch_rows=64,
                     deadline_ms=5.0, min_bucket=8, stats=stats).start()
    try:
        t0 = time.monotonic()
        b.submit(rng.randn(3, 2), timeout=30)
        assert time.monotonic() - t0 < 5.0, "deadline did not bound latency"
        assert calls == [8]
        X = rng.randn(150, 2)
        out = b.submit(X, timeout=30)
        np.testing.assert_array_equal(out, X[:, 0])
        assert calls[1:] == [64, 64, 32]
        with pytest.raises(ValueError):
            b.submit(rng.randn(4, 5), timeout=5)
    finally:
        b.stop()


@pytest.mark.serving
def test_batcher_fallback_rescores_or_fails_the_batch(rng):
    """A raising ``predict_fn`` hands its error to ``fallback_fn``: a
    fallback that re-scores answers the batch, counted; one that re-raises
    fails every rider with that error, and nothing is counted."""
    def predict_fn(Xpad, m):
        raise RuntimeError("device path failed")

    def rescore(Xpad, m, error):
        assert isinstance(error, RuntimeError)
        return Xpad[:m, 0]

    def decline(Xpad, m, error):
        raise error

    X = rng.randn(5, 2)
    for fallback_fn, counted in ((rescore, 1), (decline, 0)):
        stats = ServingStats()
        b = MicroBatcher(predict_fn, num_features=2, max_batch_rows=64,
                         deadline_ms=1.0, min_bucket=8, stats=stats,
                         fallback_fn=fallback_fn).start()
        try:
            if counted:
                np.testing.assert_array_equal(b.submit(X, timeout=30),
                                              X[:, 0])
            else:
                with pytest.raises(RuntimeError, match="device path"):
                    b.submit(X, timeout=30)
        finally:
            b.stop()
        assert stats.fallback_batches == counted
        assert stats.fallback_rows == 5 * counted


# -- registry ----------------------------------------------------------------

@pytest.mark.serving
def test_registry_hot_swap_and_rollback(rng):
    """Load, hot-swap from model text on the CPU registry's device, refuse
    a corrupt text without dislodging the live version, roll back and
    forward."""
    reg = ModelRegistry(warm_buckets=[32, 64], verify_rows=48)
    bst1 = _train(rng, trees=6)
    assert reg.load("default", booster=bst1) == 1
    assert reg.device == torch.device("cpu")
    m1 = reg.get("default")
    X = _fuzz_matrix(rng, 20)
    Xpad = np.zeros((32, 4))
    Xpad[:20] = X
    np.testing.assert_allclose(m1.predict_padded(Xpad, 20),
                               _host_raw(bst1.gbdt, X), rtol=1e-6, atol=1e-6)
    bst2 = _train(rng, trees=3, num_leaves=7)
    assert reg.load("default", model_str=bst2.model_to_string()) == 2
    m2 = reg.get("default")
    assert m2.version == 2 and m2 is not m1
    assert m2.device == torch.device("cpu")
    assert m2.booster.gbdt.train_data is None
    np.testing.assert_allclose(m2.predict_padded(Xpad, 20),
                               _host_raw(bst2.gbdt, X), rtol=1e-6, atol=1e-6)
    with pytest.raises(Exception):
        reg.load("default", model_str="not a model")
    assert reg.get("default") is m2
    assert reg.versions() == {"default": 2}
    assert reg.rollback("default") == 1 and reg.get("default") is m1
    assert reg.versions_detail() == {"default": {"version": 1,
                                                 "previous": 2}}
    assert reg.rollback("default") == 2 and reg.get("default") is m2
    with pytest.raises(KeyError):
        reg.rollback("other")


# -- server round trip -------------------------------------------------------

@pytest.mark.serving
def test_server_round_trip_and_schema(rng):
    bst = _train(rng, trees=10)
    server = bst.serve(port=0, max_batch_rows=128, min_bucket=32,
                       deadline_ms=2.0)
    try:
        with ServingClient("127.0.0.1", server.port, timeout=60) as c:
            assert c.ping()
            for n in (3, 17, 29):
                Xt = _fuzz_matrix(rng, n)
                np.testing.assert_allclose(
                    np.asarray(c.predict(Xt)).ravel(), bst.predict(Xt),
                    rtol=1e-6, atol=1e-6)
                np.testing.assert_allclose(
                    np.asarray(c.predict(Xt, raw_score=True)).ravel(),
                    bst.predict(Xt, raw_score=True), rtol=1e-6, atol=1e-6)
            rep = c.stats()
    finally:
        server.stop()
    assert validate_report(rep) == []
    srv = rep["serving"]
    assert srv["requests"] >= 6 and srv["batches"] >= 6
    assert srv["qps"] > 0 and 0 < srv["batch_occupancy"] <= 1
    assert set(srv["stage_ms"]) >= {"queue", "bin", "traverse", "unpad"}
    assert srv["models"] == {"default": 1}
    assert srv["fallback_batches"] == 0 and srv["errors"] == 0
    prov = rep["provenance"]
    assert prov["platform"] == "cpu" and prov["emulated"] is True
    assert prov["jax_version"] == "none"


@pytest.mark.serving
def test_no_new_bucket_entry_after_warmup(rng):
    """Sizes inside one bucket reuse it: the registry's bucket entries do
    not grow after warmup, and only the warmup missed (the counterpart of
    ``test_zero_recompiles_within_bucket``)."""
    bst = _train(rng, trees=8)
    server = bst.serve(port=0, max_batch_rows=64, min_bucket=64,
                       deadline_ms=1.0)
    try:
        with ServingClient("127.0.0.1", server.port, timeout=60) as c:
            c.predict(_fuzz_matrix(rng, 5))
            before = server.registry.jit_entries()
            for n in (9, 33, 64, 21):
                c.predict(_fuzz_matrix(rng, n))
            after = server.registry.jit_entries()
            rep = c.stats()
    finally:
        server.stop()
    assert before == after == 1
    srv = rep["serving"]
    assert srv["compile_cache"]["misses"] == 1
    assert srv["compile_cache"]["hits"] >= 5
    assert srv["compile_cache"]["jit_entries"] == 1
    assert list(srv["buckets"]) == ["64"]


@pytest.mark.serving
def test_server_hot_swap_over_the_wire(rng):
    bst1 = _train(rng, trees=8)
    bst2 = _train(rng, trees=4, num_leaves=7, learning_rate=0.3)
    server = bst1.serve(port=0, max_batch_rows=64, min_bucket=32,
                        deadline_ms=1.0)
    try:
        with ServingClient("127.0.0.1", server.port, timeout=60) as c:
            Xt = _fuzz_matrix(rng, 10)
            np.testing.assert_allclose(np.asarray(c.predict(Xt)).ravel(),
                                       bst1.predict(Xt), rtol=1e-6,
                                       atol=1e-6)
            assert c.swap(bst2.model_to_string()) == 2
            np.testing.assert_allclose(np.asarray(c.predict(Xt)).ravel(),
                                       bst2.predict(Xt), rtol=1e-6,
                                       atol=1e-6)
            with pytest.raises(RuntimeError):
                c.swap("garbage")
            assert c.stats()["serving"]["models"] == {"default": 2}
            # the swapped-in model serves on the server's device
            assert server.registry.get().device == torch.device("cpu")
    finally:
        server.stop()


def test_fleet_and_replicas_stay_refused(rng):
    bst = _train(rng, trees=2)
    with pytest.raises(NotImplementedError, match="serving and lifecycle"):
        bst.to_server(replicas=2)
    with pytest.raises(NotImplementedError, match="serving and lifecycle"):
        lt.Booster(model_str=bst.model_to_string(),
                   params=dict(CPU, serve_replicas=-1)).serve(port=0)


# -- CLI end to end -----------------------------------------------------------

@pytest.mark.serving(timeout=300)
def test_cli_serve_end_to_end(tmp_path, rng):
    """``python -m lightgbm_tpu_torch serve ... device_type=cpu``: served
    scores equal Booster.predict, one bucket entry across 3 sizes, and the
    telemetry report written on shutdown validates against both schemas."""
    bst = _train(rng, trees=10)
    model_path = tmp_path / "model.txt"
    bst.save_model(str(model_path))
    report_path = tmp_path / "serving_report.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "lightgbm_tpu_torch", "serve",
         f"input_model={model_path}", "serve_port=0", "serve_min_bucket=64",
         "serve_max_batch_rows=64", f"telemetry_out={report_path}",
         "device_type=cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path))
    port = None
    try:
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                raise AssertionError("serve process exited early")
            if "Serving" in line and " at " in line:
                port = int(line.split(" at ")[1].split()[0].rsplit(":", 1)[1])
                break
        assert port, "serve process never reported its port"
        with ServingClient("127.0.0.1", port, timeout=120) as c:
            for n in (5, 23, 41):
                Xt = _fuzz_matrix(rng, n)
                np.testing.assert_allclose(np.asarray(c.predict(Xt)).ravel(),
                                           bst.predict(Xt), rtol=1e-6,
                                           atol=1e-6)
            rep = c.stats()
            assert rep["serving"]["compile_cache"]["misses"] == 1
            assert rep["serving"]["compile_cache"]["hits"] >= 4
            c.shutdown()
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    assert proc.returncode == 0
    assert validate_report(rep) == []
    on_disk = json.loads(report_path.read_text())
    assert validate_report(on_disk) == [] and jvalidate(on_disk) == []
    assert on_disk["serving"]["requests"] >= 3
