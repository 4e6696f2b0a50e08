"""The port's serving lifecycle against lightgbm_tpu's, on the CPU.

``RefitBudget`` admits and vetoes a scripted sequence of cycle starts,
ends and rollbacks exactly as the JAX budget does (both clocks driven by
the test).  The ``Autopilot`` of a two-replica port fleet and of a JAX
fleet serving the same model text take the same decisions on the same
scripted traffic: an empty window, a clean window, drift below the
consecutive threshold, a clean window that resets the streak, a refit the
shadow gate rejects, a refit promoted to both replicas, and a refit the
spent budget suppresses.  The ``LifecycleController`` ports
``tests/test_lifecycle.py``: refit, shadow and promote with no request
dropped, a rejected candidate never served, the watchdog's rollback on an
injected fault and its healthy verdict, and a refit killed by
``train.crash`` that resumes to the uninterrupted model text.

Nothing here waits on a wall-clock bound: the budget's clock is driven,
the watchdog is joined, and traffic is counted.
"""

import glob
import os
import threading
import types

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
from lightgbm_tpu.lifecycle import Autopilot as JAutopilot
from lightgbm_tpu.lifecycle import LifecycleController as JController
from lightgbm_tpu.lifecycle import RefitBudget as JBudget
from lightgbm_tpu.lifecycle import budget as jbudget_mod
from lightgbm_tpu.reliability import faults as jfaults
from lightgbm_tpu.serving import ServingClient as JClient

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.lifecycle import (Autopilot, CandidateRejected,
                                          LifecycleController, RefitBudget)
from lightgbm_tpu_torch.lifecycle import budget as budget_mod
from lightgbm_tpu_torch.observability import validate_report
from lightgbm_tpu_torch.reliability import faults, rel_get, rel_reset
from lightgbm_tpu_torch.reliability.resume import list_snapshots
from lightgbm_tpu_torch.serving import FleetServer, ServingClient

torch.set_num_threads(1)

pytestmark = pytest.mark.lifecycle(timeout=300)

CPU = {"device_type": "cpu"}
_P = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 10,
      "verbosity": -1}
_PC = dict(_P, **CPU)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jfaults.reset()
    rel_reset()
    yield
    faults.reset()
    jfaults.reset()
    rel_reset()


def _data(rng, n=500, flip=0.0):
    X = rng.randn(n, 4)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    if flip:
        y = np.where(rng.rand(n) < flip, 1.0 - y, y)
    return X, y


def _label(X):
    X = np.asarray(X)
    return (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)


def _drifted(X):
    Xd = np.array(X, copy=True)
    Xd[:, 0] += 6.0
    return Xd


def _train(X, y, rounds=5, **extra):
    p = dict(_PC, **extra)
    return lt.train(dict(p), lt.Dataset(X, label=y, params=dict(p)),
                    rounds, verbose_eval=False)


def _serve(bst, **kw):
    kw.setdefault("port", 0)
    kw.setdefault("max_batch_rows", 64)
    kw.setdefault("min_bucket", 32)
    kw.setdefault("record_rows", 128)
    return bst.serve(**kw)


def _traffic(server, X, rows=96, client=ServingClient):
    with client(server.host, server.port, timeout=60) as c:
        for ofs in range(0, rows, 32):
            c.predict(X[ofs:ofs + 32])


# -- the refit budget ---------------------------------------------------------

def test_refit_budget_equals_jax(monkeypatch):
    """Starts, ends, rollbacks and clock steps through every veto (the
    concurrency slot, min spacing, the cooldown after a rollback, the
    window cap and its slide): every admission, reason and section equals
    the JAX budget's."""
    now = [500.0]
    clock = types.SimpleNamespace(monotonic=lambda: now[0])
    monkeypatch.setattr(budget_mod, "time", clock)
    monkeypatch.setattr(jbudget_mod, "time", clock)
    kw = dict(max_refits_per_window=2, window_s=600.0, min_spacing_s=60.0,
              cooldown_s=300.0)
    ours, theirs = RefitBudget(**kw), JBudget(**kw)
    script = ["begin", "begin", "end", "begin", ("step", 61), "begin",
              "end_rb", "begin", ("step", 299), "begin", ("step", 2),
              "begin", "end", ("step", 61), "note_rb", "begin",
              ("step", 301), "begin", ("step", 600), "begin", "end",
              ("step", 61), "begin", "end"]
    seen = []
    for op in script:
        if isinstance(op, tuple):
            now[0] += op[1]
        elif op == "begin":
            got, want = ours.try_begin(), theirs.try_begin()
            assert got == want
            seen.append(got[1] or "admitted")
        elif op == "note_rb":
            ours.note_rollback()
            theirs.note_rollback()
        else:
            ours.end(rolled_back=op == "end_rb")
            theirs.end(rolled_back=op == "end_rb")
        assert ours.section() == theirs.section()
    assert set(seen) == {"admitted", "concurrent_refit", "min_spacing",
                         "cooldown", "window_exhausted"}


# -- the autopilot ------------------------------------------------------------

def _autopilot_run(pkg, text, X0, y0):
    """The scripted autopilot sequence on a two-replica fleet of ``pkg``
    serving ``text``; returns the decisions and the served versions."""
    if pkg == "port":
        srv = FleetServer(booster=lt.Booster(model_str=text,
                                             params=dict(CPU)),
                          replicas=2,
                          port=0, max_batch_rows=64, min_bucket=32,
                          record_rows=96, drift_min_rows=32).start()
        ctl_cls, ap_cls, budget_cls, client = (
            LifecycleController, Autopilot, RefitBudget, ServingClient)
        params = dict(_PC)
    else:
        srv = lj.Booster(model_str=text).serve(
            replicas=2, port=0, max_batch_rows=64, min_bucket=32,
            record_rows=96, drift_min_rows=32)
        ctl_cls, ap_cls, budget_cls, client = (
            JController, JAutopilot, JBudget, JClient)
        params = dict(_P)
    out = []
    try:
        ctl = ctl_cls(srv, divergence_max=1e-9, latency_max_ratio=1e6,
                      min_shadow_rows=1)
        ap = ap_cls(srv, ctl, lambda: (X0, y0), label_fn=_label,
                    consecutive_checks=2, num_boost_round=3, params=params,
                    budget=budget_cls(max_refits_per_window=2,
                                      window_s=3600.0, min_spacing_s=0.0,
                                      cooldown_s=0.0))

        def tick():
            d = ap.tick()
            out.append(None if d is None else
                       (d["decision"], d.get("consecutive"), d.get("reason")
                        if d["decision"] != "rejected" else None))

        tick()                                    # no window, no baseline
        with pytest.raises(Exception) as ei:
            ap._refit_cycle()                     # the empty window
        out.append(("raised", type(ei.value).__name__,
                    ei.value.report["reasons"]))
        _traffic(srv, X0, client=client)
        out.append(("baseline", srv.capture_drift_baseline()))
        tick()                                    # clean
        _traffic(srv, _drifted(X0), client=client)
        tick()                                    # pending 1
        _traffic(srv, X0, client=client)
        tick()                                    # clean: the streak resets
        for _ in range(2):
            _traffic(srv, _drifted(X0), client=client)
            tick()                                # pending 1, then rejected
        ctl.divergence_max = 10.0
        _traffic(srv, _drifted(X0), client=client)
        tick()                                    # promoted
        out.append(("versions", srv.replicas.versions(),
                    [s["models"] for s in srv.replicas.section()]))
        for _ in range(2):
            _traffic(srv, X0, client=client)
            tick()                                # pending, then suppressed
        tick()                                    # stale window
        sec = ap.section()
        out.append(("section", sec["triggered"], sec["rejected"],
                    sec["promoted"], sec["suppressed"],
                    sec["budget"]["suppressed"],
                    [e["decision"] for e in sec["decisions"]]))
        if pkg == "port":
            assert validate_report(srv.report()) == []
    finally:
        srv.stop()
    return out


def test_autopilot_decisions_equal_jax():
    """The same model text, train source and scripted traffic through a
    port fleet and a JAX fleet: the same decisions in the same order, the
    promoted version on both replicas, the same section counts."""
    rng = np.random.RandomState(21)
    X0, y0 = _data(rng)
    text = _train(X0, y0, 4).model_to_string()
    ours = _autopilot_run("port", text, X0, y0)
    theirs = _autopilot_run("jax", text, X0, y0)
    assert ours == theirs
    kinds = [o[0] for o in ours if o is not None]
    assert kinds.count("promoted") == 1 and kinds.count("rejected") == 1
    assert ("suppressed", 2, "window_exhausted") in ours
    assert ("versions", {"default": 2}, [{"default": 2}] * 2) in ours


# -- the controller -----------------------------------------------------------

def test_run_cycle_promotes_without_dropping_a_request(rng):
    """Refit, shadow and promote while four clients without retries send
    requests: none fails, the promoted model (4 + 3 trees) serves, and the
    report's lifecycle section validates."""
    X, y = _data(rng)
    inc = _train(X, y, 4)
    server = _serve(inc)
    stop = threading.Event()
    answered, failures = [0], []
    cond = threading.Condition()

    def hammer():
        try:
            with ServingClient(server.host, server.port, timeout=60,
                               retries=0) as c:
                while not stop.is_set():
                    assert c.predict(X[:8], raw_score=True).shape == (8,)
                    with cond:
                        answered[0] += 1
                        cond.notify_all()
        except Exception as e:
            with cond:
                failures.append(repr(e))
                cond.notify_all()

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    try:
        ctl = LifecycleController(server, divergence_max=0.75)
        _traffic(server, X)
        X2, y2 = _data(rng)
        for t in threads:
            t.start()
        result = ctl.run_cycle(lt.Dataset(X2, label=y2, params=dict(_PC)),
                               3, dict(_PC), watch=False)
        with cond:
            base = answered[0]
            assert cond.wait_for(lambda: failures or answered[0] >= base + 8,
                                 120)
        stop.set()
        for t in threads:
            t.join(60)
        assert failures == [] and answered[0] > 0
        assert result["version"] == 2 and result["shadow"]["passed"]
        assert server.registry.versions() == {"default": 2}
        assert server.registry.get("default").booster.num_trees() == 7
        assert rel_get("lifecycle.promotions") == 1
        rep = server.report()
        assert validate_report(rep) == []
        assert rep["lifecycle"]["promotions"] == 1
        assert rep["lifecycle"]["versions"]["default"]["previous"] == 1
    finally:
        stop.set()
        for t in threads:
            if t.is_alive():
                t.join(60)
        server.stop()


def test_shadow_rejects_a_regressed_candidate(rng):
    """A candidate trained on inverted labels fails the divergence and
    metric gates with a structured report and is never served; a shadow
    without enough recorded rows fails too; ``run_cycle`` raises typed."""
    X, y = _data(rng)
    server = _serve(_train(X, y, 5))
    try:
        ctl = LifecycleController(server, divergence_max=0.15,
                                  metric="auc", metric_floor=0.75,
                                  min_shadow_rows=8)
        prepared, report = ctl.shadow(_train(X, y, 4))
        assert prepared is None
        assert "recording too small" in report["reasons"][0]
        _traffic(server, X)
        assert len(server.recorder) == 96
        prepared, report = ctl.shadow(_train(X, 1.0 - y, 5),
                                      labels=y[:96])
        assert prepared is None and report["passed"] is False
        assert not report["gates"]["divergence"]["passed"]
        assert not report["gates"]["metric"]["passed"]
        ctl.divergence_max = 1e-9
        X2, y2 = _data(rng)
        with pytest.raises(CandidateRejected) as ei:
            ctl.run_cycle(lt.Dataset(X2, label=y2, params=dict(_PC)), 2,
                          dict(_PC), watch=False)
        assert ei.value.report["reasons"]
        assert server.registry.versions() == {"default": 1}
        assert rel_get("lifecycle.shadow_rejections") == 3
        rep = server.report()
        assert rep["lifecycle"]["shadow"]["passed"] is False
        assert validate_report(rep) == []
    finally:
        server.stop()


def test_watchdog_rolls_back_on_an_injected_fault(rng):
    """After a watched promotion the promoted model's device path fails
    (``serve.predict.fail``): requests still answer through the host
    fallback, the fallback rate breaches and the watchdog restores the
    incumbent, which then serves its own scores."""
    X, y = _data(rng)
    inc = _train(X, y, 4)
    server = _serve(inc)
    try:
        ctl = LifecycleController(server, divergence_max=0.75,
                                  rollback_deadline_s=600.0,
                                  watch_interval_s=0.02,
                                  error_rate_max=0.2)
        _traffic(server, X)
        X2, y2 = _data(rng)
        assert ctl.run_cycle(lt.Dataset(X2, label=y2, params=dict(_PC)), 2,
                             dict(_PC), watch=True)["version"] == 2
        faults.arm("serve.predict.fail:count=-1")
        with ServingClient(server.host, server.port, timeout=60) as c:
            while not ctl.watchdog.join(timeout=0.05):
                c.predict(X[:8])
        faults.disarm()
        assert ctl.watchdog.result == "rolled_back", ctl.watchdog.section()
        assert "fallback rate" in ctl.watchdog.breach
        assert server.registry.get("default").version == 1
        assert server.registry.get("default").booster is inc
        assert rel_get("lifecycle.auto_rollbacks") == 1
        lc = server.report()["lifecycle"]
        assert lc["auto_rollbacks"] == 1
        assert lc["watchdog"]["result"] == "rolled_back"
        with ServingClient(server.host, server.port) as c:
            np.testing.assert_allclose(
                c.predict(X[:16], raw_score=True),
                inc.predict(X[:16], raw_score=True), rtol=1e-6, atol=1e-6)
    finally:
        faults.reset()
        server.stop()


def test_watchdog_clears_a_healthy_promotion(rng):
    """No breach before the deadline (0 s: its first look): the watchdog
    records a healthy promotion and the new version keeps serving."""
    X, y = _data(rng)
    server = _serve(_train(X, y, 4))
    try:
        ctl = LifecycleController(server, divergence_max=0.75,
                                  rollback_deadline_s=0.0,
                                  watch_interval_s=0.01)
        _traffic(server, X, rows=32)
        X2, y2 = _data(rng)
        ctl.run_cycle(lt.Dataset(X2, label=y2, params=dict(_PC)), 2,
                      dict(_PC), watch=True)
        assert ctl.watchdog.join(timeout=60)
        assert ctl.watchdog.result == "healthy"
        assert server.registry.get("default").version == 2
        assert rel_get("lifecycle.promotions_healthy") == 1
    finally:
        server.stop()


def test_killed_refit_resumes_bit_identical(rng, tmp_path):
    """``train.crash`` kills a snapshotting refit after its second
    iteration: nothing is served from it, snapshots remain, and
    ``refit(resume=True)`` lands on the uninterrupted refit's model text,
    which then promotes."""
    X, y = _data(rng)
    server = _serve(_train(X, y, 4))
    out = str(tmp_path / "refit.txt")
    try:
        ctl = LifecycleController(server, divergence_max=10.0)
        X2, y2 = _data(rng)

        def ds():
            return lt.Dataset(X2, label=y2, params=dict(_PC))

        full = ctl.refit(ds(), 4, dict(_PC), output_model=out,
                         snapshot_freq=1).model_to_string()
        for f in glob.glob(out + ".snapshot_iter_*"):
            os.unlink(f)
        faults.arm("train.crash:nth=2")
        with pytest.raises(Exception, match="train.crash"):
            ctl.refit(ds(), 4, dict(_PC), output_model=out, snapshot_freq=1)
        faults.disarm()
        assert list_snapshots(out)
        assert server.registry.versions() == {"default": 1}
        resumed = ctl.refit(ds(), 4, dict(_PC), output_model=out,
                            snapshot_freq=1, resume=True)
        assert rel_get("resume_runs") == 1
        assert resumed.model_to_string() == full
        _traffic(server, X)
        prepared, report = ctl.shadow(resumed)
        assert report["passed"]
        assert ctl.promote(prepared, watch=False) == 2
    finally:
        faults.reset()
        server.stop()
