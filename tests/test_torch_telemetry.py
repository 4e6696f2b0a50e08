"""Training telemetry, tracing and attribution: the port against lightgbm_tpu.

The same numpy-seeded problem trains through both packages with
``telemetry=true``: the reports validate against ``schema.json``, count the
same iterations and time the same phases (the synchronous loop's exactly;
in the pipelined loop the JAX package fuses gradients, tree and score
update into one dispatch, timed as ``tree_dispatch``, where the port times
``gradients`` and ``score_update`` apart), and the wave learner's device
counters (splits grown, corrections, pops, waves) equal the JAX learner's.
A disabled report is inert, and telemetry, sampling and tracing leave the
model text byte for byte as it was.  Ports of ``tests/test_telemetry.py:
47-130, 301-414`` and ``tests/test_tracing.py:249``.
"""

import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.cli import _load_params as jax_load_params
from lightgbm_tpu.observability import validate_report as jax_validate
from lightgbm_tpu_torch.cli import _load_params
from lightgbm_tpu_torch.observability import (TEL_NAMES, TraceRecorder,
                                              load_schema,
                                              training_prometheus,
                                              validate_report)

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

_BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         "verbosity": -1}
CPU = {"device_type": "cpu"}


def _problem(n=2048, f=4, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.2 * rng.randn(n) > 0).astype(float)
    return X, y


def _booster(lib, params, X, y, iters, valid=False):
    p = dict(params, **CPU) if lib is lt else dict(params)
    ds = lib.Dataset(X, label=y, params=p)
    bst = lib.Booster(p, ds)
    if valid:
        bst.add_valid(lib.Dataset(X[:300], label=y[:300], reference=ds), "v")
    for _ in range(iters):
        bst.update()
    return bst


@pytest.mark.parametrize("loop", ["sync", "pipelined"])
def test_report_equals_jax(loop):
    """Phases, iterations, schema and the wave learner's split counters."""
    X, y = _problem()
    params = dict(_BASE, telemetry=True)
    reps = {lib: _booster(lib, params, X, y, 3, valid=loop == "sync")
            .get_telemetry() for lib in (lj, lt)}
    rj, rt = reps[lj], reps[lt]
    assert validate_report(rt, load_schema()) == []
    assert jax_validate(rt) == []
    assert rt["enabled"] is True
    assert rt["iterations"]["count"] == rj["iterations"]["count"] == 3
    assert rt["iterations"]["mean_ms"] > 0.0
    if loop == "sync":
        assert set(rt["phases"]) == set(rj["phases"])
    else:
        assert set(rt["phases"]) - set(rj["phases"]) == {"gradients",
                                                         "score_update"}
    for name in ("binning", "iteration"):
        assert rt["phases"][name]["count"] >= 1
    ct, cj = rt["counters"], rj["counters"]
    for key in ("trees_measured", "total_splits", "grow_splits", "pops",
                "waves", "stall_splits", "stall_extras", "stall_events"):
        assert ct[key] == cj[key], key
    assert ct["total_splits"] == ct["grow_splits"] + ct["stall_splits"]
    # no counterpart in the port's flow: absent, not 0
    assert set(TEL_NAMES) - set(ct) == {"wave_sorts", "wave_members",
                                        "frozen_members", "stall_sort_mode"}
    assert rt["provenance"]["learner"] == "WaveTreeLearner"
    assert rt["provenance"]["platform"] == "cpu"
    assert rt["provenance"]["emulated"] is True


def test_compact_learner_reports_its_splits():
    X, y = _problem()
    params = dict(_BASE, telemetry=True, tpu_learner="compact")
    bst = _booster(lt, params, X, y, 3)
    c = bst.get_telemetry()["counters"]
    splits = sum(t.num_leaves - 1 for t in bst.gbdt.models)
    assert c["trees_measured"] == 3
    assert c["total_splits"] == c["grow_splits"] == c["pops"] == splits
    assert "waves" not in c


def test_disabled_report_is_inert():
    X, y = _problem()
    bst = _booster(lt, dict(_BASE), X, y, 1)
    rep = bst.get_telemetry()
    assert validate_report(rep) == []
    assert rep["enabled"] is False
    assert rep["iterations"]["count"] == 0
    assert rep["counters"] == {"trees_measured": 0}
    assert rep["phases"] == {}


@pytest.mark.parametrize("learner", ["wave", "compact"])
def test_telemetry_off_model_bit_identical(learner):
    """Telemetry and sampled syncs are no-ops on the trees: the same model
    text, byte for byte, with bagging and feature sampling."""
    X, y = _problem()
    texts = {}
    for tel in (False, True):
        params = dict(_BASE, telemetry=tel, bagging_fraction=0.8,
                      bagging_freq=1, feature_fraction=0.9, seed=3,
                      tpu_learner=learner)
        if tel:
            params["telemetry_sync_every"] = 2
        texts[tel] = _booster(lt, params, X, y, 5).model_to_string()
    assert texts[False] == texts[True]


def test_sampled_sync_attribution_coverage():
    """telemetry_sync_every=1: the per-leg table accounts for the synced
    iteration wall within |1 - coverage| <= 0.1."""
    X, y = _problem(n=4096)
    params = dict(_BASE, telemetry=True, telemetry_sync_every=1)
    rep = _booster(lt, params, X, y, 6).get_telemetry()
    assert validate_report(rep) == []
    dist = rep["distributed"]
    assert dist["sync_every"] == 1
    table = dist["attribution"]
    assert table["sampled_iterations"] == 6
    assert {"gradients", "tree_build", "score_update"} <= set(
        table["legs_ms"])
    assert abs(1.0 - table["coverage"]) <= 0.1, table
    assert table["legs_sum_ms"] == pytest.approx(
        sum(table["legs_ms"].values()))
    assert "devices" in dist["memory"]


def test_no_sync_phases_without_sampling():
    X, y = _problem()
    rep = _booster(lt, dict(_BASE, telemetry=True), X, y, 3).get_telemetry()
    assert not [p for p in rep["phases"] if p.startswith("sync.")]
    assert "attribution" not in rep["distributed"]


@pytest.mark.parametrize("argv", [
    ["task=train", "--telemetry-out=rep.json"],
    ["--telemetry-out", "rep.json", "data=train.txt"],
    ["--telemetry"], ["--resume", "--trace-out", "t.json"],
    ["--profile-trace-dir=prof", "snapshot_freq=2"]])
def test_cli_flag_tokens_resolve_as_jax(argv):
    assert _load_params(argv) == jax_load_params(argv)


def test_training_prometheus_renders():
    X, y = _problem(n=4096)
    params = dict(_BASE, telemetry=True, telemetry_sync_every=2)
    text = training_prometheus(_booster(lt, params, X, y, 4)
                               .get_telemetry())
    assert "lgbt_training_iterations_total 4" in text
    assert "lgbt_training_phase_iteration_total_seconds" in text
    assert "lgbt_training_iteration_mean_ms" in text
    assert "lgbt_training_total_splits_total" in text
    assert "lgbt_training_leg_ms:" in text
    assert "lgbt_training_attribution_coverage" in text
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            float(ln.rsplit(" ", 1)[1])


def test_train_writes_report_prometheus_and_callback(tmp_path):
    """``telemetry_out`` and ``telemetry_prom_out`` from ``train``, and the
    light report each iteration through ``record_telemetry``."""
    X, y = _problem()
    out, prom = tmp_path / "report.json", tmp_path / "report.prom"
    params = dict(_BASE, telemetry=True, telemetry_out=str(out),
                  telemetry_prom_out=str(prom), **CPU)
    seen = {}
    lt.train(params, lt.Dataset(X, label=y), 3, verbose_eval=False,
             callbacks=[lt.record_telemetry(seen)])
    rep = json.loads(out.read_text())
    assert validate_report(rep) == [] and jax_validate(rep) == []
    assert rep["iterations"]["count"] == 3
    assert "lgbt_training_iterations_total 3" in prom.read_text()
    assert seen["enabled"] is True and seen["iterations"]["count"] >= 2
    assert validate_report(seen) == []


def test_training_trace_off_is_noop_and_model_identical(tmp_path):
    """A recorder on a telemetry-off booster records nothing; ``trace_out``
    (which turns telemetry on) gives the same model text and a trace with
    the phase spans."""
    X, y = _problem(n=1500, f=5, seed=7)
    p = dict(_BASE, seed=7, min_data_in_leaf=10, **CPU)
    plain = lt.train(dict(p), lt.Dataset(X.copy(), label=y.copy()), 6,
                     verbose_eval=False)
    bst2 = lt.Booster(dict(p), lt.Dataset(X.copy(), label=y.copy()))
    rec = TraceRecorder(True)
    bst2.gbdt.telemetry.tracer = rec
    for _ in range(3):
        bst2.update()
    bst2.gbdt._flush_pending()
    assert len(rec) == 0
    path = tmp_path / "train_trace.json"
    traced = lt.train(dict(p, trace_out=str(path)),
                      lt.Dataset(X.copy(), label=y.copy()), 6,
                      verbose_eval=False)
    assert traced.model_to_string() == plain.model_to_string()
    trace = json.loads(path.read_text())
    names = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "B"}
    assert {"iteration", "gradients", "tree_dispatch",
            "tree_assemble"} <= names


def test_profile_trace_dir_parses_or_raises(tmp_path, monkeypatch):
    """``profile_trace_dir``: the loop runs under torch.profiler, its Chrome
    trace lands in the directory and the report's ``distributed.profile``
    holds its legs (a CPU run: every event ``other``); a run whose
    profiler writes no trace raises."""
    X, y = _problem(n=1000)
    params = dict(_BASE, telemetry=True, profile_trace_dir=str(tmp_path),
                  **CPU)
    bst = lt.train(params, lt.Dataset(X, label=y), 2, verbose_eval=False)
    prof = bst.get_telemetry()["distributed"]["profile"]
    assert prof["events"] > 0 and not prof["device_events"]
    assert set(prof["legs_ms"]) == {"hist", "scan", "partition", "replay",
                                    "flush", "other"}
    assert prof["total_ms"] == pytest.approx(sum(prof["legs_ms"].values()))
    monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace",
                        lambda self, path: None)
    with pytest.raises(RuntimeError, match="wrote no trace"):
        lt.train(dict(params, profile_trace_dir=str(tmp_path / "none")),
                 lt.Dataset(X, label=y), 1, verbose_eval=False)


def test_profile_legs_name_the_ports_kernels():
    """The parse's leg of each kernel name the port launches on the card
    (``native.KERNEL_SYMBOLS`` and the windowed partition's kernels)."""
    from lightgbm_tpu_torch.native import KERNEL_SYMBOLS
    from lightgbm_tpu_torch.observability.attribution import leg_of

    want = {"hist_packed": "hist", "hist_segments": "hist",
            "hist_multislot": "hist", "hist_full": "hist",
            "partition": "partition", "split_scan": "scan",
            "fused_scan": "scan", "split_cat": "scan", "replay": "replay",
            "bin_predict": "other"}
    for src, sym in KERNEL_SYMBOLS.items():
        assert leg_of(f"void (anonymous namespace)::{sym}<8>(int*)") \
            == want[src], src
    for k in ("count", "scatter", "copy"):
        assert leg_of(f"partition_window_{k}(int const*)") == "partition"
    assert leg_of("Memcpy DtoH (Device -> Pinned)") == "flush"
    assert leg_of("void at::native::elementwise_kernel<128>") == "other"
