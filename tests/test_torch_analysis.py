"""The port's analysis gate (`lightgbm_tpu_torch/analysis/`), AST passes,
sentinel and CLI, against lightgbm_tpu's.

  * on every JAX fixture (``tests/analysis_fixtures``, ``bad_donate.py``
    aside: donation is an XLA mechanism the port does not have) the port's
    lint, races, resources, LGB008 and LGB010 passes give the same (rule,
    symbol, line) set as the JAX package's;
  * each torch fixture (``tests/torch_analysis_fixtures``) trips exactly
    its rule, and the good one trips none;
  * the port's own tree is clean, every allowlist entry resolves, gives a
    reason and suppresses a real finding;
  * LGB005's capture closure holds the learners' passes and the serving
    bucket function, and not ``parallel/``;
  * the recompile sentinel finds a capture after ``arm()`` on a stand-in
    counter and skips, with its reason, on the CPU;
  * the gate's report validates under both packages' validators.
The program pass has its own file, ``test_torch_analysis_programs.py``.
"""

import json
import os
import re
import subprocess
import sys
import threading

import pytest
import torch

from lightgbm_tpu.analysis import lint as jlint
from lightgbm_tpu.analysis import races as jraces
from lightgbm_tpu.analysis import resources as jresources
from lightgbm_tpu.analysis import spmd as jspmd
from lightgbm_tpu.analysis import \
    validate_findings_report as jax_validate_findings
from lightgbm_tpu_torch.analysis import (Finding, build_report,
                                         load_allowlist,
                                         stale_allowlist_findings,
                                         validate_findings_report)
from lightgbm_tpu_torch.analysis import (lint, races, recompile, resources,
                                         spmd)
from lightgbm_tpu_torch.analysis.common import PKG_ROOT, REPO_ROOT

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

_HERE = os.path.dirname(os.path.abspath(__file__))
JAX_FIXTURES = os.path.join(_HERE, "analysis_fixtures")
TORCH_FIXTURES = os.path.join(_HERE, "torch_analysis_fixtures")
FIXTURE_FILES = sorted(f for f in os.listdir(JAX_FIXTURES)
                       if f.endswith(".py") and f != "bad_donate.py")


def _key(findings):
    return sorted((f.rule, f.symbol, f.line) for f in findings)


# each pass as (JAX call, port call) on one path, no allowlist
PASSES = {
    "lint": (lambda p: jlint.run(paths=[p], allowlist=[])[0],
             lambda p: lint.run(paths=[p], allowlist=[])[0]),
    "lint_traced": (lambda p: jlint.run(paths=[p], allowlist=[],
                                        traced=True)[0],
                    lambda p: lint.run(paths=[p], allowlist=[],
                                       traced=True)[0]),
    "races": (lambda p: jraces.run(paths=[p], allowlist=[])[0],
              lambda p: races.run(paths=[p], allowlist=[])[0]),
    "resources": (lambda p: jresources.run(paths=[p], allowlist=[])[0],
                  lambda p: resources.run(paths=[p], allowlist=[])[0]),
    "lgb008": (lambda p: jspmd.rank_divergence([p]),
               lambda p: spmd.rank_divergence([p])),
    "lgb010": (lambda p: jspmd.event_loop_blocking([p]),
               lambda p: spmd.event_loop_blocking([p])),
}


@pytest.mark.parametrize("pass_name", sorted(PASSES))
@pytest.mark.parametrize("fixture", FIXTURE_FILES)
def test_jax_fixture_findings_identical(fixture, pass_name):
    path = os.path.join(JAX_FIXTURES, fixture)
    theirs, mine = (fn(path) for fn in PASSES[pass_name])
    assert _key(mine) == _key(theirs)


def test_jax_fixtures_are_exercised():
    """The parity above is not vacuous: every bad fixture trips a pass."""
    hit = set()
    for fixture in FIXTURE_FILES:
        path = os.path.join(JAX_FIXTURES, fixture)
        if any(PASSES[p][1](path) for p in PASSES if p != "lint_traced"):
            hit.add(fixture)
    assert {f for f in FIXTURE_FILES if f.startswith("bad_")} <= hit


def _all_findings(path):
    return (lint.run(paths=[path], allowlist=[])[0]
            + races.run(paths=[path], allowlist=[])[0]
            + resources.run(paths=[path], allowlist=[])[0]
            + spmd.rank_divergence([path]) + spmd.event_loop_blocking([path]))


@pytest.mark.parametrize("fixture,rule,symbol", [
    ("bad_get_rank.py", "LGB008-rank-divergence", "reduce_on_root"),
    ("bad_all_reduce.py", "LGB008-rank-divergence", "Exchange.counts"),
    ("bad_selector_item.py", "LGB010-event-loop-blocking", "_finish"),
    ("bad_process.py", "LGB013-subprocess-reap", "spawn_and_forget"),
    ("bad_capture_clock.py", "LGB005-wallclock-in-traced", "Learner._step"),
])
def test_torch_fixture_trips_exactly_its_rule(fixture, rule, symbol):
    got = _all_findings(os.path.join(TORCH_FIXTURES, fixture))
    assert [(f.rule, f.symbol) for f in got] == [(rule, symbol)], \
        [str(f) for f in got]
    assert got[0].line > 0


def test_torch_good_fixture_is_clean():
    got = _all_findings(os.path.join(TORCH_FIXTURES, "good_torch.py"))
    assert got == [], [str(f) for f in got]


def test_selector_item_is_the_tensor_read():
    (f,) = spmd.event_loop_blocking(
        [os.path.join(TORCH_FIXTURES, "bad_selector_item.py")])
    assert "score.item()" in f.message and "_loop -> _finish" in f.message


# -- the port's own tree -------------------------------------------------------

def test_repo_ast_passes_clean():
    for name, kept in (("lint", lint.run()[0]), ("races", races.run()[0]),
                       ("resources", resources.run()[0]),
                       ("spmd", spmd.run()[0]),
                       ("schema", lint.schema_drift())):
        assert kept == [], (name, [str(f) for f in kept])


def test_allowlist_entries_resolve_reason_and_suppress():
    """Every vetted exception points at a real file and symbol, says why,
    and suppresses a finding the passes really make (no dead entry)."""
    entries = load_allowlist()
    assert entries and all(e.get("reason", "").strip() for e in entries)
    assert stale_allowlist_findings() == []
    assert not any(e["file"].startswith("lightgbm_tpu/") for e in entries)
    raw = (lint.run(allowlist=[])[0] + races.run(allowlist=[])[0]
           + resources.run(allowlist=[])[0] + spmd.run(allowlist=[])[0])
    from lightgbm_tpu_torch.analysis import is_allowed
    for e in entries:
        assert any(is_allowed(f, [e]) for f in raw), e


def test_stale_allowlist_detects_rot():
    good = {"rule": "LGB004-bare-except",
            "file": "lightgbm_tpu_torch/analysis/lint.py", "symbol": "run",
            "reason": "x"}
    gone_file = {"rule": "r", "file": "lightgbm_tpu_torch/no_such.py",
                 "reason": "x"}
    gone_sym = {"rule": "r", "file": "lightgbm_tpu_torch/analysis/lint.py",
                "symbol": "renamed_away_fn", "reason": "x"}
    no_file = {"rule": "r", "reason": "x"}
    no_reason = dict(good, reason=" ")
    fs = stale_allowlist_findings([good, gone_file, gone_sym, no_file,
                                   no_reason])
    assert len(fs) == 4 and {f.rule for f in fs} == {"stale-allowlist"}
    msgs = " | ".join(f.message for f in fs)
    for part in ("no_such.py", "renamed_away_fn", "names no file",
                 "gives no reason"):
        assert part in msgs


def test_capture_closure_is_the_captured_passes():
    """LGB005's set is derived from the capture sites: the compact and
    wave learners' passes and the serving bucket function are in it;
    ``parallel/``'s eager collectives, timed on purpose, are not — a copy
    of the JAX package's ``TRACED_DIRS`` would flag them."""
    cap = lint.captured_functions(list(lint.iter_package_files()))
    rel = {(os.path.relpath(p, PKG_ROOT), q) for p, q in cap}
    for want in (("learner_compact.py", "CompactTreeLearner._split_step"),
                 ("learner_compact.py", "CompactTreeLearner._forced_step"),
                 ("learner_wave.py", "WaveTreeLearner._wave_pass"),
                 ("learner_wave.py", "WaveTreeLearner._materialize"),
                 ("learner_wave.py", "WaveTreeLearner._replay_pass"),
                 ("learner_wave.py", "WaveTreeLearner._correct_pass"),
                 ("serving/registry.py", "ServingModel._run")):
        assert want in rel, want
    assert not any(p.startswith(os.path.join("parallel", "sharding"))
                   or p.startswith(os.path.join("parallel", "launch"))
                   or p.startswith(os.path.join("parallel", "multihost"))
                   for p, _ in rel)
    assert ("learner_compact.py", "CompactTreeLearner.train_async") \
        not in rel
    sharding = os.path.join(PKG_ROOT, "parallel", "sharding.py")
    forced = lint.lint_file(sharding, traced=True)
    assert len([f for f in forced
                if f.rule == "LGB005-wallclock-in-traced"]) == 4
    assert lint.lint_file(sharding, captured=cap) == []


def test_races_cover_every_lock_holder_and_see_native_edges():
    """``DEFAULT_FILES`` holds every module of the port that makes a
    threading lock, and the graph resolves module-qualified calls into
    ``native.py`` (the model lock held while replays credit the launch
    counters)."""
    pat = re.compile(r"threading\.(R?Lock|Condition)\(")
    holders = {os.path.relpath(p, PKG_ROOT)
               for p in lint.iter_package_files()
               if pat.search(open(p).read())}
    assert len(holders) >= 16
    assert holders <= set(races.DEFAULT_FILES)
    graph = races.analyze().graph()
    assert "registry.ModelRegistry._lock" in \
        graph["server.PredictionServer._batcher_lock"]
    assert "native._COUNT_LOCK" in graph["registry.ServingModel._lock"]
    # nothing is taken while the capture lock is held, so no cycle runs
    # through it
    assert not graph.get("native._CAPTURE_LOCK")


def test_runtime_lock_monitor_detects_inversion():
    mon = races.LockOrderMonitor()
    a, b = mon.make_lock("a"), mon.make_lock("b", threading.RLock)

    def order(x, y):
        with x:
            with y:
                pass

    for args in ((a, b), (b, a)):
        t = threading.Thread(target=order, args=args)
        t.start()
        t.join()
    assert len(mon.violations) == 1
    assert {mon.violations[0]["held"], mon.violations[0]["acquiring"]} \
        == {"a", "b"}
    assert mon.findings()[0].rule == "runtime-lock-order"


# -- the recompile sentinel ----------------------------------------------------

def test_sentinel_finds_a_capture_after_arm():
    """A stand-in capture counter: clean while it stands still, one
    ``recapture`` finding once it moves after ``arm()``; a counter that
    cannot move (None) is unsupported and never a finding."""
    box = {"n": 3}
    s = recompile.RecompileSentinel()
    s.register("step", lambda: box["n"], "x.py")
    s.register("cpu_model", lambda: None, "y.py")
    assert s.supported()
    assert s.arm() == {"step": 3, "cpu_model": None}
    assert s.check() == []
    box["n"] += 1
    (f,) = s.check()
    assert f.rule == "recapture" and f.symbol == "step" and f.file == "x.py"
    assert "3 -> 4" in f.message
    assert s.deltas() == {"step": (3, 4), "cpu_model": (None, None)}
    s2 = recompile.RecompileSentinel()
    s2.register("gone", lambda: 1 / 0)
    assert not s2.supported() and s2.check() == []


def test_recompile_pass_skips_on_the_cpu():
    """Nothing is captured on the CPU: the pass says so instead of a green
    result that checked nothing."""
    findings, detail, skip = recompile.run("cpu")
    assert findings == [] and detail == {}
    assert skip and "CPU" in skip


# -- report + CLI gate ---------------------------------------------------------

def test_findings_report_validates_under_both_packages():
    f = Finding("lint", "LGB001-socket-timeout", "x.py", "msg", line=3)
    rep = build_report({"lint": {"status": "findings", "findings": 1}}, [f],
                       environment={"platform": "cpu", "device_count": 1,
                                    "x64_enabled": False,
                                    "torch_version": torch.__version__})
    assert validate_findings_report(rep) == []
    assert jax_validate_findings(rep) == []
    del rep["summary"]
    assert validate_findings_report(rep) != []


def test_schema_is_the_jax_schema():
    with open(os.path.join(PKG_ROOT, "analysis", "schema.json"), "rb") as a, \
            open(os.path.join(REPO_ROOT, "lightgbm_tpu", "analysis",
                              "schema.json"), "rb") as b:
        assert a.read() == b.read()


def test_gate_cli_ast_passes_and_sentinel(tmp_path):
    """``python -m lightgbm_tpu_torch.analysis`` in a fresh process, the
    program pass aside (``test_torch_analysis_programs.py`` runs it): exit
    0, each pass's wall time printed, a report valid under both packages'
    validators with ``recompile`` skipped and its reason."""
    out = tmp_path / "r.json"
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch.analysis", "--json",
         str(out), "--passes", "lint,races,resources,spmd,recompile"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "per-pass wall time:" in proc.stdout
    rep = json.loads(out.read_text())
    assert validate_findings_report(rep) == []
    assert jax_validate_findings(rep) == []
    assert rep["summary"]["total"] == 0
    assert set(rep["passes"]) == {"allowlist", "lint", "races", "resources",
                                  "spmd", "recompile"}
    assert rep["passes"]["recompile"]["status"] == "skipped"
    assert "CPU" in rep["passes"]["recompile"]["detail"]
    assert all(p["seconds"] >= 0 for p in rep["passes"].values())
    assert rep["environment"]["platform"] == "cpu"
    assert rep["environment"]["x64_enabled"] is False
    assert rep["passes"]["lint"]["suppressed"] >= 1


def test_gate_exit_codes(monkeypatch):
    from lightgbm_tpu_torch.analysis import __main__ as gate

    assert gate.main(["--passes", "races,spmd", "--quiet"]) == 0
    monkeypatch.setattr(
        gate.races, "run",
        lambda paths=None: (
            [Finding("races", "lock-order-cycle", "x.py", "boom")], []))
    assert gate.main(["--passes", "races", "--quiet"]) == 1


def test_gate_changed_only_scopes_and_falls_back():
    from lightgbm_tpu_torch.analysis import __main__ as gate

    assert gate.main(["--passes", "races,resources,spmd",
                      "--changed-only", "HEAD", "--quiet"]) == 0
    assert gate.main(["--passes", "races,resources,spmd",
                      "--changed-only", "no-such-ref-xyzzy",
                      "--quiet"]) == 0
    assert gate._changed_files("no-such-ref-xyzzy") is None
