"""The analysis gate: ``python -m lightgbm_tpu_torch.analysis [--json out]``.

Port of ``lightgbm_tpu/analysis/__main__.py``.  Runs the six passes (lint,
races, resources, spmd, programs, recompile) plus the always-on
allowlist-staleness check, prints a summary with each pass's wall time,
optionally writes the schema-validated JSON findings report, and exits
non-zero when any unsuppressed finding remains — a pre-merge check on the
CPU.

The ``programs`` pass runs each sharded program once (one tree on a gloo
rank pool) and shares the record among the budget, sequence,
rank-agreement, cross-factorization and quantized-payload checks;
``--programs GLOB`` narrows the set (the AST passes always run in full).
``--changed-only REF`` scopes the AST file sets and the program set to the
files ``git diff --name-only REF`` (and untracked files) name; the
recompile sentinel and the staleness check still run in full, and a
change under ``analysis/`` itself, or a git failure, runs the whole gate.

``--dump-budgets`` re-derives ``budgets.json`` and ``--dump-sequences``
``sequences.json`` from one run of the programs (run them when a reviewed
learner change moves a collective, and commit the diff).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

from . import lint, programs, races, recompile, resources, spmd
from .common import (BUDGETS_PATH, PKG_ROOT, REPO_ROOT, SEQUENCES_PATH,
                     Finding, apply_allowlist, build_report, load_allowlist,
                     rel_file, stale_allowlist_findings,
                     validate_findings_report)

ALL_PASSES = ("lint", "races", "resources", "spmd", "programs", "recompile")


def _environment() -> Dict[str, object]:
    import torch

    cuda = torch.cuda.is_available()
    return {"platform": "cuda" if cuda else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 1,
            "x64_enabled": torch.get_default_dtype() == torch.float64,
            "torch_version": str(torch.__version__)}


def _changed_files(ref: str) -> Optional[set]:
    """Repo-relative paths touched since ``ref`` (tracked diffs plus
    untracked files), or None when git cannot answer."""
    import subprocess
    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", ref, "--"], cwd=REPO_ROOT,
            capture_output=True, text=True, timeout=30.0, check=True).stdout
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=REPO_ROOT, capture_output=True, text=True, timeout=30.0,
            check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return {ln.strip() for ln in (diff + untracked).splitlines()
            if ln.strip()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.analysis",
        description="Static program-invariant analysis gate of the port")
    ap.add_argument("--json", metavar="PATH", default="",
                    help="write the schema-validated findings report here")
    ap.add_argument("--passes", default=",".join(ALL_PASSES),
                    help="comma list from {" + ",".join(ALL_PASSES) + "}")
    ap.add_argument("--programs", metavar="GLOB", default="",
                    help="fnmatch glob narrowing the program set (budgets "
                         "+ sequences), e.g. 'wave_sharded*'")
    ap.add_argument("--changed-only", metavar="REF", default="",
                    help="scope the AST passes and the program set to files "
                         "changed since REF (git diff + untracked); the "
                         "recompile sentinel and the allowlist-staleness "
                         "check still run in full.  Falls back to the full "
                         "gate when the analyzer itself changed or git "
                         "fails.")
    ap.add_argument("--dump-budgets", metavar="PATH", nargs="?",
                    const=BUDGETS_PATH, default="",
                    help="run the program set and (re)write budgets.json "
                         "instead of gating")
    ap.add_argument("--dump-sequences", metavar="PATH", nargs="?",
                    const=SEQUENCES_PATH, default="",
                    help="run the program set and (re)write sequences.json "
                         "instead of gating")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    selected = [p.strip() for p in args.passes.split(",") if p.strip()]
    unknown = [p for p in selected if p not in ALL_PASSES]
    if unknown:
        ap.error(f"unknown pass(es): {unknown}; choose from {ALL_PASSES}")

    def log(msg: str) -> None:
        if not args.quiet:
            print(f"[lightgbm_tpu_torch.analysis] {msg}", flush=True)

    if args.dump_budgets or args.dump_sequences:
        log("running the program set to derive the pinned artifacts ...")
        recs = programs.run_programs()
        if args.dump_budgets:
            programs.dump_budgets(recs, args.dump_budgets)
            log(f"wrote {args.dump_budgets}")
        if args.dump_sequences:
            programs.dump_sequences(recs, args.dump_sequences)
            log(f"wrote {args.dump_sequences}")
        for name, logs in sorted(recs.logs.items()):
            log(f"  {name}: {len(logs[0])} collective(s) in order, "
                f"{programs.stats(logs[0])['calls']}")
        return 0

    # --changed-only REF: scope the AST file sets and the program set to
    # the diff.  A change under analysis/ (the analyzer, its pins, the
    # allowlist) invalidates every scoping assumption — run in full.
    changed: Optional[set] = None
    if args.changed_only:
        changed = _changed_files(args.changed_only)
        if changed is None:
            log(f"WARNING: git diff against {args.changed_only!r} failed "
                "— running the full gate")
        elif any(p.startswith("lightgbm_tpu_torch/analysis/")
                 for p in changed):
            log("--changed-only: analysis/ itself changed — running the "
                "full gate")
            changed = None
        else:
            log(f"--changed-only {args.changed_only}: "
                f"{len(changed)} changed file(s)")

    def scoped(default_paths: Sequence[str]) -> Optional[List[str]]:
        """None = pass default (full scan); a list = the changed subset."""
        if changed is None:
            return None
        return [p for p in default_paths if rel_file(p) in changed]

    findings: List[Finding] = []
    pass_results: Dict[str, Dict[str, object]] = {}
    pass_seconds: Dict[str, float] = {}
    n = len(selected)
    step = iter(range(1, n + 1))

    def finish(name: str, t0: float, kept: Sequence[Finding],
               suppressed: Sequence[Finding],
               extra: Optional[Dict[str, object]] = None) -> None:
        secs = round(time.perf_counter() - t0, 3)
        result: Dict[str, object] = {
            "status": "findings" if kept else "ok", "findings": len(kept),
            "suppressed": len(suppressed), "seconds": secs}
        result.update(extra or {})
        pass_seconds[name] = secs
        findings.extend(kept)
        pass_results[name] = result
        log(f"  {name}: {len(kept)} finding(s) in {secs:.2f}s")

    # the staleness check always runs: a rotted vetted exception (file
    # moved, symbol renamed, no reason) silently suppresses the wrong thing
    t0 = time.perf_counter()
    finish("allowlist", t0, stale_allowlist_findings(), [])

    if "lint" in selected:
        log(f"pass {next(step)}/{n}: AST repo lint + report schema "
            "drift ...")
        t0 = time.perf_counter()
        kept, suppressed = lint.run(
            paths=scoped(list(lint.iter_package_files())))
        drift_kept, drift_sup = apply_allowlist(lint.schema_drift(),
                                                load_allowlist())
        finish("lint", t0, kept + drift_kept, suppressed + drift_sup)

    if "races" in selected:
        log(f"pass {next(step)}/{n}: lock-order race detector ...")
        t0 = time.perf_counter()
        kept, suppressed = races.run(paths=scoped(
            [os.path.join(PKG_ROOT, p) for p in races.DEFAULT_FILES]))
        finish("races", t0, kept, suppressed)

    if "resources" in selected:
        log(f"pass {next(step)}/{n}: resource lifecycle — thread "
            "join-on-stop (LGB011), close-on-all-paths (LGB012), "
            "subprocess and process reaping (LGB013) ...")
        t0 = time.perf_counter()
        kept, suppressed = resources.run(
            paths=scoped(list(resources.iter_scan_files())))
        finish("resources", t0, kept, suppressed)

    if "spmd" in selected:
        log(f"pass {next(step)}/{n}: SPMD safety — rank-divergence "
            "(LGB008), event-loop blocking (LGB010) ...")
        t0 = time.perf_counter()
        kept, suppressed = spmd.run(
            rank_paths=scoped(spmd.rank_files()),
            loop_paths=scoped([os.path.join(PKG_ROOT, p)
                               for p in spmd.LOOP_FILES]))
        finish("spmd", t0, kept, suppressed)

    if "programs" in selected:
        log(f"pass {next(step)}/{n}: sharded programs — one tree each on "
            "a gloo rank pool: budgets, pinned orders, factorizations ...")
        t0 = time.perf_counter()
        only = None
        if changed is not None:
            only = {name for name, f in programs.PROGRAM_FILES.items()
                    if f in changed}
        recs = programs.run_programs(glob=args.programs or None, only=only)
        kept = programs.run(recs)
        finish("programs", t0, kept, [], {
            "programs": {name: {
                "collectives": programs.stats(logs[0])["calls"],
                "exchange_bytes": programs.stats(logs[0])["bytes"],
                "eqns": len(logs[0]),
                "trace_seconds": round(recs.seconds[name], 3)}
                for name, logs in recs.logs.items()},
            "detail": ("skipped: " + "; ".join(
                f"{k} ({v})" for k, v in sorted(recs.skipped.items()))
                if recs.skipped else "all programs run")})

    if "recompile" in selected:
        log(f"pass {next(step)}/{n}: recompile sentinel (trains tiny "
            "boosters and warms a serving model) ...")
        t0 = time.perf_counter()
        fs, detail, skip_reason = recompile.run()
        finish("recompile", t0, fs, [], {"programs": detail})
        if skip_reason:
            pass_results["recompile"].update(status="skipped",
                                             detail=skip_reason)

    report = build_report(pass_results, findings, environment=_environment())
    errs = validate_findings_report(report)
    if errs:
        log("INTERNAL: findings report violates analysis/schema.json: "
            + "; ".join(errs[:5]))
        return 2

    if args.json:
        d = os.path.dirname(args.json)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.json + ".tmp", "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")
        os.replace(args.json + ".tmp", args.json)
        log(f"report written to {args.json}")

    for f in findings:
        print(f"FINDING: {f}", flush=True)
    statuses = ", ".join(f"{k}={v['status']}"
                         for k, v in pass_results.items())
    timings = " ".join(f"{k}={pass_seconds[k]:.2f}s" for k in pass_seconds)
    log(f"per-pass wall time: {timings}")
    log(f"{len(findings)} finding(s) [{statuses}]")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
