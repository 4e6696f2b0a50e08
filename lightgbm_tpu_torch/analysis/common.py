"""Shared findings plumbing for the port's static-analysis passes.

Port of ``lightgbm_tpu/analysis/common.py``.  Every pass (``lint`` /
``races`` / ``resources`` / ``spmd`` / ``programs`` / ``recompile``)
reports violations as ``Finding`` rows; the gate (``python -m
lightgbm_tpu_torch.analysis``) assembles them into one JSON report
validated against ``schema.json`` (byte for byte the JAX package's, schema
version 3) by the telemetry report's dependency-free validator
(``observability/report.py``).

Vetted exceptions live in the port's own ``allowlist.json``: one entry per
suppressed finding, matched on (rule, file suffix, optional symbol), each
carrying a human-readable reason.  A finding the allowlist matches is
counted as ``suppressed`` in the report, never silently dropped.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

SCHEMA_VERSION = 3

_HERE = os.path.dirname(os.path.abspath(__file__))
SCHEMA_PATH = os.path.join(_HERE, "schema.json")
ALLOWLIST_PATH = os.path.join(_HERE, "allowlist.json")
BUDGETS_PATH = os.path.join(_HERE, "budgets.json")
SEQUENCES_PATH = os.path.join(_HERE, "sequences.json")

#: the package under analysis (lightgbm_tpu_torch/) and the repo root above
PKG_ROOT = os.path.dirname(_HERE)
REPO_ROOT = os.path.dirname(PKG_ROOT)


@dataclass
class Finding:
    """One violation.  ``file`` is repo-relative with forward slashes;
    ``symbol`` is the qualified function/class (or program name for the
    program passes) the finding anchors to."""

    pass_name: str
    rule: str               # e.g. "LGB001-socket-timeout", "lock-order-cycle"
    file: str
    message: str
    line: int = 0
    symbol: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return {"pass": self.pass_name, "rule": self.rule, "file": self.file,
                "line": int(self.line), "symbol": self.symbol,
                "message": self.message}

    def __str__(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else self.file
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.rule} {loc}{sym}: {self.message}"


def rel_file(path: str) -> str:
    """Repo-relative, forward-slash path for findings/allowlist matching."""
    p = os.path.abspath(path)
    try:
        p = os.path.relpath(p, REPO_ROOT)
    except ValueError:
        pass
    return p.replace(os.sep, "/")


def _load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def load_schema() -> Dict[str, Any]:
    return _load_json(SCHEMA_PATH)


def load_allowlist(path: Optional[str] = None) -> List[Dict[str, Any]]:
    p = ALLOWLIST_PATH if path is None else path
    if not os.path.exists(p):
        return []
    return list(_load_json(p).get("allow", []))


def load_budgets(path: Optional[str] = None) -> Dict[str, Any]:
    """The checked-in per-program collective budgets (``budgets.json``,
    re-derivable via ``--dump-budgets``)."""
    p = BUDGETS_PATH if path is None else path
    if not os.path.exists(p):
        return {"programs": {}}
    return _load_json(p)


def load_sequences(path: Optional[str] = None) -> Dict[str, Any]:
    """The checked-in per-program collective-order sequences
    (``sequences.json``, re-derivable via ``--dump-sequences``)."""
    p = SEQUENCES_PATH if path is None else path
    if not os.path.exists(p):
        return {"programs": {}}
    return _load_json(p)


def dump_json(payload: Dict[str, Any], path: str) -> None:
    """Write a pinned artifact byte-stably (indent 2, trailing newline)
    through a temp file and ``os.replace``."""
    with open(path + ".tmp", "w") as fh:
        json.dump(payload, fh, indent=2)
        fh.write("\n")
    os.replace(path + ".tmp", path)


def iter_py(root: str) -> List[str]:
    """Every ``.py`` file under ``root``, sorted, ``__pycache__`` skipped."""
    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        out.extend(os.path.join(dirpath, f) for f in sorted(filenames)
                   if f.endswith(".py"))
    return out


def _file_qualnames(path: str) -> set:
    """Every dotted function/class qualname defined in ``path`` (for
    stale-allowlist symbol resolution)."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    quals: set = set()

    def visit(node, stack):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                quals.add(".".join(stack + [child.name]))
                visit(child, stack + [child.name])
            else:
                visit(child, stack)

    visit(tree, [])
    return quals


def _resolve_allow_file(suffix: str) -> Optional[str]:
    """The on-disk file an allowlist ``file`` suffix points at (findings
    match on suffix, so the entry may be shorter than repo-relative)."""
    direct = os.path.join(REPO_ROOT, suffix)
    if os.path.isfile(direct):
        return direct
    for p in iter_py(PKG_ROOT):
        if rel_file(p).endswith(suffix):
            return p
    return None


def stale_allowlist_findings(allowlist: Optional[Sequence[Dict[str, Any]]]
                             = None) -> List[Finding]:
    """Every allowlist entry must still resolve: the file must exist and
    the named symbol must still be defined in it, and the entry must give
    its reason — otherwise the vetted exception has rotted (the file moved,
    the function was renamed) and is silently suppressing nothing, or
    worse, the wrong thing."""
    if allowlist is None:
        allowlist = load_allowlist()
    findings: List[Finding] = []
    for i, entry in enumerate(allowlist):
        where = f"allowlist entry #{i} (rule {entry.get('rule')!r})"
        sym = entry.get("symbol")
        if not str(entry.get("reason") or "").strip():
            findings.append(Finding(
                "allowlist", "stale-allowlist", "analysis/allowlist.json",
                f"{where} gives no reason — every vetted exception must "
                f"say why it is acceptable", symbol=sym))
        suffix = entry.get("file", "")
        if not suffix:
            findings.append(Finding(
                "allowlist", "stale-allowlist", "analysis/allowlist.json",
                f"{where} names no file — every vetted exception must "
                f"pin the file it excuses", symbol=sym))
            continue
        path = _resolve_allow_file(suffix)
        if path is None:
            findings.append(Finding(
                "allowlist", "stale-allowlist", "analysis/allowlist.json",
                f"{where} points at {suffix!r}, which no longer exists — "
                f"delete the entry or fix the path", symbol=sym))
            continue
        if sym is None:
            continue
        quals = _file_qualnames(path)
        if sym in quals or any(q.endswith("." + sym) for q in quals):
            continue
        findings.append(Finding(
            "allowlist", "stale-allowlist", "analysis/allowlist.json",
            f"{where} names symbol {sym!r}, not defined in {suffix!r} "
            f"anymore — delete the entry or fix the symbol", symbol=sym))
    return findings


def is_allowed(finding: Finding, allowlist: Sequence[Dict[str, Any]]) -> bool:
    """True when an allowlist entry vouches for this finding.  An entry
    matches on exact rule, file suffix, and — when it names one — exact
    symbol; the ``reason`` field is documentation, not matching input."""
    for entry in allowlist:
        if entry.get("rule") != finding.rule:
            continue
        f = entry.get("file", "")
        if not f or not finding.file.endswith(f):
            continue
        sym = entry.get("symbol")
        if sym is not None and sym != finding.symbol:
            continue
        return True
    return False


def apply_allowlist(findings: Sequence[Finding],
                    allowlist: Sequence[Dict[str, Any]]
                    ) -> Tuple[List[Finding], List[Finding]]:
    """Split into (kept, suppressed)."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        (suppressed if is_allowed(f, allowlist) else kept).append(f)
    return kept, suppressed


def build_report(pass_results: Dict[str, Dict[str, Any]],
                 findings: Sequence[Finding],
                 environment: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """Assemble the gate's JSON report.  ``pass_results`` maps pass name to
    ``{"status": ..., "findings": n, ...extras}``."""
    by_pass: Dict[str, int] = {}
    for f in findings:
        by_pass[f.pass_name] = by_pass.get(f.pass_name, 0) + 1
    env = dict(environment or {})
    env.setdefault("platform", "unknown")
    env.setdefault("device_count", 0)
    env.setdefault("x64_enabled", False)
    return {
        "schema_version": SCHEMA_VERSION,
        "environment": env,
        "passes": {name: dict(res) for name, res in pass_results.items()},
        "findings": [f.to_dict() for f in findings],
        "summary": {"total": len(findings), "by_pass": by_pass},
    }


def validate_findings_report(report: Any) -> List[str]:
    """Violation strings (empty = valid), via the same JSON-Schema-subset
    validator the telemetry report uses."""
    from ..observability.report import validate_report
    return validate_report(report, load_schema())
