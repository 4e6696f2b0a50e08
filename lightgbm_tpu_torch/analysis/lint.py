"""AST repo lint: the port's repo-specific invariants, checked statically.

Port of ``lightgbm_tpu/analysis/lint.py``, rules LGB001-LGB006:

  * **LGB001-socket-timeout** — every socket the package creates
    (``socket.socket`` / ``socket.create_connection`` / ``accept()``) must
    carry a deadline: a ``timeout=`` argument, a ``settimeout`` on the
    result in the same function, or a ``setblocking`` (a non-blocking
    socket on the fleet gateway's selector loop never parks a thread).
  * **LGB002-atomic-write** — a function that opens a file for writing
    must go through a temp file (``tempfile.mkstemp`` in scope) or publish
    with ``os.replace``; a plain ``open(path, "w")`` leaves a truncated
    file behind on preemption.
  * **LGB003-global-np-random** — no ``np.random.<fn>()`` through the
    global generator; only seeded ``RandomState`` / ``default_rng``.
  * **LGB004-bare-except** — no bare ``except:``, and no ``except
    BaseException`` handler that fails to re-raise.
  * **LGB005-wallclock-in-traced** — no wall clock (``time.time`` /
    ``monotonic`` / ``perf_counter`` / ``process_time``) in code that runs
    inside ``native.capture``: a pass recorded into a CUDA graph runs its
    Python once, at capture, and every replay repeats only the device
    work, so a clock read there is a capture-time constant.  The JAX
    package names the traced modules by directory (``TRACED_DIRS``); the
    port derives the set from the capture sites themselves
    (``captured_functions``): the callable handed to ``native.capture``,
    followed back through the parameters that carry it (the learners'
    ``_capture`` <- ``_queue`` <- the passes queued in ``train_async`` /
    ``_grow_tree``; the serving model's bucket function ``_run``) and
    forward through the ``self.<method>()`` and same-module calls those
    make, plus every module under ``ops/`` (the kernel wrappers a captured
    pass launches).  ``parallel/`` is eager in the port and times its
    collectives on purpose; it is not in the set.
  * **LGB006-schema-drift** — every key the port's telemetry and serving
    reports emit must have a property in its ``observability/schema.json``
    and the reports must validate (``schema_drift()``).

The rules are heuristic AST checks scoped to one function at a time
(LGB006 builds live reports instead); the port's ``allowlist.json``
records every vetted exception with a reason.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .common import (Finding, PKG_ROOT, apply_allowlist, iter_py,
                     load_allowlist, rel_file)

#: directories whose every function may run inside a capture: the kernel
#: wrappers (a captured pass calls them)
CAPTURED_DIRS = ("ops",)

# the np.random attributes that ARE the seeded-generator surface
_SAFE_NP_RANDOM = {"RandomState", "default_rng", "Generator", "SeedSequence",
                   "PCG64", "Philox", "MT19937", "BitGenerator"}

_WALLCLOCK_FNS = {"time", "monotonic", "perf_counter", "process_time"}

_WRITE_MODES = ("w", "a", "x")

#: call names that record a CUDA graph of the callable in argument 1
_CAPTURE_CALLS = ("native.capture", "capture")


_PARSED: Dict[Tuple[str, float], ast.Module] = {}
#: the last ``captured_functions`` result, by its files' versions
_CAPTURED: Dict[tuple, Set[Tuple[str, str]]] = {}


def parse(path: str) -> ast.Module:
    """The module's AST, parsed once per file version and shared by every
    pass of a gate run (the trees are only read)."""
    key = (os.path.abspath(path), os.path.getmtime(path))
    tree = _PARSED.get(key)
    if tree is None:
        with open(path) as fh:
            tree = _PARSED[key] = ast.parse(fh.read(), filename=path)
    return tree


def iter_package_files(root: Optional[str] = None) -> Iterable[str]:
    """Every module of the port but the analyzer itself."""
    root = PKG_ROOT if root is None else root
    skip = os.path.join(root, "analysis") + os.sep
    return [p for p in iter_py(root) if not p.startswith(skip)]


def is_captured_module(path: str) -> bool:
    rel = os.path.relpath(os.path.abspath(path), PKG_ROOT)
    return rel.split(os.sep)[0] in CAPTURED_DIRS


# -- the capture closure (LGB005's set) ---------------------------------------

class _Def:
    """One function: its file, qualname, class (None at module level), the
    calls in its body (nested defs' included) and its ``q = self.m``
    aliases."""

    def __init__(self, path: str, qual: str, cls: Optional[str],
                 node: ast.AST):
        self.path, self.qual, self.cls, self.node = path, qual, cls, node
        self.calls: List[ast.Call] = []
        self.aliases: Dict[str, str] = {}
        self.nested: List["_Def"] = []


class _Index:
    """Classes (by name: bases, methods) and functions of a file set, from
    one walk of each file."""

    def __init__(self, paths: Sequence[str]):
        self.defs: List[_Def] = []
        self.bases: Dict[str, Set[str]] = {}
        self.methods: Dict[Tuple[str, str], List[_Def]] = {}
        self.mod_funcs: Dict[Tuple[str, str], _Def] = {}
        self._families: Dict[str, Set[str]] = {}
        for path in paths:
            self._visit(path, parse(path), [], None, [])

    def _visit(self, path, node, stack, cls, open_defs) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                d = _Def(path, ".".join(stack + [child.name]), cls, child)
                self.defs.append(d)
                if open_defs:
                    open_defs[-1].nested.append(d)
                if cls is not None and len(stack) == 1:
                    self.methods.setdefault((cls, child.name), []).append(d)
                elif cls is None and not stack:
                    self.mod_funcs[(path, child.name)] = d
                self._visit(path, child, stack + [child.name], cls,
                            open_defs + [d])
                continue
            if isinstance(child, ast.ClassDef):
                self.bases.setdefault(child.name, set()).update(
                    b.attr if isinstance(b, ast.Attribute) else
                    getattr(b, "id", "") for b in child.bases)
                self._visit(path, child, stack + [child.name], child.name,
                            open_defs)
                continue
            if open_defs:
                if isinstance(child, ast.Call):
                    for d in open_defs:
                        d.calls.append(child)
                elif isinstance(child, ast.Assign) and \
                        len(child.targets) == 1 and \
                        isinstance(child.targets[0], ast.Name) and \
                        isinstance(child.value, ast.Attribute) and \
                        isinstance(child.value.value, ast.Name) and \
                        child.value.value.id == "self":
                    for d in open_defs:
                        d.aliases[child.targets[0].id] = child.value.attr
            self._visit(path, child, stack, cls, open_defs)

    def family(self, cls: str) -> Set[str]:
        """``cls``, its ancestors, its descendants and their ancestors:
        every class whose method a ``self.m()`` in ``cls`` may reach."""
        if cls in self._families:
            return self._families[cls]

        def up(c, seen):
            for b in self.bases.get(c, ()):
                if b not in seen:
                    seen.add(b)
                    up(b, seen)
            return seen

        down = {cls}
        changed = True
        while changed:
            changed = False
            for c, bs in self.bases.items():
                if c not in down and bs & down:
                    down.add(c)
                    changed = True
        out = set(down)
        for c in down:
            out |= up(c, set())
        self._families[cls] = out
        return out

    def resolve(self, cls: Optional[str], name: str) -> List[_Def]:
        if cls is None:
            return []
        return [d for c in sorted(self.family(cls))
                for d in self.methods.get((c, name), [])]


def _self_call_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == "self":
        return f.attr
    return None


def _params(fn: ast.AST) -> List[str]:
    args = getattr(fn, "args", None)
    return [a.arg for a in args.args] if args is not None else []


def captured_functions(paths: Sequence[str]) -> Set[Tuple[str, str]]:
    """(file, qualname) of every function in ``paths`` that may run inside
    ``native.capture`` (see the module docstring): the captured callables
    followed back through the parameters that carry them, then forward
    through ``self`` and same-module calls.  Memoized per file versions."""
    key = tuple((os.path.abspath(p), os.path.getmtime(p)) for p in paths)
    if key not in _CAPTURED:
        _CAPTURED.clear()
        _CAPTURED[key] = _captured_functions(paths)
    return _CAPTURED[key]


def _captured_functions(paths: Sequence[str]) -> Set[Tuple[str, str]]:
    idx = _Index(paths)
    roots: List[Tuple[_Def, ast.AST]] = []    # (enclosing def, callable)
    seen_param: Set[Tuple[int, int]] = set()

    def callers(d: _Def, pos: int):
        """(caller def, argument expression) for every call of method
        ``d`` (directly or through a ``q = self.m`` alias) passing
        argument ``pos`` (0 = the first after ``self``)."""
        name = d.node.name
        fam = idx.family(d.cls) if d.cls else set()
        for c in idx.defs:
            if d.cls is not None and c.cls not in fam:
                continue
            if d.cls is None and c.path != d.path:
                continue
            alias = {k for k, v in c.aliases.items() if v == name}
            for node in c.calls:
                hit = _self_call_name(node) == name if d.cls else \
                    isinstance(node.func, ast.Name) and node.func.id == name
                hit = hit or (isinstance(node.func, ast.Name)
                              and node.func.id in alias)
                if hit and len(node.args) > pos:
                    yield c, node.args[pos]

    def trace_back(d: _Def, expr: ast.AST) -> None:
        """Find what ``expr`` (an argument inside ``d``) can be."""
        if isinstance(expr, ast.Name):
            params = _params(d.node)
            if expr.id in params:
                pos = params.index(expr.id) - (1 if d.cls else 0)
                if pos >= 0 and (id(d.node), pos) not in seen_param:
                    seen_param.add((id(d.node), pos))
                    for c, arg in callers(d, pos):
                        trace_back(c, arg)
            return
        roots.append((d, expr))

    for d in idx.defs:
        for node in d.calls:
            if len(node.args) >= 2:
                try:
                    name = ast.unparse(node.func)
                except Exception:
                    continue
                if name in _CAPTURE_CALLS:
                    trace_back(d, node.args[1])

    out: Set[Tuple[str, str]] = set()
    work: List[_Def] = []

    def reach_from(owner: _Def, calls) -> None:
        for node in calls:
            m = _self_call_name(node)
            if m is not None:
                work.extend(idx.resolve(owner.cls, m))
            elif isinstance(node.func, ast.Name):
                f = idx.mod_funcs.get((owner.path, node.func.id))
                if f is not None:
                    work.append(f)

    for owner, expr in roots:
        if isinstance(expr, ast.Lambda):
            reach_from(owner, [n for n in ast.walk(expr.body)
                               if isinstance(n, ast.Call)])
        elif isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self":
            work.extend(idx.resolve(owner.cls, expr.attr))
    while work:
        d = work.pop()
        key = (d.path, d.qual)
        if key in out:
            continue
        out.add(key)
        reach_from(d, d.calls)
        # a nested def of a captured function runs inside it too
        work.extend(d.nested)
    return out


# -- scope walking ------------------------------------------------------------

class _Scope:
    """One function (or the module body) — the unit every rule reasons
    over."""

    def __init__(self, node: ast.AST, qualname: str):
        self.node = node
        self.qualname = qualname
        self.socket_calls: List[Tuple[ast.Call, str, Optional[str]]] = []
        self.settimeout_targets: Set[str] = set()
        self.open_calls: List[ast.Call] = []
        self.clock_calls: List[ast.Call] = []
        self.own: List[ast.AST] = []
        self.has_replace = False
        self.has_mkstemp = False


def _call_name(call: ast.Call) -> str:
    """Dotted name of the called expression ('' when not a plain chain)."""
    try:
        return ast.unparse(call.func)
    except Exception:
        return ""


def _assign_target_for(call: ast.Call, scope_node: ast.AST) -> Optional[str]:
    """The (unparsed) variable the call's result lands in, following one
    level of tuple unpack (``conn, addr = srv.accept()`` -> ``conn``)."""
    for node in ast.walk(scope_node):
        if isinstance(node, ast.Assign) and node.value is call:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Tuple) and tgt.elts:
                tgt = tgt.elts[0]
            try:
                return ast.unparse(tgt)
            except Exception:
                return None
        if isinstance(node, ast.withitem) and node.context_expr is call:
            if node.optional_vars is not None:
                try:
                    return ast.unparse(node.optional_vars)
                except Exception:
                    return None
    return None


def _collect_scopes(tree: ast.Module) -> List[_Scope]:
    """Every function (and the module body) with its own nodes — those not
    inside a nested function — in one walk of the tree."""
    scopes: List[_Scope] = [_Scope(tree, "<module>")]

    def visit(node: ast.AST, stack: List[str], scope: _Scope) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = _Scope(child, ".".join(stack + [child.name]))
                scopes.append(inner)
                visit(child, stack + [child.name], inner)
                continue
            scope.own.append(child)
            visit(child, stack + [child.name]
                  if isinstance(child, ast.ClassDef) else stack, scope)

    visit(tree, [], scopes[0])
    return scopes


def _is_wallclock(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and \
        isinstance(node.func, ast.Attribute) and \
        node.func.attr in _WALLCLOCK_FNS and \
        isinstance(node.func.value, ast.Name) and \
        node.func.value.id in ("time", "_time")


def _scan_scope(scope: _Scope) -> None:
    for node in scope.own:
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name in ("socket.socket",):
            scope.socket_calls.append((node, "socket.socket",
                                       _assign_target_for(node, scope.node)))
        elif name in ("socket.create_connection",):
            scope.socket_calls.append((node, "socket.create_connection",
                                       _assign_target_for(node, scope.node)))
        elif name.endswith(".accept") and isinstance(node.func,
                                                     ast.Attribute):
            scope.socket_calls.append((node, "accept",
                                       _assign_target_for(node, scope.node)))
        elif (name.endswith(".settimeout")
              or name.endswith(".setblocking")) and \
                isinstance(node.func, ast.Attribute):
            try:
                scope.settimeout_targets.add(ast.unparse(node.func.value))
            except Exception:
                pass
        elif name in ("os.replace",):
            scope.has_replace = True
        elif name in ("tempfile.mkstemp", "tempfile.NamedTemporaryFile",
                      "tempfile.TemporaryFile"):
            scope.has_mkstemp = True
        if _is_write_open(node, name):
            scope.open_calls.append(node)
        if _is_wallclock(node):
            scope.clock_calls.append(node)


def _is_write_open(call: ast.Call, name: str) -> bool:
    if not (name == "open" or name.endswith(".open")
            or name.endswith(".fdopen")):
        return False
    mode = None
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    return isinstance(mode, str) and mode.startswith(_WRITE_MODES)


def _has_timeout_kwarg(call: ast.Call) -> bool:
    return any(kw.arg == "timeout" for kw in call.keywords)


def _handler_reraises(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise) and node.exc is None:
            return True
    return False


def _names_base_exception(expr: Optional[ast.expr]) -> bool:
    if expr is None:
        return False
    exprs = expr.elts if isinstance(expr, ast.Tuple) else [expr]
    for e in exprs:
        if isinstance(e, ast.Name) and e.id == "BaseException":
            return True
        if isinstance(e, ast.Attribute) and e.attr == "BaseException":
            return True
    return False


def lint_file(path: str, traced: Optional[bool] = None,
              captured: Optional[Set[Tuple[str, str]]] = None
              ) -> List[Finding]:
    """All rule findings for one file (no allowlist applied).  LGB005
    applies to the functions in ``captured`` ((file, qualname) pairs; by
    default those ``captured_functions`` derives from this file alone) and
    to every function of a module under ``ops/``; ``traced=True`` applies
    it to the whole file, as the JAX lint's fixture tests force it."""
    tree = parse(path)
    rf = rel_file(path)
    if traced is None:
        traced = is_captured_module(path)
    if captured is None:
        captured = captured_functions([path])
    cap = {q for p, q in captured
           if os.path.abspath(p) == os.path.abspath(path)}
    findings: List[Finding] = []

    scopes = _collect_scopes(tree)
    for scope in scopes:
        _scan_scope(scope)

        # LGB001: sockets must carry timeouts
        for call, kind, target in scope.socket_calls:
            if _has_timeout_kwarg(call):
                continue
            if target is not None and target in scope.settimeout_targets:
                continue
            findings.append(Finding(
                "lint", "LGB001-socket-timeout", rf,
                f"{kind} result "
                f"{'(' + target + ') ' if target else ''}has no timeout: "
                f"pass timeout= or call settimeout() in the same function",
                line=call.lineno, symbol=scope.qualname))

        # LGB002: durable writes must be atomic
        if not (scope.has_replace or scope.has_mkstemp):
            for call in scope.open_calls:
                findings.append(Finding(
                    "lint", "LGB002-atomic-write", rf,
                    "file opened for writing without os.replace or a "
                    "tempfile in scope — a crash mid-write leaves a "
                    "truncated file",
                    line=call.lineno, symbol=scope.qualname))

        # LGB005: wall clocks in code a CUDA graph capture runs
        if not traced and scope.qualname in cap:
            for call in scope.clock_calls:
                findings.append(Finding(
                    "lint", "LGB005-wallclock-in-traced", rf,
                    f"time.{call.func.attr}() in {scope.qualname}, which "
                    f"runs inside native.capture: a CUDA graph replays only "
                    f"the device work, so the clock is read once, at "
                    f"capture", line=call.lineno, symbol=scope.qualname))

    for node in ast.walk(tree):
        # LGB003: global numpy RNG
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            f = node.func
            if isinstance(f.value, ast.Attribute) and \
                    f.value.attr == "random" and \
                    isinstance(f.value.value, ast.Name) and \
                    f.value.value.id in ("np", "numpy") and \
                    f.attr not in _SAFE_NP_RANDOM:
                findings.append(Finding(
                    "lint", "LGB003-global-np-random", rf,
                    f"np.random.{f.attr}() uses the GLOBAL generator; "
                    f"use a seeded np.random.default_rng/RandomState",
                    line=node.lineno))

        # LGB004: bare / swallowing-BaseException handlers
        if isinstance(node, ast.ExceptHandler):
            if node.type is None:
                findings.append(Finding(
                    "lint", "LGB004-bare-except", rf,
                    "bare `except:` catches SystemExit/KeyboardInterrupt; "
                    "name the exception types",
                    line=node.lineno))
            elif _names_base_exception(node.type) and \
                    not _handler_reraises(node):
                findings.append(Finding(
                    "lint", "LGB004-bare-except", rf,
                    "`except BaseException` without re-raise swallows "
                    "KeyboardInterrupt/SystemExit; catch Exception or "
                    "re-raise",
                    line=node.lineno))

        # LGB005 over a whole module (ops/, or forced)
        if traced and _is_wallclock(node):
            findings.append(Finding(
                "lint", "LGB005-wallclock-in-traced", rf,
                f"time.{node.func.attr}() in a module whose functions run "
                f"inside a CUDA graph capture: the clock is read once, at "
                f"capture", line=node.lineno))

    return findings


def schema_drift() -> List[Finding]:
    """LGB006: build the port's real telemetry and serving reports and
    check every emitted section key has an ``observability/schema.json``
    property — plus a full validator pass over both."""
    from ..observability.report import load_schema, validate_report
    from ..observability.telemetry import Telemetry
    from ..serving.batcher import ServingStats

    sfile = "lightgbm_tpu_torch/observability/schema.json"
    schema = load_schema()
    props = schema.get("properties", {})
    findings: List[Finding] = []
    reports = {
        "Telemetry.report": Telemetry(True).report(),
        "ServingStats.report": ServingStats().report(),
    }
    for sym, rep in reports.items():
        for key in rep:
            if key not in props:
                findings.append(Finding(
                    "lint", "LGB006-schema-drift", sfile,
                    f"report section {key!r} emitted by {sym} has no "
                    f"schema.json property — add it (or stop emitting it)",
                    symbol=sym))
        for err in validate_report(rep, schema):
            findings.append(Finding(
                "lint", "LGB006-schema-drift", sfile,
                f"{sym} report violates schema.json: {err}", symbol=sym))
    serving_props = props.get("serving", {}).get("properties", {})
    for key in reports["ServingStats.report"].get("serving", {}):
        if key not in serving_props:
            findings.append(Finding(
                "lint", "LGB006-schema-drift", sfile,
                f"serving section key {key!r} (ServingStats."
                f"serving_section) has no schema.json property",
                symbol="ServingStats.serving_section"))
    return findings


def run(paths: Optional[Sequence[str]] = None,
        allowlist: Optional[Sequence[dict]] = None,
        traced: Optional[bool] = None):
    """Run the repo lint.  Returns ``(findings, suppressed)`` after
    allowlist filtering.  ``paths`` defaults to every module of the port;
    the capture closure is derived from the whole package (a pass captured
    in one module may live in another) plus ``paths``, or, for paths all
    outside the package (fixtures), from ``paths`` alone.  Pass
    ``traced=True`` to force LGB005 over explicit paths (fixture tests)."""
    everything = list(iter_package_files())
    if paths is None:
        paths = everything
    if allowlist is None:
        allowlist = load_allowlist()
    pkg = os.path.join(os.path.abspath(PKG_ROOT), "")
    if any(os.path.abspath(p).startswith(pkg) for p in paths):
        captured = captured_functions(sorted(set(everything) | set(paths)))
    else:
        captured = captured_functions(list(paths))   # fixtures stand alone
    findings: List[Finding] = []
    for p in paths:
        findings.extend(lint_file(p, traced=traced, captured=captured))
    return apply_allowlist(findings, allowlist)
