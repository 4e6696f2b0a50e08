"""Lock-order race detector: static AST pass + runtime instrumentation.

Port of ``lightgbm_tpu/analysis/races.py``.  The serving layer is the most
threaded subsystem (accept loop, per-connection handlers, batcher workers,
hot-swap registry, the fleet's selector gateway and replicas), and the
port adds two process-wide locks of its own in ``native.py``: the launch
counters' ``_COUNT_LOCK`` and the CUDA graph capture lock
``_CAPTURE_LOCK`` (an ``RLock``) that serving's bucket captures and
training's pass captures share.  This pass extracts the
**lock-acquisition graph** statically:

  * lock identities are ``module.Class.field`` for ``self.<field> =
    threading.Lock()`` (and RLock/Condition/Semaphore) plus
    ``module.<name>`` for module-level locks;
  * an edge A -> B is recorded when lock B is acquired while A is held —
    directly (nested ``with``), or through a call whose transitive closure
    acquires B (``self.m()``, ``self.attr.m()`` with the attr's class
    inferred from its constructor assignment, cross-module helpers like
    ``rel_inc``, and module-qualified calls into an analyzed module such
    as ``native.capture``);
  * a **cycle** in the graph is a potential deadlock
    (``lock-order-cycle``);
  * a field mutated both inside and outside any lock of its class
    (``unlocked-mutation``) is a data-race candidate — ``__init__`` is
    construction-time and exempt.

The static pass is conservative about aliasing (it resolves only
``self.x = ClassName(...)`` attribute types) — by design: the analyzed
modules are a closed set and the point is catching *structural* inversions,
not proving absence.

For dynamic coverage, ``LockOrderMonitor`` provides a runtime
lock-discipline mode: tests build ``monitor.make_lock(name)`` locks (or
wrap existing ones into subsystem objects) and every acquisition is checked
against the accumulated order graph on the fly — an inversion is recorded
the moment the second ordering appears, without needing the interleaving
that actually deadlocks.
"""

from __future__ import annotations

import ast
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .common import Finding, PKG_ROOT, apply_allowlist, load_allowlist, \
    rel_file

#: the default analysis set: every module whose locks interlock — the
#: counterparts of the JAX package's list, plus the port's own lock
#: holders (``native.py``'s capture and counter locks, the fault table)
DEFAULT_FILES = (
    "native.py",
    os.path.join("reliability", "faults.py"),
    os.path.join("serving", "batcher.py"),
    os.path.join("serving", "registry.py"),
    os.path.join("serving", "server.py"),
    os.path.join("serving", "fleet", "wire.py"),
    os.path.join("serving", "fleet", "gateway.py"),
    os.path.join("serving", "fleet", "replicas.py"),
    os.path.join("io", "net.py"),
    os.path.join("reliability", "degrade.py"),
    os.path.join("reliability", "metrics.py"),
    os.path.join("lifecycle", "recorder.py"),
    os.path.join("lifecycle", "controller.py"),
    os.path.join("lifecycle", "budget.py"),
    os.path.join("lifecycle", "autopilot.py"),
    os.path.join("observability", "trace.py"),
    os.path.join("observability", "metrics_export.py"),
    os.path.join("observability", "drift.py"),
    os.path.join("elastic", "controller.py"),
    os.path.join("elastic", "epoch.py"),
)

_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                   "BoundedSemaphore"}


def _is_lock_ctor(value: ast.expr) -> bool:
    for node in ast.walk(value):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr in _LOCK_FACTORIES \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "threading":
            return True
    return False


class _ClassInfo:
    def __init__(self, module: str, name: str, node: ast.ClassDef):
        self.module = module
        self.name = name
        self.node = node
        self.lock_fields: Set[str] = set()
        self.attr_types: Dict[str, str] = {}        # self.<attr> -> ClassName
        self.methods: Dict[str, ast.FunctionDef] = {}

    def lock_id(self, field: str) -> str:
        return f"{self.module}.{self.name}.{field}"


class _Model:
    """The parsed world: classes, module locks, module functions."""

    def __init__(self) -> None:
        self.classes: Dict[str, _ClassInfo] = {}            # by class name
        self.mod_locks: Dict[Tuple[str, str], str] = {}     # (mod, var) -> id
        self.mod_funcs: Dict[str, Tuple[str, ast.FunctionDef]] = {}
        self.files: Dict[str, str] = {}                     # module -> file


def _build_model(paths: Sequence[str]) -> _Model:
    model = _Model()
    for path in paths:
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        mod = os.path.splitext(os.path.basename(path))[0]
        model.files[mod] = rel_file(path)
        for node in tree.body:
            if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        model.mod_locks[(mod, tgt.id)] = f"{mod}.{tgt.id}"
            elif isinstance(node, ast.FunctionDef):
                model.mod_funcs[node.name] = (mod, node)
            elif isinstance(node, ast.ClassDef):
                ci = _ClassInfo(mod, node.name, node)
                for item in node.body:
                    if isinstance(item, ast.FunctionDef):
                        ci.methods[item.name] = item
                model.classes[node.name] = ci
    # second pass: lock fields + attribute types (needs the class map)
    for ci in model.classes.values():
        for meth in ci.methods.values():
            for node in ast.walk(meth):
                if not isinstance(node, ast.Assign):
                    continue
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == "self":
                        if _is_lock_ctor(node.value):
                            ci.lock_fields.add(tgt.attr)
                        else:
                            for c in ast.walk(node.value):
                                if isinstance(c, ast.Call) and \
                                        isinstance(c.func, ast.Name) and \
                                        c.func.id in model.classes:
                                    ci.attr_types[tgt.attr] = c.func.id
                                    break
    return model


def _with_lock_of(item: ast.withitem, ci: Optional[_ClassInfo],
                  mod: str, model: _Model) -> Optional[str]:
    e = item.context_expr
    # `with self._lock:` / `self._lock.acquire()` context form
    if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) and \
            e.value.id == "self" and ci is not None and \
            e.attr in ci.lock_fields:
        return ci.lock_id(e.attr)
    if isinstance(e, ast.Name) and (mod, e.id) in model.mod_locks:
        return model.mod_locks[(mod, e.id)]
    return None


def _callee_key(call: ast.Call, ci: Optional[_ClassInfo],
                model: _Model) -> Optional[Tuple[str, str]]:
    """Resolve a call to (ClassName|'', method/function name) within the
    analyzed set, or None."""
    f = call.func
    if isinstance(f, ast.Attribute):
        v = f.value
        if isinstance(v, ast.Name) and v.id == "self" and ci is not None:
            if f.attr in ci.methods:
                return (ci.name, f.attr)
        if isinstance(v, ast.Attribute) and isinstance(v.value, ast.Name) \
                and v.value.id == "self" and ci is not None:
            tname = ci.attr_types.get(v.attr)
            if tname and f.attr in model.classes[tname].methods:
                return (tname, f.attr)
        # ``native.capture(...)``: a function of another analyzed module
        if isinstance(v, ast.Name) and f.attr in model.mod_funcs and \
                model.mod_funcs[f.attr][0] == v.id:
            return ("", f.attr)
    elif isinstance(f, ast.Name) and f.id in model.mod_funcs:
        return ("", f.id)
    return None


def _direct_acquisitions(fn: ast.AST, ci: Optional[_ClassInfo], mod: str,
                         model: _Model) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.With):
            for item in node.items:
                lock = _with_lock_of(item, ci, mod, model)
                if lock:
                    out.add(lock)
    return out


def _acquire_closure(model: _Model) -> Dict[Tuple[str, str], Set[str]]:
    """(Class, method) -> every lock it may acquire, transitively."""
    direct: Dict[Tuple[str, str], Set[str]] = {}
    calls: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}

    def scan(key: Tuple[str, str], fn: ast.AST, ci: Optional[_ClassInfo],
             mod: str) -> None:
        direct[key] = _direct_acquisitions(fn, ci, mod, model)
        cs: Set[Tuple[str, str]] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                ck = _callee_key(node, ci, model)
                if ck is not None and ck != key:
                    cs.add(ck)
        calls[key] = cs

    for ci in model.classes.values():
        for mname, fn in ci.methods.items():
            scan((ci.name, mname), fn, ci, ci.module)
    for fname, (mod, fn) in model.mod_funcs.items():
        scan(("", fname), fn, None, mod)

    closure = {k: set(v) for k, v in direct.items()}
    changed = True
    while changed:
        changed = False
        for key, cs in calls.items():
            for ck in cs:
                extra = closure.get(ck, set()) - closure[key]
                if extra:
                    closure[key] |= extra
                    changed = True
    return closure


def _find_cycle(edges: Dict[str, Set[str]]) -> Optional[List[str]]:
    """One simple cycle in the lock graph, as a node list, or None."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in
             set(edges) | {m for vs in edges.values() for m in vs}}
    stack: List[str] = []

    def dfs(n: str) -> Optional[List[str]]:
        color[n] = GRAY
        stack.append(n)
        for m in sorted(edges.get(n, ())):
            if color[m] == GRAY:
                return stack[stack.index(m):] + [m]
            if color[m] == WHITE:
                cyc = dfs(m)
                if cyc:
                    return cyc
        stack.pop()
        color[n] = BLACK
        return None

    for n in sorted(color):
        if color[n] == WHITE:
            cyc = dfs(n)
            if cyc:
                return cyc
    return None


class RaceReport:
    def __init__(self) -> None:
        # (held, acquired) -> (file, line, holder symbol)
        self.edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
        self.cycle: Optional[List[str]] = None
        # Class.field -> {"locked": [(file,line,sym)], "unlocked": [...]}
        self.mixed: Dict[str, Dict[str, List[Tuple[str, int, str]]]] = {}

    def graph(self) -> Dict[str, Set[str]]:
        g: Dict[str, Set[str]] = {}
        for a, b in self.edges:
            g.setdefault(a, set()).add(b)
        return g


def analyze(paths: Optional[Sequence[str]] = None) -> RaceReport:
    if paths is None:
        paths = [os.path.join(PKG_ROOT, p) for p in DEFAULT_FILES]
    model = _build_model(paths)
    closure = _acquire_closure(model)
    report = RaceReport()

    def walk_fn(key: Tuple[str, str], fn: ast.FunctionDef,
                ci: Optional[_ClassInfo], mod: str, rf: str) -> None:
        sym = f"{key[0]}.{key[1]}" if key[0] else key[1]

        def check(node: ast.AST, held: Tuple[str, ...]) -> None:
            """Examine ONE node under the current held-lock set, then
            recurse into its children."""
            if isinstance(node, ast.With):
                locks = [lk for item in node.items
                         for lk in [_with_lock_of(item, ci, mod, model)]
                         if lk]
                for lk in locks:
                    for h in held:
                        if h != lk:
                            report.edges.setdefault(
                                (h, lk), (rf, node.lineno, sym))
                inner = held + tuple(locks)
                for b in node.body:
                    check(b, inner)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return            # nested defs run later, not under `held`
            if isinstance(node, ast.Call) and held:
                ck = _callee_key(node, ci, model)
                if ck is not None:
                    for lk in closure.get(ck, ()):
                        for h in held:
                            if h != lk:
                                report.edges.setdefault(
                                    (h, lk), (rf, node.lineno, sym))
            # field mutations (rule: unlocked-mutation), __init__ exempt
            if ci is not None and key[1] != "__init__" and \
                    isinstance(node, (ast.Assign, ast.AugAssign)):
                tgts = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in tgts:
                    base = tgt
                    if isinstance(base, ast.Subscript):
                        base = base.value
                    if isinstance(base, ast.Attribute) and \
                            isinstance(base.value, ast.Name) and \
                            base.value.id == "self" and \
                            base.attr not in ci.lock_fields:
                        fid = f"{ci.name}.{base.attr}"
                        kind = "locked" if held else "unlocked"
                        report.mixed.setdefault(
                            fid, {"locked": [], "unlocked": []}
                        )[kind].append((rf, node.lineno, sym))
            for child in ast.iter_child_nodes(node):
                check(child, held)

        for child in ast.iter_child_nodes(fn):
            check(child, ())

    for ci in model.classes.values():
        rf = model.files[ci.module]
        for mname, fn in ci.methods.items():
            walk_fn((ci.name, mname), fn, ci, ci.module, rf)
    for fname, (mod, fn) in model.mod_funcs.items():
        walk_fn(("", fname), fn, None, mod, model.files[mod])

    report.cycle = _find_cycle(report.graph())
    return report


def findings_from(report: RaceReport) -> List[Finding]:
    out: List[Finding] = []
    if report.cycle:
        cyc = report.cycle
        witness = []
        for a, b in zip(cyc, cyc[1:]):
            f, ln, sym = report.edges[(a, b)]
            witness.append(f"{a}->{b} at {f}:{ln} ({sym})")
        f0, ln0, sym0 = report.edges[(cyc[0], cyc[1])]
        out.append(Finding(
            "races", "lock-order-cycle", f0,
            "lock acquisition cycle " + " -> ".join(cyc) + "; "
            + "; ".join(witness),
            line=ln0, symbol=sym0))
    for fid, sites in sorted(report.mixed.items()):
        if sites["locked"] and sites["unlocked"]:
            lf, lln, _ = sites["locked"][0]
            uf, uln, usym = sites["unlocked"][0]
            out.append(Finding(
                "races", "unlocked-mutation", uf,
                f"field {fid} is mutated under a lock at {lf}:{lln} but "
                f"without one at {uf}:{uln} — racy read-modify-write",
                line=uln, symbol=usym))
    return out


def run(paths: Optional[Sequence[str]] = None,
        allowlist: Optional[Sequence[dict]] = None):
    """Static pass entry: ``(findings, suppressed)``."""
    if allowlist is None:
        allowlist = load_allowlist()
    return apply_allowlist(findings_from(analyze(paths)), allowlist)


# -- runtime lock-discipline instrumentation ---------------------------------

class LockOrderMonitor:
    """Runtime lock-order tracker for tests.

    Locks built via ``make_lock`` report every acquisition; the monitor
    accumulates the order graph across ALL threads and records a violation
    the moment an acquisition closes a cycle — i.e. the two inverse
    orderings only ever need to happen, not interleave.

    Usage::

        mon = LockOrderMonitor()
        a, b = mon.make_lock("a"), mon.make_lock("b")
        ... run the system under test with a/b injected ...
        assert mon.violations == []
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._edges: Dict[str, Set[str]] = {}
        self._tls = threading.local()
        self.violations: List[Dict[str, Any]] = []

    def make_lock(self, name: str, factory=threading.Lock
                  ) -> "InstrumentedLock":
        return InstrumentedLock(self, name, factory())

    def _held(self) -> List[str]:
        if not hasattr(self._tls, "stack"):
            self._tls.stack = []
        return self._tls.stack

    def _reaches(self, src: str, dst: str) -> bool:
        seen = {src}
        frontier = [src]
        while frontier:
            n = frontier.pop()
            if n == dst:
                return True
            for m in self._edges.get(n, ()):
                if m not in seen:
                    seen.add(m)
                    frontier.append(m)
        return False

    def on_acquired(self, name: str) -> None:
        held = self._held()
        with self._mu:
            for h in held:
                if h == name:
                    continue
                if self._reaches(name, h):
                    self.violations.append({
                        "held": h, "acquiring": name,
                        "thread": threading.current_thread().name,
                        "message": f"acquired {name!r} while holding "
                                   f"{h!r}, but the inverse order "
                                   f"{name!r} -> {h!r} was also observed",
                    })
                self._edges.setdefault(h, set()).add(name)
        held.append(name)

    def on_released(self, name: str) -> None:
        held = self._held()
        if name in held:
            held.remove(name)

    def findings(self) -> List[Finding]:
        return [Finding("races", "runtime-lock-order", "<runtime>",
                        v["message"], symbol=v["thread"])
                for v in self.violations]


class InstrumentedLock:
    """A lock whose acquisitions feed a ``LockOrderMonitor``."""

    def __init__(self, monitor: LockOrderMonitor, name: str, lock):
        self._monitor = monitor
        self.name = name
        self._lock = lock

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._monitor.on_acquired(self.name)
        return ok

    def release(self) -> None:
        self._lock.release()
        self._monitor.on_released(self.name)

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
