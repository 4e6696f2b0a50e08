"""AST resource-lifecycle pass: threads join, fds close, children reap.

Port of ``lightgbm_tpu/analysis/resources.py``.  The host-side surface (fleet gateway selector loop, autopilot daemon,
watchdogs, elastic per-epoch workers) is exactly where a leaked thread,
unclosed socket or unreaped subprocess hides until a minutes-long soak —
the reference C++ LightGBM scopes its ``Network``/thread teardown by
construction; this pass is the static equivalent for the Python tree.
Rules (scanned over ``serving/``, ``lifecycle/``, ``elastic/``, ``io/``,
``observability/``, and in the port ``parallel/``, whose ``launch.py``
starts ``multiprocessing`` rank processes and whose heartbeat runs
threads):

  * **LGB011-thread-lifecycle** — every ``threading.Thread`` must have a
    reachable join:

      - stored on ``self``: some method of the class must join that
        attribute (directly, through a one-level local alias
        ``t = self._thread`` / ``getattr(self, "_thread")``, or through
        a ``for t in (self._a, self._b):`` tuple walk).  A class whose
        ``stop()``/``close()``/``shutdown()`` merely sets a stop event
        is the finding this rule exists for — signalling is not
        quiescence.  The one sanctioned joinless shape is the
        stop-event+daemon pattern: ``daemon=True`` AND the class has no
        teardown-named method at all (callers wait on a done-event
        instead — the ``RollbackWatchdog`` shape).
      - fire-and-forget ``threading.Thread(...).start()``: must be
        ``daemon=True`` (a non-daemon anonymous thread can never be
        joined and blocks interpreter exit).
      - local: needs ``daemon=True`` or a ``join`` call in the same
        function (the scatter/join worker-list shape).

  * **LGB012-close-on-all-paths** — sockets / socketpairs / selectors /
    non-``with`` ``open`` results must close: a ``with`` block, a close
    in the creating function, or — when stored on ``self`` — a close of
    that attribute somewhere in the class (same alias forms as LGB011).
    Handing the object off (argument, return, container store) transfers
    ownership and is not a finding here.

  * **LGB013-subprocess-reap** — every ``subprocess.Popen`` result needs
    a reachable ``wait``/``communicate``/``terminate``/``kill`` (or a
    ``with`` block, whose exit waits); ``subprocess.run`` and the
    ``check_*`` wrappers must pass ``timeout=`` so a wedged child cannot
    block teardown forever.  A spawned ``multiprocessing`` ``Process``
    (``ctx.Process``, ``mp.Process``; also a list of them built by a
    comprehension) is held to the same rule with ``join`` as its reap: it
    must be joined, or terminated or killed and then joined — a process
    that is killed and never joined stays a zombie, one never joined keeps
    running past the teardown.

All heuristics are one-file AST checks with the established
allowlist-with-reason workflow; vetted exceptions go to
``allowlist.json`` naming the exact symbol.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .common import Finding, PKG_ROOT, apply_allowlist, load_allowlist, \
    rel_file
from .lint import parse

#: package dirs with a host-side concurrency/io surface worth scanning
SCAN_DIRS = ("serving", "lifecycle", "elastic", "io", "observability",
             "parallel")

_THREAD_CTORS = {"threading.Thread", "Thread"}
_FD_CTORS = {"socket.socket", "socket.create_connection",
             "socket.socketpair", "selectors.DefaultSelector",
             "selectors.SelectSelector", "selectors.PollSelector",
             "selectors.EpollSelector", "selectors.KqueueSelector"}
_POPEN_CTORS = {"subprocess.Popen", "Popen"}
_RUN_CALLS = {"subprocess.run", "subprocess.call",
              "subprocess.check_call", "subprocess.check_output"}

_JOIN = {"join"}
_CLOSE = {"close"}
_REAP = {"wait", "communicate", "terminate", "kill"}
_TEARDOWN_METHODS = {"stop", "close", "shutdown", "__exit__", "__del__"}


def iter_scan_files(root: Optional[str] = None) -> Iterable[str]:
    root = PKG_ROOT if root is None else root
    for d in SCAN_DIRS:
        top = os.path.join(root, d)
        if not os.path.isdir(top):
            continue
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = [x for x in sorted(dirnames) if x != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def _call_name(call: ast.Call) -> str:
    try:
        return ast.unparse(call.func)
    except Exception:
        return ""


def _is_self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` -> ``"X"`` (else None)."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _getattr_target(node: ast.AST) -> Optional[str]:
    """``getattr(self, "X"[, default])`` -> ``"X"`` (else None)."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id == "getattr" and len(node.args) >= 2 \
            and isinstance(node.args[0], ast.Name) \
            and node.args[0].id == "self" \
            and isinstance(node.args[1], ast.Constant) \
            and isinstance(node.args[1].value, str):
        return node.args[1].value
    return None


class _Fn:
    """One function plus the class (qualname) that owns it, if any."""

    def __init__(self, node: ast.AST, qualname: str,
                 cls: Optional[str]) -> None:
        self.node = node
        self.qualname = qualname
        self.cls = cls


def _collect_fns(tree: ast.Module) -> List[_Fn]:
    fns: List[_Fn] = []

    def visit(node: ast.AST, stack: List[str], cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fns.append(_Fn(child, ".".join(stack + [child.name]), cls))
                # nested defs stay attributed to the enclosing class
                visit(child, stack + [child.name], cls)
            elif isinstance(child, ast.ClassDef):
                visit(child, stack + [child.name],
                      ".".join(stack + [child.name]))
            else:
                visit(child, stack, cls)

    visit(tree, [], None)
    return fns


def _own_nodes(fn: _Fn, all_fns: List[_Fn]) -> List[ast.AST]:
    """Nodes of this function excluding nested function bodies (a nested
    def is its own _Fn and analyzed separately)."""
    nested = {id(f.node) for f in all_fns if f.node is not fn.node}
    out: List[ast.AST] = []

    def walk(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if id(child) in nested:
                continue
            out.append(child)
            walk(child)

    walk(fn.node)
    return out


def _aliases(nodes: Sequence[ast.AST]) -> Dict[str, Set[str]]:
    """Local name -> the ``self.*`` attr(s) it aliases, one level deep:
    ``t = self._thread``, ``t = getattr(self, "_thread")``,
    ``for s in (self._a, self._b):`` and ``for p in self._procs:``."""
    out: Dict[str, Set[str]] = {}
    for node in nodes:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            attr = _is_self_attr(node.value) or _getattr_target(node.value)
            if attr is not None:
                out.setdefault(node.targets[0].id, set()).add(attr)
        elif isinstance(node, ast.For) and isinstance(node.target, ast.Name) \
                and isinstance(node.iter, (ast.Tuple, ast.List)):
            attrs = {a for a in map(_is_self_attr, node.iter.elts)
                     if a is not None}
            if attrs:
                out.setdefault(node.target.id, set()).update(attrs)
        elif isinstance(node, ast.For) and isinstance(node.target, ast.Name) \
                and _is_self_attr(node.iter) is not None:
            out.setdefault(node.target.id, set()).add(
                _is_self_attr(node.iter))
    return out


def _attr_method_calls(nodes: Sequence[ast.AST],
                       methods: Set[str]) -> Set[str]:
    """Attrs X for which ``self.X.<m>()`` (or an aliased local's
    ``<m>()``) is called, m in ``methods``."""
    aliases = _aliases(nodes)
    out: Set[str] = set()
    for node in nodes:
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in methods):
            continue
        base = node.func.value
        attr = _is_self_attr(base) or _getattr_target(base)
        if attr is not None:
            out.add(attr)
        elif isinstance(base, ast.Name) and base.id in aliases:
            out.update(aliases[base.id])
    return out


def _local_method_calls(nodes: Sequence[ast.AST], var: str,
                        methods: Set[str]) -> bool:
    for node in nodes:
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in methods \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == var:
            return True
    return False


def _any_method_call(nodes: Sequence[ast.AST], methods: Set[str]) -> bool:
    return any(isinstance(n, ast.Call)
               and isinstance(n.func, ast.Attribute)
               and n.func.attr in methods for n in nodes)


def _daemon_true(call: ast.Call) -> bool:
    return any(kw.arg == "daemon" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords)


def _has_timeout_kwarg(call: ast.Call) -> bool:
    return any(kw.arg == "timeout" for kw in call.keywords)


def _binding(call: ast.Call, nodes: Sequence[ast.AST]
             ) -> Tuple[str, Optional[ast.AST]]:
    """How the creation's result is bound: ``with`` / ``assign`` (target
    returned) / ``arg`` (passed straight into another call) / ``method``
    (immediately invoked, e.g. ``Thread(...).start()``) / ``return`` /
    ``other``."""
    for node in nodes:
        if isinstance(node, ast.withitem) and node.context_expr is call:
            return "with", None
        if isinstance(node, ast.Assign) and node.value is call:
            return "assign", node.targets[0]
        if isinstance(node, ast.Call) and node is not call:
            if call in node.args or \
                    any(kw.value is call for kw in node.keywords):
                return "arg", None
            if isinstance(node.func, ast.Attribute) \
                    and node.func.value is call:
                return "method", node.func
        if isinstance(node, ast.Return) and node.value is call:
            return "return", None
    return "other", None


def _target_attrs(target: ast.AST) -> List[str]:
    """Assign target -> the ``self.*`` attrs it stores to (empty when
    the target is not attribute-shaped)."""
    elts = target.elts if isinstance(target, (ast.Tuple, ast.List)) \
        else [target]
    attrs = [a for a in map(_is_self_attr, elts) if a is not None]
    return attrs if len(attrs) == len(elts) else attrs


def _target_names(target: ast.AST) -> List[str]:
    elts = target.elts if isinstance(target, (ast.Tuple, ast.List)) \
        else [target]
    return [e.id for e in elts if isinstance(e, ast.Name)]


def _direct_name(expr: ast.AST, var: str) -> bool:
    """True when ``expr`` hands off the bare handle: ``var`` itself or a
    tuple/list containing it (``Thread(args=(conn,))``).  Derived values
    (``var.pid``, ``var.read(10)``) are NOT a handoff."""
    if isinstance(expr, ast.Name):
        return expr.id == var
    if isinstance(expr, (ast.Tuple, ast.List)):
        return any(_direct_name(e, var) for e in expr.elts)
    return False


def _escapes(nodes: Sequence[ast.AST], var: str) -> Tuple[bool, List[str]]:
    """Does local ``var`` hand off ownership?  Returns (escaped,
    transferred_self_attrs): passed as a call argument, returned, stored
    into a container, or assigned onto ``self.X`` (those attrs are
    returned so the caller can hold the class to the attr rules)."""
    attrs: List[str] = []
    escaped = False
    for node in nodes:
        if isinstance(node, ast.Assign):
            # only a DIRECT `x = var` store transfers the handle;
            # `self.port = var.getsockname()[1]` derives a value from it
            if not (isinstance(node.value, ast.Name)
                    and node.value.id == var):
                continue
            for tgt in node.targets:
                attr = _is_self_attr(tgt)
                if attr is not None:
                    attrs.append(attr)
                elif isinstance(tgt, ast.Subscript):
                    escaped = True
        elif isinstance(node, ast.Return) and node.value is not None:
            if _direct_name(node.value, var):
                escaped = True
        elif isinstance(node, ast.Call):
            # `v` as an argument transfers ownership; `v.meth()` does not
            if isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == var:
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if _direct_name(arg, var):
                    escaped = True
    return escaped, attrs


class _ClassInfo:
    """Class-wide teardown facts, unioned over every method."""

    def __init__(self) -> None:
        self.joined: Set[str] = set()
        self.closed: Set[str] = set()
        self.reaped: Set[str] = set()
        self.method_names: Set[str] = set()


def _class_infos(fns: List[_Fn], all_fns: List[_Fn]
                 ) -> Dict[str, _ClassInfo]:
    infos: Dict[str, _ClassInfo] = {}
    for fn in fns:
        if fn.cls is None:
            continue
        info = infos.setdefault(fn.cls, _ClassInfo())
        info.method_names.add(fn.node.name)
        nodes = _own_nodes(fn, all_fns)
        info.joined |= _attr_method_calls(nodes, _JOIN)
        info.closed |= _attr_method_calls(nodes, _CLOSE)
        info.reaped |= _attr_method_calls(nodes, _REAP)
    return infos


def scan_file(path: str) -> List[Finding]:
    """All LGB011/LGB012/LGB013 findings for one file (no allowlist)."""
    tree = parse(path)
    rf = rel_file(path)
    fns = _collect_fns(tree)
    classes = _class_infos(fns, fns)
    findings: List[Finding] = []

    for fn in fns:
        nodes = _own_nodes(fn, fns)
        cls = classes.get(fn.cls) if fn.cls else None
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name in _THREAD_CTORS:
                findings.extend(_check_thread(node, nodes, fn, cls, rf))
            elif name in _FD_CTORS or name == "open":
                findings.extend(_check_fd(node, name, nodes, fn, cls, rf))
            elif name in _POPEN_CTORS:
                findings.extend(_check_popen(node, nodes, fn, cls, rf))
            elif name == "Process" or name.endswith(".Process"):
                findings.extend(_check_process(node, nodes, fn, cls, rf))
            elif name in _RUN_CALLS and not _has_timeout_kwarg(node):
                findings.append(Finding(
                    "resources", "LGB013-subprocess-reap", rf,
                    f"{name}() without timeout= — a wedged child blocks "
                    f"teardown forever; pass timeout= (or use Popen with "
                    f"an explicit wait/kill path)",
                    line=node.lineno, symbol=fn.qualname))
    return findings


def _attr_join_ok(attr: str, call: ast.Call, cls: Optional[_ClassInfo]
                  ) -> Tuple[bool, str]:
    if cls is not None and attr in cls.joined:
        return True, ""
    if _daemon_true(call) and cls is not None \
            and not (cls.method_names & _TEARDOWN_METHODS):
        # the sanctioned stop-event+daemon shape: no teardown-named
        # method exists, so no caller is promised quiescence
        return True, ""
    return False, (
        f"thread stored on self.{attr} is never joined by this class — "
        f"a stop()/close() that only sets a flag leaves the thread "
        f"running; join the attribute in the teardown method")


def _check_thread(call: ast.Call, nodes: Sequence[ast.AST], fn: _Fn,
                  cls: Optional[_ClassInfo], rf: str) -> List[Finding]:
    kind, detail = _binding(call, nodes)
    if kind == "method":
        # fire-and-forget Thread(...).start(): unjoinable by construction
        if detail.attr == "start" and not _daemon_true(call):
            return [Finding(
                "resources", "LGB011-thread-lifecycle", rf,
                "fire-and-forget Thread(...).start() without daemon=True "
                "can never be joined and blocks interpreter exit",
                line=call.lineno, symbol=fn.qualname)]
        return []
    if kind == "assign":
        attrs = _target_attrs(detail)
        names = _target_names(detail) if not attrs else []
        for var in names:
            escaped, xfer = _escapes(nodes, var)
            attrs.extend(xfer)
            if not xfer and (escaped
                             or _local_method_calls(nodes, var, _JOIN)):
                return []
        out: List[Finding] = []
        for attr in attrs:
            ok, msg = _attr_join_ok(attr, call, cls)
            if not ok:
                out.append(Finding(
                    "resources", "LGB011-thread-lifecycle", rf, msg,
                    line=call.lineno, symbol=fn.qualname))
        if attrs or not names:
            return out
    # local (or unbound) thread: a join in this function or daemon=True
    if _daemon_true(call) or _any_method_call(nodes, _JOIN):
        return []
    return [Finding(
        "resources", "LGB011-thread-lifecycle", rf,
        "thread has no reachable join in this function and is not "
        "daemon=True — join the worker (or mark it daemon and signal "
        "it with a stop event)",
        line=call.lineno, symbol=fn.qualname)]


def _check_fd(call: ast.Call, name: str, nodes: Sequence[ast.AST],
              fn: _Fn, cls: Optional[_ClassInfo], rf: str) -> List[Finding]:
    kind, detail = _binding(call, nodes)
    if kind in ("with", "arg", "return"):
        return []
    if kind in ("method", "other"):
        # immediately consumed / discarded: nothing trackable to close
        return []
    attrs = _target_attrs(detail)
    names = _target_names(detail) if not attrs else []
    for var in names:
        if _local_method_calls(nodes, var, _CLOSE):
            continue
        escaped, xfer = _escapes(nodes, var)
        if xfer:
            attrs.extend(xfer)
        elif not escaped:
            return [Finding(
                "resources", "LGB012-close-on-all-paths", rf,
                f"{name}() result ({var}) is neither closed in this "
                f"function nor handed off — close it in a finally/with "
                f"or store it where teardown closes it",
                line=call.lineno, symbol=fn.qualname)]
    out: List[Finding] = []
    for attr in attrs:
        if cls is not None and attr in cls.closed:
            continue
        out.append(Finding(
            "resources", "LGB012-close-on-all-paths", rf,
            f"{name}() result stored on self.{attr} but no method of "
            f"the class closes that attribute — teardown must close "
            f"every fd it owns",
            line=call.lineno, symbol=fn.qualname))
    return out


def _check_popen(call: ast.Call, nodes: Sequence[ast.AST], fn: _Fn,
                 cls: Optional[_ClassInfo], rf: str) -> List[Finding]:
    kind, detail = _binding(call, nodes)
    if kind in ("with", "arg", "return"):
        return []                     # Popen.__exit__ waits; handoff ok
    if kind in ("method", "other"):
        return [Finding(
            "resources", "LGB013-subprocess-reap", rf,
            "Popen(...) result is discarded — the child is never "
            "wait()ed and becomes a zombie",
            line=call.lineno, symbol=fn.qualname)]
    attrs = _target_attrs(detail)
    names = _target_names(detail) if not attrs else []
    for var in names:
        if _local_method_calls(nodes, var, _REAP):
            continue
        escaped, xfer = _escapes(nodes, var)
        if xfer:
            attrs.extend(xfer)
        elif not escaped:
            return [Finding(
                "resources", "LGB013-subprocess-reap", rf,
                f"Popen result ({var}) has no wait/communicate/"
                f"terminate/kill path in this function — reap the child "
                f"on every exit arm",
                line=call.lineno, symbol=fn.qualname)]
    out: List[Finding] = []
    for attr in attrs:
        if cls is not None and attr in cls.reaped:
            continue
        out.append(Finding(
            "resources", "LGB013-subprocess-reap", rf,
            f"Popen result stored on self.{attr} but no method of the "
            f"class waits/kills it — teardown must reap the child",
            line=call.lineno, symbol=fn.qualname))
    return out


def _comprehension_binding(call: ast.Call, nodes: Sequence[ast.AST]
                           ) -> Optional[ast.AST]:
    """The assign target of ``x = [Ctor(...) for ...]`` when ``call`` is
    that comprehension's element (a list of handles), else None."""
    for node in nodes:
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, (ast.ListComp, ast.GeneratorExp)) \
                and node.value.elt is call:
            return node.targets[0]
    return None


def _loop_joined(nodes: Sequence[ast.AST], var: str) -> bool:
    """``var.join()``, or ``for p in var: ... p.join()``."""
    if _local_method_calls(nodes, var, _JOIN):
        return True
    for node in nodes:
        if isinstance(node, ast.For) and isinstance(node.iter, ast.Name) \
                and node.iter.id == var and \
                isinstance(node.target, ast.Name) and \
                _local_method_calls(list(ast.walk(node)), node.target.id,
                                    _JOIN):
            return True
    return False


def _check_process(call: ast.Call, nodes: Sequence[ast.AST], fn: _Fn,
                   cls: Optional[_ClassInfo], rf: str) -> List[Finding]:
    """A spawned process is joined (after a terminate/kill too)."""
    target = _comprehension_binding(call, nodes)
    kind, detail = ("assign", target) if target is not None \
        else _binding(call, nodes)
    if kind in ("arg", "return"):
        return []                     # handed off: the receiver joins it
    if kind in ("method", "other", "with"):
        return [Finding(
            "resources", "LGB013-subprocess-reap", rf,
            "Process(...) result is discarded — the spawned process is "
            "never joined: it outlives the teardown, or, killed, stays a "
            "zombie", line=call.lineno, symbol=fn.qualname)]
    attrs = _target_attrs(detail)
    names = _target_names(detail) if not attrs else []
    for var in names:
        if _loop_joined(nodes, var):
            continue
        escaped, xfer = _escapes(nodes, var)
        if xfer:
            attrs.extend(xfer)
        elif not escaped:
            return [Finding(
                "resources", "LGB013-subprocess-reap", rf,
                f"Process result ({var}) is never joined in this function "
                f"— join it (after terminate/kill too) on every exit arm",
                line=call.lineno, symbol=fn.qualname)]
    out: List[Finding] = []
    for attr in attrs:
        if cls is not None and attr in cls.joined:
            continue
        out.append(Finding(
            "resources", "LGB013-subprocess-reap", rf,
            f"Process result stored on self.{attr} but no method of the "
            f"class joins it — teardown must join every process it "
            f"started, after a terminate/kill too",
            line=call.lineno, symbol=fn.qualname))
    return out


def run(paths: Optional[Sequence[str]] = None,
        allowlist: Optional[Sequence[dict]] = None):
    """Run the resource-lifecycle pass; ``(findings, suppressed)`` after
    allowlist filtering.  ``paths`` defaults to every module under the
    scanned package dirs."""
    if paths is None:
        paths = list(iter_scan_files())
    if allowlist is None:
        allowlist = load_allowlist()
    findings: List[Finding] = []
    for p in paths:
        findings.extend(scan_file(p))
    return apply_allowlist(findings, allowlist)
