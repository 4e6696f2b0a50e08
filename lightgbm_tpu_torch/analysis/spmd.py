"""SPMD safety, the AST half: rank-divergence and event-loop blocking.

Port of the AST passes of ``lightgbm_tpu/analysis/spmd.py``; its
collective-order pins run in ``programs.py`` (the port runs its sharded
programs instead of tracing them).

  * **LGB008 rank-divergence** — over ``parallel/``, ``io/``,
    ``boosting/``, ``elastic/`` and ``lifecycle/``: host control flow
    conditioned on rank identity that dominates a collective or net op on
    only one branch — the silent-cluster-hang class.  Every JAX token is
    kept (``process_index``, ``rank``, ``dead_rank``, ``heartbeat``, the
    net seams' ops), so the JAX fixtures give the same findings; the torch
    idioms are added: ``dist.get_rank()``, ``mesh.rank`` and ``coords`` as
    rank identity, ``torch.distributed``'s ``all_reduce`` /
    ``all_gather`` / ``broadcast`` / ``barrier`` and the rest, the
    ``Mesh`` collectives (``psum`` / ``pmax`` / ``psum_scatter`` /
    ``all_gather``, the JAX primitives' names) and the store ops under the
    port's ``DistributedNet``.
  * **LGB010 event-loop blocking** — the fleet gateway's selector thread
    (and the batcher ``_done`` callbacks it hands out) must never block:
    no ``time.sleep``, no unbounded frame recv, every socket op in the
    non-blocking idiom (an enclosing ``BlockingIOError`` handler), and, in
    the port, no read that waits for the card: ``torch.cuda.synchronize``,
    a stream's ``synchronize``, ``.item()``, ``.cpu()``, ``.tolist()``.

Vetted sites carry ``allowlist.json`` entries with reasons.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .common import (Finding, PKG_ROOT, apply_allowlist, iter_py,
                     load_allowlist, rel_file)
from .lint import parse


def rank_files() -> List[str]:
    """Every module under ``RANK_DIRS``."""
    return [p for d in RANK_DIRS for p in iter_py(os.path.join(PKG_ROOT, d))]


# -- LGB008: rank-divergent control flow around collectives -------------------

#: the default LGB008 analysis set (the layers elastic recovery touches,
#: plus lifecycle/ — the autopilot daemon must stay host-only with ZERO
#: collective sites, and this scan is what proves it)
RANK_DIRS = ("parallel", "io", "boosting", "elastic", "lifecycle")

#: the JAX package's collective primitives (``jaxpr_lint.COLLECTIVE_PRIMS``):
#: the names ``Mesh`` gives its collectives too
COLLECTIVE_PRIMS = frozenset({
    "psum", "pmax", "pmin", "ppermute", "pbroadcast", "all_gather",
    "all_to_all", "reduce_scatter", "psum_scatter", "pargmax", "pargmin",
})

#: ``torch.distributed``'s collectives, and the store ops the port's
#: ``DistributedNet`` rides (its own ops, ``allgather`` / ``sync_min`` /
#: ``sync_max`` / ``heartbeat`` / ``barrier``, are the JAX net seam's names)
TORCH_COLLECTIVES = frozenset({
    "all_reduce", "broadcast", "reduce", "all_gather_into_tensor",
    "reduce_scatter_tensor", "all_gather_object", "broadcast_object_list",
    "gather", "scatter", "all_to_all_single", "monitored_barrier",
    "delete_key", "_wait",
})

#: call names (attribute suffixes) that ARE collective / net ops: the
#: host-side net seams (SocketNet / DistributedNet / LoopbackNet), the
#: KV-store ops the JAX DistributedNet rides, the JAX collectives (the
#: ``Mesh`` methods of the port carry the same names) and torch's
_COLLECTIVE_CALLS = frozenset({
    "allgather", "sync_min", "sync_max", "heartbeat", "barrier",
    "_send_msg", "_recv_msg", "_recv_deadline", "_abort_survivors",
    "key_value_set_bytes", "blocking_key_value_get_bytes",
    "key_value_delete", "wait_at_barrier",
}) | COLLECTIVE_PRIMS | TORCH_COLLECTIVES

#: identifier fragments that mean "this condition depends on rank
#: identity or liveness results" — `self.rank`, `rank == 0`,
#: `jax.process_index()`, `dist.get_rank()`, a mesh's `coords`,
#: heartbeat / dead-rank verdicts
_RANK_TOKENS = ("process_index", "dead_rank", "heartbeat", "is_master",
                "missing_rank", "get_rank", "coords")


def _is_rank_conditioned(test: ast.expr) -> bool:
    for node in ast.walk(test):
        if isinstance(node, ast.Name) and node.id == "rank":
            return True
        if isinstance(node, ast.Attribute) and node.attr == "rank":
            return True
        if isinstance(node, (ast.Name, ast.Attribute)):
            ident = node.id if isinstance(node, ast.Name) else node.attr
            if any(t in ident for t in _RANK_TOKENS):
                return True
    return False


def _collective_calls_in(nodes: Iterable[ast.AST]) -> Set[str]:
    out: Set[str] = set()
    for root in nodes:
        for node in ast.walk(root):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else "")
            if name in _COLLECTIVE_CALLS:
                out.add(name)
    return out


def _rank_scope_stack(tree: ast.Module) -> List[Tuple[str, ast.AST]]:
    """(qualname, function node) for every function, classes joined in."""
    out: List[Tuple[str, ast.AST]] = []

    def visit(node: ast.AST, stack: List[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((".".join(stack + [child.name]), child))
                visit(child, stack + [child.name])
            elif isinstance(child, ast.ClassDef):
                visit(child, stack + [child.name])
            else:
                visit(child, stack)

    visit(tree, [])
    return out


def rank_divergence_file(path: str) -> List[Finding]:
    """LGB008 findings for one file (no allowlist applied)."""
    tree = parse(path)
    rf = rel_file(path)
    findings: List[Finding] = []
    for qualname, fn in _rank_scope_stack(tree):
        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While)):
                body, orelse = node.body, getattr(node, "orelse", [])
            elif isinstance(node, ast.IfExp):
                body, orelse = [node.body], [node.orelse]
            else:
                continue
            if not _is_rank_conditioned(node.test):
                continue
            in_body = _collective_calls_in(body)
            in_else = _collective_calls_in(orelse)
            if in_body == in_else:
                continue       # symmetric (or no) collectives: every rank
            diverging = sorted(in_body ^ in_else)
            findings.append(Finding(
                "spmd", "LGB008-rank-divergence", rf,
                f"rank-conditioned branch dominates collective/net op(s) "
                f"{diverging} on only one side — ranks taking different "
                f"paths around a collective is a silent cluster hang; "
                f"make the schedule rank-symmetric or allowlist this "
                f"vetted site with a reason",
                line=node.lineno, symbol=qualname))
    return findings


def rank_divergence(paths: Optional[Sequence[str]] = None
                    ) -> List[Finding]:
    """LGB008 over ``RANK_DIRS`` (no allowlist applied — :func:`run` does
    that)."""
    if paths is None:
        paths = rank_files()
    findings: List[Finding] = []
    for p in paths:
        findings.extend(rank_divergence_file(p))
    return findings


# -- LGB010: blocking calls on the gateway's selector thread ------------------

#: the event-loop analysis set: the selector gateway (loop thread +
#: the _done callbacks it hands to batcher workers)
LOOP_FILES = (os.path.join("serving", "fleet", "gateway.py"),)

#: the loop entry point: everything reachable from here via self-calls
#: runs on the selector thread
_LOOP_ENTRY = "_loop"

#: socket methods that park the calling thread unless the socket is
#: non-blocking (the gateway idiom: an enclosing BlockingIOError handler)
_SOCKET_OPS = frozenset({"recv", "recv_into", "accept", "send", "sendall",
                         "connect", "makefile"})

#: calls that block unconditionally — never allowed on the loop thread
#: (the JAX set, plus the torch reads that wait for the card's queue)
_HARD_BLOCKERS = {
    "time.sleep": "time.sleep parks the selector thread",
    "block_until_ready": "block_until_ready syncs on device work",
    "_recv_msg": "length-prefixed frame recv blocks until a full frame",
    "recv_frame": "length-prefixed frame recv blocks until a full frame",
    "create_connection": "blocking connect",
    "torch.cuda.synchronize": "torch.cuda.synchronize waits for the card",
    "synchronize": "a stream/event synchronize waits for the card",
    "item": ".item() reads a tensor to the host, waiting for the card",
    "cpu": ".cpu() copies a tensor to the host, waiting for the card",
    "tolist": ".tolist() reads a tensor to the host, waiting for the card",
}


def _loop_callables(tree: ast.Module) -> Dict[str, ast.AST]:
    """name -> function node for every method of every class plus nested
    callback defs, with nested defs keyed ``outer.<name>``."""
    out: Dict[str, ast.AST] = {}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                key = f"{prefix}.{child.name}" if prefix else child.name
                out[key] = child
                visit(child, key)
            elif isinstance(child, ast.ClassDef):
                visit(child, "")
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


def _thread_targets(fn: ast.AST) -> Set[str]:
    """Names handed to ``threading.Thread(target=...)`` inside ``fn`` —
    those run on their OWN thread and are exempt from the loop rule."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = ""
            f = node.func
            if isinstance(f, ast.Attribute):
                name = f.attr
            elif isinstance(f, ast.Name):
                name = f.id
            if name != "Thread":
                continue
            for kw in node.keywords:
                if kw.arg == "target":
                    for n in ast.walk(kw.value):
                        if isinstance(n, ast.Name):
                            out.add(n.id)
                        elif isinstance(n, ast.Attribute):
                            out.add(n.attr)
    return out


def _loop_closure(callables: Dict[str, ast.AST]) -> Dict[str, str]:
    """Every callable transitively reachable from the loop entry on the
    SAME thread -> how it got there (the call chain for the message).
    ``self.m()`` follows methods; nested defs handed to anything OTHER
    than threading.Thread (the batcher callback surface) are reachable
    from their definition site."""
    if _LOOP_ENTRY not in callables:
        return {}
    reach: Dict[str, str] = {_LOOP_ENTRY: _LOOP_ENTRY}
    frontier = [_LOOP_ENTRY]
    while frontier:
        cur = frontier.pop()
        fn = callables[cur]
        exempt = _thread_targets(fn)
        # nested callbacks defined here (minus Thread targets) run on
        # worker threads invoked FOR the loop's request path — the
        # batcher _done callbacks; they must obey the same no-block rule
        for name in callables:
            if name.startswith(cur + ".") and \
                    name.rsplit(".", 1)[1] not in exempt and \
                    name not in reach:
                reach[name] = f"{reach[cur]} -> {name}"
                frontier.append(name)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Name) and f.value.id == "self":
                callee = f.attr
                if callee in callables and callee not in exempt and \
                        callee not in reach:
                    reach[callee] = f"{reach[cur]} -> {callee}"
                    frontier.append(callee)
    return reach


def _in_blocking_guard(fn: ast.AST, call: ast.Call) -> bool:
    """True when ``call`` sits inside a ``try`` whose handlers name
    ``BlockingIOError`` — the gateway's proof that the socket op is
    non-blocking (EAGAIN is expected and handled, never a park)."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Try):
            continue
        if not any(isinstance(sub, ast.Call) and sub is call
                   for body in node.body for sub in ast.walk(body)):
            continue
        for handler in node.handlers:
            if handler.type is None:
                continue
            names = handler.type.elts if isinstance(
                handler.type, ast.Tuple) else [handler.type]
            for n in names:
                ident = n.id if isinstance(n, ast.Name) else \
                    getattr(n, "attr", "")
                if ident == "BlockingIOError":
                    return True
    return False


def event_loop_blocking(paths: Optional[Sequence[str]] = None
                        ) -> List[Finding]:
    """LGB010 findings (no allowlist applied)."""
    if paths is None:
        paths = [os.path.join(PKG_ROOT, p) for p in LOOP_FILES]
    findings: List[Finding] = []
    for path in paths:
        tree = parse(path)
        rf = rel_file(path)
        callables = _loop_callables(tree)
        reach = _loop_closure(callables)
        for name, chain in sorted(reach.items()):
            fn = callables[name]
            nested = {id(v) for k, v in callables.items()
                      if k != name and k.startswith(name + ".")}

            def own_calls(node: ast.AST):
                for child in ast.iter_child_nodes(node):
                    if id(child) in nested:
                        continue
                    if isinstance(child, ast.Call):
                        yield child
                    yield from own_calls(child)

            for call in own_calls(fn):
                f = call.func
                dotted = ""
                attr = ""
                if isinstance(f, ast.Attribute):
                    attr = f.attr
                    try:
                        dotted = ast.unparse(f)
                    except Exception:
                        dotted = attr
                elif isinstance(f, ast.Name):
                    attr = dotted = f.id
                why = _HARD_BLOCKERS.get(dotted) or \
                    _HARD_BLOCKERS.get(attr)
                if why is not None:
                    findings.append(Finding(
                        "spmd", "LGB010-event-loop-blocking", rf,
                        f"{dotted}() on the selector thread ({chain}): "
                        f"{why} — the event loop must never block",
                        line=call.lineno, symbol=name))
                    continue
                if attr in _SOCKET_OPS and isinstance(f, ast.Attribute):
                    if attr in ("sendall", "connect", "makefile") or \
                            not _in_blocking_guard(fn, call):
                        findings.append(Finding(
                            "spmd", "LGB010-event-loop-blocking", rf,
                            f"{dotted}() on the selector thread ({chain}) "
                            f"without a BlockingIOError guard — a "
                            f"blocking socket op parks the whole "
                            f"gateway; use the non-blocking idiom",
                            line=call.lineno, symbol=name))
    return findings


# -- pass entry ---------------------------------------------------------------

def run(rank_paths: Optional[Sequence[str]] = None,
        loop_paths: Optional[Sequence[str]] = None,
        allowlist: Optional[Sequence[dict]] = None):
    """The spmd gate pass: LGB008 + LGB010.  Returns ``(findings,
    suppressed)``."""
    if allowlist is None:
        allowlist = load_allowlist()
    findings = rank_divergence(rank_paths) + \
        event_loop_blocking(loop_paths)
    return apply_allowlist(findings, allowlist)
