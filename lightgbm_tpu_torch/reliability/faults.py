"""Deterministic fault-injection harness.

Port of ``lightgbm_tpu/reliability/faults.py``: the spec grammar, the
``LGBT_FAULTS`` environment variable / ``fault_spec`` key and ``fire`` are
the JAX package's.  Chaos tests drive the REAL failure paths (the serving
layer's host fallback, the framing's length guard), not mocks of them.
Injection points cost one ``is None`` check when disarmed.

Spec grammar (semicolon-separated clauses)::

    point[:key=value]*

    serve.predict.fail:count=-1       # every device predict raises
    serve.predict.delay:seconds=0.2   # device predict stalls (overload tests)
    net.recv.corrupt_len              # recv sees a garbage length prefix

Those three points are the ones the port fires.  The JAX package's others
(``train.crash``, ``net.send.*``, ``net.crash``, ``serving.replica_fault``)
belong to modules the port does not carry yet: a spec that arms one raises
``NotImplementedError`` naming its ROADMAP.md Queue A item
(``config.not_ported``), so an injection never silently no-ops there.

Clause keys understood everywhere: ``rank`` (only fire for that rank;
default any), ``nth`` (first firing hit, 1-based, counted per clause over
MATCHING calls; default 1), ``count`` (how many firings; default 1, ``-1``
= unlimited).  Remaining keys are passed to the injection site verbatim
(e.g. ``seconds`` for delays).

Determinism: firing depends only on the per-clause hit counter, never on
time or randomness — the same arm + the same call sequence injects the
same fault.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from ..config import OBSERVE, PARALLEL, SERVING, not_ported
from .metrics import rel_inc

ENV_VAR = "LGBT_FAULTS"

#: the JAX package's injection points whose code the port does not carry
#: yet, with the Queue A item that brings each
NOT_PORTED = {"train.crash": OBSERVE, "net.send.drop": PARALLEL,
              "net.send.delay": PARALLEL, "net.send.truncate": PARALLEL,
              "net.crash": PARALLEL, "serving.replica_fault": SERVING}


class InjectedFault(RuntimeError):
    """The failure an armed point raises at its site (``serve.predict.fail``),
    so a handler can tell an injected fault from a real one."""


class _Clause:
    __slots__ = ("point", "rank", "nth", "count", "args", "hits", "fired")

    def __init__(self, point: str, rank: Optional[int], nth: int,
                 count: int, args: Dict[str, str]):
        self.point = point
        self.rank = rank
        self.nth = max(int(nth), 1)
        self.count = int(count)
        self.args = args
        self.hits = 0
        self.fired = 0

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (f"_Clause({self.point}, rank={self.rank}, nth={self.nth}, "
                f"count={self.count}, args={self.args})")


def parse_spec(spec: str) -> List[_Clause]:
    """Parse a fault spec string; raises ``ValueError`` naming the bad
    clause so a typo'd injection never silently no-ops, and
    ``NotImplementedError`` for a point of ``NOT_PORTED``."""
    clauses: List[_Clause] = []
    for raw in spec.replace("\n", ";").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        point = parts[0].strip()
        if not point or "=" in point:
            raise ValueError(f"bad fault clause {raw!r}: first token must "
                             f"be the injection point name")
        rank: Optional[int] = None
        nth = 1
        count = 1
        args: Dict[str, str] = {}
        for kv in parts[1:]:
            if "=" not in kv:
                raise ValueError(f"bad fault clause {raw!r}: token {kv!r} "
                                 f"is not key=value")
            k, v = kv.split("=", 1)
            k, v = k.strip(), v.strip()
            if k == "rank":
                rank = int(v)
            elif k == "nth":
                nth = int(v)
            elif k == "count":
                count = int(v)
            else:
                args[k] = v
        if point in NOT_PORTED:
            raise not_ported(f"fault point {point}", NOT_PORTED[point])
        clauses.append(_Clause(point, rank, nth, count, args))
    return clauses


_lock = threading.Lock()
_plan: Optional[List[_Clause]] = None
_env_loaded = False


def arm(spec: str) -> None:
    """Arm the plan from a spec string (replaces any existing plan)."""
    global _plan, _env_loaded
    with _lock:
        _plan = parse_spec(spec)
        _env_loaded = True


def disarm() -> None:
    """Remove every armed fault (and stop re-reading the environment)."""
    global _plan, _env_loaded
    with _lock:
        _plan = []
        _env_loaded = True


def reset() -> None:
    """Back to pristine: no plan, environment re-read on next ``fire``."""
    global _plan, _env_loaded
    with _lock:
        _plan = None
        _env_loaded = False


def load() -> List[_Clause]:
    """The armed plan, reading ``LGBT_FAULTS`` first if nothing armed or
    read it yet.  The server calls this when it starts, so a bad or
    refused spec in the environment raises there and not in a batch."""
    global _plan, _env_loaded
    plan = _plan
    if plan is None:
        with _lock:
            if not _env_loaded:
                spec = os.environ.get(ENV_VAR, "")
                _plan = parse_spec(spec) if spec else []
                _env_loaded = True
            plan = _plan or []
    return plan


def fire(point: str, rank: Optional[int] = None) -> Optional[Dict[str, str]]:
    """Called from an injection point.  Returns the clause's extra args
    when a matching clause fires, else ``None``.  The caller performs the
    actual fault (raise / sleep) so the failure flows through the real
    code path at the real location."""
    plan = load()
    if not plan:
        return None
    with _lock:
        for c in plan:
            if c.point != point:
                continue
            if c.rank is not None and rank is not None and c.rank != rank:
                continue
            if c.rank is not None and rank is None:
                continue
            c.hits += 1
            if c.hits >= c.nth and (c.count < 0 or c.fired < c.count):
                c.fired += 1
                rel_inc("faults_injected")
                rel_inc(f"fault.{point}")
                return dict(c.args)
    return None

