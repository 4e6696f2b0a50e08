"""Process-wide reliability counters.

Port of ``lightgbm_tpu/reliability/metrics.py``.  Every shed request, host
fallback, rollback and injected fault of the port increments a counter here;
the table surfaces as the ``reliability`` section of the JSON telemetry
report (``observability/schema.json``), so a post-mortem has the failure
accounting next to the performance accounting.

Deliberately global (one process = one failure domain): the serving server,
its clients and the fault points all feed the same table.  Thread-safe;
``rel_reset()`` exists for tests.
"""

from __future__ import annotations

import threading
from typing import Dict

_lock = threading.Lock()
_counters: Dict[str, int] = {}


def rel_inc(name: str, v: int = 1) -> None:
    """Increment reliability counter ``name`` by ``v``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(v)


def rel_get(name: str) -> int:
    with _lock:
        return _counters.get(name, 0)


def rel_counters() -> Dict[str, int]:
    """Snapshot of all counters."""
    with _lock:
        return dict(_counters)


def rel_reset() -> None:
    """Zero every counter (tests)."""
    with _lock:
        _counters.clear()


def reliability_section() -> Dict[str, Dict[str, int]]:
    """The ``reliability`` section attached to every telemetry report."""
    return {"counters": rel_counters()}
