"""Serving graceful degradation: bounded admission with load shedding.

Port of the ``AdmissionController`` of
``lightgbm_tpu/reliability/degrade.py``, unchanged in logic.  Under
synthetic or real overload the serving layer must keep every connection
alive and every response structured — shed requests get an
immediate ``{"ok": False, "error": "overloaded", "shed": True}`` frame
instead of queueing until their client times out (which looks like a
dropped connection from the outside).  The ``AdmissionController`` is the
bound: at most ``capacity`` requests may be between admission and
response at once; request ``capacity + 1`` is shed in O(1) without
touching the device queue.

The controller also feeds the health probe: ``snapshot()`` reports
inflight/capacity/shedding so ``{"op": "health"}`` stays accurate while
the server is saturated (it IS alive and ready — just shedding).

The JAX package's per-tenant caps (``TenantAdmission``) serve its fleet
gateway and come with the serving fleet (ROADMAP.md Queue A, "serving and
lifecycle").
"""

from __future__ import annotations

import threading
from typing import Any, Dict

from .metrics import rel_inc


class AdmissionController:
    """Thread-safe bounded admission counter with shed accounting."""

    def __init__(self, capacity: int):
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._inflight = 0
        self._shed = 0
        self._admitted = 0

    def try_acquire(self) -> bool:
        """Admit one request, or refuse (shed) when at capacity."""
        with self._lock:
            if self._inflight >= self.capacity:
                self._shed += 1
                rel_inc("serve.requests_shed")
                return False
            self._inflight += 1
            self._admitted += 1
            return True

    def release(self) -> None:
        with self._lock:
            self._inflight = max(self._inflight - 1, 0)

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    @property
    def shed_total(self) -> int:
        with self._lock:
            return self._shed

    def snapshot(self) -> Dict[str, Any]:
        """Health-probe view: current load and whether admission is
        refusing new work right now."""
        with self._lock:
            return {"inflight": self._inflight,
                    "capacity": self.capacity,
                    "shedding": self._inflight >= self.capacity,
                    "shed_total": self._shed,
                    "admitted_total": self._admitted}
