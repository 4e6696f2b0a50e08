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

``TenantAdmission`` (JAX ``degrade.py:78-111``) puts one such bound per
tenant (model name) in front of the fleet gateway's device queue
(`serving/fleet/gateway.py`), so one hot tenant sheds while the others keep
admitting.
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


class TenantAdmission:
    """Per-tenant admission caps in front of the device queue.

    Lazily creates one ``AdmissionController`` per tenant under a leaf
    lock; acquire/release never hold the map lock across the tenant
    controller's own lock (both are leaves, taken one at a time)."""

    def __init__(self, capacity_per_tenant: int):
        self.capacity = max(int(capacity_per_tenant), 1)
        self._lock = threading.Lock()
        self._tenants: Dict[str, AdmissionController] = {}

    def controller(self, name: str) -> AdmissionController:
        with self._lock:
            ctl = self._tenants.get(name)
            if ctl is None:
                ctl = AdmissionController(self.capacity)
                self._tenants[name] = ctl
            return ctl

    def try_acquire(self, name: str) -> bool:
        return self.controller(name).try_acquire()

    def release(self, name: str) -> None:
        self.controller(name).release()

    def inflight(self, name: str) -> int:
        return self.controller(name).inflight

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            tenants = dict(self._tenants)
        return {"tenant_capacity": self.capacity,
                "tenants": {n: c.snapshot() for n, c in tenants.items()}}
