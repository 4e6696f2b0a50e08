"""Bounded ring recorder for live serving traffic.

Port of ``lightgbm_tpu/lifecycle/recorder.py``.  The prediction server
copies each admitted request's feature rows into a fixed-size ring
(`serving/server.py` ``predict`` op, ``record_rows``), so memory stays
bounded however long the server runs and the newest ``capacity`` rows are
always available for replay: the shadow validation
(`lifecycle/shadow.py`) and the drift monitor (`observability/drift.py`)
read it.

Disabled (capacity 0, the default) the recorder is a single attribute
check on the request path; recording is one bounded ``ndarray`` copy
under a leaf lock (never held across a device call).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np

from ..reliability.metrics import rel_inc


class TrafficRecorder:
    """Fixed-capacity row ring: ``record`` overwrites oldest-first."""

    def __init__(self, capacity_rows: int = 0):
        self.capacity = max(int(capacity_rows), 0)
        self.enabled = self.capacity > 0
        self._lock = threading.Lock()
        self._buf: Optional[np.ndarray] = None   # (capacity, F), lazy
        self._next = 0          # next write slot
        self._size = 0          # valid rows
        self.total_rows = 0     # ever recorded (ring overwrites past this)
        self.skipped_rows = 0   # wrong-width requests, never recorded

    def record(self, X: np.ndarray) -> None:
        """Copy the rows of one request into the ring (no-op when
        disabled).  A request whose feature width disagrees with the
        first recorded one is counted and skipped — a recording must
        stay a rectangular matrix the replay can score."""
        if not self.enabled:
            return
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        with self._lock:
            if self._buf is None:
                self._buf = np.zeros((self.capacity, X.shape[1]), np.float64)
            if X.shape[1] != self._buf.shape[1]:
                self.skipped_rows += int(X.shape[0])
                rel_inc("lifecycle.record_width_mismatch_rows", X.shape[0])
                return
            n = X.shape[0]
            if n >= self.capacity:
                # one request larger than the whole ring: keep its tail
                self._buf[:] = X[n - self.capacity:]
                self._next = 0
                self._size = self.capacity
            else:
                end = self._next + n
                if end <= self.capacity:
                    self._buf[self._next:end] = X
                else:
                    k = self.capacity - self._next
                    self._buf[self._next:] = X[:k]
                    self._buf[:end - self.capacity] = X[k:]
                self._next = end % self.capacity
                self._size = min(self._size + n, self.capacity)
            self.total_rows += int(n)

    def __len__(self) -> int:
        with self._lock:
            return self._size

    def snapshot(self) -> np.ndarray:
        """The recorded rows, oldest first, as an owned ``(n, F)`` copy
        (empty ``(0, 0)`` when nothing was recorded)."""
        with self._lock:
            if self._buf is None or self._size == 0:
                return np.zeros((0, 0), np.float64)
            if self._size < self.capacity:
                return self._buf[:self._size].copy()
            # full ring: unroll so row order is oldest -> newest
            return np.concatenate([self._buf[self._next:],
                                   self._buf[:self._next]], axis=0)

    def drain(self) -> np.ndarray:
        """``snapshot()`` that also empties the ring (capacity and width
        are kept), so consecutive drift checks judge DISJOINT traffic
        windows instead of re-scoring overlapping rows.  ``total_rows``
        keeps counting monotonically across drains."""
        with self._lock:
            if self._buf is None or self._size == 0:
                return np.zeros((0, 0), np.float64)
            if self._size < self.capacity:
                out = self._buf[:self._size].copy()
            else:
                out = np.concatenate([self._buf[self._next:],
                                      self._buf[:self._next]], axis=0)
            self._next = 0
            self._size = 0
            return out

    def section(self) -> Dict[str, Any]:
        """The ``lifecycle.recorder`` report fragment."""
        with self._lock:
            return {"capacity": self.capacity,
                    "rows": int(self._size),
                    "total_rows": int(self.total_rows),
                    "skipped_rows": int(self.skipped_rows)}
