"""Refit budget: rate limits for autonomous model refits.

Port of ``lightgbm_tpu/lifecycle/budget.py``, the same vetoes in the same
order.  An autopilot that refits whenever drift looks sustained can still
melt a fleet: a permanently drifted verdict would trigger a refit at every
check and the serving host would train instead of serve.  ``RefitBudget``
is the one gate every autopilot cycle passes:

  * **concurrency**: one cycle at a time; a second trigger while one runs
    is suppressed (``concurrent_refit``), never queued;
  * **cooldown after rollback**: a cycle that ended in a rollback freezes
    refits for ``cooldown_s`` (``cooldown``);
  * **min spacing**: at least ``min_spacing_s`` between starts
    (``min_spacing``);
  * **window cap**: at most ``max_refits_per_window`` starts inside any
    rolling ``window_s`` span, failed cycles included
    (``window_exhausted``).

The budget never blocks: ``try_begin`` admits the cycle or returns the
machine-readable reason.  Host bookkeeping under one leaf lock on
``time.monotonic``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

__all__ = ["RefitBudget"]


class RefitBudget:
    """Admission control for autopilot refit cycles (see module doc)."""

    def __init__(self, max_refits_per_window: int = 4,
                 window_s: float = 3600.0,
                 min_spacing_s: float = 60.0,
                 cooldown_s: float = 300.0):
        self.max_refits_per_window = max(int(max_refits_per_window), 1)
        self.window_s = float(window_s)
        self.min_spacing_s = float(min_spacing_s)
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._starts: list = []          # monotonic stamps, newest last
        self._last_start: Optional[float] = None
        self._cooldown_until = 0.0
        self._active = False
        self._admitted = 0
        self._suppressed: Dict[str, int] = {}

    # -- admission -----------------------------------------------------

    def try_begin(self) -> Tuple[bool, str]:
        """Admit one refit cycle or return ``(False, reason)``.

        On success the caller OWNS the budget's concurrency slot and
        must call :meth:`end` exactly once, however the cycle ends.
        """
        now = time.monotonic()
        with self._lock:
            reason = self._veto(now)
            if reason:
                self._suppressed[reason] = self._suppressed.get(reason, 0) + 1
                return False, reason
            self._active = True
            self._last_start = now
            self._starts.append(now)
            self._admitted += 1
            return True, ""

    def _veto(self, now: float) -> str:
        """Reason the cycle must not start, or '' — caller holds the
        lock."""
        if self._active:
            return "concurrent_refit"
        if now < self._cooldown_until:
            return "cooldown"
        if self._last_start is not None and \
                now - self._last_start < self.min_spacing_s:
            return "min_spacing"
        self._starts = [t for t in self._starts
                        if now - t < self.window_s]
        if len(self._starts) >= self.max_refits_per_window:
            return "window_exhausted"
        return ""

    def end(self, rolled_back: bool = False) -> None:
        """Release the concurrency slot; a rollback arms the cooldown."""
        with self._lock:
            self._active = False
            if rolled_back:
                self._cooldown_until = time.monotonic() + self.cooldown_s

    def note_rollback(self) -> None:
        """An out-of-band rollback (operator, watchdog) also cools the
        autopilot down — the serving window just proved hostile."""
        with self._lock:
            self._cooldown_until = time.monotonic() + self.cooldown_s

    # -- introspection -------------------------------------------------

    def section(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            in_window = len([t for t in self._starts
                             if now - t < self.window_s])
            return {
                "max_refits_per_window": self.max_refits_per_window,
                "window_s": self.window_s,
                "min_spacing_s": self.min_spacing_s,
                "cooldown_s": self.cooldown_s,
                "refits_in_window": in_window,
                "admitted": self._admitted,
                "active": self._active,
                "in_cooldown": now < self._cooldown_until,
                "suppressed": dict(self._suppressed),
            }
