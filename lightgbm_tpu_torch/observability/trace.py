"""Request-scoped structured tracing: spans -> Chrome trace-event JSON.

Port of ``lightgbm_tpu/observability/trace.py``.  A ``TraceRecorder`` is a
thread-safe monotonic-clock ring buffer of completed spans that exports the
Chrome trace-event format: load the file in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing`` and every span nests under
its thread track.

  * **Host-only.**  Spans time host-visible stages (the serving queue /
    pad / bin / traverse / unpad stages); recording a span never
    synchronizes the device.
  * **Monotonic clocks only** (``time.perf_counter``).
  * **Bounded.**  Completed spans land in a ``deque(maxlen=capacity)``; a
    long-lived server overwrites its oldest spans (``dropped_spans`` in
    the export counts the loss).
  * **Zero overhead when off.**  A disabled recorder's ``span()`` returns
    a shared ``nullcontext`` and every record call returns immediately.

Causal linkage: serving requests carry a ``trace_id`` (client-supplied or
server-generated) end to end: the per-request span, the micro-batch span
that coalesced it and the batch's stage spans all carry the id in their
``args``.  ``bind()`` is the thread-local propagation: spans recorded while
a bind is active inherit the bound id, which is how the batch worker's
stage spans pick up the ids of the requests riding the batch.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Union

#: shared no-op context for disabled recorders (allocation-free hot path)
_NULL_CTX = contextlib.nullcontext()

#: trace ids are opaque strings; span records may carry one id or a list
TraceId = Union[str, List[str]]


def new_trace_id() -> str:
    """A fresh opaque request id (8 random bytes, hex)."""
    return os.urandom(8).hex()


# -- process-global recorder registry ----------------------------------------
# A dataset is built (and a streamed one read chunk by chunk) before the
# training GBDT, and so its Telemetry, exists; the streaming loader's spans
# reach the run's recorder through this registration point (JAX
# ``trace.py:63-80``).  ``engine.train`` registers its recorder before it
# builds the Booster and clears it on return.

_global_tracer: Optional["TraceRecorder"] = None


def set_global_tracer(tracer: Optional["TraceRecorder"]) -> None:
    """Register (or clear, with ``None``) the process-wide recorder."""
    global _global_tracer
    _global_tracer = tracer


def get_global_tracer() -> Optional["TraceRecorder"]:
    """The registered recorder, or None — callers must null-check."""
    return _global_tracer


class TraceRecorder:
    """Thread-safe ring buffer of completed spans + Chrome JSON export."""

    def __init__(self, enabled: bool = True, capacity: int = 65536):
        self.enabled = bool(enabled)
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=self.capacity)
        self._total = 0                     # spans ever recorded
        self._tls = threading.local()
        # the trace epoch: every exported ts is relative to this, in µs.
        # perf_counter matches the clock Telemetry._PhaseCtx stamps t0
        # with, so stage spans and explicit spans share one timeline.
        self._epoch = time.perf_counter()
        # export metadata (rank, clock offsets) merged into ``otherData``,
        # where the pod-trace merge reads it
        self._metadata: Dict[str, Any] = {}

    @property
    def epoch(self) -> float:
        """The ``perf_counter`` stamp every exported ts is relative to."""
        return self._epoch

    def set_metadata(self, **kw: Any) -> None:
        """Attach export metadata (it lands in ``otherData``): a pod rank's
        rank, process count and clock handshake ride here, so
        ``podtrace.merge_pod_trace`` puts every rank on one timeline."""
        self._metadata.update(kw)

    # -- thread-local trace-id binding ---------------------------------------

    def bind(self, trace_id: Optional[TraceId]):
        """Context manager: spans recorded on this thread while the bind
        is active default their ``trace_id`` to ``trace_id``.  Binds
        nest; ``None`` is a no-op bind."""
        if not self.enabled or trace_id is None:
            return _NULL_CTX
        return _BindCtx(self._tls, trace_id)

    def bound_id(self) -> Optional[TraceId]:
        return getattr(self._tls, "trace_id", None)

    # -- recording -----------------------------------------------------------

    def span(self, name: str, cat: str = "span",
             trace_id: Optional[TraceId] = None,
             args: Optional[Dict[str, Any]] = None):
        """Context manager recording one span on exit (no-op when
        disabled)."""
        if not self.enabled:
            return _NULL_CTX
        return _SpanCtx(self, name, cat, trace_id, args)

    def add_complete(self, name: str, t0: float, dur_s: float,
                     cat: str = "span", trace_id: Optional[TraceId] = None,
                     args: Optional[Dict[str, Any]] = None) -> None:
        """Record an already-timed span.  ``t0`` is a ``perf_counter``
        stamp (the clock the recorder's epoch is on); ``dur_s`` seconds."""
        if not self.enabled:
            return
        if trace_id is None:
            trace_id = self.bound_id()
        th = threading.current_thread()
        rec = (name, cat, float(t0), max(float(dur_s), 0.0),
               th.ident, th.name, trace_id, args, "span")
        with self._lock:
            self._total += 1
            self._spans.append(rec)

    def instant(self, name: str, cat: str = "instant",
                trace_id: Optional[TraceId] = None,
                args: Optional[Dict[str, Any]] = None) -> None:
        """Record a zero-duration annotation event."""
        if not self.enabled:
            return
        if trace_id is None:
            trace_id = self.bound_id()
        th = threading.current_thread()
        rec = (name, cat, time.perf_counter(), 0.0,
               th.ident, th.name, trace_id, args, "instant")
        with self._lock:
            self._total += 1
            self._spans.append(rec)

    # -- introspection -------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    @property
    def dropped(self) -> int:
        """Spans overwritten by ring wrap."""
        with self._lock:
            return self._total - len(self._spans)

    def spans(self) -> List[tuple]:
        """Snapshot of the raw span records (oldest first)."""
        with self._lock:
            return list(self._spans)

    # -- Chrome trace-event export -------------------------------------------

    def export(self) -> Dict[str, Any]:
        """The trace as a Chrome trace-event JSON object: every span
        becomes a B/E pair on its thread's track (instants become "i"
        events), timestamps in µs relative to the recorder epoch.  Loads
        directly in Perfetto / ``chrome://tracing``."""
        with self._lock:
            recs = list(self._spans)
            dropped = self._total - len(recs)
        pid = os.getpid()
        tid_map: Dict[int, int] = {}
        tid_names: Dict[int, str] = {}
        events: List[tuple] = []            # (sort_key, event_dict)
        for name, cat, t0, dur, ident, tname, trace_id, args, kind in recs:
            tid = tid_map.setdefault(ident, len(tid_map) + 1)
            tid_names.setdefault(tid, tname)
            a: Dict[str, Any] = dict(args or {})
            if trace_id is not None:
                a["trace_id"] = trace_id
            ts = (t0 - self._epoch) * 1e6
            if kind == "instant":
                events.append(((ts, 2, 0.0), {
                    "name": name, "cat": cat, "ph": "i", "s": "t",
                    "ts": ts, "pid": pid, "tid": tid,
                    **({"args": a} if a else {})}))
                continue
            te = ts + dur * 1e6
            # tie-breaks keep pairs well-nested: at equal ts a parent's B
            # (longer span) precedes its child's, a child's E (shorter)
            # precedes its parent's, and any E precedes a sibling's B
            events.append(((ts, 1, -dur), {
                "name": name, "cat": cat, "ph": "B", "ts": ts,
                "pid": pid, "tid": tid, **({"args": a} if a else {})}))
            events.append(((te, 0, dur), {
                "name": name, "cat": cat, "ph": "E", "ts": te,
                "pid": pid, "tid": tid}))
        events.sort(key=lambda e: e[0])
        meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": tname}}
                for tid, tname in sorted(tid_names.items())]
        other: Dict[str, Any] = {"dropped_spans": dropped,
                                 "clock": "perf_counter",
                                 "spans_recorded": self._total}
        other.update(self._metadata)
        return {"traceEvents": meta + [e for _, e in events],
                "displayTimeUnit": "ms",
                "otherData": other}

    def save(self, path: str) -> None:
        """Atomic (tmp + ``os.replace``) write of the exported trace."""
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.export(), fh)
            fh.write("\n")
        os.replace(tmp, path)


class _BindCtx:
    __slots__ = ("tls", "trace_id", "prev")

    def __init__(self, tls, trace_id):
        self.tls = tls
        self.trace_id = trace_id

    def __enter__(self):
        self.prev = getattr(self.tls, "trace_id", None)
        self.tls.trace_id = self.trace_id
        return self

    def __exit__(self, *exc):
        self.tls.trace_id = self.prev
        return False


class _SpanCtx:
    __slots__ = ("rec", "name", "cat", "trace_id", "args", "t0")

    def __init__(self, rec, name, cat, trace_id, args):
        self.rec = rec
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.args = args

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.rec.add_complete(self.name, self.t0,
                              time.perf_counter() - self.t0, cat=self.cat,
                              trace_id=self.trace_id, args=self.args)
        return False
