"""Host-side telemetry accumulator and the report's provenance block.

Port of ``lightgbm_tpu/observability/telemetry.py``: the ``Telemetry``
accumulator (host wall-clock phase timers, counters, gauges) and the JSON
report it builds, which validates against ``schema.json``.  The serving
layer times its stages through it (``serving/batcher.py:ServingStats``).
Training keeps refusing ``telemetry=true`` until ROADMAP.md Queue A,
"reliability and training observability", wires it into the boosting loop
with the learner's device counters and the per-iteration timings; until
then a report's required ``iterations`` block counts none.

Where the JAX module asks ``jax.devices()``, this one asks ``torch.cuda``:
``provenance_section`` reports the serving device's platform (``gpu`` on a
CUDA device, ``cpu`` otherwise) and ``memory_watermarks`` the caching
allocator's peaks, neither of which synchronizes the device.
"""

from __future__ import annotations

import contextlib
import time
import tracemalloc
from typing import Any, Dict, List, Optional

#: the version of ``schema.json`` (the JAX package's history of it is in
#: ``lightgbm_tpu/observability/telemetry.py``): v11 = required provenance
#: with ``cost_ledger_sha256``, optional serving / reliability / lifecycle /
#: drift / distributed sections
SCHEMA_VERSION = 11


def provenance_section(device=None) -> Dict[str, Any]:
    """The required ``provenance`` block: what hardware and software
    produced this report.  ``device`` is the torch device the reported
    work ran on: ``platform`` is ``gpu`` for a CUDA device and ``cpu``
    otherwise, and ``emulated`` is true unless it is a CUDA device, so a
    CPU number can never pass for a card's.  The schema requires
    ``jax_version``; the port writes ``"none"``.  It has no cost ledger
    (``cost_ledger_sha256`` null)."""
    import torch

    cuda = device is not None and torch.device(device).type == "cuda"
    return {
        "platform": "gpu" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(torch.device(device))
        if cuda else "cpu",
        "jax_version": "none",
        "torch_version": str(torch.__version__),
        "num_devices": int(torch.cuda.device_count()) if cuda else 1,
        "num_hosts": 1, "process_index": 0, "emulated": not cuda,
        "mesh_shape": None, "cost_ledger_sha256": None,
    }


def memory_watermarks() -> Dict[str, Any]:
    """Peak device memory of every CUDA device this process initialized
    (the caching allocator's statistics: no device synchronization, no
    CUDA initialization) and the process tracemalloc snapshot when the
    caller has tracing on."""
    import torch

    devices = []
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            st = torch.cuda.memory_stats(i)
            if not st:
                continue
            devices.append({
                "device": f"cuda:{i}",
                "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
                "bytes_in_use": int(torch.cuda.memory_allocated(i)),
                "bytes_limit": int(
                    torch.cuda.get_device_properties(i).total_memory),
            })
    host = None
    if tracemalloc.is_tracing():
        cur, peak = tracemalloc.get_traced_memory()
        host = {"current_bytes": int(cur), "peak_bytes": int(peak)}
    return {"devices": devices, "host_heap": host}


class Telemetry:
    """Accumulates phases / counters / gauges and builds the JSON report."""

    def __init__(self, enabled: bool, device=None):
        self.enabled = bool(enabled)
        #: the torch device the reported work runs on (provenance)
        self.device = device
        # optional span recorder (observability/trace.py): when attached,
        # every phase occurrence that carries a start stamp also lands as
        # a trace span, so the Perfetto timeline and the phase table are
        # two views of the same measurements
        self.tracer = None
        self._phases: Dict[str, List[float]] = {}  # name -> [sum_s, n, max_s]
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, Any] = {}
        self._phase_heap: Dict[str, int] = {}      # name -> peak bytes
        self._heap_stack: List[int] = []

    # -- phases --------------------------------------------------------------

    def phase(self, name: str):
        """Context manager timing one phase occurrence (no-op when
        disabled)."""
        if not self.enabled:
            return contextlib.nullcontext()
        return _PhaseCtx(self, name)

    def add_phase_time(self, name: str, seconds: float,
                       t0: Optional[float] = None) -> None:
        """Accumulate one phase occurrence.  ``t0`` (a ``perf_counter``
        stamp) additionally records the occurrence as a trace span when a
        recorder is attached."""
        if not self.enabled:
            return
        st = self._phases.setdefault(name, [0.0, 0, 0.0])
        st[0] += seconds
        st[1] += 1
        st[2] = max(st[2], seconds)
        tr = self.tracer
        if tr is not None and t0 is not None:
            tr.add_complete(name, t0, seconds, cat="phase")

    # -- host-heap watermarks (per phase) ------------------------------------
    # tracemalloc's peak is global-since-start; per-phase window peaks use
    # reset_peak() with explicit propagation to the enclosing phase.  Only
    # active when the user already turned tracemalloc on.

    def _heap_enter(self) -> None:
        if not tracemalloc.is_tracing():
            return
        tracemalloc.reset_peak()
        self._heap_stack.append(0)

    def _heap_exit(self, name: str) -> None:
        if not self._heap_stack or not tracemalloc.is_tracing():
            return
        wpeak = max(tracemalloc.get_traced_memory()[1],
                    self._heap_stack.pop())
        self._phase_heap[name] = max(self._phase_heap.get(name, 0),
                                     int(wpeak))
        if self._heap_stack:
            self._heap_stack[-1] = max(self._heap_stack[-1], wpeak)
        tracemalloc.reset_peak()

    # -- counters / gauges ---------------------------------------------------

    def inc(self, name: str, v: int = 1) -> None:
        if self.enabled:
            self._counters[name] = self._counters.get(name, 0) + int(v)

    def gauge(self, name: str, v: Any) -> None:
        if self.enabled:
            self._gauges[name] = v

    # -- report --------------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        counters = dict(self._counters)
        gauges = dict(self._gauges)
        phases = {
            name: {"total_ms": st[0] * 1e3, "count": st[1],
                   "max_ms": st[2] * 1e3}
            for name, st in self._phases.items()}
        # no boosting iteration is timed here yet (training telemetry)
        it = {"count": 0, "total_ms": 0.0, "mean_ms": 0.0, "last_ms": 0.0}
        mem = memory_watermarks()
        if self._phase_heap:
            mem["phase_heap_peak_bytes"] = dict(self._phase_heap)
        # failure accounting travels with every report (process-wide)
        from ..reliability.metrics import reliability_section
        return {"schema_version": SCHEMA_VERSION, "enabled": self.enabled,
                "phases": phases, "iterations": it, "counters": counters,
                "gauges": gauges,
                # no collective runs in a one-card process: no sites
                "collectives": {"sites": [],
                                "per_tree_estimate": {"count": None,
                                                      "bytes": None},
                                "saved_by_stall_batching": 0},
                "provenance": provenance_section(self.device),
                "distributed": {"memory": mem},
                "reliability": reliability_section()}


class _PhaseCtx:
    __slots__ = ("tel", "name", "t0")

    def __init__(self, tel: Telemetry, name: str):
        self.tel = tel
        self.name = name

    def __enter__(self):
        self.tel._heap_enter()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.tel.add_phase_time(self.name, time.perf_counter() - self.t0,
                                t0=self.t0)
        self.tel._heap_exit(self.name)
        return False
