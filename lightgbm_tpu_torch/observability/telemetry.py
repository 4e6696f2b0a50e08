"""Host-side telemetry accumulator and the report's provenance block.

Port of ``lightgbm_tpu/observability/telemetry.py``: the ``Telemetry``
accumulator (host wall-clock phase timers, counters, gauges, the iteration
ring behind the report's ``iterations`` block, the per-tree device counter
lane) and the JSON report it builds, which validates against
``schema.json``.  The serving layer times its stages through it
(``serving/batcher.py:ServingStats``); training (``telemetry=true``) times
the boosting loop's phases (``boosting/gbdt.py``) and feeds the learners'
per-tree counters.

The device counter lane.  The JAX wave learner carries a counter vector
through its tree program (``TEL_*``); the port's learners count on the
device per tree and read the counts with the records, so ``device_telem``
takes each tree's decoded ``tree_stats`` entry and ``device_counters``
maps them onto the report's names.  From the wave learner: ``waves`` (its
device count of waves and opening levels that split), ``stall_splits``,
``stall_events``, and, with telemetry on, ``grow_splits`` and
``total_splits`` (the split count after growth and after the replay's
corrections, read with the records only then, so a run without telemetry
does the parent's device work); ``pops`` is the valid records and
``stall_extras`` is ``stall_splits - stall_events``, as the JAX package
derives the events.  The compact learner reports the splits it took
(``total_splits``, ``grow_splits`` and ``pops`` alike).  ``wave_sorts``,
``wave_members``, ``frozen_members`` and ``stall_sort_mode`` have no
counterpart in the port's flow (every growth wave partitions, and no
learner counts its members on the device), so they are absent from the
report rather than 0; so is every name a learner does not report.

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

#: the JAX package's per-tree device counter names (``TEL_NAMES``)
TEL_NAMES = ("waves", "wave_sorts", "wave_members", "frozen_members",
             "grow_splits", "stall_splits", "stall_extras",
             "stall_sort_mode", "pops", "total_splits")
#: the ``tree_stats`` entries summed into the device counters: the names
#: above the port's learners report, and the wave learner's own
_DEVICE_KEYS = ("waves", "grow_splits", "stall_splits", "pops",
                "total_splits", "stall_events", "replay_passes",
                "open_levels")

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
    (``cost_ledger_sha256`` null).  ``num_hosts`` and ``process_index``
    are the pod's hosts and this host's index (``multihost.host_layout``).
    """
    import torch

    from ..parallel.multihost import host_layout
    cuda = device is not None and torch.device(device).type == "cuda"
    num_hosts, host_index, _ = host_layout()
    return {
        "platform": "gpu" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(torch.device(device))
        if cuda else "cpu",
        "jax_version": "none",
        "torch_version": str(torch.__version__),
        "num_devices": int(torch.cuda.device_count()) if cuda else 1,
        "num_hosts": int(num_hosts), "process_index": int(host_index),
        "emulated": not cuda,
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
        self._iter_wall: List[float] = []          # bounded ring, seconds
        self._iter_total = 0.0
        self._iter_count = 0
        self._device_totals: Dict[str, int] = {}
        self._device_trees = 0
        self._provenance_extra: Dict[str, Any] = {}
        self._distributed: Dict[str, Any] = {}
        self._elastic: Dict[str, Any] = {}

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
        if name == "iteration":
            self._iter_total += seconds
            self._iter_count += 1
            self._iter_wall.append(seconds)
            if len(self._iter_wall) > 512:
                del self._iter_wall[:256]

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

    # -- provenance / distributed extras -------------------------------------

    def set_provenance(self, **kw: Any) -> None:
        """Merge facts the loop knows (tree_learner, learner) into the
        report's ``provenance`` block."""
        if self.enabled:
            self._provenance_extra.update(kw)

    def set_distributed(self, **kw: Any) -> None:
        """Merge facts into the report's ``distributed`` section (the
        sampling period, the profiler parse, a pod's process count and
        index, rank step times, skew and clock handshake)."""
        if self.enabled:
            self._distributed.update(kw)

    def set_elastic(self, **kw: Any) -> None:
        """Merge elastic-pod facts (membership epoch, member count, the
        recoveries) into the report's optional ``elastic`` section."""
        if self.enabled:
            self._elastic.update(kw)

    # -- device counter lane -------------------------------------------------

    def device_telem(self, stats: Optional[Dict[str, int]]) -> None:
        """Add one tree's decoded counters (a learner's ``tree_stats``
        entry, host integers read with the records)."""
        if not self.enabled or stats is None:
            return
        for k in _DEVICE_KEYS:
            if k in stats:
                self._device_totals[k] = \
                    self._device_totals.get(k, 0) + int(stats[k])
        self._device_trees += 1

    def device_counters(self) -> Dict[str, int]:
        """The device counters the learners reported (see the module
        docstring: absent names have no counterpart), ``trees_measured``
        and the derived ``stall_extras`` and ``sim_passes``."""
        out = dict(self._device_totals)
        out["trees_measured"] = self._device_trees
        if "stall_splits" in out and "stall_events" in out:
            # every correction event splits one stalled top; the rest of
            # its splits are speculative extras
            out["stall_extras"] = out["stall_splits"] - out["stall_events"]
            out["sim_passes"] = out["stall_events"] + self._device_trees
        return out

    # -- report --------------------------------------------------------------

    def report(self, extra_gauges: Optional[Dict] = None,
               ledger=None, transport: Optional[str] = None
               ) -> Dict[str, Any]:
        """The JSON report; ``ledger`` is the sharded learner's
        ``CollectiveLedger`` and ``transport`` how its collectives travel
        (``Mesh.transport``; None: no collective ran)."""
        counters = dict(self._counters)
        counters.update(self.device_counters())
        gauges = dict(self._gauges)
        if extra_gauges:
            gauges.update(extra_gauges)
        phases = {
            name: {"total_ms": st[0] * 1e3, "count": st[1],
                   "max_ms": st[2] * 1e3}
            for name, st in self._phases.items()}
        it = {
            "count": self._iter_count,
            "total_ms": self._iter_total * 1e3,
            "mean_ms": (self._iter_total / self._iter_count * 1e3
                        if self._iter_count else 0.0),
            "last_ms": (self._iter_wall[-1] * 1e3
                        if self._iter_wall else 0.0),
        }
        dist: Dict[str, Any] = dict(self._distributed)
        from .attribution import attribution_table
        table = attribution_table(phases)
        if table is not None:
            dist["attribution"] = table
        mem = memory_watermarks()
        if self._phase_heap:
            mem["phase_heap_peak_bytes"] = dict(self._phase_heap)
        dist["memory"] = mem
        prov = provenance_section(self.device)
        prov.update({k: v for k, v in self._provenance_extra.items()
                     if v is not None})
        # failure accounting travels with every report (process-wide)
        from ..reliability.metrics import reliability_section
        rep = {"schema_version": SCHEMA_VERSION, "enabled": self.enabled,
               "phases": phases, "iterations": it, "counters": counters,
               "gauges": gauges,
               "collectives": self._collectives(ledger, counters,
                                                transport),
               "provenance": prov,
               "distributed": dist,
               "reliability": reliability_section()}
        if self._elastic:
            rep["elastic"] = dict(self._elastic)
        return rep


    @staticmethod
    def _collectives(ledger, counters: Dict[str, int],
                     transport: Optional[str] = None) -> Dict[str, Any]:
        """The sites the sharded learner's seams recorded and the
        collectives and bytes it issued per tree: counted, where the JAX
        package multiplies traced sites by decoded counters.  A serial run
        has no sites."""
        sites = list(ledger.sites()) if ledger is not None else []
        trees = counters.get("trees_measured", 0)
        per_tree = {"count": None, "bytes": None}
        if sites and trees:
            per_tree = {"count": ledger.calls / trees,
                        "bytes": ledger.bytes / trees}
        out = {"sites": sites, "per_tree_estimate": per_tree,
               "saved_by_stall_batching": counters.get("stall_extras", 0)}
        if transport is not None:
            out["transport"] = transport
        return out


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
