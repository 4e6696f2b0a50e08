"""Runtime phase attribution of training: sampled syncs and the profiler.

Port of ``lightgbm_tpu/observability/attribution.py``.  The phase table
(``telemetry.py``) times host-visible windows; on the card most of a
tree's work is queued, not done, when its host window closes.  Two
mechanisms say where device time goes:

  * **Sampled-sync timer** (``telemetry_sync_every=N``): every Nth
    iteration the boosting loop drains the queue, then brackets each leg
    of the iteration (gradients, tree build, score update) with a forced
    device sync, landing ``sync.*`` phases whose per-leg means sum to the
    synced iteration wall (``attribution_table``'s ``coverage``).  N-1 of
    every N iterations stay fully asynchronous.  ``force_sync`` is
    ``torch.cuda.synchronize`` on the tensors' card (a CPU tensor is ready
    when its op returns).
  * **Profiler capture and parse** (``profile_trace_dir``): ``engine.train``
    runs the loop under ``torch.profiler`` and writes its Chrome trace
    there; ``parse_profiler_trace`` maps the device events to the legs
    ``hist``, ``scan``, ``partition``, ``replay`` and ``flush`` by the
    port's kernel names (``native.KERNEL_SYMBOLS`` and the windowed
    partition's kernels), every other kernel (PyTorch's own) to
    ``other``.

  * **Exchange-window probe** (``SampledSync.probe_exchange``, on the
    sampled iterations of a sharded run): the learner's representative
    collective (``exchange_probe``: the data axis's histogram
    reduce-scatter, feature parallel's winner all-gather) timed alone,
    best of three after a warm-up, as ``sync.exchange_probe`` and the
    ``exchange_probe_ms`` gauge.  The mesh also counts the host seconds of
    every collective the run issues (``parallel/sharding.py:Mesh.seconds``).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import time
from typing import Any, Dict, List, Optional

#: legs the profiler parse speaks in
LEGS = ("hist", "scan", "partition", "replay", "flush")

#: sync.* phases that are not iteration legs: the iteration wall itself, the
#: pre-iteration queue drain and the exchange probe
_NON_LEG_SYNC = ("sync.iteration", "sync.drain", "sync.exchange_probe")

#: per-iteration host phases folded into the table so the leg sum tracks
#: the whole iteration wall (their global means estimate their share of a
#: sampled one); ``tree_train`` is the synchronous loop's tree build
_HOST_LEGS = ("bagging", "tree_dispatch", "score_update",
              "pipeline_flush", "tree_assemble", "tree_train")

#: host phases whose window is a prefix of a sync leg's [dispatch,
#: completion] window: counting both would count the dispatch twice
_HOST_SHADOWED = {"tree_dispatch": "sync.tree_build",
                  "score_update": "sync.score_update",
                  "tree_train": "sync.tree_train"}


def force_sync(*tensors: Any) -> None:
    """Block until the work behind every CUDA tensor is done (one
    ``torch.cuda.synchronize`` per card they lie on)."""
    import torch

    devs = {t.device for t in tensors
            if isinstance(t, torch.Tensor) and t.is_cuda}
    for d in devs:
        torch.cuda.synchronize(d)


class SampledSync:
    """The boosting loop's sampled-sync bracket (``telemetry_sync_every``):
    ``sampled(iter_)`` is True on every Nth iteration; while ``active`` the
    loop calls ``leg`` after each leg to sync its outputs and record a
    ``sync.<name>`` phase."""

    def __init__(self, tel, every: int):
        self.tel = tel
        self.every = max(int(every), 0)
        self.active = False

    def sampled(self, iter_: int) -> bool:
        return self.every > 0 and self.tel.enabled \
            and (iter_ % self.every == 0)

    def leg(self, name: str, t0: float, tensors) -> None:
        """Sync ``tensors`` and record ``sync.<name>`` from ``t0`` to their
        completion."""
        if not self.active:
            return
        force_sync(*tensors)
        self.tel.add_phase_time(f"sync.{name}",
                                time.perf_counter() - t0, t0=t0)

    def probe_exchange(self, learner) -> None:
        """Time the learner's exchange probe (JAX `attribution.py:162-185`):
        best of three synced calls after one warm-up, recorded as
        ``sync.exchange_probe`` and the ``exchange_probe_ms`` gauge.  Every
        rank samples the same iterations, so the probe's collective is
        entered pod-wide together.  No-op for a learner without an
        exchange seam (the serial ones)."""
        probe = getattr(learner, "exchange_probe", None)
        if probe is None:
            return
        fn, args = probe()
        t0 = time.perf_counter()
        force_sync(fn(*args))
        best = float("inf")
        for _ in range(3):
            t = time.perf_counter()
            force_sync(fn(*args))
            best = min(best, time.perf_counter() - t)
        self.tel.add_phase_time("sync.exchange_probe",
                                time.perf_counter() - t0, t0=t0)
        self.tel.gauge("exchange_probe_ms", best * 1e3)

    def drain(self, *tensors: Any) -> None:
        """The queue drain before a bracketed iteration, so it measures only
        its own work (``sync.drain``, not a leg)."""
        t0 = time.perf_counter()
        force_sync(*tensors)
        self.tel.add_phase_time("sync.drain", time.perf_counter() - t0,
                                t0=t0)


def attribution_table(phases_ms: Dict[str, Dict[str, float]]
                      ) -> Optional[Dict[str, Any]]:
    """The per-leg table from a report's ``phases`` (``{name: {total_ms,
    count, max_ms}}``): every ``sync.<leg>`` over the sampled iterations,
    plus the per-iteration host phases at their own means.  ``coverage``
    is the leg sum over the synced iteration wall (|1 - coverage| <= 0.1
    is the bar).  None when no iteration was sampled."""
    it = phases_ms.get("sync.iteration")
    if not it or not it.get("count"):
        return None
    n = int(it["count"])
    wall_ms = it["total_ms"] / n
    legs: Dict[str, float] = {}
    for name, st in phases_ms.items():
        if not name.startswith("sync.") or name in _NON_LEG_SYNC:
            continue
        legs[name[len("sync."):]] = st["total_ms"] / n
    for name in _HOST_LEGS:
        if _HOST_SHADOWED.get(name) in phases_ms:
            continue
        st = phases_ms.get(name)
        if st and st.get("count"):
            legs[f"host.{name}"] = st["total_ms"] / st["count"]
    legs_sum = sum(legs.values())
    return {
        "sampled_iterations": n,
        "iteration_ms": wall_ms,
        "legs_ms": legs,
        "legs_sum_ms": legs_sum,
        "coverage": (legs_sum / wall_ms) if wall_ms > 0 else 0.0,
        "unattributed_ms": wall_ms - legs_sum,
        "exchange_probe_ms": None,
    }


# -- torch.profiler capture and parse ---------------------------------------

#: device event name -> leg, first match wins: the port's kernels by name
#: (``csrc/*.cu``), the records' device-to-host copies
_LEG_PATTERNS = [
    ("hist", re.compile(r"hist_(packed|segments|multislot|full)")),
    ("scan", re.compile(r"split_scan|fused_child_scan|split_cat")),
    ("partition", re.compile(r"partition_(rows|window)")),
    ("replay", re.compile(r"replay_pass")),
    ("flush", re.compile(r"[Mm]emcpy DtoH|[Mm]emcpy D2H")),
]
#: the Chrome-trace categories of device work (torch.profiler with CUDA)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the file ``engine.train`` writes under ``profile_trace_dir``
TRACE_NAME = "train.pt.trace.json"


def leg_of(name: str) -> str:
    """The leg a device event's name belongs to (``other`` for none)."""
    for leg, pat in _LEG_PATTERNS:
        if pat.search(name):
            return leg
    return "other"


def _trace_files(trace_dir: str) -> List[str]:
    out: List[str] = []
    for pat in ("*.trace.json.gz", "*.trace.json"):
        out.extend(glob.glob(os.path.join(trace_dir, "**", pat),
                             recursive=True))
    return sorted(out, key=os.path.getmtime)


def parse_profiler_trace(trace_dir: str, top_k: int = 20
                         ) -> Optional[Dict[str, Any]]:
    """Map the newest Chrome trace under ``trace_dir`` to the legs: its
    device events where it has any (a CUDA run), else every complete
    event (a CPU run, whose plain versions are all ``other``).  Returns the
    source, event count, total and per-leg milliseconds, the top events
    and the leg of every distinct event name (``names``); None when the
    directory holds no readable trace with events."""
    files = _trace_files(trace_dir)
    if not files:
        return None
    path = files[-1]
    try:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return None
    events = [ev for ev in data.get("traceEvents", [])
              if ev.get("ph") == "X" and "dur" in ev]
    device = [ev for ev in events if ev.get("cat") in _DEVICE_CATS]
    events = device or events
    if not events:
        return None
    legs = {leg: 0.0 for leg in LEGS}
    legs["other"] = 0.0
    per_op: Dict[str, float] = {}
    names: Dict[str, str] = {}
    total_us = 0.0
    for ev in events:
        name = str(ev.get("name", ""))
        dur = float(ev["dur"])
        total_us += dur
        per_op[name] = per_op.get(name, 0.0) + dur
        leg = names.setdefault(name, leg_of(name))
        legs[leg] += dur
    top = dict(sorted(per_op.items(), key=lambda kv: -kv[1])[:top_k])
    return {"source": path, "device_events": bool(device),
            "events": len(events), "total_ms": total_us / 1e3,
            "legs_ms": {k: v / 1e3 for k, v in legs.items()},
            "top_ops_ms": {k: v / 1e3 for k, v in top.items()},
            "names": names}


def attribute_profile(trace_dir: str) -> Optional[Dict[str, Any]]:
    """``parse_profiler_trace`` with the port's kernels named: for each
    kernel source of ``native.KERNEL_SYMBOLS`` (and the windowed
    partition) whose kernel the trace holds, the leg it went to
    (``kernels``)."""
    prof = parse_profiler_trace(trace_dir)
    if prof is None:
        return None
    from ..native import KERNEL_SYMBOLS

    symbols = dict(KERNEL_SYMBOLS, partition_window="partition_window")
    kernels = {}
    for src, sym in symbols.items():
        legs = {leg for name, leg in prof["names"].items() if sym in name}
        if legs:
            kernels[src] = sorted(legs)
    prof["kernels"] = kernels
    return prof
