"""Pod-wide flight recorder: per-rank trace export and the cross-host merge.

Port of ``lightgbm_tpu/observability/podtrace.py`` (host code, copied).
Every rank of a pod runs its own ``TraceRecorder`` through training
(iteration, heartbeat and phase spans), each on its own ``perf_counter``
timeline.  This module relates the clocks:

  * ``estimate_clock_offset(net)``: a Cristian-style ping over the pod's
    ``DistributedNet`` (the store channel the heartbeat rides): each round
    every rank posts its send stamp into one allgather and stamps the
    return; rank 0's stamp fell inside the local [send, recv] window, so
    the midpoint estimates the offset to rank 0 within RTT/2.  The
    minimum-RTT round wins (NTP's rule); rank 0's offset is exactly 0.
  * ``export_rank_trace(tracer, path, net)``: stamps the handshake (rank,
    process_count, offset, RTT, the recorder epoch on rank 0's clock) into
    the trace's ``otherData`` and writes ``<path>.rank<r>`` (a single-host
    run keeps the plain path).
  * ``merge_pod_trace(paths, out)``: one pod-wide Chrome trace; each rank's
    events shift by one constant (its aligned epoch minus the merge base),
    which keeps B/E nesting exact; pids become ranks, with
    ``process_name`` metadata, and the offsets land in ``otherData``.

Host code on monotonic clocks only (``perf_counter``, the recorder's).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Union

#: event-phase sort rank keeping per-(pid,tid) streams well-nested when
#: the merged list is stably re-sorted by timestamp: metadata first, at
#: equal ts an E precedes a B (trace.py's export tie-break); equal keys
#: keep each rank's already-correct original order (stable sort)
_PH_RANK = {"M": -1, "E": 0, "B": 1, "i": 2}


def estimate_clock_offset(net, rounds: int = 8) -> Dict[str, Any]:
    """Estimate this rank's perf_counter delta vs rank 0 over ``net``
    (a ``parallel.multihost.DistributedNet``).  Returns
    ``{offset_s, rtt_s, rounds, method}`` — ``offset_s`` is (this rank's
    clock) − (rank 0's clock), 0.0 exactly on rank 0."""
    best_rtt = float("inf")
    best_off = 0.0
    for _ in range(max(int(rounds), 1)):
        t_send = time.perf_counter()
        stamps = net.allgather(("clk", int(net.rank), float(t_send)))
        t_recv = time.perf_counter()
        rtt = t_recv - t_send
        if rtt >= best_rtt:
            continue
        best_rtt = rtt
        # rank 0 posted its stamp somewhere inside our [send, recv]
        # window; the midpoint correspondence bounds the error by rtt/2
        s0 = float(stamps[0][2])
        best_off = (t_send + t_recv) / 2.0 - s0
    if int(net.rank) == 0:
        best_off = 0.0          # rank 0 IS the reference clock
    return {"offset_s": best_off, "rtt_s": best_rtt,
            "rounds": int(rounds), "method": "kv-ping-midpoint"}


def rank_trace_path(base: str, rank: int, process_count: int) -> str:
    """Per-rank trace file name: ``<base>.rank<r>`` on a pod, ``base``
    unchanged single-host (so existing single-host flows keep their
    output path)."""
    return f"{base}.rank{int(rank)}" if process_count > 1 else base


def export_rank_trace(tracer, base_path: str, net=None,
                      clock: Optional[Dict[str, Any]] = None) -> str:
    """Stamp pod/clock metadata into ``tracer`` and save its trace to the
    per-rank path.  With ``net=None`` (single host) the clock metadata
    degenerates to offset 0.  ``clock`` reuses an already-run
    ``estimate_clock_offset`` result (the engine shares one handshake
    between the trace metadata and the report's ``distributed.clock``).
    Returns the path written."""
    rank = int(net.rank) if net is not None else 0
    nproc = int(net.num_machines) if net is not None else 1
    clk = clock if clock is not None else (
        estimate_clock_offset(net) if net is not None else
        {"offset_s": 0.0, "rtt_s": 0.0, "rounds": 0, "method": "local"})
    # the recorder epoch expressed on rank 0's clock: the merge aligns
    # timelines by differencing these, so no rank needs to know another's
    # epoch at export time
    aligned_epoch_us = (tracer.epoch - clk["offset_s"]) * 1e6
    tracer.set_metadata(
        rank=rank, process_count=nproc,
        clock_offset_us=clk["offset_s"] * 1e6,
        clock_rtt_us=clk["rtt_s"] * 1e6,
        clock_sync=clk["method"],
        aligned_epoch_us=aligned_epoch_us)
    path = rank_trace_path(base_path, rank, nproc)
    tracer.save(path)
    return path


def _load(obj: Union[str, Dict[str, Any]]) -> Dict[str, Any]:
    if isinstance(obj, dict):
        return obj
    with open(obj) as fh:
        return json.load(fh)


def merge_pod_trace(traces: Sequence[Union[str, Dict[str, Any]]],
                    out: Optional[str] = None) -> Dict[str, Any]:
    """Merge per-rank Chrome traces into ONE pod-wide trace.

    Each input is a path or an already-loaded export dict carrying the
    ``export_rank_trace`` metadata.  All of one rank's timestamps shift
    by the same constant (aligned epoch minus the merge base), so span
    nesting is preserved exactly; traces without metadata merge at
    offset 0 with their list index as the rank.  Writes ``out``
    atomically when given; returns the merged trace object."""
    loaded: List[Dict[str, Any]] = [_load(t) for t in traces]
    ranks_meta: List[Dict[str, Any]] = []
    for i, tr in enumerate(loaded):
        od = tr.get("otherData", {})
        ranks_meta.append({
            "rank": int(od.get("rank", i)),
            "aligned_epoch_us": float(od.get("aligned_epoch_us", 0.0)),
            "clock_offset_us": float(od.get("clock_offset_us", 0.0)),
            "clock_rtt_us": float(od.get("clock_rtt_us", 0.0)),
            "dropped_spans": int(od.get("dropped_spans", 0)),
        })
    base = min((m["aligned_epoch_us"] for m in ranks_meta), default=0.0)
    merged: List[tuple] = []     # (sort_key, seq, event)
    seq = 0
    for tr, meta in zip(loaded, ranks_meta):
        shift = meta["aligned_epoch_us"] - base
        rank = meta["rank"]
        pid_orig = None
        for ev in tr.get("traceEvents", []):
            ev = dict(ev)
            ph = ev.get("ph")
            if pid_orig is None:
                pid_orig = ev.get("pid")
            ev["pid"] = rank
            if ph == "M":
                # keep per-thread names; the process row is named below
                merged.append(((float("-inf"), _PH_RANK["M"]), seq, ev))
                seq += 1
                continue
            ts = float(ev.get("ts", 0.0)) + shift
            ev["ts"] = ts
            merged.append(((ts, _PH_RANK.get(ph, 3)), seq, ev))
            seq += 1
        name_ev = {"name": "process_name", "ph": "M", "pid": rank,
                   "args": {"name": f"rank {rank}"
                            + (f" (pid {pid_orig})"
                               if pid_orig is not None else "")}}
        merged.append(((float("-inf"), _PH_RANK["M"]), -1, name_ev))
    merged.sort(key=lambda e: (e[0], e[1]))
    result = {
        "traceEvents": [ev for _, _, ev in merged],
        "displayTimeUnit": "ms",
        "otherData": {
            "clock": "perf_counter",
            "pod_merge": True,
            "process_count": len(loaded),
            "ranks": ranks_meta,
        },
    }
    if out:
        tmp = out + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(result, fh)
            fh.write("\n")
        os.replace(tmp, out)
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI: ``python -m lightgbm_tpu_torch.observability.podtrace OUT
    RANK_TRACE [RANK_TRACE ...]`` — merge per-rank traces into OUT."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print("usage: python -m lightgbm_tpu_torch.observability.podtrace "
              "OUT RANK_TRACE [RANK_TRACE ...]", file=sys.stderr)
        return 2
    out, paths = argv[0], argv[1:]
    merged = merge_pod_trace(paths, out=out)
    n_ev = len(merged["traceEvents"])
    print(f"merged {len(paths)} rank trace(s), {n_ev} events -> {out}")
    return 0


if __name__ == "__main__":      # pragma: no cover — CLI shim
    raise SystemExit(main())
