"""Observability of training and serving: telemetry, tracing, metrics.

Port of ``lightgbm_tpu/observability/``:

  * ``Telemetry`` (`telemetry.py`) — host phase timers, counters, gauges,
    the iteration ring and the per-tree device counter lane, building the
    JSON report with its ``provenance`` block;
  * ``attribution`` — the sampled-sync timer (``telemetry_sync_every``)
    and the ``torch.profiler`` trace parse (``profile_trace_dir``);
  * ``report`` — ``schema.json`` (byte for byte the JAX package's) and a
    dependency-free validator and atomic writer;
  * ``TraceRecorder`` (`trace.py`) — request- and phase-scoped spans
    exported as Chrome trace-event JSON (open in Perfetto);
  * ``LatencyHistogram`` / Prometheus export (`metrics_export.py`) —
    exact p50/p95/p99 over a bounded window, the text page behind the
    server's ``metrics`` op and ``training_prometheus``.

  * ``CollectiveLedger`` (`collectives.py`) — the sharded learners'
    collective sites and traffic, the report's ``collectives`` section.

  * ``DriftMonitor`` (`drift.py`) — per-feature and score PSI/KS of the
    served traffic against the promote-time baseline (host numpy).

  * ``podtrace`` — a pod's per-rank traces with a store clock-offset
    handshake (``estimate_clock_offset``, ``export_rank_trace``) and their
    merge into one Chrome trace (``merge_pod_trace``).

  * ``set_global_tracer`` / ``get_global_tracer`` — the process-wide
    recorder ``engine.train`` registers before the Booster is built, so
    the streaming loader's ``ingest.*`` spans reach the run's trace.
"""

from .attribution import (SampledSync, attribute_profile, attribution_table,
                          force_sync, parse_profiler_trace, timeit)
from .collectives import CollectiveLedger
from .drift import DriftMonitor, ks_2samp, ks_from_counts, psi_from_counts
from .metrics_export import (LatencyHistogram, prometheus_text,
                             training_prometheus)
from .podtrace import (estimate_clock_offset, export_rank_trace,
                       merge_pod_trace)
from .report import load_schema, validate_report, write_report
from .telemetry import TEL_NAMES, Telemetry, provenance_section
from .trace import (TraceRecorder, get_global_tracer, new_trace_id,
                    set_global_tracer)

__all__ = ["Telemetry", "TEL_NAMES", "load_schema", "validate_report",
           "write_report", "TraceRecorder", "new_trace_id",
           "LatencyHistogram", "prometheus_text", "training_prometheus",
           "provenance_section", "SampledSync", "attribution_table",
           "force_sync", "parse_profiler_trace", "attribute_profile",
           "CollectiveLedger", "DriftMonitor", "psi_from_counts",
           "ks_from_counts", "ks_2samp", "timeit", "estimate_clock_offset",
           "export_rank_trace", "merge_pod_trace", "get_global_tracer",
           "set_global_tracer"]
