"""Serving observability: telemetry report, request tracing, metrics.

Port of the serving half of ``lightgbm_tpu/observability/``:

  * ``Telemetry`` (`telemetry.py`) — host phase timers, counters and
    gauges building the JSON report, with its ``provenance`` block;
  * ``report`` — ``schema.json`` (byte for byte the JAX package's) and a
    dependency-free validator and atomic writer;
  * ``TraceRecorder`` (`trace.py`) — request-scoped spans exported as
    Chrome trace-event JSON (open in Perfetto);
  * ``LatencyHistogram`` / Prometheus export (`metrics_export.py`) —
    exact p50/p95/p99 over a bounded window and the text page behind the
    server's ``metrics`` op.

The training side (attribution, collectives, the pod trace) and the drift
monitor are not ported: ROADMAP.md Queue A, "reliability and training
observability" and "serving and lifecycle".
"""

from .metrics_export import LatencyHistogram, prometheus_text
from .report import load_schema, validate_report, write_report
from .telemetry import Telemetry, provenance_section
from .trace import TraceRecorder, new_trace_id

__all__ = ["Telemetry", "load_schema", "validate_report",
           "write_report", "TraceRecorder", "new_trace_id",
           "LatencyHistogram", "prometheus_text", "provenance_section"]
