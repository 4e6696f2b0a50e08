"""Latency histograms + Prometheus text-format metrics export.

Port of ``lightgbm_tpu/observability/metrics_export.py``:

  * ``LatencyHistogram`` — log-bucketed counts (powers of two from 0.1 ms,
    the Prometheus ``le`` buckets) plus a bounded window of raw samples.
    Percentiles come from the raw window with numpy's default linear
    interpolation, so p50/p95/p99 are exact over the retained window; the
    log buckets exist for the Prometheus exposition.
  * ``prometheus_text`` / ``prometheus_snapshot`` — the text exposition
    format (``# TYPE``, ``_bucket{le=...}``, ``_sum``/``_count``) over the
    serving counters, stage timers, reliability counters, per-tenant
    series and latency histograms: the server's ``metrics`` op.

The JAX package's drift monitor and fleet replicas are not ported (ROADMAP.md
Queue A, "serving and lifecycle"); a ``drift`` report section passed as a
dict still renders as ``lgbt_serving_drift_*`` gauges.

Monotonic clocks only; host-side only; every structure is thread-safe and
lock-leaf (nothing here acquires another subsystem's lock).
"""

from __future__ import annotations

import re
import threading
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

#: default log buckets: 0.1 ms · 2^k, k = 0..20 (0.1 ms .. ~105 s)
DEFAULT_BOUNDS_MS: Tuple[float, ...] = tuple(0.1 * (2.0 ** k)
                                             for k in range(21))

#: raw-sample window backing exact percentiles (per histogram)
DEFAULT_WINDOW = 8192

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


class LatencyHistogram:
    """Thread-safe log-bucketed histogram with an exact-percentile window.

    ``record(ms)`` is O(log buckets); ``percentiles`` computes numpy
    percentiles over the last ``window`` samples (exact for any workload
    that fits the window, and a sliding-window estimate beyond it — the
    honest trade for bounded memory in a long-lived server)."""

    def __init__(self, bounds_ms: Optional[Sequence[float]] = None,
                 window: int = DEFAULT_WINDOW):
        self.bounds = np.asarray(sorted(bounds_ms if bounds_ms is not None
                                        else DEFAULT_BOUNDS_MS), np.float64)
        self._counts = np.zeros(len(self.bounds) + 1, np.int64)  # +Inf last
        self._window: deque = deque(maxlen=max(int(window), 1))
        self._lock = threading.Lock()
        self.count = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0

    def record(self, ms: float) -> None:
        ms = float(ms)
        # first bound >= ms == the Prometheus `le` bucket the sample joins
        idx = int(np.searchsorted(self.bounds, ms, side="left"))
        with self._lock:
            self._counts[idx] += 1
            self.count += 1
            self.sum_ms += ms
            if ms > self.max_ms:
                self.max_ms = ms
            self._window.append(ms)

    # -- extraction ----------------------------------------------------------

    def percentiles(self, qs: Sequence[float] = (50, 95, 99)
                    ) -> Dict[str, float]:
        """``{"p50": ..., ...}`` over the raw sample window (numpy linear
        interpolation — exact vs ``np.percentile`` on the same samples)."""
        with self._lock:
            arr = np.asarray(self._window, np.float64)
        if arr.size == 0:
            return {f"p{g:g}": 0.0 for g in qs}
        vals = np.percentile(arr, list(qs))
        return {f"p{q:g}": float(v) for q, v in zip(qs, vals)}

    def snapshot(self) -> Dict[str, Any]:
        """The ``latency_ms`` report section (observability/schema.json)."""
        p = self.percentiles((50, 95, 99))
        with self._lock:
            count, total, mx = self.count, self.sum_ms, self.max_ms
        return {"count": int(count),
                "mean": float(total / count) if count else 0.0,
                "max": float(mx),
                "p50": p["p50"], "p95": p["p95"], "p99": p["p99"]}

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """``(le_ms, cumulative_count)`` rows, ending with ``(inf, count)``."""
        with self._lock:
            cum = np.cumsum(self._counts)
        rows = [(float(b), int(c)) for b, c in zip(self.bounds, cum[:-1])]
        rows.append((float("inf"), int(cum[-1])))
        return rows

    def prometheus_lines(self, name: str, labels: str = "") -> List[str]:
        """Text-exposition histogram block (``le`` in SECONDS, the
        Prometheus convention for latency metrics)."""
        name = sanitize_metric_name(name)
        lab = labels if not labels or labels.startswith("{") else \
            "{" + labels + "}"
        base = lab[1:-1] if lab else ""
        out = [f"# TYPE {name} histogram"]
        for le_ms, cum in self.cumulative_buckets():
            le = "+Inf" if le_ms == float("inf") else f"{le_ms / 1e3:g}"
            sep = "," if base else ""
            out.append(f'{name}_bucket{{{base}{sep}le="{le}"}} {cum}')
        with self._lock:
            out.append(f"{name}_sum{lab} {self.sum_ms / 1e3:g}")
            out.append(f"{name}_count{lab} {self.count}")
        return out


def sanitize_metric_name(name: str) -> str:
    """Prometheus metric names allow ``[a-zA-Z0-9_:]`` only."""
    return _NAME_RE.sub("_", name)


def prometheus_text(counters: Optional[Dict[str, float]] = None,
                    gauges: Optional[Dict[str, float]] = None,
                    histograms: Optional[Dict[str, LatencyHistogram]] = None,
                    prefix: str = "lgbt_") -> str:
    """Render counters/gauges/histograms as one text-format exposition."""
    lines: List[str] = []
    for name, v in sorted((counters or {}).items()):
        n = sanitize_metric_name(prefix + name)
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {float(v):g}")
    for name, v in sorted((gauges or {}).items()):
        n = sanitize_metric_name(prefix + name)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {float(v):g}")
    for name, h in sorted((histograms or {}).items()):
        lines.extend(h.prometheus_lines(prefix + name))
    return "\n".join(lines) + "\n"


def _escape_label(value: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def tenant_prometheus_lines(tenants: Iterable[Dict[str, Any]]
                            ) -> List[str]:
    """``lgbt_serving_tenant_*{model="..."}`` series from a
    ``ServingStats.tenants_section()`` list: request/error/shed
    counters, latency percentile gauges, SLO attainment and error-budget
    burn per model name."""
    metrics = [
        ("lgbt_serving_tenant_requests_total", "counter",
         lambda t: t["requests"]),
        ("lgbt_serving_tenant_errors_total", "counter",
         lambda t: t["errors"]),
        ("lgbt_serving_tenant_shed_total", "counter",
         lambda t: t["shed"]),
        ("lgbt_serving_tenant_latency_p50_ms", "gauge",
         lambda t: t["latency_ms"]["p50"]),
        ("lgbt_serving_tenant_latency_p95_ms", "gauge",
         lambda t: t["latency_ms"]["p95"]),
        ("lgbt_serving_tenant_latency_p99_ms", "gauge",
         lambda t: t["latency_ms"]["p99"]),
        ("lgbt_serving_tenant_slo_p99_target_ms", "gauge",
         lambda t: t["slo"]["p99_target_ms"]),
        ("lgbt_serving_tenant_slo_target", "gauge",
         lambda t: t["slo"]["target"]),
        ("lgbt_serving_tenant_slo_attainment", "gauge",
         lambda t: t["slo"]["attainment"]),
        ("lgbt_serving_tenant_error_budget_burn", "gauge",
         lambda t: t["slo"]["error_budget_burn"]),
    ]
    tenants = list(tenants)
    lines: List[str] = []
    for name, kind, get in metrics:
        lines.append(f"# TYPE {name} {kind}")
        for t in tenants:
            lab = _escape_label(t["model"])
            lines.append(f'{name}{{model="{lab}"}} {float(get(t)):g}')
    return lines


def drift_prometheus_lines(gauges: Dict[str, float],
                           section: Optional[Dict[str, Any]] = None
                           ) -> List[str]:
    """``lgbt_serving_drift_*`` gauges from ``DriftMonitor.gauges()``,
    plus per-feature PSI series for the last check's top drifted
    features when the full ``drift`` section is supplied."""
    lines: List[str] = []
    for name, v in sorted((gauges or {}).items()):
        n = sanitize_metric_name("lgbt_" + name)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {float(v):g}")
    feats = [f for f in (section or {}).get("features", ())
             if f["feature"] in (section or {}).get("top_features", ())]
    if feats:
        lines.append("# TYPE lgbt_serving_drift_feature_psi gauge")
        for f in feats:
            lab = _escape_label(f["feature"])
            lines.append(f'lgbt_serving_drift_feature_psi'
                         f'{{feature="{lab}"}} {float(f["psi"]):g}')
    return lines


def prometheus_snapshot(stats, registry=None, admission=None,
                        tenants=None, drift=None) -> str:
    """The server ``metrics`` op payload: every serving counter, stage
    timer total, reliability counter, model version and the request
    latency histogram, as one Prometheus text page.  ``tenants`` (a
    ``ServingStats.tenants_section()`` list) adds the per-model-name SLO
    series and ``drift`` (a dict of ``lgbt_serving_drift_*`` gauge
    values) the drift gauges."""
    from ..reliability.metrics import rel_counters

    section = stats.serving_section(
        models=registry.versions() if registry is not None else None,
        jit_entries=registry.jit_entries() if registry is not None else None)
    counters: Dict[str, float] = {
        "serving_requests_total": section["requests"],
        "serving_rows_total": section["rows"],
        "serving_batches_total": section["batches"],
        "serving_shed_total": section["shed"],
        "serving_fallback_batches_total": section["fallback_batches"],
        "serving_compile_cache_hits_total":
            section["compile_cache"]["hits"],
        "serving_compile_cache_misses_total":
            section["compile_cache"]["misses"],
    }
    for name, v in rel_counters().items():
        counters[f"reliability_{sanitize_metric_name(name)}_total"] = v
    gauges: Dict[str, float] = {
        "serving_qps": section["qps"],
        "serving_rows_per_s": section["rows_per_s"],
        "serving_batch_occupancy": section["batch_occupancy"],
    }
    for stage, st in section["stage_ms"].items():
        g = sanitize_metric_name(stage)
        gauges[f"serving_stage_{g}_total_seconds"] = st["total_ms"] / 1e3
        counters[f"serving_stage_{g}_count_total"] = st["count"]
    if admission is not None:
        snap = admission.snapshot()
        gauges["serving_inflight"] = snap["inflight"]
        gauges["serving_inflight_capacity"] = snap["capacity"]
        gauges["serving_shedding"] = 1.0 if snap["shedding"] else 0.0
    if registry is not None:
        for name, ver in (registry.versions() or {}).items():
            gauges[f"serving_model_version:{sanitize_metric_name(name)}"] = ver
    text = prometheus_text(
        counters, gauges,
        histograms={"serving_request_latency_seconds": stats.request_hist})
    extra: List[str] = []
    if tenants:
        extra.extend(tenant_prometheus_lines(tenants))
    if drift:
        extra.extend(drift_prometheus_lines(drift))
    if extra:
        text += "\n".join(extra) + "\n"
    return text
