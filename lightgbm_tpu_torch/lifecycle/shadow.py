"""Shadow validation: replay recorded traffic, gate the candidate.

Port of ``lightgbm_tpu/lifecycle/shadow.py``: the same gates and report.
A refreshed model is never promoted on faith.  The candidate is built and
warmed off to the side (`serving/registry.py` ``prepare``: the live model
keeps serving), then candidate and incumbent are replayed over the traffic
recording through ``ServingModel.predict_padded``, the padded-bucket path
production requests take (on a CUDA device each chunk replays the model's
bucket graph of ``bin_predict`` and the traversal), and the candidate must
clear every configured gate:

  * **divergence ceiling**: mean |candidate - incumbent| over the replayed
    predictions (output space, after ``convert_output``) under
    ``divergence_max``;
  * **metric floor**: with labels, the candidate's metric ("auc", "l2",
    "mse" or "binary_logloss") must clear ``metric_floor``;
  * **latency ceiling**: the candidate's per-batch p50 (host clock around
    each replay, ``LatencyHistogram``) within ``latency_max_ratio`` x the
    incumbent's p50 from the same replay.

The outcome is a structured report (``gates`` / ``passed`` / ``reasons``)
that lands in the lifecycle telemetry section: a rejected candidate is a
recorded decision, not a log line.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..observability.metrics_export import LatencyHistogram
from ..reliability.metrics import rel_inc

# metrics the floor gate understands; (higher_better, fn(preds, labels))
_LOWER_BETTER = {"l2", "mse", "binary_logloss"}


def _metric_value(name: str, preds: np.ndarray,
                  labels: np.ndarray) -> Tuple[float, bool]:
    """(value, higher_better) of a shadow metric over 1-D predictions."""
    preds = np.asarray(preds, np.float64).reshape(-1)
    labels = np.asarray(labels, np.float64).reshape(-1)[:preds.size]
    preds = preds[:labels.size]
    if name == "auc":
        pos = labels > 0
        npos, nneg = int(pos.sum()), int((~pos).sum())
        if npos == 0 or nneg == 0:
            return 0.5, True
        # rank-sum AUC with midrank ties (matches metrics.AUCMetric)
        order = np.argsort(preds, kind="mergesort")
        ranks = np.empty(preds.size, np.float64)
        sorted_p = preds[order]
        i = 0
        while i < sorted_p.size:
            j = i
            while j + 1 < sorted_p.size and sorted_p[j + 1] == sorted_p[i]:
                j += 1
            ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
            i = j + 1
        auc = (ranks[pos].sum() - npos * (npos + 1) / 2.0) / (npos * nneg)
        return float(auc), True
    if name in ("l2", "mse"):
        return float(np.mean((preds - labels) ** 2)), False
    if name == "binary_logloss":
        p = np.clip(preds, 1e-15, 1 - 1e-15)
        return float(-np.mean(labels * np.log(p)
                              + (1 - labels) * np.log(1 - p))), False
    raise ValueError(f"unsupported shadow metric {name!r} "
                     f"(supported: auc, l2, binary_logloss)")


def _replay(model, X: np.ndarray,
            buckets: Sequence[int]) -> Tuple[np.ndarray, LatencyHistogram]:
    """Score ``X`` through the model's padded device path in warm-bucket
    chunks, timing each dispatch.  Returns (output-space predictions,
    per-batch latency histogram)."""
    hist = LatencyHistogram()
    ladder = sorted(int(b) for b in buckets) or [
        1 << max(int(X.shape[0]) - 1, 0).bit_length()]
    chunk = max(ladder)
    outs: List[np.ndarray] = []
    for ofs in range(0, X.shape[0], chunk):
        part = X[ofs:ofs + chunk]
        m = part.shape[0]
        fits = [b for b in ladder if b >= m]
        bucket = min(fits) if fits else chunk
        Xpad = np.zeros((bucket, X.shape[1]), np.float64)
        Xpad[:m] = part
        t0 = time.perf_counter()
        raw = model.predict_padded(Xpad, m)
        hist.record((time.perf_counter() - t0) * 1e3)
        outs.append(np.asarray(model.convert_output(raw), np.float64))
    return np.concatenate(outs, axis=0), hist


def shadow_validate(candidate, incumbent, X: np.ndarray, *,
                    labels: Optional[np.ndarray] = None,
                    metric: str = "",
                    metric_floor: float = float("nan"),
                    divergence_max: float = 0.25,
                    latency_max_ratio: float = 4.0,
                    min_rows: int = 1,
                    buckets: Sequence[int] = ()) -> Dict[str, Any]:
    """Gate a prepared candidate ``ServingModel`` against the serving
    incumbent over recorded traffic ``X``.  Returns the structured shadow
    report; never raises on a failing gate — rejection is a decision the
    caller reads from ``report["passed"]``."""
    X = np.atleast_2d(np.asarray(X, np.float64))
    gates: Dict[str, Any] = {}
    reasons: List[str] = []
    report: Dict[str, Any] = {"rows": int(X.shape[0]), "gates": gates,
                              "reasons": reasons}
    if X.shape[0] < max(int(min_rows), 1) or X.size == 0:
        reasons.append(f"recording too small ({X.shape[0]} rows, "
                       f"need >= {min_rows})")
        gates["recording"] = {"rows": int(X.shape[0]),
                              "min_rows": int(min_rows), "passed": False}
        report["passed"] = False
        rel_inc("lifecycle.shadow_runs")
        rel_inc("lifecycle.shadow_rejections")
        return report
    cand_pred, cand_hist = _replay(candidate, X, buckets)
    inc_pred, inc_hist = _replay(incumbent, X, buckets)

    flat_c = cand_pred.reshape(cand_pred.shape[0], -1)
    flat_i = inc_pred.reshape(inc_pred.shape[0], -1)
    diff = np.abs(flat_c - flat_i)
    div_mean = float(np.mean(diff))
    div_max = float(np.max(diff))
    gates["divergence"] = {"mean": div_mean, "max": div_max,
                           "limit": float(divergence_max),
                           "passed": div_mean <= float(divergence_max)}
    if not gates["divergence"]["passed"]:
        reasons.append(f"prediction divergence {div_mean:.4g} exceeds "
                       f"ceiling {divergence_max:g}")

    cand_metric = inc_metric = None
    if metric and labels is not None and not (
            isinstance(metric_floor, float) and math.isnan(metric_floor)):
        cand_metric, higher = _metric_value(metric, flat_c[:, 0], labels)
        inc_metric, _ = _metric_value(metric, flat_i[:, 0], labels)
        ok = cand_metric >= metric_floor if higher \
            else cand_metric <= metric_floor
        gates["metric"] = {"name": metric, "value": cand_metric,
                           "incumbent": inc_metric,
                           "floor": float(metric_floor),
                           "higher_better": higher, "passed": bool(ok)}
        if not ok:
            side = "below floor" if higher else "above ceiling"
            reasons.append(f"{metric} {cand_metric:.4g} is {side} "
                           f"{metric_floor:g}")
    else:
        gates["metric"] = {"passed": True, "skipped": True}

    cand_p50 = cand_hist.percentiles((50,))["p50"]
    inc_p50 = max(inc_hist.percentiles((50,))["p50"], 1e-3)
    ratio = cand_p50 / inc_p50
    gates["latency"] = {"candidate_p50_ms": cand_p50,
                        "incumbent_p50_ms": inc_p50, "ratio": float(ratio),
                        "limit": float(latency_max_ratio),
                        "passed": ratio <= float(latency_max_ratio)}
    if not gates["latency"]["passed"]:
        reasons.append(f"candidate p50 {cand_p50:.3g} ms is {ratio:.2f}x "
                       f"the incumbent's {inc_p50:.3g} ms (ceiling "
                       f"{latency_max_ratio:g}x)")

    report["candidate"] = {"latency_ms": cand_hist.snapshot(),
                           "metric": cand_metric}
    report["incumbent"] = {"latency_ms": inc_hist.snapshot(),
                           "metric": inc_metric}
    report["passed"] = not reasons
    rel_inc("lifecycle.shadow_runs")
    if reasons:
        rel_inc("lifecycle.shadow_rejections")
    return report
