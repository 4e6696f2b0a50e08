"""Statistical drift detection over the serving traffic recorder.

Port of ``lightgbm_tpu/observability/drift.py``: the same detectors,
thresholds, section and gauges, so a drift section of the port equals the
JAX package's on the same model and windows, and a baseline file written by
either package restores in the other.

Two detectors, both over distributions the serving stack already produces:

  * **Per-feature PSI + two-sample KS over bin-index distributions.**
    ``BinnerArrays.bin_host`` (`binner.py`) maps raw rows to the exact
    train-time bin space, so each used feature's traffic reduces to a small
    integer histogram (``num_bin`` regular bins + one overflow slot for the
    categorical OOV sentinel).  PSI is the population-stability index over
    those bin fractions (merged into ``PSI_GROUPS`` groups of equal baseline
    mass); KS is the max CDF gap between the binned baseline and window
    distributions, with the asymptotic two-sample p-value.
  * **Score-distribution PSI + KS.**  Raw margins of the baseline sample
    (``ServingModel.host_raw``) define decile edges; window scores are
    binned against the same edges for PSI, and exact two-sample KS runs
    over the bounded raw score samples.

``DriftMonitor`` holds one baseline per model name, captured from the
``TrafficRecorder`` window at promotion time
(`serving/fleet/gateway.FleetServer.promote_rolling`), and compares later
windows against it: the ``drift`` report section, the
``lgbt_serving_drift_*`` gauges and a ``drift.alert`` trace instant when a
check trips.

Everything here is host numpy: a drift check never contends for the
serving device (no tensor is made, no kernel launched).  The monitor's one
lock guards only its own dicts and is never held across binning, scoring
or tracer calls.  No wall clock: freshness is counted in recorder rows.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..reliability.metrics import rel_inc

#: smoothing floor for PSI bin fractions (empty bins would otherwise
#: send the log-ratio to infinity on any novel bin)
PSI_EPS = 1e-4

#: number of quantile bins the score-distribution PSI uses
SCORE_BINS = 10

#: adjacent equal-baseline-mass groups per-feature PSI is computed over.
#: A 255-bin histogram against a few-hundred-row window holds ~2 rows
#: per bin — pure sampling noise that the eps floor would inflate into
#: PSI — so fine bins are merged to the conventional ~10-group PSI
#: binning first (KS keeps the full-resolution CDF; it is noise-robust)
PSI_GROUPS = 10

#: bounded raw score sample retained per baseline for exact two-sample KS
SCORE_SAMPLE = 8192


def psi_from_counts(expected: np.ndarray, actual: np.ndarray,
                    eps: float = PSI_EPS) -> float:
    """Population stability index between two count histograms over the
    same bins: ``sum((q - p) * ln(q / p))`` with ``eps``-floored
    fractions.  0 = identical; > 0.2 is the conventional "shifted"
    threshold."""
    p = np.asarray(expected, np.float64)
    q = np.asarray(actual, np.float64)
    if p.sum() <= 0 or q.sum() <= 0:
        return 0.0
    p = np.maximum(p / p.sum(), eps)
    q = np.maximum(q / q.sum(), eps)
    return float(np.sum((q - p) * np.log(q / p)))


def _psi_groups(expected: np.ndarray, actual: np.ndarray,
                groups: int = PSI_GROUPS
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge two aligned fine-bin histograms into at most ``groups``
    adjacent groups of roughly equal BASELINE mass (bins the baseline
    never saw merge into their left neighbour, so a window burst in
    them still lands in a group)."""
    p = np.asarray(expected, np.float64)
    q = np.asarray(actual, np.float64)
    tot = p.sum()
    if p.size <= groups or tot <= 0:
        return p, q
    left = (np.cumsum(p) - p) / tot
    gid = np.minimum((left * groups).astype(np.int64), groups - 1)
    return (np.bincount(gid, weights=p, minlength=groups),
            np.bincount(gid, weights=q, minlength=groups))


def _ks_pvalue(stat: float, n1: float, n2: float) -> float:
    """Asymptotic two-sample Kolmogorov p-value (Smirnov's limiting
    distribution with the Stephens small-sample correction — the same
    approximation scipy's ``ks_2samp(mode="asymp")`` uses)."""
    if n1 <= 0 or n2 <= 0 or stat <= 0:
        return 1.0
    en = np.sqrt(n1 * n2 / (n1 + n2))
    lam = (en + 0.12 + 0.11 / en) * float(stat)
    # Q_KS(lam) = 2 * sum_{j>=1} (-1)^(j-1) exp(-2 j^2 lam^2)
    j = np.arange(1, 101, dtype=np.float64)
    terms = 2.0 * ((-1.0) ** (j - 1)) * np.exp(-2.0 * (j * lam) ** 2)
    return float(min(max(np.sum(terms), 0.0), 1.0))


def ks_from_counts(expected: np.ndarray, actual: np.ndarray
                   ) -> Tuple[float, float]:
    """Two-sample KS over two count histograms on the same bins:
    max |CDF gap| between the binned empirical distributions, p-value
    from the asymptotic Kolmogorov distribution."""
    p = np.asarray(expected, np.float64)
    q = np.asarray(actual, np.float64)
    n1, n2 = p.sum(), q.sum()
    if n1 <= 0 or n2 <= 0:
        return 0.0, 1.0
    stat = float(np.max(np.abs(np.cumsum(p) / n1 - np.cumsum(q) / n2)))
    return stat, _ks_pvalue(stat, n1, n2)


def ks_2samp(a: np.ndarray, b: np.ndarray) -> Tuple[float, float]:
    """Exact two-sample KS statistic over raw samples (max ECDF gap at
    the pooled sample points), asymptotic p-value."""
    a = np.sort(np.asarray(a, np.float64).ravel())
    b = np.sort(np.asarray(b, np.float64).ravel())
    if a.size == 0 or b.size == 0:
        return 0.0, 1.0
    both = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, both, side="right") / a.size
    cdf_b = np.searchsorted(b, both, side="right") / b.size
    stat = float(np.max(np.abs(cdf_a - cdf_b)))
    return stat, _ks_pvalue(stat, a.size, b.size)


def _feature_counts(model, X: np.ndarray) -> List[np.ndarray]:
    """Per-used-feature bin-index count histograms of a raw row matrix,
    through the model's own serving binner (`BinnerArrays.bin_host`):
    the train-time bin space, bit-identical to the ``bin_predict`` codes
    the device path serves.  Each feature gets ``num_bin`` slots + 1
    overflow slot that the categorical ``OOV_BIN`` sentinel folds into."""
    arrays = model.arrays
    bins = arrays.bin_host(np.atleast_2d(np.asarray(X, np.float64)))
    out: List[np.ndarray] = []
    for k in range(arrays.num_used):
        nbins = int(arrays.nan_bin[k]) + 1
        b = bins[k].astype(np.int64)
        b = np.where((b < 0) | (b >= nbins), nbins, b)
        out.append(np.bincount(b, minlength=nbins + 1).astype(np.int64))
    return out


def _feature_names(model) -> List[str]:
    """Original-dataset feature name per used feature (positional
    ``f<idx>`` fallback when the booster carries no names)."""
    fmap = model.arrays.used_feature_map
    try:
        names = list(model.booster.gbdt.feature_names)
    except Exception:
        names = []
    return [names[int(i)] if int(i) < len(names) else f"f{int(i)}"
            for i in fmap]


def _scores(model, X: np.ndarray) -> np.ndarray:
    """Flat raw margins of a row matrix through the host reference
    traversal (deterministic, device-free — a drift check must never
    contend for the serving device)."""
    s = np.asarray(model.host_raw(np.atleast_2d(X)), np.float64)
    return s.ravel() if s.ndim == 1 else s[:, 0]


class _Baseline:
    """One captured reference distribution (immutable after capture)."""

    __slots__ = ("model_name", "version", "rows", "feature_counts",
                 "feature_names", "score_sample", "score_edges",
                 "score_counts")

    def __init__(self, model, X: np.ndarray):
        X = np.atleast_2d(np.asarray(X, np.float64))
        self.model_name = model.name
        self.version = int(model.version)
        self.rows = int(X.shape[0])
        self.feature_counts = _feature_counts(model, X)
        self.feature_names = _feature_names(model)
        scores = _scores(model, X)
        self.score_sample = scores[-SCORE_SAMPLE:].copy()
        # decile edges of the BASELINE define the score-PSI bins; both
        # windows bin against the same fixed edges
        self.score_edges = np.unique(np.percentile(
            scores, np.linspace(0, 100, SCORE_BINS + 1)[1:-1]))
        self.score_counts = self._bin_scores(scores)

    def _bin_scores(self, scores: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self.score_edges, scores, side="right")
        return np.bincount(idx, minlength=len(self.score_edges) + 1
                           ).astype(np.int64)

    # -- persistence (baselines survive a gateway restart) ------------

    def to_dict(self) -> Dict[str, Any]:
        """JSON-serializable form — exactly the ``__slots__`` state, so
        a restored baseline is indistinguishable from the captured
        one."""
        return {
            "model_name": self.model_name,
            "version": self.version,
            "rows": self.rows,
            "feature_counts": [c.tolist() for c in self.feature_counts],
            "feature_names": list(self.feature_names),
            "score_sample": self.score_sample.tolist(),
            "score_edges": self.score_edges.tolist(),
            "score_counts": self.score_counts.tolist(),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "_Baseline":
        base = cls.__new__(cls)
        base.model_name = str(d["model_name"])
        base.version = int(d["version"])
        base.rows = int(d["rows"])
        base.feature_counts = [np.asarray(c, np.int64)
                               for c in d["feature_counts"]]
        base.feature_names = [str(n) for n in d["feature_names"]]
        base.score_sample = np.asarray(d["score_sample"], np.float64)
        base.score_edges = np.asarray(d["score_edges"], np.float64)
        base.score_counts = np.asarray(d["score_counts"], np.int64)
        return base


class DriftMonitor:
    """Baseline-vs-window drift checks keyed by model name.

    ``capture(model, X)`` snapshots the reference distribution (called
    at registry commit/promote time with the recorder window);
    ``check(model, X)`` compares a later window and returns the
    ``drift`` report section.  The last check per model is retained for
    ``section()``/``gauges()`` so the metrics op and the Prometheus
    scrape read the same result the check produced."""

    def __init__(self, psi_threshold: float = 0.2,
                 ks_threshold: float = 0.15, top_k: int = 5,
                 min_rows: int = 32, tracer=None):
        self.psi_threshold = float(psi_threshold)
        self.ks_threshold = float(ks_threshold)
        self.top_k = int(top_k)
        self.min_rows = max(int(min_rows), 1)
        self.tracer = tracer
        self._lock = threading.Lock()
        self._baselines: Dict[str, _Baseline] = {}
        self._last: Dict[str, Dict[str, Any]] = {}
        self._checks = 0
        self._alerts = 0

    # -- capture -------------------------------------------------------------

    def capture(self, model, X: np.ndarray) -> bool:
        """Snapshot the baseline for ``model.name`` from a raw row
        window; False (and no state change) when the window is smaller
        than ``min_rows``."""
        X = np.atleast_2d(np.asarray(X, np.float64))
        if X.shape[0] < self.min_rows or X.size == 0:
            return False
        base = _Baseline(model, X)
        with self._lock:
            self._baselines[model.name] = base
            # a fresh baseline invalidates the previous verdict
            self._last.pop(model.name, None)
        return True

    def has_baseline(self, name: str = "default") -> bool:
        with self._lock:
            return name in self._baselines

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> int:
        """Atomic write (tmp + ``os.replace``) of every
        captured baseline so a restarted gateway resumes drift
        detection without waiting for the next promotion.  Returns the
        number of baselines written."""
        with self._lock:
            data = {n: b.to_dict() for n, b in self._baselines.items()}
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"drift_baselines": data}, fh)
        os.replace(tmp, path)
        return len(data)

    def restore(self, path: str) -> int:
        """Load baselines written by :meth:`save`.  In-memory baselines
        win (a live capture is fresher than anything on disk); each
        restored entry counts on ``drift.baseline_restored``.  Returns
        the number restored; 0 when the file does not exist."""
        if not os.path.exists(path):
            return 0
        with open(path) as fh:
            data = json.load(fh).get("drift_baselines", {})
        restored = 0
        with self._lock:
            for name, d in data.items():
                if name in self._baselines:
                    continue
                self._baselines[name] = _Baseline.from_dict(d)
                restored += 1
        if restored:
            rel_inc("drift.baseline_restored", restored)
        return restored

    # -- check ---------------------------------------------------------------

    def check(self, model, X: np.ndarray) -> Optional[Dict[str, Any]]:
        """Compare a window of raw rows against the captured baseline →
        the ``drift`` report section (None without a baseline or with a
        window below ``min_rows``).  Emits a ``drift.alert`` trace
        instant when the verdict is drifted."""
        with self._lock:
            base = self._baselines.get(model.name)
        X = np.atleast_2d(np.asarray(X, np.float64))
        if base is None or X.shape[0] < self.min_rows or X.size == 0:
            return None
        window_counts = _feature_counts(model, X)
        features: List[Dict[str, Any]] = []
        for k, (bc, wc) in enumerate(zip(base.feature_counts,
                                         window_counts)):
            n = max(len(bc), len(wc))
            bc = np.pad(bc, (0, n - len(bc)))
            wc = np.pad(wc, (0, n - len(wc)))
            psi = psi_from_counts(*_psi_groups(bc, wc))
            ks, ks_p = ks_from_counts(bc, wc)
            features.append({
                "feature": base.feature_names[k]
                if k < len(base.feature_names) else f"f{k}",
                "psi": psi, "ks": ks, "ks_p": ks_p,
                "drifted": bool(psi >= self.psi_threshold
                                or (ks >= self.ks_threshold
                                    and ks_p < 0.05))})
        scores = _scores(model, X)
        s_psi = psi_from_counts(base.score_counts,
                                base._bin_scores(scores))
        s_ks, s_ks_p = ks_2samp(base.score_sample,
                                scores[-SCORE_SAMPLE:])
        score = {"psi": s_psi, "ks": s_ks, "ks_p": s_ks_p,
                 "drifted": bool(s_psi >= self.psi_threshold
                                 or (s_ks >= self.ks_threshold
                                     and s_ks_p < 0.05))}
        ranked = sorted(features, key=lambda f: f["psi"], reverse=True)
        top = [f["feature"] for f in ranked[:self.top_k] if f["drifted"]]
        drifted = bool(top or score["drifted"])
        section = {
            "model": base.model_name,
            "version": base.version,
            "baseline_rows": base.rows,
            "window_rows": int(X.shape[0]),
            "psi_threshold": self.psi_threshold,
            "ks_threshold": self.ks_threshold,
            "max_psi": max((f["psi"] for f in features), default=0.0),
            "max_ks": max((f["ks"] for f in features), default=0.0),
            "features": ranked,
            "top_features": top,
            "score": score,
            "drifted": drifted,
        }
        tracer = self.tracer
        with self._lock:
            self._checks += 1
            if drifted:
                self._alerts += 1
            section["checks"] = self._checks
            section["alerts"] = self._alerts
            self._last[model.name] = section
        if drifted:
            rel_inc("serve.drift_alerts")
            if tracer is not None:
                tracer.instant(
                    "drift.alert", cat="serving",
                    args={"model": base.model_name,
                          "top_features": top,
                          "max_psi": section["max_psi"],
                          "max_ks": section["max_ks"],
                          "score_psi": s_psi})
        return section

    # -- export --------------------------------------------------------------

    def section(self, name: str = "default") -> Optional[Dict[str, Any]]:
        """The last check's ``drift`` report section (None before any
        check completed for this model)."""
        with self._lock:
            return self._last.get(name)

    def gauges(self) -> Dict[str, float]:
        """Flat ``serving_drift_*`` gauge map for the Prometheus page —
        the headline verdict across every checked model (max-drift
        model wins the scalar gauges)."""
        with self._lock:
            last = list(self._last.values())
        if not last:
            return {}
        worst = max(last, key=lambda s: s["max_psi"])
        return {
            "serving_drift_drifted":
                1.0 if any(s["drifted"] for s in last) else 0.0,
            "serving_drift_max_psi": float(worst["max_psi"]),
            "serving_drift_max_ks": float(worst["max_ks"]),
            "serving_drift_score_psi": float(worst["score"]["psi"]),
            "serving_drift_score_ks": float(worst["score"]["ks"]),
            "serving_drift_window_rows": float(worst["window_rows"]),
            "serving_drift_checks_total": float(worst["checks"]),
            "serving_drift_alerts_total": float(worst["alerts"]),
        }
