# Port copy of lightgbm_tpu/metrics.py: the port keeps its own numpy-only copy so
# that importing it never runs lightgbm_tpu/__init__.py (which imports JAX).
"""Evaluation metrics (host side, f64 numpy).

Re-implementation of `src/metric/` (interface `include/LightGBM/metric.h:16-57`;
factory `src/metric/metric.cpp:13-53`).  Metrics run on host in float64 —
they are O(N) once per ``metric_freq`` iterations, far off the hot path, and
the reference accumulates them in double as well.

Each metric returns ``(name, value)`` pairs; ``is_higher_better`` drives early
stopping comparisons (`metric.h:34`, `callback.py:153`).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .config import Config
from .dataset import Metadata


class Metric:
    """Base (reference `metric.h:16-57`)."""
    is_higher_better = False

    def __init__(self, cfg: Config):
        self.cfg = cfg

    def init(self, metadata: Metadata, num_data: int) -> None:
        self.metadata = metadata
        self.num_data = num_data
        self.label = metadata.label.astype(np.float64)
        self.weights = None if metadata.weights is None \
            else metadata.weights.astype(np.float64)
        self.sum_weights = float(self.weights.sum()) if self.weights is not None \
            else float(num_data)

    def eval(self, score: np.ndarray, objective=None) -> List[Tuple[str, float]]:
        raise NotImplementedError

    def _avg(self, pointwise: np.ndarray) -> float:
        if self.weights is None:
            return float(pointwise.sum() / self.sum_weights)
        return float((pointwise * self.weights).sum() / self.sum_weights)


class _PointwiseRegressionMetric(Metric):
    """``RegressionMetric<T>`` template (`src/metric/regression_metric.hpp:14-110`):
    converts scores via the objective then averages a pointwise loss."""
    name = "l2"

    def eval(self, score, objective=None):
        score = np.asarray(score, dtype=np.float64)[:self.num_data]
        if objective is not None:
            score = objective.convert_output(score)
        return [(self.name, self._transform(self._avg(self._loss(self.label, score))))]

    def _transform(self, v: float) -> float:
        return v

    def _loss(self, label, score):
        raise NotImplementedError


class L2Metric(_PointwiseRegressionMetric):
    name = "l2"
    def _loss(self, label, score):
        return (score - label) ** 2


class RMSEMetric(_PointwiseRegressionMetric):
    name = "rmse"
    def _loss(self, label, score):
        return (score - label) ** 2
    def _transform(self, v):
        return math.sqrt(v)


class L1Metric(_PointwiseRegressionMetric):
    name = "l1"
    def _loss(self, label, score):
        return np.abs(score - label)


class QuantileMetric(_PointwiseRegressionMetric):
    name = "quantile"
    def _loss(self, label, score):
        a = self.cfg.alpha
        d = label - score
        return np.where(d >= 0, a * d, (a - 1) * d)


class HuberLossMetric(_PointwiseRegressionMetric):
    name = "huber"
    def _loss(self, label, score):
        a = self.cfg.alpha
        d = np.abs(score - label)
        return np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))


class FairLossMetric(_PointwiseRegressionMetric):
    name = "fair"
    def _loss(self, label, score):
        c = self.cfg.fair_c
        x = np.abs(score - label)
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_PointwiseRegressionMetric):
    name = "poisson"
    def _loss(self, label, score):
        eps = 1e-10
        score = np.maximum(score, eps)
        return score - label * np.log(score)


class MAPEMetric(_PointwiseRegressionMetric):
    name = "mape"
    def _loss(self, label, score):
        return np.abs((label - score)) / np.maximum(1.0, np.abs(label))


class GammaMetric(_PointwiseRegressionMetric):
    name = "gamma"
    def _loss(self, label, score):
        psi = 1.0
        theta = -1.0 / score
        a = psi
        b = -np.log(-theta)
        c = 1.0 / psi * np.log(label / psi) - np.log(label) - math.lgamma(1.0 / psi)
        return -((label * theta - b) / a + c)


class GammaDevianceMetric(_PointwiseRegressionMetric):
    name = "gamma-deviance"
    def _loss(self, label, score):
        eps = 1e-9
        temp = label / (score + eps)
        return 2.0 * (temp - np.log(temp) - 1.0)
    def _transform(self, v):
        return v


class TweedieMetric(_PointwiseRegressionMetric):
    name = "tweedie"
    def _loss(self, label, score):
        rho = self.cfg.tweedie_variance_power
        eps = 1e-10
        score = np.maximum(score, eps)
        a = label * np.exp((1 - rho) * np.log(score)) / (1 - rho)
        b = np.exp((2 - rho) * np.log(score)) / (2 - rho)
        return -a + b


class BinaryLoglossMetric(Metric):
    """`src/metric/binary_metric.hpp:111-133`."""
    name = "binary_logloss"

    def eval(self, score, objective=None):
        score = np.asarray(score, dtype=np.float64)[:self.num_data]
        prob = objective.convert_output(score) if objective is not None \
            else 1.0 / (1.0 + np.exp(-score))
        eps = 1e-15
        p = np.clip(prob, eps, 1 - eps)
        loss = np.where(self.label > 0, -np.log(p), -np.log(1 - p))
        return [(self.name, self._avg(loss))]


class BinaryErrorMetric(Metric):
    """`binary_metric.hpp:135-153`."""
    name = "binary_error"

    def eval(self, score, objective=None):
        score = np.asarray(score, dtype=np.float64)[:self.num_data]
        prob = objective.convert_output(score) if objective is not None \
            else 1.0 / (1.0 + np.exp(-score))
        err = np.where(self.label > 0, prob <= 0.5, prob > 0.5).astype(np.float64)
        return [(self.name, self._avg(err))]


class AUCMetric(Metric):
    """`binary_metric.hpp:155-250` — weighted rank-sum AUC, accumulated over
    descending-score tie groups exactly like the reference (`:196-242`)."""
    name = "auc"
    is_higher_better = True

    def eval(self, score, objective=None):
        score = np.asarray(score, dtype=np.float64)[:self.num_data]
        label = self.label > 0
        w = self.weights if self.weights is not None else np.ones(self.num_data)
        pos_w = np.where(label, w, 0.0)
        neg_w = np.where(~label, w, 0.0)
        # group by unique score in DESCENDING order; for each negative count
        # positives with strictly higher score + half the tied positives
        uniq, idx = np.unique(-score, return_inverse=True)
        gp = np.bincount(idx, weights=pos_w, minlength=len(uniq))
        gn = np.bincount(idx, weights=neg_w, minlength=len(uniq))
        sum_pos_before = np.concatenate([[0.0], np.cumsum(gp)[:-1]])
        accum = float((gn * (gp * 0.5 + sum_pos_before)).sum())
        sum_pos = float(gp.sum())
        total = float(w.sum())
        denom = sum_pos * (total - sum_pos)
        return [(self.name, accum / denom if denom > 0 else 1.0)]


class MultiLoglossMetric(Metric):
    """`multiclass_metric.hpp:150-164` (softmax logloss)."""
    name = "multi_logloss"

    def eval(self, score, objective=None):
        # score shape (n, K) raw
        n = self.num_data
        raw = np.asarray(score, dtype=np.float64).reshape(n, -1)
        prob = objective.convert_output(raw) if objective is not None else raw
        k = prob.shape[1]
        li = self.label.astype(np.int64)
        eps = 1e-15
        p = np.clip(prob[np.arange(n), li], eps, None)
        return [(self.name, self._avg(-np.log(p)))]


class MultiErrorMetric(Metric):
    """`multiclass_metric.hpp:130-148`."""
    name = "multi_error"

    def eval(self, score, objective=None):
        n = self.num_data
        raw = np.asarray(score, dtype=np.float64).reshape(n, -1)
        prob = objective.convert_output(raw) if objective is not None else raw
        li = self.label.astype(np.int64)
        err = (np.argmax(prob, axis=1) != li).astype(np.float64)
        return [(self.name, self._avg(err))]


class CrossEntropyMetric(Metric):
    """`xentropy_metric.hpp:67-160`."""
    name = "cross_entropy"

    def eval(self, score, objective=None):
        score = np.asarray(score, dtype=np.float64)[:self.num_data]
        p = 1.0 / (1.0 + np.exp(-score))
        eps = 1e-15
        p = np.clip(p, eps, 1 - eps)
        y = self.label
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [("xentropy", self._avg(loss))]


class CrossEntropyLambdaMetric(Metric):
    """`xentropy_metric.hpp:162-243`."""
    name = "cross_entropy_lambda"

    def eval(self, score, objective=None):
        score = np.asarray(score, dtype=np.float64)[:self.num_data]
        y = self.label
        w = self.weights if self.weights is not None else np.ones_like(y)
        hhat = np.log1p(np.exp(score))
        z = 1.0 - np.exp(-w * hhat)
        eps = 1e-15
        z = np.clip(z, eps, 1 - eps)
        loss = -(y * np.log(z) + (1 - y) * np.log(1 - z))
        return [("xentlambda", float(loss.sum() / self.num_data))]


class KLDivergenceMetric(Metric):
    """`xentropy_metric.hpp:245-310`."""
    name = "kullback_leibler"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        y = np.clip(self.label, 1e-15, 1 - 1e-15)
        e = y * np.log(y) + (1 - y) * np.log(1 - y)
        if self.weights is not None:
            self._presum = float((e * self.weights).sum() / self.sum_weights)
        else:
            self._presum = float(e.mean())

    def eval(self, score, objective=None):
        score = np.asarray(score, dtype=np.float64)[:self.num_data]
        p = np.clip(1.0 / (1.0 + np.exp(-score)), 1e-15, 1 - 1e-15)
        y = self.label
        xent = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [("kldiv", self._presum + self._avg(xent))]


class _RankMetricBase(Metric):
    """Shared fully-vectorized ranking machinery: ONE stable lexsort of all
    documents by (query, -score) per eval instead of a Python loop over
    queries — MSLR-scale (30k+ queries) evals run in milliseconds.  Queries
    are contiguous blocks in the row axis, so sorting by (qid, -score)
    leaves every block in place with its docs ranked; the within-query rank
    of sorted position i is ``i - query_start(i)``."""

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            raise ValueError(f"{self.name} metric requires query information")
        self.qb = np.asarray(metadata.query_boundaries, dtype=np.int64)
        self.eval_at = list(self.cfg.eval_at)
        self.nq = len(self.qb) - 1
        sizes = np.diff(self.qb)
        self.qid = np.repeat(np.arange(self.nq, dtype=np.int64), sizes)
        self.rank_pos = np.arange(num_data, dtype=np.int64) - \
            self.qb[self.qid]

    @staticmethod
    def _stable_argsort_u32(keys: np.ndarray) -> np.ndarray:
        """Stable ascending argsort of uint32 keys via two uint16 radix
        passes — numpy's stable sort is radix only for <=16-bit dtypes, and
        this is ~5x faster than one mergesort at 4M keys."""
        lo = (keys & np.uint32(0xFFFF)).astype(np.uint16)
        o = np.argsort(lo, kind="stable")
        hi = (keys >> np.uint32(16)).astype(np.uint16)
        return o[np.argsort(hi[o], kind="stable")]

    def _ranked(self, score):
        """Per-doc within-query rank ordering by descending score (stable —
        ties keep document order, matching per-query mergesort argsort).
        Keys are f32: the training scores are f32 sums already; values that
        collide in f32 rank in document order."""
        s = np.ascontiguousarray(
            np.asarray(score, dtype=np.float32)[:self.num_data])
        u = s.view(np.uint32)
        # IEEE754 -> order-preserving uint, then invert for descending
        u = np.where(u >> np.uint32(31), ~u, u | np.uint32(0x80000000))
        o = self._stable_argsort_u32(~u)
        # stable regroup into contiguous query blocks
        q = self.qid[o]
        if self.nq <= 0xFFFF:
            return o[np.argsort(q.astype(np.uint16), kind="stable")]
        return o[self._stable_argsort_u32(q.astype(np.uint32))]


class NDCGMetric(_RankMetricBase):
    """`src/metric/rank_metric.hpp:15-130` + DCGCalculator."""
    name = "ndcg"
    is_higher_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        lg = self.cfg.label_gain
        self.label_gain = np.asarray(lg, dtype=np.float64) if lg \
            else (2.0 ** np.arange(32)) - 1.0  # DefaultLabelGain: 2^i - 1
        self.label_int = self.label.astype(np.int64)
        if self.label_int.size and \
                int(self.label_int.max()) >= len(self.label_gain):
            # reference is fatal here (`dcg_calculator.cpp` CheckLabel)
            raise ValueError(
                f"Label {int(self.label_int.max())} exceeds label_gain size "
                f"{len(self.label_gain)}; set label_gain explicitly")
        self.label_int = np.clip(self.label_int, 0, None)
        self.discount = 1.0 / np.log2(self.rank_pos + 2.0)
        # max DCG@k is score-independent — precompute per (k, query) once
        ideal = np.lexsort((-self.label_int, self.qid))
        ideal_gain = self.label_gain[self.label_int[ideal]] * self.discount
        self.max_dcg = {
            k: np.bincount(self.qid,
                           weights=ideal_gain * (self.rank_pos < k),
                           minlength=self.nq)
            for k in self.eval_at}

    def eval(self, score, objective=None):
        order = self._ranked(score)
        gain_sorted = self.label_gain[self.label_int[order]] * self.discount
        results = []
        for k in self.eval_at:
            dcg = np.bincount(self.qid, weights=gain_sorted *
                              (self.rank_pos < k), minlength=self.nq)
            maxd = self.max_dcg[k]
            ndcg = np.where(maxd > 0, dcg / np.where(maxd > 0, maxd, 1.0),
                            1.0)
            results.append((f"ndcg@{k}", float(ndcg.sum() / self.nq)))
        return results


class MapMetric(_RankMetricBase):
    """`src/metric/map_metric.hpp:15-120` — mean average precision@k."""
    name = "map"
    is_higher_better = True

    def eval(self, score, objective=None):
        order = self._ranked(score)
        rel = (self.label[order] > 0).astype(np.float64)
        cum = np.cumsum(rel)
        # hits within the query up to and including this rank
        start_base = cum[self.qb[:-1]] - rel[self.qb[:-1]]
        hits = cum - start_base[self.qid]
        prec = rel * hits / (self.rank_pos + 1.0)
        results = []
        for k in self.eval_at:
            topk = self.rank_pos < k
            sum_prec = np.bincount(self.qid, weights=prec * topk,
                                   minlength=self.nq)
            npos = np.bincount(self.qid, weights=rel * topk,
                               minlength=self.nq)
            ap = np.where(npos > 0,
                          sum_prec / np.where(npos > 0, npos, 1.0), 0.0)
            results.append((f"map@{k}", float(ap.sum() / self.nq)))
        return results


_METRIC_TABLE = {
    "l2": L2Metric, "mean_squared_error": L2Metric, "mse": L2Metric,
    "regression": L2Metric, "regression_l2": L2Metric,
    "l2_root": RMSEMetric, "root_mean_squared_error": RMSEMetric,
    "rmse": RMSEMetric,
    "l1": L1Metric, "mean_absolute_error": L1Metric, "mae": L1Metric,
    "regression_l1": L1Metric,
    "quantile": QuantileMetric,
    "huber": HuberLossMetric,
    "fair": FairLossMetric,
    "poisson": PoissonMetric,
    "mape": MAPEMetric, "mean_absolute_percentage_error": MAPEMetric,
    "gamma": GammaMetric, "gamma_deviance": GammaDevianceMetric,
    "gamma-deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "multi_logloss": MultiLoglossMetric, "multiclass": MultiLoglossMetric,
    "softmax": MultiLoglossMetric, "multiclassova": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "cross_entropy": CrossEntropyMetric, "xentropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "xentlambda": CrossEntropyLambdaMetric,
    "kullback_leibler": KLDivergenceMetric, "kldiv": KLDivergenceMetric,
    "ndcg": NDCGMetric, "lambdarank": NDCGMetric,
    "map": MapMetric, "mean_average_precision": MapMetric,
}


def create_metric(name: str, cfg: Config) -> Optional[Metric]:
    """`src/metric/metric.cpp:13-53`."""
    if name in ("", "none", "null", "custom", "na"):
        return None
    if name not in _METRIC_TABLE:
        raise ValueError(f"Unknown metric type name: {name}")
    return _METRIC_TABLE[name](cfg)
