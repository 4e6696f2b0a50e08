"""Objective functions as element-wise torch maps ``score -> (grad, hess)``.

Port of ``lightgbm_tpu/objectives.py``: the regression family (L2 with
``reg_sqrt``, L1, Huber, Fair, Poisson, quantile, MAPE, Gamma, Tweedie),
binary logloss, multiclass softmax (gradients of all K classes at once over
the (K, N) score) and one-vs-all, and the two cross-entropies, with the same
formulas; lambdarank is ``rank_objective.py``.  Gradients are float32
tensors over the padded row axis on the booster's device; padded rows are
neutralized by the bagging mask downstream.  The host statistics of
``boost_from_score`` and the percentile leaf renewal of L1, quantile and
MAPE (``RenewTreeOutput``, `regression_objective.hpp:224-298`) stay float64
numpy, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .binning import kEpsilon
from .config import Config
from .dataset import Metadata


class ObjectiveFunction:
    """Base (reference `objective_function.h:15-74`)."""

    name = "none"
    is_constant_hessian = False
    num_model_per_iteration = 1
    need_group = False

    def __init__(self, cfg: Config, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.num_data = 0
        self.label: Optional[torch.Tensor] = None
        self.weights: Optional[torch.Tensor] = None

    def init(self, metadata: Metadata, num_data: int,
             num_data_padded: int) -> None:
        self.num_data = num_data
        lab = np.zeros(num_data_padded, dtype=np.float32)
        lab[:num_data] = metadata.label
        self._np_label_pad = lab
        self.label = self._dev(lab)
        if metadata.weights is not None:
            w = np.zeros(num_data_padded, dtype=np.float32)
            w[:num_data] = metadata.weights
            self._np_weights_pad = w
            self.weights = self._dev(w)
        self._np_label = metadata.label
        self._np_weights = metadata.weights
        self.metadata = metadata

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def get_gradients(self, score: torch.Tensor, class_id: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        return raw

    def class_need_train(self, class_id: int) -> bool:
        return True

    def _w(self, g, h):
        if self.weights is None:
            return g, h
        return g * self.weights, h * self.weights

    def renew_tree_output(self, tree, score: np.ndarray, leaf_id: np.ndarray,
                          mask: np.ndarray) -> None:
        """Leaf refinement hook (`objective_function.h:58-66`); default no-op."""

    @property
    def needs_renew_tree_output(self) -> bool:
        """True when this objective overrides ``renew_tree_output``: the
        boosting loop then reads the class's score and the tree's leaf ids
        to the host once per tree and keeps the synchronous loop."""
        return type(self).renew_tree_output is not \
            ObjectiveFunction.renew_tree_output

    def to_string(self) -> str:
        return self.name


# --------------------------- regression family ----------------------------

class RegressionL2(ObjectiveFunction):
    """`regression_objective.hpp:71-180` (sqrt transform at `:77-101`)."""
    name = "regression"
    is_constant_hessian = True  # without weights

    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        self.sqrt = cfg.reg_sqrt

    def init(self, metadata, num_data, num_data_padded):
        super().init(metadata, num_data, num_data_padded)
        lab = self._np_label_pad
        if self.sqrt:
            lab = np.sign(lab) * np.sqrt(np.abs(lab))
            self.trans_label = self._dev(lab)
        else:
            self.trans_label = self.label
        self._np_trans_label = lab
        self.is_constant_hessian = self.weights is None

    def get_gradients(self, score, class_id=0):
        return self._w(score - self.trans_label, torch.ones_like(score))

    def boost_from_score(self, class_id=0):
        lab = self._np_trans_label[:self.num_data].astype(np.float64)
        if self._np_weights is not None:
            w = self._np_weights.astype(np.float64)
            return float((lab * w).sum() / w.sum())
        return float(lab.mean())

    def convert_output(self, raw):
        if self.sqrt:
            return np.sign(raw) * raw * raw
        return raw


class RegressionL1(RegressionL2):
    """`regression_objective.hpp:182-298`; leaf renewed to weighted median."""
    name = "regression_l1"
    is_constant_hessian = True

    def get_gradients(self, score, class_id=0):
        g = torch.sign(score - self.trans_label)
        return self._w(g, torch.ones_like(score))

    def boost_from_score(self, class_id=0):
        lab = self._np_label.astype(np.float64)
        if self._np_weights is not None:
            return _weighted_percentile(lab, self._np_weights, 0.5)
        return float(np.percentile(lab, 50, method="lower")
                     if len(lab) % 2 else np.median(lab))

    def renew_tree_output(self, tree, score, leaf_id, mask):
        _percentile_renew(tree, self._np_label, self._np_weights, score,
                          leaf_id, mask, 0.5)


class RegressionHuber(RegressionL2):
    """`regression_objective.hpp:300-360`."""
    name = "huber"
    is_constant_hessian = False

    def get_gradients(self, score, class_id=0):
        a = float(self.cfg.alpha)
        diff = score - self.trans_label
        g = torch.where(torch.abs(diff) <= a, diff, torch.sign(diff) * a)
        return self._w(g, torch.ones_like(score))


class RegressionFair(RegressionL2):
    """`regression_objective.hpp:362-407`."""
    name = "fair"
    is_constant_hessian = False

    def get_gradients(self, score, class_id=0):
        c = float(self.cfg.fair_c)
        x = score - self.trans_label
        g = c * x / (torch.abs(x) + c)
        h = c * c / (torch.abs(x) + c) ** 2
        return self._w(g, h)

    def boost_from_score(self, class_id=0):
        return 0.0


class RegressionPoisson(RegressionL2):
    """`regression_objective.hpp:409-487`; score is log(E[y])."""
    name = "poisson"
    is_constant_hessian = False

    def get_gradients(self, score, class_id=0):
        g = torch.exp(score) - self.label
        h = torch.exp(score + float(self.cfg.poisson_max_delta_step))
        return self._w(g, h)

    def boost_from_score(self, class_id=0):
        mean = RegressionL2.boost_from_score(self, class_id)
        return math.log(max(mean, 1e-20))

    def convert_output(self, raw):
        return np.exp(raw)


class RegressionQuantile(RegressionL2):
    """`regression_objective.hpp:489-616`."""
    name = "quantile"
    is_constant_hessian = True

    def get_gradients(self, score, class_id=0):
        a = float(self.cfg.alpha)
        g = torch.where(score > self.label, 1.0 - a, -a).to(torch.float32)
        return self._w(g, torch.ones_like(score))

    def boost_from_score(self, class_id=0):
        lab = self._np_label.astype(np.float64)
        if self._np_weights is not None:
            return _weighted_percentile(lab, self._np_weights, self.cfg.alpha)
        return _percentile(lab, self.cfg.alpha)

    def renew_tree_output(self, tree, score, leaf_id, mask):
        _percentile_renew(tree, self._np_label, self._np_weights, score,
                          leaf_id, mask, self.cfg.alpha)


class RegressionMAPE(RegressionL2):
    """`regression_objective.hpp:618-735`."""
    name = "mape"
    is_constant_hessian = False

    def init(self, metadata, num_data, num_data_padded):
        super().init(metadata, num_data, num_data_padded)
        lw = 1.0 / np.maximum(1.0, np.abs(self._np_label_pad))
        if self.weights is not None:
            lw = lw * self._np_weights_pad
        self.label_weight = self._dev(lw.astype(np.float32))
        # the float64 host weights of boost_from_score and the renewal
        lw = 1.0 / np.maximum(1.0, np.abs(self._np_label.astype(np.float64)))
        if self._np_weights is not None:
            lw = lw * self._np_weights
        self._np_label_weight = lw

    def get_gradients(self, score, class_id=0):
        g = torch.sign(score - self.label) * self.label_weight
        h = torch.ones_like(score) if self.weights is None else self.weights
        return g, h

    def boost_from_score(self, class_id=0):
        return _weighted_percentile(self._np_label.astype(np.float64),
                                    self._np_label_weight, 0.5)

    def renew_tree_output(self, tree, score, leaf_id, mask):
        _percentile_renew(tree, self._np_label, self._np_label_weight,
                          score, leaf_id, mask, 0.5)


class RegressionGamma(RegressionPoisson):
    """`regression_objective.hpp:737-768`."""
    name = "gamma"

    def get_gradients(self, score, class_id=0):
        r = self.label / torch.exp(score)
        return self._w(1.0 - r, r)


class RegressionTweedie(RegressionPoisson):
    """`regression_objective.hpp:770-805`."""
    name = "tweedie"

    def get_gradients(self, score, class_id=0):
        rho = float(self.cfg.tweedie_variance_power)
        e1 = torch.exp((1.0 - rho) * score)
        e2 = torch.exp((2.0 - rho) * score)
        g = -self.label * e1 + e2
        h = -self.label * (1.0 - rho) * e1 + (2.0 - rho) * e2
        return self._w(g, h)


# ------------------------------- binary -----------------------------------

class BinaryLogloss(ObjectiveFunction):
    """`src/objective/binary_objective.hpp:13-170`."""
    name = "binary"

    def init(self, metadata, num_data, num_data_padded):
        super().init(metadata, num_data, num_data_padded)
        lab = self._np_label
        cnt_pos = int((lab > 0).sum())
        cnt_neg = int(len(lab) - cnt_pos)
        self.need_train = not (cnt_pos == 0 or cnt_neg == 0)
        lw_neg, lw_pos = 1.0, 1.0
        if self.cfg.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                lw_neg = cnt_pos / cnt_neg
            else:
                lw_pos = cnt_neg / cnt_pos
        lw_pos *= self.cfg.scale_pos_weight
        pos = self.label > 0
        self.label_sign = torch.where(pos, 1.0, -1.0).to(torch.float32)
        self.label_w = torch.where(pos, lw_pos, lw_neg).to(torch.float32)

    def get_gradients(self, score, class_id=0):
        sig = float(self.cfg.sigmoid)
        response = -self.label_sign * sig / (
            1.0 + torch.exp(self.label_sign * sig * score))
        abs_r = torch.abs(response)
        g = response * self.label_w
        h = abs_r * (sig - abs_r) * self.label_w
        return self._w(g, h)

    def boost_from_score(self, class_id=0):
        lab = self._np_label.astype(np.float64)
        pos = (lab > 0).astype(np.float64)
        if self._np_weights is not None:
            w = self._np_weights.astype(np.float64)
            pavg = (pos * w).sum() / w.sum()
        else:
            pavg = pos.mean()
        pavg = min(max(pavg, kEpsilon), 1.0 - kEpsilon)
        return math.log(pavg / (1.0 - pavg)) / self.cfg.sigmoid

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-self.cfg.sigmoid * raw))

    def class_need_train(self, class_id):
        return self.need_train


# ------------------------------ multiclass --------------------------------

def _class_labels(label: np.ndarray, num_class: int) -> np.ndarray:
    li = label.astype(np.int32)
    if li.size and (li.min() < 0 or li.max() >= num_class):
        raise ValueError(f"Label must be in [0, {num_class})")
    return li


class MulticlassSoftmax(ObjectiveFunction):
    """`src/objective/multiclass_objective.hpp:16-160`: K trees per
    iteration over a shared softmax; the gradients of all classes are
    computed at once (``get_gradients_all``).  As the JAX class, it has no
    ``boost_from_score`` (0)."""
    name = "multiclass"

    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        self.num_class = cfg.num_class
        self.num_model_per_iteration = cfg.num_class

    def init(self, metadata, num_data, num_data_padded):
        super().init(metadata, num_data, num_data_padded)
        li = _class_labels(self._np_label, self.num_class)
        onehot = np.zeros((self.num_class, num_data_padded), dtype=np.float32)
        onehot[li, np.arange(len(li))] = 1.0
        self.label_onehot = self._dev(onehot)

    def get_gradients_all(self, score_kn: torch.Tensor):
        """score (K, N) -> grads, hess (K, N) (`multiclass_objective.hpp:67-112`)."""
        p = torch.softmax(score_kn, dim=0)
        g = p - self.label_onehot
        h = 2.0 * p * (1.0 - p)
        if self.weights is not None:
            g, h = g * self.weights[None, :], h * self.weights[None, :]
        return g, h

    def get_gradients(self, score, class_id=0):
        raise RuntimeError("multiclass gradients are computed jointly; "
                           "use get_gradients_all")

    def convert_output(self, raw):
        # raw (n, K) -> softmax rows
        e = np.exp(raw - raw.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)


class MulticlassOVA(ObjectiveFunction):
    """`multiclass_objective.hpp:166-230`: K independent sigmoid binaries."""
    name = "multiclassova"

    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        self.num_class = cfg.num_class
        self.num_model_per_iteration = cfg.num_class
        self.binaries = []

    def init(self, metadata, num_data, num_data_padded):
        super().init(metadata, num_data, num_data_padded)
        li = _class_labels(self._np_label, self.num_class)
        self.binaries = []
        for k in range(self.num_class):
            sub = BinaryLogloss(self.cfg, self.device)
            meta_k = Metadata(len(li))
            meta_k.set_label((li == k).astype(np.float32))
            if self._np_weights is not None:
                meta_k.set_weights(self._np_weights)
            sub.init(meta_k, num_data, num_data_padded)
            self.binaries.append(sub)

    def get_gradients(self, score, class_id=0):
        return self.binaries[class_id].get_gradients(score)

    def boost_from_score(self, class_id=0):
        return self.binaries[class_id].boost_from_score()

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-self.cfg.sigmoid * raw))


# ----------------------------- cross entropy ------------------------------

def _mean_label_logit(label: np.ndarray, weights: Optional[np.ndarray]
                      ) -> float:
    lab = label.astype(np.float64)
    if weights is not None:
        w = weights.astype(np.float64)
        pavg = (lab * w).sum() / w.sum()
    else:
        pavg = lab.mean()
    pavg = min(max(pavg, kEpsilon), 1.0 - kEpsilon)
    return math.log(pavg / (1.0 - pavg))


class CrossEntropy(ObjectiveFunction):
    """`src/objective/xentropy_objective.hpp:38-137` (labels in [0,1])."""
    name = "cross_entropy"

    def get_gradients(self, score, class_id=0):
        z = torch.sigmoid(score)
        return self._w(z - self.label, z * (1.0 - z))

    def boost_from_score(self, class_id=0):
        return _mean_label_logit(self._np_label, self._np_weights)

    def convert_output(self, raw):
        return 1.0 / (1.0 + np.exp(-raw))

    def to_string(self):
        return "xentropy"


class CrossEntropyLambda(ObjectiveFunction):
    """`xentropy_objective.hpp:142-245`."""
    name = "cross_entropy_lambda"

    def get_gradients(self, score, class_id=0):
        if self.weights is None:
            z = torch.sigmoid(score)
            return z - self.label, z * (1.0 - z)
        w, y = self.weights, self.label
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = 1.0 / epf
        g = (1.0 - y / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - z)
        d = 1.0 + epf
        a = w * epf / (d * d)
        d2 = c - 1.0
        b = (c / (d2 * d2)) * (1.0 + w * epf - c)
        return g, a * (1.0 + y * b)

    def boost_from_score(self, class_id=0):
        return _mean_label_logit(self._np_label, self._np_weights)

    def convert_output(self, raw):
        return np.log1p(np.exp(raw))

    def to_string(self):
        return "xentlambda"


# ---------------------------- percentile utils -----------------------------

def _percentile(values: np.ndarray, alpha: float) -> float:
    """``PercentileFun`` (`regression_objective.hpp:23-37`)."""
    if len(values) <= 1:
        return float(values[0]) if len(values) else 0.0
    position = (len(values) - 1) * alpha
    pos_int = int(position)
    srt = np.sort(values)
    if pos_int == position:
        return float(srt[pos_int])
    frac = position - pos_int
    return float(srt[pos_int] * (1 - frac) + srt[pos_int + 1] * frac)


def _weighted_percentile(values: np.ndarray, weights: np.ndarray,
                         alpha: float) -> float:
    """``WeightedPercentileFun`` (`regression_objective.hpp:39-69`)."""
    if len(values) == 0:
        return 0.0
    if len(values) == 1:
        return float(values[0])
    order = np.argsort(values)
    v, w = np.asarray(values)[order], np.asarray(weights, dtype=np.float64)[order]
    cum = np.cumsum(w) - w * 0.5
    threshold = alpha * w.sum()
    idx = int(np.searchsorted(cum, threshold, side="right")) - 1
    idx = max(0, min(idx, len(v) - 2))
    if cum[idx + 1] <= threshold:
        idx += 1
    if idx == len(v) - 1:
        return float(v[-1])
    frac = (threshold - cum[idx]) / max(cum[idx + 1] - cum[idx], 1e-300)
    return float(v[idx] * (1 - frac) + v[idx + 1] * frac)


def _percentile_renew(tree, label, weights, score, leaf_id, mask, alpha):
    """``RenewTreeOutput`` for the L1 family
    (`regression_objective.hpp:224-298`): set each leaf's output to the alpha
    percentile of (label - score) over its (bagged) rows, in float64."""
    n = len(label)
    leaf_id = np.asarray(leaf_id)[:n]
    mask = np.asarray(mask)[:n] > 0
    resid = label.astype(np.float64) - np.asarray(score)[:n]
    for leaf in range(tree.num_leaves):
        sel = (leaf_id == leaf) & mask
        if not sel.any():
            continue
        if weights is None:
            out = _percentile(resid[sel], alpha)
        else:
            out = _weighted_percentile(resid[sel], np.asarray(weights)[sel],
                                       alpha)
        tree.set_leaf_output(leaf, out)


# ------------------------------- factory -----------------------------------

def create_objective(cfg: Config, device: torch.device
                     ) -> Optional[ObjectiveFunction]:
    """`src/objective/objective_function.cpp:10-82`, the JAX package's table
    (`objectives.py:542-559`)."""
    from .rank_objective import LambdarankNDCG
    table = {
        "regression": RegressionL2, "regression_l1": RegressionL1,
        "huber": RegressionHuber, "fair": RegressionFair,
        "poisson": RegressionPoisson, "quantile": RegressionQuantile,
        "mape": RegressionMAPE, "gamma": RegressionGamma,
        "tweedie": RegressionTweedie, "binary": BinaryLogloss,
        "multiclass": MulticlassSoftmax, "multiclassova": MulticlassOVA,
        "cross_entropy": CrossEntropy,
        "cross_entropy_lambda": CrossEntropyLambda,
        "lambdarank": LambdarankNDCG,
    }
    if cfg.objective in ("none", "null", "custom", "na", ""):
        return None
    if cfg.objective not in table:
        raise ValueError(f"Unknown objective type name: {cfg.objective}")
    return table[cfg.objective](cfg, device)
