"""Objective functions as element-wise torch maps ``score -> (grad, hess)``.

Port of the part of ``lightgbm_tpu/objectives.py`` this slice runs:
``BinaryLogloss`` (`:283-331`) and ``RegressionL2`` (`:99`), with the same
formulas.  Gradients are float32 tensors over the padded row axis on the
booster's device; padded rows are neutralized by the bagging mask downstream.
Every other objective raises ``NotImplementedError`` (``config.check_supported``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .binning import kEpsilon
from .config import BREADTH, Config, not_ported
from .dataset import Metadata


class ObjectiveFunction:
    """Base (reference `objective_function.h:15-74`)."""

    name = "none"
    num_model_per_iteration = 1

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
        self.label = torch.from_numpy(lab).to(self.device)
        if metadata.weights is not None:
            w = np.zeros(num_data_padded, dtype=np.float32)
            w[:num_data] = metadata.weights
            self.weights = torch.from_numpy(w).to(self.device)
        self._np_label = metadata.label
        self._np_weights = metadata.weights

    def get_gradients(self, score: torch.Tensor, class_id: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        return raw

    def class_need_train(self, class_id: int) -> bool:
        return True

    def to_string(self) -> str:
        return self.name


class RegressionL2(ObjectiveFunction):
    """`regression_objective.hpp:71-180` (without the sqrt transform)."""
    name = "regression"

    def get_gradients(self, score, class_id=0):
        g = score - self.label
        h = torch.ones_like(score)
        if self.weights is not None:
            g, h = g * self.weights, h * self.weights
        return g, h

    def boost_from_score(self, class_id=0):
        lab = self._np_label.astype(np.float64)
        if self._np_weights is not None:
            w = self._np_weights.astype(np.float64)
            return float((lab * w).sum() / w.sum())
        return float(lab.mean())


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
        if self.weights is not None:
            g, h = g * self.weights, h * self.weights
        return g, h

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


def create_objective(cfg: Config, device: torch.device
                     ) -> Optional[ObjectiveFunction]:
    """`src/objective/objective_function.cpp:10-82`, for the ported subset."""
    if cfg.objective in ("none", "null", "custom", "na", ""):
        return None
    table = {"regression": RegressionL2, "binary": BinaryLogloss}
    if cfg.objective not in table:
        raise not_ported(f"objective={cfg.objective}", BREADTH)
    return table[cfg.objective](cfg, device)
