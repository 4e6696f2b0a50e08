"""DART: dropout boosting (`src/boosting/dart.hpp:29-210`).

Port of ``lightgbm_tpu/boosting/dart.py``.  Each iteration drops trained
trees at random (uniformly or by weight), takes their output out of the
training score, fits the new tree against the rest, then normalises the
dropped trees and the new one (`dart.hpp:152-196`).  The drops come from
``np.random.RandomState(drop_seed)``, the JAX package's host stream, so
both packages drop the same trees.  The scores move by device traversals
of the training and validation codes; every iteration edits earlier trees
in place (``_model_version``), so DART never pipelines and never stops
early.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .gbdt import GBDT


class DART(GBDT):
    name = "dart"
    _supports_pipeline = False

    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0
        self.drop_index: List[int] = []
        self._drop_rng = np.random.RandomState(cfg.drop_seed)

    def _dropping_trees(self) -> None:
        """`dart.hpp:90-143`: choose the dropped iterations, take their
        trees out of the training score and set this iteration's
        shrinkage."""
        cfg = self.cfg
        self.drop_index = []
        if self._drop_rng.rand() >= cfg.skip_drop:
            drop_rate = cfg.drop_rate
            if not cfg.uniform_drop:
                if self.sum_weight > 0:
                    inv_avg = len(self.tree_weight) / self.sum_weight
                    if cfg.max_drop > 0:
                        drop_rate = min(drop_rate, cfg.max_drop * inv_avg
                                        / self.sum_weight)
                    for i in range(self.iter_):
                        if self._drop_rng.rand() < \
                                drop_rate * self.tree_weight[i] * inv_avg:
                            self.drop_index.append(i)
                            if len(self.drop_index) >= cfg.max_drop > 0:
                                break
            else:
                if cfg.max_drop > 0 and self.iter_ > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / self.iter_)
                for i in range(self.iter_):
                    if self._drop_rng.rand() < drop_rate:
                        self.drop_index.append(i)
                        if len(self.drop_index) >= cfg.max_drop > 0:
                            break
        self._negate_dropped()
        n_drop = len(self.drop_index)
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + n_drop)
        else:
            self.shrinkage_rate = cfg.learning_rate if n_drop == 0 else \
                cfg.learning_rate / (cfg.learning_rate + n_drop)

    def _negate_dropped(self) -> None:
        """Negate the dropped trees and add them to the training score:
        takes them out, or (a second time) puts them back."""
        k = self.num_tree_per_iteration
        for i in self.drop_index:
            for cid in range(k):
                tree = self.models[i * k + cid]
                tree.apply_shrinkage(-1.0)
                self._add_tree_score_train(tree, cid)

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        self._model_version += 1   # drops and normalisation edit trees
        self._dropping_trees()
        ret = super().train_one_iter(gradients, hessians)
        if ret:
            # a failed iteration undoes its drop
            self._negate_dropped()
            self.shrinkage_rate = self.cfg.learning_rate
            return ret
        self._normalize()
        if not self.cfg.uniform_drop:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        return False

    def eval_and_check_early_stopping(self, log=None) -> bool:
        """DART never stops early (`dart.hpp:83-86`)."""
        self.output_metric(self.iter_, log)
        return False

    def _normalize(self) -> None:
        """`dart.hpp:152-196`."""
        cfg = self.cfg
        k = float(len(self.drop_index))
        for i in self.drop_index:
            for cid in range(self.num_tree_per_iteration):
                tree = self.models[i * self.num_tree_per_iteration + cid]
                if not cfg.xgboost_dart_mode:
                    tree.apply_shrinkage(1.0 / (k + 1.0))
                    for vs in self.valid_scores:
                        vs.add_by_tree(tree, cid)
                    tree.apply_shrinkage(-k)
                    self._add_tree_score_train(tree, cid)
                else:
                    tree.apply_shrinkage(self.shrinkage_rate)
                    for vs in self.valid_scores:
                        vs.add_by_tree(tree, cid)
                    tree.apply_shrinkage(-k / cfg.learning_rate)
                    self._add_tree_score_train(tree, cid)
            if not cfg.uniform_drop:
                if not cfg.xgboost_dart_mode:
                    self.sum_weight -= self.tree_weight[i] * (1.0 / (k + 1.0))
                    self.tree_weight[i] *= k / (k + 1.0)
                else:
                    self.sum_weight -= self.tree_weight[i] * (
                        1.0 / (k + cfg.learning_rate))
                    self.tree_weight[i] *= k / (k + cfg.learning_rate)
