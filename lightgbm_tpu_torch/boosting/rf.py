"""Random forest (`src/boosting/rf.hpp:18-180`).

Port of ``lightgbm_tpu/boosting/rf.py``.  Bagged trees, each fit to the
gradients at the constant init score (computed once, every class of a
multiclass objective jointly), no shrinkage, leaf renewal at that constant
score, and averaged output (``average_output``): the running scores are the
mean of the trees so far (``_multiply_score``), and ``predict_raw`` divides
the sum of the trees by their iteration count on the host path and the
``DevicePredictor`` path alike.  The learners train synchronously (one host
read per tree).
"""

from __future__ import annotations

import numpy as np

from ..binning import kEpsilon
from ..dataset import upload
from ..tree import Tree
from .gbdt import GBDT


class RF(GBDT):
    name = "rf"

    def init(self, train_data, objective, training_metrics=()) -> None:
        cfg = self.cfg
        if not (cfg.bagging_freq > 0 and 0.0 < cfg.bagging_fraction < 1.0):
            raise ValueError("RF mode requires bagging "
                             "(bagging_freq > 0 and bagging_fraction in "
                             "(0,1))")
        if not 0.0 < cfg.feature_fraction <= 1.0:
            raise ValueError("RF mode requires feature_fraction in (0, 1]")
        super().init(train_data, objective, training_metrics)
        self.average_output = True
        self.shrinkage_rate = 1.0
        k_trees = self.num_tree_per_iteration
        # gradients once, at the constant init score (`rf.hpp:76-95`)
        self.init_scores = [
            (self.objective.boost_from_score(k)
             if self.objective is not None and cfg.boost_from_average
             else 0.0) for k in range(k_trees)]
        n_pad = self.train_data.num_data_padded
        const = np.stack([np.full(n_pad, np.float32(s), np.float32)
                          for s in self.init_scores])
        const = upload(const, self.device)
        if self.objective.name == "multiclass":
            g, h = self.objective.get_gradients_all(const)
            self._rf_grads = list(zip(g, h))
        else:
            self._rf_grads = [self.objective.get_gradients(const[k], k)
                              for k in range(k_trees)]

    def add_valid_data(self, valid_data, name, metrics) -> None:
        """The replayed trees averaged (`rf.hpp` AddValidDataset)."""
        super().add_valid_data(valid_data, name, metrics)
        if self.iter_ > 0:
            f = float(np.float32(1.0 / self.iter_))
            for k in range(self.num_tree_per_iteration):
                self.valid_scores[-1].score[k] *= f

    def _multiply_score(self, class_id: int, factor: float) -> None:
        f = float(np.float32(factor))
        self.train_score.score[class_id] *= f
        for vs in self.valid_scores:
            vs.score[class_id] *= f

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        self._bagging(self.iter_)
        renew = self.objective is not None \
            and self.objective.needs_renew_tree_output
        should_continue = False
        for k in range(self.num_tree_per_iteration):
            new_tree = Tree(2)
            if self.class_need_train[k]:
                grad, hess = self._rf_grads[k]
                new_tree, leaf_id, _ = self.learner.train(
                    grad, hess, self._bag_mask, self._feature_sample())
            if new_tree.num_leaves > 1:
                should_continue = True
                if renew:
                    # the renewal at the constant init score: one read of
                    # the tree's leaf ids
                    lid = leaf_id.cpu().numpy().astype(np.int64)
                    self.host_syncs += 1
                    self.renew_reads += 1
                    self.objective.renew_tree_output(
                        new_tree, np.full(self.num_data, self.init_scores[k],
                                          dtype=np.float64),
                        lid, self._np_bag())
                if abs(self.init_scores[k]) > kEpsilon:
                    new_tree.leaf_value[:new_tree.num_leaves] += \
                        self.init_scores[k]
                # the running average of the trees (`rf.hpp:131-134`)
                self._multiply_score(k, self.iter_)
                lv = upload(new_tree.leaf_value[:new_tree.num_leaves]
                            .astype(np.float32), self.device)
                self.train_score.add_by_leaf_id(lv, leaf_id, k)
                for vs in self.valid_scores:
                    vs.add_by_tree(new_tree, k)
                self._multiply_score(k, 1.0 / (self.iter_ + 1))
            elif len(self.models) < self.num_tree_per_iteration:
                output = (self.objective.boost_from_score(k)
                          if self.objective is not None
                          and not self.class_need_train[k]
                          else self.init_scores[k])
                new_tree = Tree(2)
                new_tree.num_leaves = 1
                new_tree.leaf_value[0] = output
                self.train_score.add_constant(output, k)
                for vs in self.valid_scores:
                    vs.add_constant(output, k)
            self.models.append(new_tree)
        if not should_continue:
            if len(self.models) > self.num_tree_per_iteration:
                del self.models[-self.num_tree_per_iteration:]
            return True
        self.iter_ += 1
        return False

    def predict_raw(self, X: np.ndarray, num_iteration: int = -1
                    ) -> np.ndarray:
        raw = super().predict_raw(X, num_iteration)
        n_iter = self._num_models_for(num_iteration) // max(
            self.num_tree_per_iteration, 1)
        return raw / max(n_iter, 1)
