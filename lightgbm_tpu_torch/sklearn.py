"""scikit-learn estimator API.

Port of ``lightgbm_tpu/sklearn.py``, which, like this module, does not
import scikit-learn: the estimators follow its conventions without it.
Mirrors `python-package/lightgbm/sklearn.py:133-900` (``LGBMModel``,
``LGBMRegressor`` `:667`, ``LGBMClassifier`` `:693`, ``LGBMRanker`` `:821`):
same constructor surface, ``fit``/``predict``/``predict_proba``, and the
fitted attributes (`best_score_`, `best_iteration_`, `feature_importances_`).
The estimators train on the card unless ``device_type="cpu"`` is passed.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .dataset import Dataset
from .engine import Booster, train


class LGBMModel:
    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[str] = None, class_weight=None,
                 min_split_gain: float = 0.0, min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 0, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 random_state=None, n_jobs: int = -1, silent: bool = True,
                 importance_type: str = "split", **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        self._other_params = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._n_features = 0
        self._objective = objective
        self.best_score_: Dict = {}
        self.best_iteration_: int = -1

    # -- sklearn plumbing ----------------------------------------------------

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {
            "boosting_type": self.boosting_type, "num_leaves": self.num_leaves,
            "max_depth": self.max_depth, "learning_rate": self.learning_rate,
            "n_estimators": self.n_estimators,
            "subsample_for_bin": self.subsample_for_bin,
            "objective": self.objective, "class_weight": self.class_weight,
            "min_split_gain": self.min_split_gain,
            "min_child_weight": self.min_child_weight,
            "min_child_samples": self.min_child_samples,
            "subsample": self.subsample, "subsample_freq": self.subsample_freq,
            "colsample_bytree": self.colsample_bytree,
            "reg_alpha": self.reg_alpha, "reg_lambda": self.reg_lambda,
            "random_state": self.random_state, "n_jobs": self.n_jobs,
            "silent": self.silent, "importance_type": self.importance_type,
        }
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for key, value in params.items():
            if hasattr(self, key):
                setattr(self, key, value)
            else:
                self._other_params[key] = value
        return self

    def _default_objective(self) -> str:
        return "regression"

    def _build_params(self) -> Dict[str, Any]:
        params = {
            "boosting": self.boosting_type,
            "objective": self.objective or self._default_objective(),
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "bin_construct_sample_cnt": self.subsample_for_bin,
            "min_gain_to_split": self.min_split_gain,
            "min_sum_hessian_in_leaf": self.min_child_weight,
            "min_data_in_leaf": self.min_child_samples,
            "bagging_fraction": self.subsample,
            "bagging_freq": self.subsample_freq,
            "feature_fraction": self.colsample_bytree,
            "lambda_l1": self.reg_alpha,
            "lambda_l2": self.reg_lambda,
            "verbosity": -1 if self.silent else 1,
        }
        if self.random_state is not None:
            params["seed"] = int(self.random_state) \
                if not hasattr(self.random_state, "randint") \
                else int(self.random_state.randint(2 ** 31))
        params.update(self._other_params)
        return params

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_class_weight=None, eval_init_score=None, eval_group=None,
            eval_metric=None, early_stopping_rounds=None, verbose=True,
            feature_name="auto", categorical_feature="auto", callbacks=None
            ) -> "LGBMModel":
        params = self._build_params()
        if eval_metric is not None and not callable(eval_metric):
            params["metric"] = eval_metric
        X = _as_2d(X)
        y = np.asarray(y).reshape(-1)
        self._n_features = X.shape[1]
        train_set = Dataset(X, label=self._process_label(y),
                            weight=sample_weight, group=group,
                            init_score=init_score, params=params,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature)
        valid_sets: List[Dataset] = []
        names: List[str] = []
        if eval_set is not None:
            for i, (vx, vy) in enumerate(eval_set):
                if vx is X and vy is y:
                    valid_sets.append(train_set)
                else:
                    vw = eval_sample_weight[i] if eval_sample_weight else None
                    vg = eval_group[i] if eval_group else None
                    vi = eval_init_score[i] if eval_init_score else None
                    valid_sets.append(train_set.create_valid(
                        _as_2d(vx), label=self._process_label(
                            np.asarray(vy).reshape(-1)),
                        weight=vw, group=vg, init_score=vi))
                names.append(eval_names[i] if eval_names else f"valid_{i}")
        feval = _wrap_feval(eval_metric) if callable(eval_metric) else None
        self._Booster = train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets, valid_names=names, feval=feval,
            early_stopping_rounds=early_stopping_rounds,
            verbose_eval=verbose, callbacks=callbacks)
        self.best_score_ = self._Booster.best_score
        self.best_iteration_ = self._Booster.best_iteration
        return self

    def _process_label(self, y):
        return y

    def predict(self, X, raw_score: bool = False, num_iteration: int = -1,
                pred_leaf: bool = False, pred_contrib: bool = False, **kwargs):
        if self._Booster is None:
            raise _NotFittedError("Estimator not fitted, call `fit` first")
        return self._Booster.predict(_as_2d(X), num_iteration=num_iteration,
                                     raw_score=raw_score, pred_leaf=pred_leaf,
                                     pred_contrib=pred_contrib)

    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise _NotFittedError("No booster found, call `fit` first")
        return self._Booster

    @property
    def feature_importances_(self) -> np.ndarray:
        return self.booster_.feature_importance(self.importance_type)

    @property
    def n_features_(self) -> int:
        return self._n_features

    @property
    def evals_result_(self):
        return self.booster_.gbdt.eval_history


class LGBMRegressor(LGBMModel):
    def _default_objective(self):
        return "regression"


class LGBMClassifier(LGBMModel):
    def _default_objective(self):
        return "binary" if getattr(self, "_n_classes", 2) <= 2 else "multiclass"

    def fit(self, X, y, **kwargs):
        y = np.asarray(y).reshape(-1)
        self._classes = np.unique(y)
        self._n_classes = len(self._classes)
        if self._n_classes > 2:
            self._other_params.setdefault("num_class", self._n_classes)
            if self.objective is None:
                self.objective = "multiclass"
        self._label_map = {c: i for i, c in enumerate(self._classes)}
        return super().fit(X, y, **kwargs)

    def _process_label(self, y):
        return np.asarray([self._label_map[v] for v in y], dtype=np.float64)

    def predict(self, X, raw_score=False, num_iteration=-1, pred_leaf=False,
                pred_contrib=False, **kwargs):
        result = self.predict_proba(X, raw_score, num_iteration, pred_leaf,
                                    pred_contrib)
        if raw_score or pred_leaf or pred_contrib:
            return result
        return self._classes[np.argmax(result, axis=1)]

    def predict_proba(self, X, raw_score=False, num_iteration=-1,
                      pred_leaf=False, pred_contrib=False):
        result = super().predict(X, raw_score, num_iteration, pred_leaf,
                                 pred_contrib)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if self._n_classes == 2 and result.ndim == 1:
            return np.vstack([1.0 - result, result]).T
        return result

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self):
        return self._n_classes


class LGBMRanker(LGBMModel):
    def _default_objective(self):
        return "lambdarank"

    def fit(self, X, y, group=None, **kwargs):
        if group is None:
            raise ValueError("Should set group for ranking task")
        return super().fit(X, y, group=group, **kwargs)


class _NotFittedError(ValueError):
    pass


def _as_2d(X):
    if hasattr(X, "values") and not isinstance(X, np.ndarray):
        X = X.values
    X = np.asarray(X, dtype=np.float64)
    if X.ndim == 1:
        X = X.reshape(1, -1)
    return X


def _wrap_feval(func: Callable) -> Callable:
    def inner(preds, dataset):
        res = func(np.asarray(dataset.get_label() if dataset else []), preds)
        return res
    return inner
