"""Training engine: ``train`` and the ``Booster`` facade.

Port of the part of ``lightgbm_tpu/engine.py`` this slice runs: ``train``
with validation sets (query groups included), evaluation history and
callbacks (early stopping via ``callback.early_stopping``), and ``Booster``
training, prediction ((n,) or (n, K) for K classes) and model text, for
every objective of the JAX package's table.  The device comes from ``device_type`` (``config.resolve_device``): the
CUDA card unless the params ask for the CPU.  ``cv``, custom objectives and
continued training come with a later slice.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import callback as callback_mod
from .boosting.gbdt import GBDT
from .config import Config, check_supported, resolve_device
from .dataset import Dataset, recode_pandas
from .metrics import create_metric
from .objectives import create_objective


class Booster:
    """User-facing booster handle (`python-package/lightgbm/basic.py:1577`)."""

    def __init__(self, params: Optional[Dict] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        params = dict(params or {})
        self.params = params
        self.cfg = Config.from_params(params)
        self.device = resolve_device(self.cfg)
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._train_set = train_set
        self.gbdt = GBDT(self.cfg, self.device)
        if train_set is not None:
            check_supported(self.cfg)
            train_set.construct()
            objective = create_objective(self.cfg, self.device)
            train_metrics = []
            if self.cfg.is_provide_training_metric:
                train_metrics = self._make_metrics(train_set)
            self.gbdt.init(train_set, objective, train_metrics)
        elif model_file is not None:
            with open(model_file) as fh:
                self.gbdt.load_model_from_string(fh.read())
        elif model_str is not None:
            self.gbdt.load_model_from_string(model_str)
        else:
            raise ValueError("At least one of params/train_set, model_file "
                             "or model_str should be provided")

    @classmethod
    def _from_gbdt(cls, params: Dict, gbdt: GBDT) -> "Booster":
        """A booster around a GBDT built elsewhere (``interop.py``)."""
        self = cls.__new__(cls)
        self.params, self.cfg, self.device = params, gbdt.cfg, gbdt.device
        self.best_iteration, self.best_score = -1, {}
        self._train_set, self.gbdt = None, gbdt
        return self

    def _make_metrics(self, dataset: Dataset):
        metrics = []
        for name in self.cfg.metric:
            m = create_metric(name, self.cfg)
            if m is not None:
                m.init(dataset.constructed.metadata,
                       dataset.constructed.num_data)
                metrics.append(m)
        return metrics

    # -- training-side API ---------------------------------------------------

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        data.construct()
        self.gbdt.add_valid_data(data, name, self._make_metrics(data))
        return self

    def update(self) -> bool:
        """One boosting iteration; returns True if training should stop."""
        return self.gbdt.train_one_iter()

    @property
    def current_iteration(self) -> int:
        return self.gbdt.iter_

    def num_trees(self) -> int:
        return len(self.gbdt.models)

    # -- evaluation ----------------------------------------------------------

    def eval_train(self) -> List[Tuple]:
        return self._eval_set("training", self.gbdt.train_score,
                              self.gbdt.training_metrics)

    def eval_valid(self) -> List[Tuple]:
        out = []
        for i, name in enumerate(self.gbdt.valid_names):
            out.extend(self._eval_set(name, self.gbdt.valid_scores[i],
                                      self.gbdt.valid_metrics[i]))
        return out

    def _eval_set(self, name, updater, metrics) -> List[Tuple]:
        results = []
        if metrics:
            score = self.gbdt.metric_score(updater)
            for m in metrics:
                for mname, val in m.eval(score, self.gbdt.objective):
                    results.append((name, mname, val, m.is_higher_better))
        for dname, mname, val, _ in results:
            self.gbdt.eval_history.setdefault(dname, {}).setdefault(
                mname, []).append(val)
        return results

    # -- prediction / persistence -------------------------------------------

    def predict(self, data, num_iteration: int = -1, raw_score: bool = False,
                pred_leaf: bool = False) -> np.ndarray:
        """Raw scores, probabilities or leaf indices.  Large batches (rows x
        trees >= 200,000) and ``pred_early_stop`` traverse every tree on the
        booster's device (``predictor.DevicePredictor``), smaller ones walk
        the host trees, as ``GBDT.predict_raw`` routes.  A DataFrame's
        ``category`` columns are coded through the model's stored category
        lists."""
        if hasattr(data, "dtypes") and hasattr(data, "columns") \
                and not isinstance(data, np.ndarray):
            data = self._predict_data_from_pandas(data)
        elif hasattr(data, "values") and not isinstance(data, np.ndarray):
            data = data.values
        data = np.asarray(data, dtype=np.float64)
        return self.gbdt.predict(data, num_iteration, raw_score, pred_leaf)

    def _predict_data_from_pandas(self, df) -> np.ndarray:
        """Predict-time DataFrame conversion (JAX
        ``engine.py:_predict_data_from_pandas``): the category lists
        recorded at training define the code space; unseen values -> NaN."""
        stored = self.gbdt.pandas_categorical
        cat_cols = [j for j, c in enumerate(df.columns)
                    if str(df.dtypes.iloc[j]) == "category"]
        if not cat_cols:
            return np.asarray(df.values, dtype=np.float64)
        if stored is None or len(stored) != len(cat_cols):
            raise ValueError(
                "train and predict dataset categorical_feature do not "
                f"match ({0 if stored is None else len(stored)} recorded "
                f"category columns vs {len(cat_cols)} in this DataFrame)")
        return recode_pandas(df, cat_cols, stored)

    def save_model(self, filename: str, num_iteration: int = -1,
                   start_iteration: int = 0) -> "Booster":
        if num_iteration < 0:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else -1
        self.gbdt.save_model_to_file(filename, start_iteration, num_iteration)
        return self

    def model_to_string(self, num_iteration: int = -1,
                        start_iteration: int = 0) -> str:
        if num_iteration < 0:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else -1
        return self.gbdt.save_model_to_string(start_iteration, num_iteration)

    def feature_importance(self, importance_type: str = "split",
                           iteration: int = -1) -> np.ndarray:
        return self.gbdt.feature_importance(importance_type, iteration)

    def feature_name(self) -> List[str]:
        return list(self.gbdt.feature_names)

    def num_feature(self) -> int:
        return self.gbdt.max_feature_idx + 1


def train(params: Dict, train_set: Dataset, num_boost_round: int = 100,
          valid_sets: Optional[Sequence[Dataset]] = None,
          valid_names: Optional[Sequence[str]] = None,
          evals_result: Optional[Dict] = None, verbose_eval=True,
          callbacks: Optional[List[Callable]] = None) -> Booster:
    """`python-package/lightgbm/engine.py:19-245` semantics for the ported
    subset."""
    params = dict(params or {})
    if "num_iterations" not in params and num_boost_round is not None:
        params["num_iterations"] = num_boost_round
    num_boost_round = Config.from_params(params).num_iterations
    train_set.params = {**params, **(train_set.params or {})}
    booster = Booster(params=params, train_set=train_set)

    for i, vs in enumerate(valid_sets or []):
        if vs is train_set:
            continue
        name = (valid_names[i] if valid_names and i < len(valid_names)
                else f"valid_{i}")
        booster.add_valid(vs, name)

    callbacks = list(callbacks or [])
    if verbose_eval is True:
        callbacks.append(callback_mod.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval >= 1:
        callbacks.append(callback_mod.print_evaluation(verbose_eval))
    if evals_result is not None:
        callbacks.append(callback_mod.record_evaluation(evals_result))
    before = sorted((cb for cb in callbacks
                     if getattr(cb, "before_iteration", False)),
                    key=lambda cb: getattr(cb, "order", 0))
    after = sorted((cb for cb in callbacks
                    if not getattr(cb, "before_iteration", False)),
                   key=lambda cb: getattr(cb, "order", 0))

    results: List[Tuple] = []
    for i in range(num_boost_round):
        env = callback_mod.CallbackEnv(
            model=booster, params=params, iteration=i, begin_iteration=0,
            end_iteration=num_boost_round, evaluation_result_list=None)
        for cb in before:
            cb(env)
        finished = booster.update()
        results = booster.eval_train() + booster.eval_valid()
        env = env._replace(evaluation_result_list=results)
        try:
            for cb in after:
                cb(env)
        except callback_mod.EarlyStopException as es:
            booster.best_iteration = es.best_iteration + 1
            for name, mname, val, _ in es.best_score:
                booster.best_score.setdefault(name, {})[mname] = val
            break
        if finished:
            break
    if booster.best_iteration <= 0:
        for name, mname, val, _ in results:
            booster.best_score.setdefault(name, {})[mname] = val
    return booster
