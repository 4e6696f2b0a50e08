"""Training engine: ``train``, ``cv`` and the ``Booster`` facade.

Port of ``lightgbm_tpu/engine.py``: ``train`` with validation sets (query
groups included), custom objectives (``fobj``) and metrics (``feval``),
continued training (``init_model``), early stopping, learning-rate schedules
and callbacks; ``cv`` with stratified folds and early stopping on the folds'
mean in lockstep; and ``Booster`` training, prediction ((n,) or (n, K) for
K classes, leaf indices, TreeSHAP contributions through ``contrib.py``),
model text, ``dump_model``, ``rollback_one_iter``, ``refit`` and
``refit_file`` and pickling, for every objective of the JAX package's table
and every boosting variant (``boosting/__init__.py``), and the prediction
server (``to_server``, ``serve``: ``serving/``).  The device comes from
``device_type`` (``config.resolve_device``): the CUDA card unless the params
ask for the CPU.
"""

from __future__ import annotations

import collections
import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import callback as callback_mod
from .boosting import create_boosting
from .boosting.gbdt import GBDT, rebind_tree_to_dataset
from .config import (OBSERVE, SERVING, Config, check_serving_supported,
                     check_supported, not_ported, resolve_device)
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
        if train_set is not None:
            check_supported(self.cfg)
            train_set.construct()
            objective = create_objective(self.cfg, self.device)
            self.gbdt = create_boosting(self.cfg, self.device)
            train_metrics = []
            if self.cfg.is_provide_training_metric:
                train_metrics = self._make_metrics(train_set)
            self.gbdt.init(train_set, objective, train_metrics)
        elif model_file is not None:
            with open(model_file) as fh:
                self._load_from_string(fh.read())
        elif model_str is not None:
            self._load_from_string(model_str)
        else:
            raise ValueError("At least one of params/train_set, model_file "
                             "or model_str should be provided")

    def _load_from_string(self, s: str) -> None:
        """A text-loaded model is a plain GBDT, whatever it was trained
        with, as in the JAX package (so an ``average_output`` model is not
        averaged: ROADMAP.md Queue C)."""
        self.gbdt = create_boosting(self.cfg, self.device, "gbdt")
        self.gbdt.load_model_from_string(s)

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

    def update(self, train_set: Optional[Dataset] = None,
               fobj: Optional[Callable] = None) -> bool:
        """One boosting iteration (`basic.py:1842`); returns True if
        training should stop.  ``fobj(preds, train_set)`` returns the
        gradients and hessians of a custom objective at the current raw
        scores (one host read)."""
        if fobj is None:
            return self.gbdt.train_one_iter()
        grad, hess = fobj(self._curr_preds(), self._train_set)
        return self.gbdt.train_one_iter(grad, hess)

    def _curr_preds(self) -> np.ndarray:
        return self.gbdt.metric_score(self.gbdt.train_score)

    def rollback_one_iter(self) -> "Booster":
        self.gbdt.rollback_one_iter()
        return self

    @property
    def current_iteration(self) -> int:
        return self.gbdt.iter_

    def num_trees(self) -> int:
        return len(self.gbdt.models)

    # -- evaluation ----------------------------------------------------------

    def eval_train(self, feval: Optional[Callable] = None) -> List[Tuple]:
        return self._eval_set("training", self.gbdt.train_score,
                              self.gbdt.training_metrics, feval,
                              self._train_set)

    def eval_valid(self, feval: Optional[Callable] = None) -> List[Tuple]:
        out = []
        for i, name in enumerate(self.gbdt.valid_names):
            out.extend(self._eval_set(name, self.gbdt.valid_scores[i],
                                      self.gbdt.valid_metrics[i], feval,
                                      None))
        return out

    def _eval_set(self, name, updater, metrics, feval=None,
                  dataset=None) -> List[Tuple]:
        """The metrics and ``feval(raw scores, dataset) -> (name, value,
        higher_better)`` on one set's scores (one host read)."""
        results = []
        if metrics or feval is not None:
            score = self.gbdt.metric_score(updater)
            for m in metrics:
                for mname, val in m.eval(score, self.gbdt.objective):
                    results.append((name, mname, val, m.is_higher_better))
            if feval is not None:
                fname, fval, higher_better = feval(score, dataset)
                results.append((name, fname, fval, higher_better))
        for dname, mname, val, _ in results:
            self.gbdt.eval_history.setdefault(dname, {}).setdefault(
                mname, []).append(val)
        return results

    # -- prediction / persistence -------------------------------------------

    def predict(self, data, num_iteration: int = -1, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                **kwargs) -> np.ndarray:
        """Raw scores, probabilities, leaf indices or (``pred_contrib``)
        TreeSHAP contributions on the host (``contrib.py``: (n, F + 1), the
        expected value last; (n, K * (F + 1)) for K classes).  Large batches
        (rows x trees >= 200,000) and ``pred_early_stop`` bin and traverse
        every tree on the booster's device (``predictor.DevicePredictor``),
        smaller ones walk the host trees, as ``GBDT.predict_raw`` routes.  A
        DataFrame's ``category`` columns are coded through the model's
        stored category lists.  Other keyword arguments are accepted and
        unused, as in the JAX package."""
        if hasattr(data, "dtypes") and hasattr(data, "columns") \
                and not isinstance(data, np.ndarray):
            data = self._predict_data_from_pandas(data)
        elif hasattr(data, "values") and not isinstance(data, np.ndarray):
            data = data.values
        data = np.asarray(data, dtype=np.float64)
        if pred_contrib:
            from .contrib import predict_contrib
            return predict_contrib(self.gbdt, data, num_iteration)
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

    def dump_model(self, num_iteration: int = -1, start_iteration: int = 0
                   ) -> Dict:
        """The model as a JSON-able dict (`basic.py:2102`, ``DumpModel``
        `gbdt_model_text.cpp:15`) with the pandas category lists."""
        if num_iteration < 0:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else -1
        ret = self.gbdt.dump_model(start_iteration, num_iteration)
        ret["pandas_categorical"] = self.gbdt.pandas_categorical
        return ret

    def refit(self, data, label, decay_rate: float = 0.9,
              **kwargs) -> "Booster":
        """A new booster with this model's trees, their leaf values refit
        on ``data`` (`basic.py:2284` -> ``GBDT::RefitTree``,
        `gbdt.cpp:262-286`); its trees keep this model's thresholds and are
        rebound only if training continues on them, so it predicts through
        the host trees."""
        leaf_preds = np.atleast_2d(np.asarray(
            self.predict(data, pred_leaf=True, **kwargs)))
        new_train = Dataset(data, label=label, params=dict(self.params))
        new_booster = Booster(params=dict(self.params), train_set=new_train)
        new_booster.gbdt.models = [copy.deepcopy(t)
                                   for t in self.gbdt.models]
        new_booster.gbdt.iter_ = len(new_booster.gbdt.models) // max(
            new_booster.gbdt.num_tree_per_iteration, 1)
        for tree in new_booster.gbdt.models:
            tree.needs_rebind = True
        new_booster.gbdt.refit_leaf_preds(leaf_preds, decay_rate)
        return new_booster

    def refit_file(self, data_path: str, decay_rate: float = 0.9
                   ) -> "Booster":
        """CLI ``task=refit``: refit the leaf values in place on a text data
        file's rows (JAX ``engine.py:302-308``)."""
        from .io.parser import load_data_file

        mat, label, _, _ = load_data_file(data_path, self.params)
        self.gbdt = self.refit(mat, label, decay_rate).gbdt
        return self

    def feature_importance(self, importance_type: str = "split",
                           iteration: int = -1) -> np.ndarray:
        return self.gbdt.feature_importance(importance_type, iteration)

    def to_server(self, replicas: int = 0, **kwargs):
        """An UNSTARTED ``serving.PredictionServer`` with this booster
        registered as the ``default`` model, serving on the booster's
        device (JAX ``engine.py:321-339``).  Keyword args are forwarded
        (host/port/max_batch_rows/deadline_ms/min_bucket/warmup/
        max_inflight/telemetry_out, trace/trace_out/trace_capacity/
        stats_out/stats_interval_s, record_rows, slo_p99_ms/slo_target).
        The booster's params may carry ``telemetry_out``, ``trace_out``,
        ``trace_capacity``, ``stats_out`` and ``fault_spec`` (armed here),
        as ``task=serve``'s do; keyword args win.  ``replicas`` other than
        0 asks for the serving fleet, which is not ported."""
        if replicas:
            raise not_ported(f"to_server(replicas={replicas}) (the serving "
                             f"fleet)", SERVING)
        cfg = self.cfg
        check_serving_supported(cfg)
        for key, value in (("telemetry_out", cfg.telemetry_out),
                           ("trace_out", cfg.trace_out),
                           ("stats_out", cfg.serve_stats_out)):
            if value:
                kwargs.setdefault(key, value)
        kwargs.setdefault("trace_capacity", cfg.trace_capacity)
        if cfg.fault_spec:
            from .reliability import faults
            faults.arm(cfg.fault_spec)
        from .serving import PredictionServer

        return PredictionServer(booster=self, **kwargs)

    def serve(self, **kwargs):
        """Start serving this booster over a socket; returns the running
        server (``.host``/``.port``/``.stop()``)."""
        return self.to_server(**kwargs).start()

    def feature_name(self) -> List[str]:
        return list(self.gbdt.feature_names)

    def num_feature(self) -> int:
        return self.gbdt.max_feature_idx + 1

    def __getstate__(self):
        return {"model_str": self.model_to_string(num_iteration=-1),
                "params": self.params,
                "best_iteration": self.best_iteration,
                "best_score": self.best_score}

    def __setstate__(self, state):
        self.params = state["params"]
        self.cfg = Config.from_params(self.params)
        self.device = resolve_device(self.cfg)
        self.best_iteration = state["best_iteration"]
        self.best_score = state["best_score"]
        self._train_set = None
        self._load_from_string(state["model_str"])


def train(params: Dict, train_set: Dataset, num_boost_round: int = 100,
          valid_sets: Optional[Sequence[Dataset]] = None,
          valid_names: Optional[Sequence[str]] = None,
          fobj: Optional[Callable] = None, feval: Optional[Callable] = None,
          init_model: Optional[Union[str, Booster]] = None,
          feature_name="auto", categorical_feature="auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None, verbose_eval=True,
          learning_rates=None, keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None,
          resume: Optional[bool] = None) -> Booster:
    """`python-package/lightgbm/engine.py:19-245` semantics, the JAX
    signature (``engine.py:367-377``).  ``fobj`` trains with
    ``objective=none`` on its gradients; ``init_model`` (a model file or a
    ``Booster``) continues its trees on ``train_set``;
    ``keep_training_booster`` is accepted and changes nothing, as in the
    JAX package.  ``resume`` (crash-safe snapshots) is not ported."""
    if resume:
        raise not_ported("resume", OBSERVE)
    params = dict(params or {})
    if "num_iterations" not in params and num_boost_round is not None:
        params["num_iterations"] = num_boost_round
    num_boost_round = Config.from_params(params).num_iterations
    if fobj is not None:
        params["objective"] = "none"
    init_booster: Optional[Booster] = None
    if init_model is not None:
        init_booster = init_model if isinstance(init_model, Booster) else \
            Booster(model_file=init_model, params=params)
    train_set.params = {**params, **(train_set.params or {})}
    if feature_name != "auto":
        train_set.set_feature_name(feature_name)
    if categorical_feature != "auto":
        train_set.set_categorical_feature(categorical_feature)
    booster = Booster(params=params, train_set=train_set)
    if init_booster is not None:
        _continue_training(booster, init_booster)

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
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        callbacks.append(callback_mod.early_stopping(
            early_stopping_rounds, verbose=bool(verbose_eval)))
    if evals_result is not None:
        callbacks.append(callback_mod.record_evaluation(evals_result))
    if learning_rates is not None:
        callbacks.append(callback_mod.reset_parameter(
            learning_rate=learning_rates))
    before = sorted((cb for cb in callbacks
                     if getattr(cb, "before_iteration", False)),
                    key=lambda cb: getattr(cb, "order", 0))
    after = sorted((cb for cb in callbacks
                    if not getattr(cb, "before_iteration", False)),
                   key=lambda cb: getattr(cb, "order", 0))

    results: List[Tuple] = []
    init_iter = booster.current_iteration
    end_iter = init_iter + num_boost_round
    gbdt = booster.gbdt
    provide_train = Config.from_params(params).is_provide_training_metric
    for i in range(init_iter, end_iter):
        env = callback_mod.CallbackEnv(
            model=booster, params=params, iteration=i,
            begin_iteration=init_iter, end_iteration=end_iter,
            evaluation_result_list=None)
        for cb in before:
            cb(env)
        finished = booster.update(fobj=fobj)
        results = []
        if gbdt.valid_metrics or gbdt.training_metrics or feval:
            if gbdt.training_metrics or (feval and provide_train):
                results.extend(booster.eval_train(feval))
            results.extend(booster.eval_valid(feval))
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


def _continue_training(booster: Booster, init_booster: Booster) -> None:
    """Seed ``booster`` with ``init_booster``'s trees (`boosting.cpp:43-62`,
    JAX ``engine.py:616-642``): each copied tree is rebound to the new
    training set's bins and its output replayed into the training score by
    a device traversal; the score then counts as an init score (no
    boost-from-average)."""
    gbdt = booster.gbdt
    src = init_booster.gbdt
    gbdt.models = [copy.deepcopy(t) for t in src.models]
    gbdt.num_tree_per_iteration = src.num_tree_per_iteration
    gbdt.iter_ = len(gbdt.models) // max(gbdt.num_tree_per_iteration, 1)
    for tree in gbdt.models:
        # the copied inner fields are in the source's bin space
        tree.needs_rebind = True
        rebind_tree_to_dataset(tree, gbdt.train_data)
    for idx, tree in enumerate(gbdt.models):
        k = idx % gbdt.num_tree_per_iteration
        gbdt._add_tree_score_train(tree, k)
        for vs in gbdt.valid_scores:
            vs.add_by_tree(tree, k)
    gbdt.train_score.has_init_score = True


class CVBooster:
    """The folds' boosters; a method call goes to each of them and returns
    their results in a list."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def _append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler


def cv(params: Dict, train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, feature_name="auto", categorical_feature="auto",
       early_stopping_rounds=None, fpreproc=None, verbose_eval=None,
       show_stdv: bool = True, seed: int = 0, callbacks=None,
       eval_train_metric: bool = False) -> Dict[str, List[float]]:
    """K-fold cross-validation (`engine.py:334-447`, JAX
    ``engine.py:659-766``): one booster per fold, boosted in lockstep;
    each round's per-fold validation metrics are aggregated to mean and
    standard deviation, and early stopping and the callbacks act on the
    mean.  ``init_model``, ``feature_name``, ``categorical_feature`` and
    ``eval_train_metric`` are accepted and unused, as in the JAX
    package."""
    params = dict(params or {})
    if metrics is not None:
        params["metric"] = metrics
    if "num_iterations" not in params and num_boost_round is not None:
        params["num_iterations"] = num_boost_round
    num_boost_round = Config.from_params(params).num_iterations
    train_set.construct()
    full = train_set
    n = full.num_data()
    label = np.asarray(full.get_label())
    rng = np.random.RandomState(seed)
    if folds is None:
        idx = np.arange(n)
        if stratified and Config.from_params(params).objective in (
                "binary", "multiclass", "multiclassova"):
            folds = _stratified_folds(label, nfold, rng, shuffle)
        else:
            if shuffle:
                rng.shuffle(idx)
            folds = [(np.setdiff1d(idx, idx[f::nfold], assume_unique=False),
                      idx[f::nfold]) for f in range(nfold)]

    results = collections.defaultdict(list)
    cvbooster = CVBooster()
    raw = full._load_raw(full._raw_data)
    weights = full.get_weight()
    for train_idx, test_idx in folds:
        dtrain = Dataset(raw[train_idx], label=label[train_idx],
                         weight=None if weights is None
                         else weights[train_idx],
                         params=params,
                         categorical_feature=full.categorical_feature)
        dtest = Dataset(raw[test_idx], label=label[test_idx],
                        weight=None if weights is None else weights[test_idx],
                        reference=dtrain, params=params)
        if fpreproc is not None:
            dtrain, dtest, params = fpreproc(dtrain, dtest, dict(params))
        params_fold = dict(params)
        params_fold.pop("early_stopping_round", None)
        bst = Booster(params=params_fold, train_set=dtrain)
        bst.add_valid(dtest, "valid")
        cvbooster._append(bst)

    callbacks = list(callbacks or [])
    if early_stopping_rounds:
        callbacks.append(callback_mod.early_stopping(
            early_stopping_rounds, verbose=bool(verbose_eval)))
    if isinstance(verbose_eval, int) and not isinstance(verbose_eval, bool) \
            and verbose_eval > 0:
        callbacks.append(callback_mod.print_evaluation(verbose_eval,
                                                       show_stdv))
    elif verbose_eval is True:
        callbacks.append(callback_mod.print_evaluation(show_stdv=show_stdv))
    cbs_before = sorted((cb for cb in callbacks
                         if getattr(cb, "before_iteration", False)),
                        key=lambda cb: getattr(cb, "order", 0))
    cbs_after = sorted((cb for cb in callbacks
                        if not getattr(cb, "before_iteration", False)),
                       key=lambda cb: getattr(cb, "order", 0))
    stopped_at = -1
    for it in range(num_boost_round):
        env = callback_mod.CallbackEnv(
            model=cvbooster, params=params, iteration=it,
            begin_iteration=0, end_iteration=num_boost_round,
            evaluation_result_list=None)
        for cb in cbs_before:
            cb(env)
        finished = False
        agg: Dict[str, List[float]] = collections.defaultdict(list)
        hb_map: Dict[str, bool] = {}
        for bst in cvbooster.boosters:
            if bst.update(fobj=fobj):
                finished = True
            for _, mname, val, hb in bst.eval_valid(feval):
                agg[mname].append(val)
                hb_map[mname] = hb
        agg_list = []
        for mname, vals in agg.items():
            results[f"{mname}-mean"].append(float(np.mean(vals)))
            results[f"{mname}-stdv"].append(float(np.std(vals)))
            agg_list.append(("cv_agg", mname, float(np.mean(vals)),
                             hb_map[mname], float(np.std(vals))))
        try:
            env = env._replace(evaluation_result_list=agg_list)
            for cb in cbs_after:
                cb(env)
        except callback_mod.EarlyStopException as e:
            stopped_at = getattr(e, "best_iteration", it)
            break
        if finished:
            break
    if stopped_at >= 0:
        for key in list(results):
            results[key] = results[key][:stopped_at + 1]
    return dict(results)


def _stratified_folds(label, nfold, rng, shuffle):
    """(train indices, test indices) per fold, each class's rows dealt
    round-robin to the test folds after a shuffle."""
    classes = np.unique(label)
    test_folds = [[] for _ in range(nfold)]
    for c in classes:
        idx = np.where(label == c)[0]
        if shuffle:
            rng.shuffle(idx)
        for f in range(nfold):
            test_folds[f].extend(idx[f::nfold])
    n = len(label)
    out = []
    for f in range(nfold):
        test = np.asarray(sorted(test_folds[f]))
        train_idx = np.setdiff1d(np.arange(n), test)
        out.append((train_idx, test))
    return out
