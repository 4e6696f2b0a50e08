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
server (``to_server``, ``serve``: ``serving/``).  ``train`` also carries
the JAX package's training reliability and observability
(`engine.py:393-464, 510-538, 572`): crash-safe snapshots
(``snapshot_freq``) and ``resume`` (``reliability/resume.py``), the
``train.crash`` fault point, the telemetry report (``telemetry``,
``telemetry_out``, ``telemetry_prom_out``, ``Booster.get_telemetry``),
phase spans (``trace_out``) and a ``torch.profiler`` trace parsed into
legs (``profile_trace_dir``); and multi-host pods (`engine.py:41-175,
565-612`): the pod joined before the dataset is built
(``parallel/multihost.py``), a heartbeat before every iteration that
names a dead rank, the rank-skew gauges it carries, and at the end the
clock handshake and the per-rank trace (``observability/podtrace.py``).  The device comes from ``device_type``
(``config.resolve_device``): the CUDA card unless the params ask for the
CPU.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import callback as callback_mod
from .boosting import create_boosting
from .boosting.gbdt import GBDT, rebind_tree_to_dataset
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
        # a pod's heartbeat net (``parallel/multihost.py``) and the last
        # step's host seconds, which ride the heartbeat
        self._mh_net = None
        self._last_step_s: Optional[float] = None
        if train_set is not None:
            check_supported(self.cfg)
            # join the pod before the dataset is built: the elastic loader
            # exchanges its shards over the pod's store
            from .parallel import multihost
            if multihost.initialize_from_config(self.cfg, self.device):
                self._mh_net = multihost.net_for_run(self.cfg)
            t0 = time.perf_counter()
            train_set.construct()
            bin_s = time.perf_counter() - t0
            objective = create_objective(self.cfg, self.device)
            self.gbdt = create_boosting(self.cfg, self.device)
            train_metrics = []
            if self.cfg.is_provide_training_metric:
                train_metrics = self._make_metrics(train_set)
            self.gbdt.init(train_set, objective, train_metrics)
            tel = self.gbdt.telemetry
            # binning ran before the GBDT and its telemetry existed
            tel.add_phase_time("binning", bin_s)
            if self._mh_net is not None:
                tel.set_distributed(
                    process_count=int(self._mh_net.num_machines),
                    process_index=int(self._mh_net.rank))
                if self.cfg.elastic:
                    tel.set_elastic(epoch=int(self.cfg.elastic_epoch),
                                    members=int(self._mh_net.num_machines))
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
        tel = self.gbdt.telemetry
        if self._mh_net is not None:
            self._heartbeat(tel)
        t0 = time.perf_counter()
        if fobj is None:
            ret = self.gbdt.train_one_iter()
        else:
            grad, hess = fobj(self._curr_preds(), self._train_set)
            ret = self.gbdt.train_one_iter(grad, hess)
        self._last_step_s = time.perf_counter() - t0
        return ret

    def _heartbeat(self, tel) -> None:
        """The pod's liveness agreement before an iteration (JAX
        `engine.py:103-130`), on either loop (both step through
        ``update``): a host that died since the last iteration surfaces
        here as a ``RankDeathError`` naming the dead rank, with the
        iteration and the membership epoch, within the collective
        deadline, instead of a hang in the next collective.  With
        telemetry the last step's host seconds ride the same allgather."""
        from .parallel.multihost import RankDeathError
        payload = self._last_step_s if tel.enabled else None
        with tel.phase("heartbeat"):
            try:
                peers = self._mh_net.heartbeat(self.gbdt.iter_,
                                               payload=payload)
            except RankDeathError as e:
                raise RankDeathError(
                    f"training aborted before iteration "
                    f"{self.gbdt.iter_ + 1} (membership epoch {e.epoch}): "
                    f"{e}", dead_ranks=e.dead_ranks, epoch=e.epoch) from None
        if tel.enabled:
            self._note_rank_skew(peers)

    def _note_rank_skew(self, peers) -> None:
        """The rank-skew gauges from the heartbeat's gathered step times
        (JAX `engine.py:144-175`); past ``telemetry_skew_warn_ratio`` a
        warning naming the slowest rank."""
        import warnings
        tel = self.gbdt.telemetry
        times: Dict[int, Optional[float]] = {}
        for p in peers or ():
            if isinstance(p, tuple) and len(p) >= 4 and p[0] == "hb":
                times[int(p[1])] = None if p[3] is None else float(p[3])
        vals = sorted(v for v in times.values() if v is not None)
        if not vals:
            return
        tel.set_distributed(rank_step_s={str(r): v for r, v
                                         in sorted(times.items())})
        if len(vals) < 2:
            return
        m = len(vals)
        med = vals[m // 2] if m % 2 else \
            0.5 * (vals[m // 2 - 1] + vals[m // 2])
        slow_s, slow_rank = max(
            (v, r) for r, v in times.items() if v is not None)
        ratio = (slow_s / med) if med > 0 else 0.0
        warn_ratio = float(getattr(self.cfg, "telemetry_skew_warn_ratio",
                                   0.0))
        tel.set_distributed(skew_ratio=ratio, slowest_rank=int(slow_rank),
                            skew_warn_ratio=warn_ratio)
        if warn_ratio > 0 and ratio > warn_ratio:
            tel.inc("straggler_warnings")
            warnings.warn(
                f"straggler: rank {slow_rank} last step "
                f"{slow_s * 1e3:.1f} ms is {ratio:.2f}x the pod median "
                f"({med * 1e3:.1f} ms)")

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

    def get_telemetry(self, light: bool = False) -> Dict:
        """The training telemetry report (``telemetry=true``;
        ``observability/schema.json``); ``light`` never waits on the
        device (``GBDT.get_telemetry``)."""
        return self.gbdt.get_telemetry(light=light)

    def to_server(self, replicas: int = 0, **kwargs):
        """An UNSTARTED server with this booster registered as the
        ``default`` model (JAX ``engine.py:321-339``).  ``replicas=0`` (the
        default) builds the threaded ``serving.PredictionServer`` on the
        booster's device; any other value builds the async
        ``serving.FleetServer`` (``-1`` = one replica per card, N > 0 =
        exactly N, round-robin over the cards; a CPU booster's replicas
        serve on the CPU).  Keyword args are forwarded
        (host/port/max_batch_rows/deadline_ms/min_bucket/warmup/
        max_inflight/telemetry_out, trace/trace_out/trace_capacity/
        stats_out/stats_interval_s, record_rows, slo_p99_ms/slo_target;
        for the fleet also recovery_s, tenant_max_inflight and the
        drift_* keys).  The booster's params may carry
        ``telemetry_out``, ``trace_out``, ``trace_capacity``,
        ``stats_out`` and ``fault_spec`` (armed here), as ``task=serve``'s
        do; keyword args win."""
        cfg = self.cfg
        for key, value in (("telemetry_out", cfg.telemetry_out),
                           ("trace_out", cfg.trace_out),
                           ("stats_out", cfg.serve_stats_out)):
            if value:
                kwargs.setdefault(key, value)
        kwargs.setdefault("trace_capacity", cfg.trace_capacity)
        if cfg.fault_spec:
            from .reliability import faults
            faults.arm(cfg.fault_spec)
        if replicas:
            from .serving import FleetServer

            return FleetServer(booster=self,
                               replicas=max(int(replicas), 0), **kwargs)
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
    JAX package.

    ``snapshot_freq > 0`` checkpoints the model every K iterations to
    ``<output_model>.snapshot_iter_<k>`` with its sidecars, and ``resume``
    (or the config's ``resume``) continues a killed run from the newest
    valid snapshot, training only the remaining iterations, so the model
    text equals an uninterrupted run's of the same loop.  A snapshot newer
    than an ``init_model`` wins (it holds the incumbent's trees), and the
    run still targets the incumbent's iterations + ``num_boost_round``.
    ``trace_out`` implies ``telemetry``; ``profile_trace_dir`` runs the
    loop under ``torch.profiler``, writes its Chrome trace there and
    raises if none was written."""
    from .reliability import faults
    from .reliability.metrics import rel_inc
    from .reliability.resume import (find_resume_snapshot,
                                     load_snapshot_state,
                                     restore_training_state, save_snapshot)

    params = dict(params or {})
    cfg = Config.from_params(params)
    if cfg.trace_out and not cfg.telemetry:
        # spans ride the phase timers: asking for a trace opts in
        params["telemetry"] = True
    if "num_iterations" not in params and num_boost_round is not None:
        params["num_iterations"] = num_boost_round
    cfg = Config.from_params(params)
    num_boost_round = cfg.num_iterations
    if fobj is not None:
        params["objective"] = "none"
    if cfg.fault_spec:
        faults.arm(cfg.fault_spec)
    init_booster: Optional[Booster] = None
    resume_base_iter = 0
    if init_model is not None:
        init_booster = init_model if isinstance(init_model, Booster) else \
            Booster(model_file=init_model, params=params)
        resume_base_iter = init_booster.current_iteration
    resumed_iter: Optional[int] = None
    snapshot: Optional[str] = None
    if resume if resume is not None else cfg.resume:
        found = find_resume_snapshot(cfg.output_model, cfg)
        if found is not None and found[0] > resume_base_iter:
            resumed_iter, snapshot = found
            init_booster = Booster(model_file=snapshot, params=params)
            rel_inc("resume_runs")
    train_set.params = {**params, **(train_set.params or {})}
    if feature_name != "auto":
        train_set.set_feature_name(feature_name)
    if categorical_feature != "auto":
        train_set.set_categorical_feature(categorical_feature)
    # the span recorder exists, and is registered process-wide, before the
    # Booster is built: a streamed dataset is read while the Booster is
    # built, before its Telemetry exists, and its ``ingest.*`` spans reach
    # the run's trace through the registration (JAX `engine.py:440-451`)
    tracer = None
    if cfg.trace_out:
        from .observability import TraceRecorder, set_global_tracer
        tracer = TraceRecorder(True, capacity=cfg.trace_capacity)
        set_global_tracer(tracer)
    booster = Booster(params=params, train_set=train_set)
    gbdt = booster.gbdt
    if tracer is not None:
        gbdt.telemetry.tracer = tracer
    if init_booster is not None:
        _continue_training(booster, init_booster)

    for i, vs in enumerate(valid_sets or []):
        if vs is train_set:
            continue
        name = (valid_names[i] if valid_names and i < len(valid_names)
                else f"valid_{i}")
        booster.add_valid(vs, name)
    if snapshot is not None:
        # exact continuation: the live scores and random streams (the
        # traversal replay above adds in another order)
        state = load_snapshot_state(snapshot)
        if state is not None:
            restore_training_state(gbdt, state)

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
    # a resumed run trains to the original target; init_model keeps the
    # reference's "num_boost_round more"
    end_iter = init_iter + num_boost_round if resumed_iter is None \
        else max(resume_base_iter + num_boost_round, init_iter)
    provide_train = cfg.is_provide_training_metric
    profiler = None
    if cfg.profile_trace_dir:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if booster.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
    with profiler or contextlib.nullcontext():
        for i in range(init_iter, end_iter):
            env = callback_mod.CallbackEnv(
                model=booster, params=params, iteration=i,
                begin_iteration=init_iter, end_iteration=end_iter,
                evaluation_result_list=None)
            for cb in before:
                cb(env)
            finished = booster.update(fobj=fobj)
            if cfg.snapshot_freq > 0 and cfg.output_model \
                    and (i + 1) % cfg.snapshot_freq == 0:
                save_snapshot(gbdt, cfg.output_model, i + 1, cfg)
            # `train.crash[:nth=K]` kills the run after its K-th completed
            # iteration, the snapshot (if due) written (`engine.py:532-538`)
            if faults.fire("train.crash") is not None:
                raise faults.InjectedFault(
                    f"injected fault train.crash at iteration {i + 1}")
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
    if profiler is not None:
        from .observability.attribution import TRACE_NAME, attribute_profile
        os.makedirs(cfg.profile_trace_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(cfg.profile_trace_dir,
                                                  TRACE_NAME))
        prof = attribute_profile(cfg.profile_trace_dir)
        if prof is None:
            raise RuntimeError(f"profile_trace_dir={cfg.profile_trace_dir}:"
                               f" the profiler wrote no trace with events")
        gbdt.telemetry.set_distributed(profile=prof)
    clock = None
    if booster._mh_net is not None and cfg.telemetry \
            and (cfg.telemetry_out or cfg.trace_out):
        # one clock handshake serves the report's distributed.clock and the
        # per-rank trace's metadata (JAX `engine.py:576-611`)
        from .observability import podtrace
        clock = podtrace.estimate_clock_offset(booster._mh_net)
        gbdt.telemetry.set_distributed(clock={
            "offset_us": clock["offset_s"] * 1e6,
            "rtt_us": clock["rtt_s"] * 1e6,
            "rounds": clock["rounds"], "method": clock["method"]})
    if cfg.telemetry and cfg.telemetry_out:
        from .observability import write_report
        write_report(booster.get_telemetry(), cfg.telemetry_out)
    if cfg.telemetry and cfg.telemetry_prom_out:
        from .observability import training_prometheus
        tmp = cfg.telemetry_prom_out + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(training_prometheus(booster.get_telemetry()))
        os.replace(tmp, cfg.telemetry_prom_out)
    if tracer is not None:
        gbdt._flush_pending()                # the queued trees' spans
        # ``<trace_out>.rank<r>`` in a pod, the handshake in its otherData
        # for ``podtrace.merge_pod_trace``
        from .observability import podtrace, set_global_tracer
        podtrace.export_rank_trace(tracer, cfg.trace_out,
                                   net=booster._mh_net, clock=clock)
        set_global_tracer(None)
    if booster._mh_net is not None:
        booster._mh_net.close()
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
