# Port copy of lightgbm_tpu/callback.py: the port keeps its own numpy-only copy so
# that importing it never runs lightgbm_tpu/__init__.py (which imports JAX).
"""Callback protocol (`python-package/lightgbm/callback.py`).

Same shapes as the reference: ``CallbackEnv`` namedtuple, ``print_evaluation``
(`callback.py:55`), ``record_evaluation`` (`:78`), ``reset_parameter``
(`:108`), ``early_stopping`` (`:153`) raising ``EarlyStopException``.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score: List):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def _format_eval_result(value, show_stdv: bool = True) -> str:
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:
        if show_stdv:
            return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    raise ValueError("Wrong metric value")


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(_format_eval_result(x, show_stdv)
                               for x in env.evaluation_result_list)
            print(f"[{env.iteration + 1}]\t{result}")
    _callback.order = 10
    return _callback


def record_evaluation(eval_result: Dict) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")
    eval_result.clear()

    def _names(ret):
        # train() passes 4-tuples; cv() passes 5-tuples ('cv_agg', name,
        # mean, higher_better, stdv) which record as name-mean / name-stdv
        if len(ret) == 5:
            return [(ret[0], f"{ret[1]}-mean", ret[2]),
                    (ret[0], f"{ret[1]}-stdv", ret[4])]
        return [(ret[0], ret[1], ret[2])]

    def _callback(env: CallbackEnv) -> None:
        for ret in (env.evaluation_result_list or []):
            for data_name, eval_name, result in _names(ret):
                eval_result.setdefault(data_name, collections.OrderedDict())
                eval_result[data_name].setdefault(eval_name, [])
                eval_result[data_name][eval_name].append(result)
    _callback.order = 20
    return _callback


def record_telemetry(result: Dict) -> Callable:
    """Fill ``result`` with the booster's telemetry report each iteration
    (requires ``telemetry=True`` in params; see README "Telemetry &
    profiling").  Uses the LIGHT report — already-decoded phase timers and
    counters only — so the callback never forces a device sync; call
    ``Booster.get_telemetry()`` after training for the complete report."""
    if not isinstance(result, dict):
        raise TypeError("record_telemetry expects a dictionary to fill")
    result.clear()

    def _callback(env: CallbackEnv) -> None:
        gbdt = getattr(env.model, "gbdt", None)
        if gbdt is None or not getattr(gbdt, "telemetry", None) \
                or not gbdt.telemetry.enabled:
            return
        result.clear()
        result.update(gbdt.get_telemetry(light=True))
    _callback.order = 40
    return _callback


def reset_parameter(**kwargs) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        new_params = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(f"Length of list {key!r} has to equal "
                                     "num_boost_round")
                new_param = value[env.iteration - env.begin_iteration]
            else:
                new_param = value(env.iteration - env.begin_iteration)
            new_params[key] = new_param
        if new_params:
            if "learning_rate" in new_params:
                env.model.gbdt.shrinkage_rate = new_params["learning_rate"]
                env.model.gbdt.cfg.learning_rate = new_params["learning_rate"]
            for k, v in new_params.items():
                if hasattr(env.model.gbdt.cfg, k):
                    setattr(env.model.gbdt.cfg, k, v)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    best_score = []
    best_iter = []
    best_score_list: List = []
    cmp_op = []
    enabled = [True]

    def _init(env: CallbackEnv) -> None:
        enabled[0] = not any(
            env.params.get(alias, "") == "dart"
            for alias in ("boosting", "boosting_type", "boost"))
        if not enabled[0]:
            import warnings
            warnings.warn("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError("For early stopping, at least one dataset and "
                             "eval metric is required for evaluation")
        if verbose:
            print(f"Training until validation scores don't improve for "
                  f"{stopping_rounds} rounds.")
        for ret in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if ret[3]:
                best_score.append(float("-inf"))
                cmp_op.append(lambda a, b: a > b)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda a, b: a < b)

    def _callback(env: CallbackEnv) -> None:
        if not best_score:
            _init(env)
        if not enabled[0]:
            return
        for i, ret in enumerate(env.evaluation_result_list):
            score = ret[2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            if ret[0] == "training":
                continue
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    print("Early stopping, best iteration is:\n"
                          f"[{best_iter[i] + 1}]\t"
                          + "\t".join(_format_eval_result(x)
                                      for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if env.iteration == env.end_iteration - 1:
                if verbose:
                    print("Did not meet early stopping. Best iteration is:\n"
                          f"[{best_iter[i] + 1}]\t"
                          + "\t".join(_format_eval_result(x)
                                      for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if first_metric_only:
                break
    _callback.order = 30
    return _callback
