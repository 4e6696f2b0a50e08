"""Command-line application: ``python -m lightgbm_tpu_torch config=train.conf``.

Port of ``lightgbm_tpu/cli.py``, the analogue of the reference CLI
(`src/main.cpp`, `src/application/application.cpp:30-260`): ``key=value``
arguments, a ``config=`` file (``Config::KV2Map`` syntax,
`src/io/config.cpp:15-43`), GNU-style flags (``--num-leaves 31``,
``--num-leaves=31``; a bare flag means true) and a bare task word
(``python -m lightgbm_tpu_torch predict ...``), the command line winning
over the file.  The tasks:

  * ``task=train``          train on ``data`` (``valid`` sets, continued
                            from ``input_model``), write ``output_model``
  * ``task=predict``        score ``data`` with ``input_model``, write
                            ``output_result``
  * ``task=refit``          refit ``input_model``'s leaf values on ``data``
                            (`gbdt.cpp` RefitTree)
  * ``task=convert_model``  model text -> C++ if-else source
                            (`gbdt_model_text.cpp` SaveModelToIfElse)

Like every entry point of the port, the CLI runs on the CUDA card unless
``device_type=cpu``.  ``task=serve`` and the telemetry, trace, snapshot,
resume and fault-injection keys are not ported: they raise
``NotImplementedError`` naming their ROADMAP.md Queue A item.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import numpy as np

from .config import (OBSERVE, SERVING, Config, not_ported,
                     parse_config_file, resolve_aliases)


def _load_params(argv: List[str]) -> Dict[str, str]:
    """`Application::LoadParameters` (`application.cpp:48-81`): the command
    line, then the ``config`` file under it (the command line wins)."""
    cmdline: Dict[str, str] = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok in _TASKS and "task" not in cmdline:
            cmdline["task"] = tok
        elif tok.startswith("--"):
            key = tok[2:].replace("-", "_")
            if "=" in key:
                key, v = key.split("=", 1)
            elif i + 1 < len(argv) and "=" not in argv[i + 1] \
                    and not argv[i + 1].startswith("--"):
                i += 1
                v = argv[i]
            else:
                v = "true"
            cmdline[key.strip()] = v.strip().strip('"').strip("'")
        elif "=" in tok:
            k, v = tok.split("=", 1)
            cmdline[k.strip()] = v.strip().strip('"').strip("'")
        i += 1
    cmdline = resolve_aliases(cmdline)
    params: Dict[str, str] = {}
    if "config" in cmdline:
        params.update(parse_config_file(cmdline.pop("config")))
        params = resolve_aliases(params)
    params.update(cmdline)
    return params


def _log(msg: str) -> None:
    print(f"[lightgbm_tpu_torch] [Info] {msg}", flush=True)


def run_train(params: Dict[str, str], cfg: Config) -> None:
    from . import engine
    from .dataset import Dataset

    t0 = time.time()
    train_set = Dataset(cfg.data, params=dict(params))
    valid_sets = [Dataset(v, reference=train_set, params=dict(params))
                  for v in cfg.valid]
    booster = engine.train(
        dict(params), train_set, cfg.num_iterations,
        valid_sets=valid_sets,
        valid_names=[f"valid_{i + 1}" for i in range(len(valid_sets))],
        init_model=cfg.input_model or None,
        early_stopping_rounds=(cfg.early_stopping_round
                               if cfg.early_stopping_round > 0 else None),
        verbose_eval=max(cfg.metric_freq, 1))
    booster.save_model(cfg.output_model)
    if cfg.convert_model_language == "cpp":
        _save_if_else(booster, cfg.convert_model)
    _log(f"Finished training in {time.time() - t0:.6f} seconds")


def run_predict(params: Dict[str, str], cfg: Config) -> None:
    from .engine import Booster
    from .io.parser import load_data_file

    if not cfg.input_model:
        raise ValueError("task=predict requires input_model")
    booster = Booster(model_file=cfg.input_model, params=dict(params))
    # the file's label column is split off as for training
    mat, _, _, _ = load_data_file(cfg.data, dict(params))
    kwargs = {}
    if cfg.num_iteration_predict > 0:
        kwargs["num_iteration"] = cfg.num_iteration_predict
    if cfg.predict_leaf_index:
        out = booster.predict(mat, pred_leaf=True, **kwargs)
    elif cfg.predict_contrib:
        out = booster.predict(mat, pred_contrib=True, **kwargs)
    elif cfg.predict_raw_score:
        out = booster.predict(mat, raw_score=True, **kwargs)
    else:
        out = booster.predict(mat, **kwargs)
    out = np.atleast_2d(np.asarray(out))
    if out.shape[0] == 1 and out.size > 1:
        out = out.T
    with open(cfg.output_result, "w") as fh:
        for row in out:
            fh.write("\t".join(f"{v:g}" for v in np.atleast_1d(row)) + "\n")
    _log("Finished prediction")


def run_refit(params: Dict[str, str], cfg: Config) -> None:
    from .engine import Booster

    if not cfg.input_model:
        raise ValueError("task=refit requires input_model")
    booster = Booster(model_file=cfg.input_model, params=dict(params))
    booster.refit_file(cfg.data, decay_rate=cfg.refit_decay_rate)
    booster.save_model(cfg.output_model)
    _log("Finished RefitTree")


def _save_if_else(booster, path: str) -> None:
    from .convert import model_to_if_else

    with open(path or "gbdt_prediction.cpp", "w") as fh:
        fh.write(model_to_if_else(booster.gbdt))
    _log("Finished converting model to if-else statements")


def run_convert_model(params: Dict[str, str], cfg: Config) -> None:
    from .engine import Booster

    if not cfg.input_model:
        raise ValueError("task=convert_model requires input_model")
    _save_if_else(Booster(model_file=cfg.input_model, params=dict(params)),
                  cfg.convert_model)


def run_serve(params: Dict[str, str], cfg: Config) -> None:
    raise not_ported("task=serve (the prediction server)", SERVING)


_TASKS = {"train": run_train, "refit_tree": run_refit, "refit": run_refit,
          "predict": run_predict, "prediction": run_predict,
          "test": run_predict, "convert_model": run_convert_model,
          "serve": run_serve}


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    params = _load_params(argv)
    cfg = Config.from_params(params)
    if cfg.telemetry or cfg.telemetry_out or cfg.trace_out \
            or cfg.profile_trace_dir or cfg.snapshot_freq > 0 or cfg.resume \
            or cfg.fault_spec:
        raise not_ported("telemetry, tracing, snapshots, resume and fault "
                         "injection", OBSERVE)
    task = _TASKS.get(cfg.task)
    if task is None:
        print(f"[lightgbm_tpu_torch] [Fatal] Unknown task: {cfg.task}",
              file=sys.stderr)
        return 1
    if not cfg.data and task not in (run_convert_model, run_serve):
        print("[lightgbm_tpu_torch] [Fatal] No training/prediction data, "
              "application quit", file=sys.stderr)
        return 1
    task(params, cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
