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
  * ``task=serve``          the prediction server over ``input_model``
                            (``serving/``; ``telemetry_out``,
                            ``trace_out``, ``stats_out``, ``fault_spec``)

Like every entry point of the port, the CLI runs on the CUDA card unless
``device_type=cpu``.  ``task=train`` takes the training telemetry, trace,
profiler, snapshot and fault-injection keys (``--telemetry-out`` and
``--trace-out`` imply ``telemetry``) and ``--resume``, which continues a
killed run from its newest valid snapshot
(``<output_model>.snapshot_iter_<k>``, written every ``snapshot_freq``
iterations).  ``task=serve`` with ``serve_replicas != 0`` serves through the
fleet gateway (``serving/fleet/``), and ``autopilot=true`` arms the
drift-triggered refit loop over it (``lifecycle/autopilot.py``).
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import numpy as np

from .config import Config, parse_config_file, resolve_aliases


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

    # --telemetry-out / --trace-out imply telemetry: asking for the report
    # (or for spans, which ride the phase timers) is opting in
    if (cfg.telemetry_out or cfg.trace_out) and not cfg.telemetry:
        cfg.telemetry = True
        params = dict(params, telemetry="true")
    if cfg.resume:
        # engine.train makes the same choice; this is the operator's line
        from .reliability.resume import find_resume_snapshot
        found = find_resume_snapshot(cfg.output_model, cfg)
        if found is not None:
            _log(f"Resuming from snapshot {found[1]} (iteration "
                 f"{found[0]})")
        else:
            _log("--resume: no valid snapshot found, training from scratch")
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
    from .parallel.sharding import is_primary
    if not is_primary():
        # every rank holds the same trees; rank 0 writes them
        return
    booster.save_model(cfg.output_model)
    if cfg.convert_model_language == "cpp":
        _save_if_else(booster, cfg.convert_model)
    if cfg.telemetry and cfg.telemetry_out:
        _log(f"Telemetry report written to {cfg.telemetry_out}")
    if cfg.trace_out:
        _log(f"Trace written to {cfg.trace_out} (open in Perfetto / "
             f"chrome://tracing)")
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
    """``task=serve``: the micro-batched prediction server over a saved
    model (``serving/``), on the card unless ``device_type=cpu``.  Blocks
    until a client sends ``shutdown`` or the process receives SIGINT;
    ``telemetry_out`` writes the serving report on exit, ``stats_out`` /
    ``stats_interval`` write periodic atomic schema-validated snapshots of
    it, ``trace_out`` the request spans as Chrome trace-event JSON, and
    ``fault_spec`` arms fault points (JAX ``cli.py:182-290``).  A non-zero
    ``serve_replicas`` serves through the fleet gateway (``-1``: one
    replica per card) with drift monitoring over the recorder window;
    ``autopilot=true`` (with ``lifecycle_record_rows > 0`` and ``data=``,
    the train source refits continue from) starts the autopilot."""
    from .engine import Booster

    if not cfg.input_model:
        raise ValueError("task=serve requires input_model")
    if cfg.fault_spec:
        from .reliability import faults
        faults.arm(cfg.fault_spec)
    booster = Booster(model_file=cfg.input_model, params=dict(params))
    fleet_kwargs = {}
    if cfg.serve_replicas:
        # any non-zero replica count serves through the async gateway
        # (serving/fleet/); -1 = one replica per card.  Drift monitoring
        # rides the fleet's recorder window
        fleet_kwargs["recovery_s"] = cfg.serve_recovery_s
        fleet_kwargs["drift_psi_threshold"] = cfg.drift_psi_threshold
        fleet_kwargs["drift_ks_threshold"] = cfg.drift_ks_threshold
        fleet_kwargs["tenant_max_inflight"] = cfg.serve_tenant_max_inflight
        baseline_path = cfg.drift_baseline_path
        if not baseline_path and cfg.lifecycle_record_rows > 0:
            # default: baselines live beside the served model artifact
            baseline_path = cfg.input_model + ".drift_baselines.json"
        if baseline_path and baseline_path != "off":
            fleet_kwargs["drift_baseline_path"] = baseline_path
    server = booster.serve(
        replicas=cfg.serve_replicas,
        host=cfg.serve_host, port=cfg.serve_port,
        max_batch_rows=cfg.serve_max_batch_rows,
        deadline_ms=cfg.serve_deadline_ms,
        min_bucket=cfg.serve_min_bucket, warmup=cfg.serve_warmup,
        max_inflight=cfg.serve_max_inflight,
        telemetry_out=cfg.telemetry_out,
        trace_out=cfg.trace_out, trace_capacity=cfg.trace_capacity,
        stats_out=cfg.serve_stats_out,
        stats_interval_s=cfg.serve_stats_interval,
        record_rows=cfg.lifecycle_record_rows,
        slo_p99_ms=cfg.serve_slo_p99_ms,
        slo_target=cfg.serve_slo_target, **fleet_kwargs)
    if cfg.serve_replicas:
        _log(f"Serving {cfg.input_model} at {server.host}:{server.port} "
             f"with {len(server.replicas)} replica(s) "
             f"(binary+pickle protocols, buckets {server.buckets}, "
             f"deadline {cfg.serve_deadline_ms} ms)")
    else:
        _log(f"Serving {cfg.input_model} at {server.host}:{server.port} "
             f"(buckets {server.buckets}, deadline "
             f"{cfg.serve_deadline_ms} ms)")
    if cfg.serve_stats_out:
        _log(f"Stats snapshots every {cfg.serve_stats_interval:g}s to "
             f"{cfg.serve_stats_out}")
    if cfg.lifecycle_record_rows > 0:
        _log(f"Recording the newest {cfg.lifecycle_record_rows} request "
             f"rows for lifecycle shadow validation")
    if cfg.autopilot:
        _start_autopilot(server, params, cfg)
    try:
        server.wait()
    except KeyboardInterrupt:
        _log("Interrupted, shutting down")
    finally:
        server.stop()
    if cfg.telemetry_out:
        _log(f"Serving telemetry report written to {cfg.telemetry_out}")
    if cfg.trace_out:
        _log(f"Serving trace written to {cfg.trace_out}")
    _log("Finished serving")


def _start_autopilot(server, params: Dict[str, str], cfg: Config) -> None:
    """Bind a ``LifecycleController`` and start the ``Autopilot`` on a
    fleet server, refitting from the ``data`` file (JAX
    ``cli.py:244-272``)."""
    if not cfg.serve_replicas:
        server.stop()
        raise ValueError("autopilot=true requires fleet serving "
                         "(serve_replicas != 0)")
    if cfg.lifecycle_record_rows <= 0:
        server.stop()
        raise ValueError("autopilot=true requires lifecycle_record_rows > 0 "
                         "(the drift and shadow window)")
    if not cfg.data:
        server.stop()
        raise ValueError("autopilot=true requires data= (the original "
                         "train source refits continue from)")
    from .io.parser import load_data_file
    from .lifecycle import Autopilot, LifecycleController

    def train_source(path=cfg.data, p=dict(params)):
        mat, label, _, _ = load_data_file(path, p)
        if label is None:
            raise ValueError(f"autopilot train source {path!r} carries no "
                             f"label column")
        return mat, label

    controller = LifecycleController.from_config(server, cfg)
    Autopilot.from_config(server, controller, train_source, cfg,
                          params=dict(params)).start()
    _log(f"Autopilot armed: check every {cfg.autopilot_interval_s:g}s, "
         f"refit after {cfg.autopilot_consecutive_checks} consecutive "
         f"drifted windows, <= {cfg.autopilot_max_refits} refits per "
         f"{cfg.autopilot_window_s:g}s window")


_TASKS = {"train": run_train, "refit_tree": run_refit, "refit": run_refit,
          "predict": run_predict, "prediction": run_predict,
          "test": run_predict, "convert_model": run_convert_model,
          "serve": run_serve}


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    params = _load_params(argv)
    cfg = Config.from_params(params)
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
