"""Subprocess worker of the port's pod tests: one emulated host's rank.

``tests/test_torch_multihost.py``, ``test_torch_elastic.py`` and
``test_torch_distributed_bin.py`` launch it once per rank (or per host
agent) on 127.0.0.1, with gloo collectives on the CPU.  It imports only
the port, never JAX.  The spec (one JSON argument) picks a job:

  * ``train`` — a pod rank from the LGBT_* environment and
    ``LOCAL_WORLD_SIZE`` / ``LOCAL_RANK`` (or from ``torchrun``'s
    environment, the file named by ``RANK``): ``lt.train`` for each
    ``tree_learner`` mode, then a ``DistributedNet`` exercise, then (with
    ``observe``) a serial run with telemetry and a per-rank trace, rank 1
    sleeping in every step;
  * ``chaos`` — no training: heartbeats until the armed ``net.crash``
    clause kills this rank (exit 17) or a peer's death surfaces as the
    named error; survivors report it, its latency and the counters;
  * ``elastic`` — one host's agent: ``elastic.run_host`` through every
    membership epoch; reports the model, the history and the counters;
  * ``socket`` — a ``SocketNet`` rank binning its mod-dealt shard of a
    file (``distributed_construct``).

The result is written as JSON (or a pickle for ``socket``) to
``spec["out"]``.
"""

import json
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ITERS = 6


def problem(seed=0, n=600, f=30):
    """The JAX pod tests' problem (``tests/test_multihost.py``)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + np.sin(X[:, 1]) + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


def pod_params(mode, **extra):
    """The pod tests' params (float64 sums: the model cannot depend on the
    reduction order of the ranks)."""
    p = {"objective": "binary", "num_leaves": 7, "max_bin": 31,
         "min_data_in_leaf": 5, "verbosity": -1, "metric": "none",
         "tree_learner": mode, "gpu_use_dp": True}
    if mode == "data_feature":
        p["parallel_mesh"] = "2x2"
    p.update(extra)
    return p


def train_model(params, X, y, rounds):
    """``lt.train`` on the CPU: (model text, predictions, learner, the
    report's gauges when telemetry is on)."""
    import lightgbm_tpu_torch as lt
    p = dict(params, device_type="cpu")
    bst = lt.train(p, lt.Dataset(X, label=y, params=p), rounds,
                   verbose_eval=False)
    gauges = bst.get_telemetry()["gauges"] if p.get("telemetry") else {}
    return {"text": bst.model_to_string(),
            "pred": bst.predict(X).tolist(),
            "learner": type(bst.gbdt.learner).__name__,
            "heartbeats": (bst._mh_net._seq if bst._mh_net is not None
                           else None),
            "gauges": gauges}


def ndcg_task(params, X, y, group, rounds):
    """A rank's ``eval_train`` after ``rounds`` iterations of a lambdarank
    run on the CPU: {metric: value}."""
    import lightgbm_tpu_torch as lt
    p = dict(params, device_type="cpu")
    bst = lt.Booster(p, lt.Dataset(X, label=y, group=group, params=p))
    for _ in range(rounds):
        bst.update()
    return {name: v for _, name, v, _ in bst.eval_train()}


def _job_train(spec):
    import torch.distributed as dist

    from lightgbm_tpu_torch.parallel import multihost
    X, y = problem()
    out = {"modes": {}}
    for mode in spec["modes"]:
        out["modes"][mode] = train_model(
            pod_params(mode, telemetry=True, telemetry_sync_every=2),
            X, y, ITERS)
    out.update(rank=dist.get_rank(), world=dist.get_world_size(),
               backend=dist.get_backend(),
               layout=list(multihost.host_layout()))
    # the host: LGBT_PROCESS_ID, or torchrun's node rank
    host = int(os.environ.get("LGBT_PROCESS_ID",
                              os.environ.get("GROUP_RANK", "0")))
    net = multihost.DistributedNet(namespace="probe", deadline_s=60)
    out["net"] = {"allgather": net.allgather(("hello", out["rank"])),
                  "sync_min": net.sync_min(100 + host),
                  "sync_max": net.sync_max(100 + host)}
    net.barrier("probe-done")
    net.close()
    if spec.get("observe"):
        out["observe"] = _observe(spec, out["rank"])
    return out


def _observe(spec, rank):
    """The pod's flight recorder: a serial run (no collective inside a
    step) with telemetry, the per-rank trace and rank 1 sleeping in every
    step, so the heartbeat's step times name it."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.boosting.gbdt import GBDT

    if rank == 1:
        delay = float(spec["straggle_s"])
        orig = GBDT.train_one_iter

        def slow(self, *a, **kw):
            time.sleep(delay)
            return orig(self, *a, **kw)

        GBDT.train_one_iter = slow
    X, y = problem()
    telem = spec["telemetry_out"].format(rank=rank)
    p = pod_params("serial", telemetry=True, trace_out=spec["trace_out"],
                   telemetry_out=telem, telemetry_sync_every=2,
                   telemetry_skew_warn_ratio=1.3, device_type="cpu")
    lt.train(p, lt.Dataset(X, label=y, params=p), 5, verbose_eval=False)
    with open(telem) as fh:
        rep = json.load(fh)
    return {"distributed": rep["distributed"],
            "provenance": rep["provenance"], "counters": rep["counters"]}


def _job_chaos(spec):
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.parallel import multihost
    from lightgbm_tpu_torch.reliability.metrics import rel_counters

    cfg = Config.from_params({
        "coordinator_address": f"127.0.0.1:{spec['port']}",
        "num_hosts": spec["num_hosts"], "process_id": spec["rank"],
        "net_collective_deadline_s": spec["deadline_s"]})
    assert multihost.initialize_from_config(cfg)
    net = multihost.DistributedNet(cfg, namespace="chaos")
    t0 = time.time()
    out = {"rank": spec["rank"], "survived_error": None}
    try:
        for i in range(int(spec.get("beats", 6))):
            t0 = time.time()
            net.heartbeat(i)
        out["beats_completed"] = True
    except ConnectionError as e:
        out["survived_error"] = str(e)
        out["elapsed_s"] = time.time() - t0
        out["dead_ranks"] = list(getattr(e, "dead_ranks", ()))
    out["rel_counters"] = rel_counters()
    return out


def _job_elastic(spec):
    """One host's agent: ``run_host`` through every epoch; never joins a
    process group itself."""
    from lightgbm_tpu_torch.elastic import (ElasticHostDead,
                                            ElasticTerminalError, run_host)
    from lightgbm_tpu_torch.reliability.metrics import rel_counters

    params = pod_params("data", elastic=True, device_type="cpu",
                        elastic_min_ranks=int(spec.get("min_ranks", 1)),
                        elastic_max_recoveries=3,
                        coordinator_address=f"127.0.0.1:{spec['port']}",
                        net_collective_deadline_s=spec.get("deadline_s", 6),
                        telemetry=True)
    for key in ("telemetry_out", "trace_out"):
        if spec.get(key):
            params[key] = spec[key]
    env = {"OMP_NUM_THREADS": "1"}
    if spec.get("faults"):
        env["LGBT_FAULTS"] = spec["faults"]
    out = {"rank": spec["rank"], "ok": False}
    try:
        res = run_host(params, spec["data"], int(spec.get("iters", ITERS)),
                       host_id=spec["rank"], num_hosts=spec["num_hosts"],
                       workdir=spec["workdir"], worker_env=env,
                       negotiate_deadline_s=20.0,
                       worker_timeout_s=float(spec.get("worker_timeout_s",
                                                       240)))
        with open(res.model_path) as fh:
            model = fh.read()
        out.update({
            "ok": True, "model": model, "history": res.history,
            "recoveries": res.recoveries, "ranks_lost": res.ranks_lost,
            "recovery_wall_s": res.recovery_wall_s,
            "iterations": res.result.get("iterations"),
            "report_elastic": (res.report or {}).get("elastic"),
            "worker_counters": (res.report or {}).get(
                "reliability", {}).get("counters", {})})
    except ElasticTerminalError as e:
        out.update({"error_kind": "terminal", "error": str(e),
                    "history": e.history})
    except ElasticHostDead as e:
        out.update({"error_kind": "host_dead", "error": str(e),
                    "rc": e.rc})
    import torch
    out["cuda_initialized"] = torch.cuda.is_initialized()
    out["rel_counters"] = rel_counters()
    return out


def _job_socket(spec):
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.distributed import (distributed_construct,
                                                   load_partitioned_file)
    from lightgbm_tpu_torch.io.net import SocketNet

    params = {"max_bin": 63, "min_data_in_bin": 3,
              "bin_construct_sample_cnt": 2000, "label_column": "0"}
    cfg = Config.from_params(params)
    mat, label, _w, _g, rows = load_partitioned_file(
        spec["data"], params, spec["rank"], spec["num_machines"])
    with SocketNet(spec["rank"], spec["num_machines"],
                   ("127.0.0.1", spec["port"])) as net:
        ds = distributed_construct(net, mat, cfg, categorical=[4],
                                   label=label, global_rows=rows)
    return {"mappers": [m.to_dict() for m in ds.bin_mappers],
            "used": ds.used_feature_map,
            "bins": ds.bins[:len(ds.bin_mappers), :ds.num_data],
            "global_rows": ds.global_rows,
            "num_data_global": ds.num_data_global}


def main():
    spec = json.loads(sys.argv[1])
    import torch
    torch.set_num_threads(1)
    job = spec["job"]
    # torchrun's ranks share one spec: their rank names the file
    spec["out"] = spec["out"].format(rank=os.environ.get("RANK", ""))
    out = {"train": _job_train, "chaos": _job_chaos,
           "elastic": _job_elastic, "socket": _job_socket}[job](spec)
    if job == "socket":
        with open(spec["out"], "wb") as fh:
            pickle.dump(out, fh)
    else:
        with open(spec["out"], "w") as fh:
            json.dump(out, fh)
    print(f"rank {spec.get('rank')} ok", flush=True)
    if job in ("chaos", "train"):
        if job == "chaos" and spec["rank"] == 0:
            _quiesce(spec, out.get("dead_ranks") or [])
        # leave without a teardown that would wait on a peer (dead, in
        # the chaos drill)
        sys.stdout.flush()
        os._exit(0)


def _quiesce(spec, dead_ranks):
    """Leader-last exit of the chaos drill: the store lives in rank 0's
    process, so rank 0 waits (bounded) for the other survivors' reports
    before it exits."""
    outdir = os.path.dirname(os.path.abspath(spec["out"]))
    peers = [os.path.join(outdir, f"r{r}.json")
             for r in range(1, int(spec["num_hosts"]))
             if r not in set(dead_ranks)]
    t0 = time.monotonic()
    while time.monotonic() - t0 < 15 and not all(
            os.path.exists(p) for p in peers):
        time.sleep(0.05)


if __name__ == "__main__":
    main()
