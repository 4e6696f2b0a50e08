"""Where one boosting iteration of the PyTorch port spends its time on the card.

    python3 profiling/profile_torch_iteration.py
        [--learner wave|compact|masked] [--max-bin 255] [--quant]
        [--open-levels N] [--categorical] [--rows 1000000] [--valid-rows 0]
        [--warmup 2] [--iters 1] [--out reports/profile_torch_iteration.json]

Trains the bench workload (bench.py's Higgs-shaped data, 28 features, 255
leaves, 255 bins unless ``--max-bin`` says otherwise, binary) with
``lightgbm_tpu_torch`` on ``cuda:0`` through the chosen learner (``wave``:
the default ``tpu_learner=auto`` path; ``compact``: the sequential learner;
``masked``: the masked learner, which ``auto`` picks past 256 bins, e.g.
``--learner masked --max-bin 1023``; ``--quant`` sets
``tpu_quantized_grad=on`` and ``--open-levels N`` ``tpu_wave_open_levels=N``
for the wave learner; ``--categorical`` trains chip_smoke.py's
Expo-shaped categorical cell instead (``expo_data.py``: six categorical
columns and two numerical ones, ``categorical_feature=0,...,5``);
``--valid-rows N`` holds out N more rows as a
validation set, which keeps the synchronous boosting loop, as chip_smoke.py's
wave_train runs it; without one the loop pipelines): ``--warmup``
iterations (past ``tpu_pipeline_flush_depth``, 8, every profiled iteration
of the pipelined loop also builds the host tree 8 iterations back), then
``--iters`` iterations under ``torch.profiler`` (CPU and CUDA
activities).  Writes one JSON file with the card's name and power limit
(nvidia-smi), the wall time, the device busy time over the profiled
iterations (sum of CUDA kernel and memcpy times), the device idle share, the
number of CUDA kernel and memcpy events per split and per iteration
(``cuda_events_*``: a kernel inside a replayed CUDA graph counts once per
replay), the host's launch calls per iteration (``host_launch_calls_per_iter``:
the runtime's kernel-launch and graph-launch calls, one per
``cudaGraphLaunch`` however many kernels the graph holds), host syncs per
tree (and for the wave learner waves, stall events, lagged flag waits and
graph launches per tree), each of the port's kernels' device ms per
iteration (``kernel_device_ms_per_iter``, by ``native.KERNEL_SYMBOLS``),
and the top operators by host time and by device time; prints a one-line
summary.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import lightgbm_tpu_torch as lt  # noqa: E402
from expo_data import EXPO_CATEGORICAL, expo_like  # noqa: E402
from lightgbm_tpu_torch.native import KERNEL_SYMBOLS  # noqa: E402

PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
          "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
          "metric": "none"}
LEARNERS = {"wave": "auto", "compact": "compact", "masked": "masked"}
#: runtime calls that launch work on the card, as the profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch", "cuGraphLaunch")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--learner", choices=sorted(LEARNERS), default="wave")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--valid-rows", type=int, default=0,
                    help="held-out rows (a validation set: the "
                         "synchronous loop)")
    ap.add_argument("--max-bin", type=int, default=255)
    ap.add_argument("--warmup", type=int, default=2,
                    help="iterations before the profiled ones")
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--quant", action="store_true",
                    help="tpu_quantized_grad=on")
    ap.add_argument("--open-levels", type=int, default=0,
                    help="tpu_wave_open_levels")
    ap.add_argument("--categorical", action="store_true",
                    help="chip_smoke.py's Expo-shaped categorical cell")
    ap.add_argument("--out", default="reports/profile_torch_iteration.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    rows = args.rows + args.valid_rows
    if args.categorical:
        X, y = expo_like(rows)
    else:
        rng = np.random.RandomState(7)
        X = rng.randn(rows, 28)
        logit = (X[:, 0] * 1.5 + X[:, 1] * X[:, 2] * 0.5 + np.sin(X[:, 3])
                 + 0.5 * rng.randn(rows))
        y = (logit > 0).astype(np.float64)
    params = dict(PARAMS, tpu_learner=LEARNERS[args.learner],
                  max_bin=args.max_bin,
                  tpu_quantized_grad="on" if args.quant else "auto",
                  tpu_wave_open_levels=args.open_levels)
    if args.categorical:
        params["categorical_feature"] = EXPO_CATEGORICAL
    ds = lt.Dataset(X[:args.rows], label=y[:args.rows], params=params)
    bst = lt.Booster(params, ds)
    if args.valid_rows:
        bst.add_valid(ds.create_valid(X[args.rows:], label=y[args.rows:]),
                      "heldout")
    for _ in range(args.warmup):
        bst.update()
    torch.cuda.synchronize()
    learner = bst.gbdt.learner
    syncs0 = learner.host_syncs
    waits0 = bst.gbdt.pipeline_waits
    # not ``models``, whose read would build the queued host trees
    trees0 = bst.gbdt.iter_ * bst.gbdt.num_tree_per_iteration
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            bst.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    waits = bst.gbdt.pipeline_waits - waits0
    trees = bst.gbdt.models[trees0:]
    splits = sum(t.num_leaves - 1 for t in trees)
    events = prof.key_averages()

    def dev_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    launch_calls = [e for e in prof.events() if e.name in LAUNCH_CALLS]
    graph_calls = sum(e.name in ("cudaGraphLaunch", "cuGraphLaunch")
                      for e in launch_calls)
    busy_us = sum(float(e.time_range.elapsed_us()) for e in kernels)
    kernel_ms = {n: sum(float(e.time_range.elapsed_us()) for e in kernels
                        if re.search(rf"(^|::){sym}(<[^>]*>)?\(", e.name))
                 / 1e3 / args.iters for n, sym in KERNEL_SYMBOLS.items()}
    by_host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:20]
    by_dev = sorted(events, key=dev_us, reverse=True)[:20]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    out = {
        "card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "learner": args.learner, "max_bin": args.max_bin,
        "quant": args.quant, "categorical": args.categorical,
        "open_levels": args.open_levels,
        "learner_class": type(learner).__name__, "rows": args.rows,
        "iters": args.iters, "splits": splits, "wall_s": wall,
        "s_per_iter": wall / args.iters,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "cuda_events": len(kernels),
        "cuda_events_per_split": len(kernels) / max(splits, 1),
        "cuda_events_per_iter": len(kernels) / args.iters,
        "host_launch_calls_per_iter": len(launch_calls) / args.iters,
        "graph_launch_calls_per_iter": graph_calls / args.iters,
        "valid_rows": args.valid_rows, "warmup": args.warmup,
        "pipelined": bool(getattr(bst.gbdt, "_can_pipeline",
                                  lambda: False)()),
        "record_waits_per_iter": waits / args.iters,
        "host_syncs_per_tree": (learner.host_syncs - syncs0) / len(trees),
        "kernel_device_ms_per_iter": kernel_ms,
        "top_host": [{"op": e.key, "count": e.count,
                      "self_cpu_ms": e.self_cpu_time_total / 1e3}
                     for e in by_host],
        "top_device": [{"op": e.key, "count": e.count,
                        "self_device_ms": dev_us(e) / 1e3}
                       for e in by_dev if dev_us(e) > 0],
    }
    stats = getattr(learner, "tree_stats", [])[-len(trees):]
    for key in ("open_levels", "waves", "stall_events", "stall_splits",
                "replay_passes", "flag_waits", "graph_launches", "passes"):
        if stats and key in stats[0]:
            out[key + "_per_tree"] = [s[key] for s in stats]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({k: out[k] for k in (
        "nvidia_smi", "learner", "learner_class", "max_bin", "quant",
        "open_levels", "categorical", "rows",
        "s_per_iter", "device_busy_s",
        "device_idle_share", "cuda_events_per_iter", "cuda_events_per_split",
        "host_launch_calls_per_iter", "graph_launch_calls_per_iter",
        "pipelined", "record_waits_per_iter", "host_syncs_per_tree",
        "kernel_device_ms_per_iter")
        + tuple(k for k in out if k.endswith("_per_tree")
                and k != "host_syncs_per_tree")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
