"""Where one boosting iteration of the PyTorch port spends its time on the card.

    python3 profiling/profile_torch_iteration.py
        [--learner wave|compact|masked] [--max-bin 255] [--quant]
        [--open-levels N] [--rows 1000000] [--iters 1]
        [--out reports/profile_torch_iteration.json]

Trains the bench workload (bench.py's Higgs-shaped data, 28 features, 255
leaves, 255 bins unless ``--max-bin`` says otherwise, binary) with
``lightgbm_tpu_torch`` on ``cuda:0`` through the chosen learner (``wave``:
the default ``tpu_learner=auto`` path; ``compact``: the sequential learner;
``masked``: the masked learner, which ``auto`` picks past 256 bins, e.g.
``--learner masked --max-bin 1023``; ``--quant`` sets
``tpu_quantized_grad=on`` and ``--open-levels N`` ``tpu_wave_open_levels=N``
for the wave learner): two warm-up iterations, then
``--iters`` iterations under ``torch.profiler`` (CPU and CUDA activities).
Writes one JSON file with the card's name and power limit (nvidia-smi), the
wall time, the device busy time over the profiled iterations (sum of CUDA
kernel and memcpy times), the device idle share, the number of CUDA kernels
per split and per iteration, host syncs per tree (and for the wave learner
waves and stall events per tree), and the top operators by host time and by
device time; prints a one-line summary.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import lightgbm_tpu_torch as lt  # noqa: E402

PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
          "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
          "metric": "none"}
LEARNERS = {"wave": "auto", "compact": "compact", "masked": "masked"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--learner", choices=sorted(LEARNERS), default="wave")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--max-bin", type=int, default=255)
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--quant", action="store_true",
                    help="tpu_quantized_grad=on")
    ap.add_argument("--open-levels", type=int, default=0,
                    help="tpu_wave_open_levels")
    ap.add_argument("--out", default="reports/profile_torch_iteration.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    rng = np.random.RandomState(7)
    X = rng.randn(args.rows, 28)
    logit = (X[:, 0] * 1.5 + X[:, 1] * X[:, 2] * 0.5 + np.sin(X[:, 3])
             + 0.5 * rng.randn(args.rows))
    y = (logit > 0).astype(np.float64)
    params = dict(PARAMS, tpu_learner=LEARNERS[args.learner],
                  max_bin=args.max_bin,
                  tpu_quantized_grad="on" if args.quant else "auto",
                  tpu_wave_open_levels=args.open_levels)
    bst = lt.Booster(params, lt.Dataset(X, label=y, params=params))
    for _ in range(2):
        bst.update()
    torch.cuda.synchronize()
    learner = bst.gbdt.learner
    syncs0 = learner.host_syncs
    trees0 = len(bst.gbdt.models)
    stats0 = len(getattr(learner, "tree_stats", []))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            bst.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trees = bst.gbdt.models[trees0:]
    splits = sum(t.num_leaves - 1 for t in trees)
    events = prof.key_averages()

    def dev_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(float(e.time_range.elapsed_us()) for e in kernels)
    by_host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:20]
    by_dev = sorted(events, key=dev_us, reverse=True)[:20]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    out = {
        "card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "learner": args.learner, "max_bin": args.max_bin,
        "quant": args.quant,
        "open_levels": args.open_levels,
        "learner_class": type(learner).__name__, "rows": args.rows,
        "iters": args.iters, "splits": splits, "wall_s": wall,
        "s_per_iter": wall / args.iters,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "cuda_events": len(kernels),
        "cuda_events_per_split": len(kernels) / max(splits, 1),
        "cuda_events_per_iter": len(kernels) / args.iters,
        "host_syncs_per_tree": (learner.host_syncs - syncs0) / len(trees),
        "top_host": [{"op": e.key, "count": e.count,
                      "self_cpu_ms": e.self_cpu_time_total / 1e3}
                     for e in by_host],
        "top_device": [{"op": e.key, "count": e.count,
                        "self_device_ms": dev_us(e) / 1e3}
                       for e in by_dev if dev_us(e) > 0],
    }
    for key in ("open_levels", "waves", "stall_events", "stall_splits",
                "replay_passes"):
        stats = getattr(learner, "tree_stats", [])[stats0:]
        if stats:
            out[key + "_per_tree"] = [s[key] for s in stats]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({k: out[k] for k in (
        "nvidia_smi", "learner", "learner_class", "max_bin", "quant",
        "open_levels", "rows",
        "s_per_iter", "device_busy_s",
        "device_idle_share", "cuda_events_per_iter", "cuda_events_per_split",
        "host_syncs_per_tree") + tuple(k for k in out if k.endswith(
            "_per_tree") and k != "host_syncs_per_tree")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
