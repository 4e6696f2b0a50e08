"""The wave learner's device memory on the card against its byte estimate.

    python3 profiling/wave_memory.py
        [--cases 1000000:31,11000000:255:quant:open5,...]
        [--out chiprun_out/wave_memory.json]

Each case is ROWS:LEAVES with optional ``quant`` (``tpu_quantized_grad=on``)
and ``openN`` (``tpu_wave_open_levels=N``).  The rows are chip_smoke.py's
bench rows (bench.py's Higgs-shaped data, 28 features, 255 bins), binned
once at 1,000,000 rows and repeated through ``Dataset.subset`` up to the
case's rows.  Each case trains through the wave learner with the budget
lifted (``tpu_learner=wave``, ``tpu_wave_max_bytes`` 2**40), so shapes the
default budget refuses are measured too, and grows three trees from the
first gradients (chip_smoke.py's ``tree_memory``: the eager first tree, the
second that captures the CUDA graphs, the third that replays them).  Writes
one JSON file with the card's name and power limit (nvidia-smi) and per
case the peak allocation per tree, the CUDA graphs' pool, the learner's
footprint, the estimate (``learner_wave.wave_transient_bytes``, every
term) and whether
``tpu_learner=auto`` keeps the wave learner under the default
``tpu_wave_max_bytes``; prints one line per case.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu_torch.config import Config  # noqa: E402
from lightgbm_tpu_torch.learner_wave import (  # noqa: E402
    WaveTreeLearner, wave_ineligible_reason)

CASES = ("1000000:31,1000000:255,1000000:4095,1000000:255:quant:open5,"
         "8000000:31,8000000:255,11000000:31,11000000:255,11000000:4095,"
         "11000000:255:quant:open5,16000000:255")


def case_params(spec: str) -> tuple:
    """(rows, the case's training params) of one ROWS:LEAVES[:...] spec."""
    rows, leaves, *opts = spec.split(":")
    params = dict(chip_smoke.WAVE_PARAMS, num_leaves=int(leaves))
    for opt in opts:
        if opt == "quant":
            params["tpu_quantized_grad"] = "on"
        elif opt.startswith("open"):
            params["tpu_wave_open_levels"] = int(opt[4:])
        else:
            raise ValueError(f"unknown option {opt!r} in {spec!r}")
    return int(rows), params


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=CASES)
    ap.add_argument("--out", default="chiprun_out/wave_memory.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    ctx: dict = {}
    ds, _ = chip_smoke._dataset(ctx)
    n0 = ds.constructed.num_data
    default_budget = int(Config.from_params({}).tpu_wave_max_bytes)
    results = []
    for spec in args.cases.split(","):
        rows, params = case_params(spec)
        d = ds if rows == n0 else ds.subset(np.arange(rows) % n0)
        auto = wave_ineligible_reason(Config.from_params(params),
                                      d.constructed)
        bst = lt.Booster(dict(params, tpu_learner="wave",
                              tpu_wave_max_bytes=2 ** 40), d)
        if type(bst.gbdt.learner) is not WaveTreeLearner:
            raise RuntimeError(f"{spec}: {type(bst.gbdt.learner).__name__}")
        m = chip_smoke.tree_memory(bst)
        m.update({"case": spec, "auto_keeps_wave": auto is None,
                  "auto_reason": auto,
                  "footprint_over_default_budget":
                      m["footprint_bytes"] > default_budget})
        results.append(m)
        print(json.dumps({k: m[k] for k in (
            "case", "auto_keeps_wave", "peak_bytes_per_tree",
            "graph_pool_bytes", "reserved_unallocated_bytes",
            "footprint_bytes", "estimate_over_peak",
            "estimate_over_footprint")}
            | {"estimate": m["estimate_bytes"]["total_bytes"]}), flush=True)
        del bst, d
        gc.collect()
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "default_tpu_wave_max_bytes":
                   default_budget, "cases": results}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
