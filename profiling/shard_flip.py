"""Where a float32 2-D sharded model leaves the serial one on the card.

    python3 profiling/shard_flip.py [--iters 3]
        [--out chiprun_out/shard_flip.json]

chip_smoke.py's bench rows (1,000,000 x 28, 255 bins) train ``--iters``
iterations of its wave cell's float32 params twice: serially on the card,
and with ``tree_learner=data_feature`` on four ranks (a 2 x 2 mesh over
gloo, every rank on the one card).  The same pair then trains with
``gpu_use_dp`` (float64 histograms and gains).  For each pair the script
finds the first node, in tree order, whose split feature or threshold
differs, and prints both models' split there: the feature, the bin
threshold, the gain at full precision, the node's rows, and the two gains'
relative gap.  It also prints the largest difference of the two models'
predictions on 10,000 held-out rows.  It writes one JSON file with the
card's name and power limit (nvidia-smi).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu_torch import native  # noqa: E402
from lightgbm_tpu_torch.parallel.launch import RankPool  # noqa: E402

PRED_ROWS = 10_000


def host_trees(bst) -> list:
    """Per tree, its split arrays at full precision (the model text rounds
    ``split_gain``), node by node: feature, bin threshold, gain, the node's
    rows; and its child arrays."""
    out = []
    for t in bst.gbdt.models:
        n = t.num_leaves - 1
        out.append({"feature": t.split_feature[:n].tolist(),
                    "bin": t.threshold_in_bin[:n].tolist(),
                    "gain": t.split_gain[:n].tolist(),
                    "children": (t.left_child[:n].tolist(),
                                 t.right_child[:n].tolist()),
                    "internal_count": t.internal_count[:n].tolist()})
    return out


def first_divergence(serial: list, sharded: list):
    """The first (tree, node) whose split (feature, bin threshold) differs
    between two ``host_trees`` lists, with both splits and the gap of their
    gains; None where every split agrees."""
    for t, (a, b) in enumerate(zip(serial, sharded)):
        for i in range(max(len(a["feature"]), len(b["feature"]))):
            sa = (a["feature"][i], a["bin"][i]) \
                if i < len(a["feature"]) else None
            sb = (b["feature"][i], b["bin"][i]) \
                if i < len(b["feature"]) else None
            if sa == sb:
                continue
            side = {}
            for name, tree, sp in (("serial", a, sa), ("sharded", b, sb)):
                side[name] = None if sp is None else {
                    "feature": sp[0], "bin": sp[1],
                    "gain": tree["gain"][i],
                    "rows": tree["internal_count"][i]}
            gap = None
            if sa is not None and sb is not None:
                ga, gb = side["serial"]["gain"], side["sharded"]["gain"]
                gap = abs(ga - gb) / max(abs(ga), abs(gb))
            return {"tree": t, "node": i, **side, "gain_rel_gap": gap}
        if a["children"] != b["children"]:
            return {"tree": t, "node": None, "children_differ": True}
    return None


def _rank_train(path: str, params: dict, iters: int, Xp) -> dict:
    """One rank: the binned rows from ``path``, ``iters`` iterations."""
    ds = lt.Dataset(path, params=params)
    t0 = time.perf_counter()
    bst = lt.train(params, ds, iters, verbose_eval=False)
    return {"text": bst.model_to_string(), "trees": host_trees(bst),
            "pred": bst.predict(Xp),
            "learner": type(bst.gbdt.learner).__name__,
            "s": time.perf_counter() - t0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/shard_flip.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    # built once here, before the ranks start, so that they do not race
    native.build_all(native.KERNELS)
    ctx: dict = {}
    ds, _ = chip_smoke._dataset(ctx)
    Xp = ctx["Xv"][:PRED_ROWS]
    base = {k: v for k, v in chip_smoke.WAVE_PARAMS.items()
            if k != "metric"}
    res = {"card": smi, "iters": args.iters, "pairs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/rows.bin"
        ds.save_binary(path)
        with RankPool(4, "gloo", timeout_s=600) as pool:
            for name, extra in (("float32", {}),
                                ("dp", {"gpu_use_dp": True})):
                params = dict(base, **extra)
                t0 = time.perf_counter()
                serial = lt.train(params, ds, args.iters, verbose_eval=False)
                serial_s = time.perf_counter() - t0
                s_trees = host_trees(serial)
                ranks = pool.run(_rank_train, path,
                                 dict(params, tree_learner="data_feature",
                                      parallel_mesh="2x2"),
                                 args.iters, Xp, timeout_s=1200)
                pair = {
                    "serial_s": serial_s,
                    "sharded_s": [r["s"] for r in ranks],
                    "sharded_learner": ranks[0]["learner"],
                    "ranks_agree": all(r["text"] == ranks[0]["text"]
                                       for r in ranks),
                    "pred_max_diff": float(np.abs(
                        ranks[0]["pred"] - serial.predict(Xp)).max()),
                    "first_divergence": first_divergence(
                        s_trees, ranks[0]["trees"])}
                res["pairs"][name] = pair
                print(json.dumps({name: pair}), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(smi)


if __name__ == "__main__":
    main()
