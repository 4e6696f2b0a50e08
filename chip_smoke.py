"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py                 # every phase (what a check runs)
    python3 chip_smoke.py --phases device,kernel

Run from the root of a checkout: the kernels are built from its sources
(``lightgbm_tpu_torch/csrc``) into ``lightgbm_tpu_torch/_build``.  Imports
torch, numpy and ``lightgbm_tpu_torch`` only.  Phases, each printing one JSON
line and each raising (exit code 1) on any failure:

  device  card name and power limit (nvidia-smi), torch, kernel build times
  kernel  packed histogram kernel vs its plain torch version at full width
          (Fw=8, N=1,000,448, 255 bins): bitwise on dyadic inputs at the full
          window and at a strided window view, within rtol=1e-5 and
          atol=1e-5*sum|w| on random float32 (summation order), bitwise
          equal across two launches
  tree    one 255-leaf tree from dyadic gradients on 1M x 28 Higgs-shaped
          rows, grown through the kernel and through the plain histogram:
          records bitwise equal
  train   lightgbm_tpu_torch.train at the bench width (1M x 28, 255 leaves,
          255 bins, 5 iterations, 100,000 held-out rows): launch count equal
          to the sum over trees of (1 + splits), device residency, training
          logloss falling every iteration, held-out AUC, seconds per
          iteration, host syncs per tree, peak device memory, Booster.predict
          agreeing with the device-side held-out scores
  small   a small input trained on the card and on the CPU (the path the
          tests hold against lightgbm_tpu): held-out metrics within 1e-4
  timing  kernel, plain-version and library (index_add_) times from CUDA
          events, L2 flushed before each launch, beside the byte bound

Then a ``kernels`` line, the card's ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

PHASES = ("device", "kernel", "tree", "train", "small", "timing")
FW, N_FULL, NUM_BINS = 8, 1_000_448, 255
ROWS, FEATURES, VALID_ROWS = 1_000_000, 28, 100_000
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS = 67e12                # H100 SXM float32, outside the tensor cores
TRAIN_PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
                "learning_rate": 0.1, "min_data_in_leaf": 20,
                "verbosity": -1, "metric": "auc,binary_logloss",
                "tpu_learner": "compact"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def higgs_like(rows: int, seed: int = 7):
    """bench.py's synthetic Higgs-shaped binary problem (28 dense features)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(rows, FEATURES).astype(np.float64)
    logit = (X[:, 0] * 1.5 + X[:, 1] * X[:, 2] * 0.5 + np.sin(X[:, 3])
             + 0.5 * rng.randn(rows))
    return X, (logit > 0).astype(np.float64)


def dyadic_weights(rng, n: int, n_real: int, dev):
    """(g*bag, h*bag, bag) with g, h multiples of 1/16, |g| <= 1, bag in
    {0, 1}: every sum is exact in float32 whatever its order."""
    bag = np.zeros(n, np.float32)
    bag[:n_real] = rng.rand(n_real) < 0.9
    g = (rng.randint(-16, 17, n) / 16.0).astype(np.float32)
    h = (rng.randint(1, 17, n) / 16.0).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (g, h, bag)]


def cuda_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` in ms from CUDA events, the 64 MB
    ``flush`` buffer rewritten before each launch so the L2 starts cold."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.add_(1)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def phase_device(ctx) -> None:
    from lightgbm_tpu_torch import native

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    ctx["smi"] = smi.stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    native.build_all(["hist_packed"])
    emit({"phase": "device", "nvidia_smi": ctx["smi"],
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": {k: v for k, v in native.BUILD_SECONDS.items()},
          "build_wall_s": time.perf_counter() - t0,
          "ptxas": {k: [ln for ln in v.splitlines() if "registers" in ln
                        or "smem" in ln] for k, v in
                    native.PTXAS_REPORT.items()}})


def phase_kernel(ctx) -> None:
    from lightgbm_tpu_torch.ops.hist_packed import (
        build_histogram_packed, build_histogram_packed_plain, pack_bin_words)

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    codes = rng.randint(0, NUM_BINS, size=(4 * FW, N_FULL)).astype(np.uint8)
    words = pack_bin_words(torch.from_numpy(codes).to(dev))
    g, h, bag = dyadic_weights(rng, N_FULL, N_FULL, dev)
    w_dy = torch.stack([g * bag, h * bag, bag])
    bag_r = torch.from_numpy((rng.rand(N_FULL) < 0.8).astype(np.float32)) \
        .to(dev)
    w_rand = torch.stack([
        torch.from_numpy(rng.randn(N_FULL).astype(np.float32)).to(dev) * bag_r,
        torch.from_numpy(rng.rand(N_FULL).astype(np.float32)).to(dev) * bag_r,
        bag_r])
    off, size = 12_345, 4096
    views = {"full": (words, slice(0, N_FULL)),
             "view4096@12345": (words[:, off:off + size],
                                slice(off, off + size))}
    out = {"phase": "kernel", "Fw": FW, "N": N_FULL, "num_bins": NUM_BINS}
    max_err = 0.0
    for tag, (wv, sl) in views.items():
        k = build_histogram_packed(wv, w_dy[:, sl], num_bins=NUM_BINS)
        p = build_histogram_packed_plain(wv, w_dy[:, sl], num_bins=NUM_BINS)
        check(torch.equal(k, p), f"dyadic {tag}: kernel != plain "
              f"(max diff {(k - p).abs().max().item()})")
        k = build_histogram_packed(wv, w_rand[:, sl], num_bins=NUM_BINS)
        k2 = build_histogram_packed(wv, w_rand[:, sl], num_bins=NUM_BINS)
        p = build_histogram_packed_plain(wv, w_rand[:, sl],
                                         num_bins=NUM_BINS)
        # float32 sums in another order than index_add_'s atomics: the error
        # bound scales with the channel's absolute mass
        atol = 1e-5 * w_rand[:, sl].abs().sum(dim=1)
        err = (k - p).abs()
        ok = bool((err <= 1e-5 * p.abs() + atol).all())
        check(ok, f"random {tag}: kernel vs plain beyond rtol=1e-5, "
              f"atol=1e-5*sum|w| (max diff {err.max().item()})")
        check(torch.equal(k, k2), f"{tag}: two launches differ")
        max_err = max(max_err, err.max().item())
        out[tag] = {"dyadic_bitwise": True, "random_max_abs_err":
                    err.max().item(), "relaunch_bitwise": True}
    torch.cuda.synchronize()
    ctx["max_abs_err"] = max_err
    emit(out)


def _dataset(ctx):
    """The 1M-row training set and the 100,000-row held-out set, binned
    once and shared by the tree and train phases."""
    if "ds" not in ctx:
        import lightgbm_tpu_torch as lt

        X, y = higgs_like(ROWS + VALID_ROWS)
        t0 = time.perf_counter()
        ds = lt.Dataset(X[:ROWS], label=y[:ROWS], params=TRAIN_PARAMS)
        dv = ds.create_valid(X[ROWS:], label=y[ROWS:])
        ds.construct()
        dv.construct()
        ctx["ds"], ctx["dv"] = ds, dv
        ctx["Xv"], ctx["yv"] = X[ROWS:], y[ROWS:]
        ctx["bin_s"] = time.perf_counter() - t0
    return ctx["ds"], ctx["dv"]


def phase_tree(ctx) -> None:
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.learner_compact import CompactTreeLearner
    from lightgbm_tpu_torch.ops.hist_packed import (
        build_histogram_packed, build_histogram_packed_plain)

    dev = torch.device("cuda", 0)
    ds, _ = _dataset(ctx)
    data = ds.constructed
    cfg = Config.from_params(TRAIN_PARAMS)
    g, h, bag = dyadic_weights(np.random.RandomState(1),
                               data.num_data_padded, data.num_data, dev)
    res = {}
    for tag, fn in (("kernel", build_histogram_packed),
                    ("plain", build_histogram_packed_plain)):
        learner = CompactTreeLearner(cfg, data, dev, histogram=fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[tag] = learner.grow(g, h, bag)
        torch.cuda.synchronize()
        res[tag + "_s"] = time.perf_counter() - t0
    (rk, ik, lk, _), (rp, ip, lp, _) = res["kernel"], res["plain"]
    splits = int((rk[:, 0] > 0.5).sum())
    check(splits > 0, "the dyadic tree did not split")
    check(np.array_equal(rk, rp) and np.array_equal(ik, ip),
          "tree records differ between kernel and plain histograms")
    check(torch.equal(lk, lp), "leaf partitions differ")
    emit({"phase": "tree", "splits": splits, "records_bitwise": True,
          "grow_s_kernel": res["kernel_s"], "grow_s_plain": res["plain_s"],
          "bin_s": ctx["bin_s"]})


def phase_train(ctx) -> None:
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.metrics import create_metric
    from lightgbm_tpu_torch.ops.hist_packed import build_histogram_packed

    ds, dv = _dataset(ctx)
    iters = 5
    evals, t_iter, train_ll = {}, [], []
    logloss = create_metric("binary_logloss", lt.Config.from_params(
        TRAIN_PARAMS))
    logloss.init(ds.constructed.metadata, ds.constructed.num_data)
    marks = {}

    def before(env):
        torch.cuda.synchronize()
        marks["t0"] = time.perf_counter()
    before.before_iteration = True

    def after(env):
        torch.cuda.synchronize()
        t_iter.append(time.perf_counter() - marks["t0"])
        score = env.model.gbdt.train_score.np_score()
        train_ll.append(logloss.eval(score, env.model.gbdt.objective)[0][1])
    after.order = 100

    torch.cuda.reset_peak_memory_stats()
    build_histogram_packed.launches = 0          # counts of the main path
    bst = lt.train(TRAIN_PARAMS, ds, iters, valid_sets=[dv],
                   valid_names=["heldout"], evals_result=evals,
                   verbose_eval=False, callbacks=[before, after])
    launches = build_histogram_packed.launches
    peak = torch.cuda.max_memory_allocated()
    trees = bst.gbdt.models
    want = sum(1 + t.num_leaves - 1 for t in trees)
    check(len(trees) == iters, f"{len(trees)} trees, want {iters}")
    check(launches == want, f"kernel launches {launches} != sum over trees "
          f"of (1 + splits) = {want}")
    learner = bst.gbdt.learner
    check(learner.bins_packed().is_cuda and bst.gbdt.train_score.score.is_cuda,
          "bins or scores are not on the card")
    st = learner._init_root(
        *[x for x in bst.gbdt.objective.get_gradients(
            bst.gbdt.train_score.score[0])], bst.gbdt._bag_mask,
        learner._all_features)
    check(st.w_p.is_cuda and st.hist_pool.is_cuda and st.bins_p.is_cuda,
          "weights or histogram pool are not on the card")
    check(all(b < a for a, b in zip(train_ll, train_ll[1:])),
          f"training logloss did not fall every iteration: {train_ll}")
    auc = evals["heldout"]["auc"]
    check(all(np.isfinite(auc)) and auc[-1] > 0.7,
          f"held-out AUC too low: {auc}")
    pred = bst.predict(ctx["Xv"])
    dev_score = bst.gbdt.valid_scores[0].np_score().astype(np.float64)
    check(pred.shape == (VALID_ROWS,) and bool(np.isfinite(pred).all()),
          "predictions are not finite of shape (100000,)")
    diff = float(np.abs(pred - 1.0 / (1.0 + np.exp(-dev_score))).max())
    check(diff < 1e-5, f"Booster.predict vs device held-out scores: {diff}")
    syncs_per_tree = learner.host_syncs / len(trees)
    ctx["launches"] = launches
    emit({"phase": "train", "iterations": iters, "trees_leaves":
          [t.num_leaves for t in trees], "kernel_launches": launches,
          "launches_expected": want, "train_logloss": train_ll,
          "heldout_auc": auc,
          "heldout_logloss": evals["heldout"]["binary_logloss"],
          "s_per_iter": t_iter, "s_per_iter_after_first":
          float(np.mean(t_iter[1:])), "host_syncs_per_tree": syncs_per_tree,
          "loop_score_reads": bst.gbdt.host_syncs,
          "peak_device_bytes": peak, "predict_vs_device_max_diff": diff,
          "device": str(learner.device)})


def phase_small(ctx) -> None:
    import lightgbm_tpu_torch as lt

    X, y = higgs_like(20_480, seed=11)
    out = {}
    for dev in ("cuda", "cpu"):
        p = dict(TRAIN_PARAMS, num_leaves=31, device_type=dev)
        ds = lt.Dataset(X[:16_384], label=y[:16_384], params=p)
        dv = ds.create_valid(X[16_384:], label=y[16_384:])
        ev = {}
        lt.train(p, ds, 3, valid_sets=[dv], valid_names=["v"],
                 evals_result=ev, verbose_eval=False)
        out[dev] = ev["v"]
    worst = max(abs(a - b) for m in ("auc", "binary_logloss")
                for a, b in zip(out["cuda"][m], out["cpu"][m]))
    # float32 histograms summed in other orders on the card and the CPU
    check(worst < 1e-4, f"card vs CPU held-out metrics differ by {worst}")
    emit({"phase": "small", "rows": 16_384, "cuda": out["cuda"],
          "cpu": out["cpu"], "max_metric_diff": worst})


def phase_timing(ctx) -> None:
    from lightgbm_tpu_torch.ops.hist_packed import (
        build_histogram_packed, build_histogram_packed_plain, pack_bin_words,
        unpack_bin_words)

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(2)
    codes = rng.randint(0, NUM_BINS, size=(4 * FW, N_FULL)).astype(np.uint8)
    words = pack_bin_words(torch.from_numpy(codes).to(dev))
    bag = torch.from_numpy((rng.rand(N_FULL) < 0.9).astype(np.float32)) \
        .to(dev)
    w = torch.stack([
        torch.from_numpy(rng.randn(N_FULL).astype(np.float32)).to(dev) * bag,
        torch.from_numpy(rng.rand(N_FULL).astype(np.float32)).to(dev) * bag,
        bag])
    flush = torch.zeros(16 * 1024 * 1024, dtype=torch.float32, device=dev)
    launches_before = build_histogram_packed.launches
    rows = {}
    for tag, s in (("full", N_FULL), ("65536", 65_536)):
        wv, ww = words[:, :s], w[:, :s]
        flat = (unpack_bin_words(wv, 4 * FW).to(torch.int64)
                + torch.arange(4 * FW, device=dev)[:, None] * NUM_BINS) \
            .reshape(-1)
        src = ww.t().unsqueeze(0).expand(4 * FW, s, 3).reshape(-1, 3) \
            .contiguous()
        reps = 20
        ms = cuda_ms(lambda: build_histogram_packed(wv, ww, num_bins=NUM_BINS),
                     reps, flush)
        plain_ms = cuda_ms(lambda: build_histogram_packed_plain(
            wv, ww, num_bins=NUM_BINS), reps, flush)
        lib_ms = cuda_ms(lambda: torch.zeros(
            4 * FW * NUM_BINS, 3, device=dev).index_add_(0, flat, src),
            reps, flush)
        in_bytes = FW * s * 4 + 3 * s * 4
        out_bytes = 4 * FW * NUM_BINS * 3 * 4
        bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = 4 * FW * s * 3 / F32_FLOPS * 1e3   # one add per row, lane
        rows[tag] = {"rows": s, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations", "bytes": in_bytes + out_bytes,
                     "achieved_GBps": (in_bytes + out_bytes) / ms / 1e6}
    build_histogram_packed.launches = launches_before
    ctx["timing"] = rows
    emit({"phase": "timing", "kernel": "hist_packed", "Fw": FW,
          "num_bins": NUM_BINS, "windows": rows,
          "nvidia_smi": ctx.get("smi")})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch  # noqa: F401  (fails outside a checkout)

    phases = [p for p in args.phases.split(",") if p]
    bad = [p for p in phases if p not in PHASES]
    if bad:
        raise SystemExit(f"unknown phases {bad}; known: {PHASES}")
    ctx = {}
    if "device" not in phases:
        phases.insert(0, "device")
    for name in PHASES:
        if name in phases:
            globals()[f"phase_{name}"](ctx)
    if "train" in phases and "timing" in phases:
        t = ctx["timing"]["full"]
        emit({"kernels": [{
            "name": "hist_packed", "route": "cuda",
            "source": "lightgbm_tpu_torch/csrc/hist_packed.cu",
            "replaces": "lightgbm_tpu/ops/hist_pallas.py:315",
            "launches": ctx["launches"],
            "max_abs_err": ctx.get("max_abs_err"),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "compare": "dyadic inputs bitwise; two launches bitwise; random "
                       "float32 within rtol=1e-5, atol=1e-5*sum|w|"}]})
    print(ctx["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
