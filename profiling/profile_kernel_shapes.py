"""Where the histogram and split-scan kernels spend their time.

    python3 profiling/profile_kernel_shapes.py [--out chiprun_out/shapes.json]
        [--only split_scan,hist_segments,hist_full,hist_packed,
                hist_multislot,fused_scan] [--passes]

Times each kernel alone (its C entry point called again on the buffers one
wrapper call staged, ``native.staging()``; CUDA events, the L2 flushed
before each launch, mean of 20) on ``cuda:0`` across shapes that separate
its costs:

  split_scan     K in (2, 8, 128) leaves x B in (16, 64, 255) bins at
                 F = 28, random float32 histograms: the per-bin cost (the
                 carries and the threshold evaluation) against the fixed one
  hist_segments  the 64-member fixture of chip_smoke.py over 1,000,448
                 rows at Fw = 8, and one member of 25,000 and of 500,000
                 rows, each with random weights and with every weight zero
                 (a zero row is read but never binned: loads, pipeline and
                 flushes without the binning)
  hist_full      F = 28 uint16 codes at 1,023 bins over 1,000,448 rows with
                 every row weighted, 5%, 0.2% (the masked learner's usual
                 share) and no row weighted: what the weight rows and the
                 stage loop cost against the binning
  hist_packed    Fw = 8 words at 255 bins over the full 1,000,448-row
                 window, 65,536, 8,192 and 4,096 rows (an unaligned view),
                 each with random weights and with every weight zero
  hist_multislot Fw = 8 words at 255 bins over 1,000,448 rows, K in (1, 2,
                 4, 8, 16) slots with half of the rows in a slot (seeded
                 random slots in root order, as an opening level sees
                 them), K = 16 with 16 of every 18 rows in a slot (the
                 chip_smoke.py fixture), and K = 1, 4, 16 with features
                 28-31 at code 0 in every row (the dataset's padding of
                 the bench's 28 features, which the learner bins too)
  fused_scan     K in (1, 8, 16, 64) members at F = 28, B = 255, random
                 float32 histograms, a 574-slot pool

With ``--passes`` each hist_full, hist_packed, hist_multislot and fused_scan
case also gives the device time of each kernel the call launches (its
passes: row ballots, binning, reduce), from ``torch.profiler`` over the
same replays, and the wrapper's host time per call (``host_us``: 50 calls enqueued back to back, the host
clock around them, the card drained before and after).  Prints one JSON
line per kernel and writes them all to ``--out`` with the card's name and
power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from lightgbm_tpu_torch import native  # noqa: E402
from lightgbm_tpu_torch.ops.fused_scan import \
    fused_child_scans  # noqa: E402
from lightgbm_tpu_torch.ops.hist_full import \
    build_histogram_full  # noqa: E402
from lightgbm_tpu_torch.ops.hist_multislot import \
    build_histogram_multislot  # noqa: E402
from lightgbm_tpu_torch.ops.hist_packed import (  # noqa: E402
    build_histogram_packed, pack_bin_words)
from lightgbm_tpu_torch.ops.hist_segments import \
    build_histogram_segments  # noqa: E402
from lightgbm_tpu_torch.ops.scan import find_best_splits_batched  # noqa

N, FW, BINS, F = 1_000_448, 8, 255, 28


def pass_us(call, flush, reps: int = 20) -> dict:
    """Device microseconds per call of each kernel ``call`` launches, from
    torch.profiler over ``reps`` replays (the L2 flush's own kernel left
    out)."""
    from torch.profiler import ProfilerActivity, profile

    with native.staging() as rec:
        call()
    replay = rec[0]
    replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.add_(1)
            replay()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(
            e, "self_device_time_total", 0)
        if t and ("hist" in e.key or "lgbt" in e.key or "scan" in e.key):
            name = e.key.replace("(anonymous namespace)::", "")
            out[name.split("(")[0].split("<")[0].split(" ")[-1]] = t / reps
    return out


def host_us(call, reps: int = 50) -> float:
    """Host microseconds per wrapper call, the calls enqueued back to back
    (the card keeps up or queues; the host never waits)."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def kernel_ms(call, flush, reps: int = 20) -> float:
    with native.staging() as rec:
        call()
    replay = rec[0]
    replay()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.add_(1)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        replay()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def scan_case(dev, k: int, b: int, seed: int):
    rng = np.random.RandomState(seed)
    hist = rng.rand(k, F, b, 3).astype(np.float32)
    hist[..., 0] -= 0.5
    hist[..., 2] = np.floor(hist[..., 2] * 20)
    sums = hist.sum(axis=(1, 2)) / F
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        hist, sums[:, 0], sums[:, 1], sums[:, 2],
        np.full(F, b, np.int32), rng.randint(0, 3, F).astype(np.int32),
        (rng.randint(0, 99, F) % b).astype(np.int32), np.ones(F, bool))]
    return t


def segments_case(dev, members, zero: bool, seed: int):
    """Words over N rows and K disjoint members of the given sizes laid out
    in order; random float32 weights or all zero."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, BINS, size=(4 * FW, N)).astype(np.uint8)
    words = pack_bin_words(torch.from_numpy(codes).to(dev))
    w = np.stack([rng.randn(N), rng.rand(N), np.ones(N)]).astype(np.float32)
    if zero:
        w[:] = 0.0
    start = np.concatenate([[0], np.cumsum(members)[:-1]]) + 13
    lid = np.full(N, 9999, np.int32)
    for m, (s, c) in enumerate(zip(start, members)):
        lid[s:s + c] = 100 + m
    t = [torch.from_numpy(np.asarray(a)).to(dev) for a in (
        lid, start.astype(np.int64), np.asarray(members, np.int64),
        100 + np.arange(len(members)))]
    return words, torch.from_numpy(w).to(dev), t


def full_case(dev, share: float, seed: int):
    """(28, N) uint16 codes over 1,023 bins and
    random float32 weights on exactly ``share`` of the rows (random rows)."""
    rng = np.random.RandomState(seed)
    bins = torch.from_numpy(rng.randint(0, 1023, size=(F, N))
                            .astype(np.uint16)).to(dev)
    keep = np.zeros(N, np.float32)
    keep[rng.permutation(N)[:int(round(share * N))]] = 1.0
    w = np.stack([rng.randn(N) * keep, rng.rand(N) * keep, keep])
    return bins, torch.from_numpy(w.astype(np.float32)).to(dev)


def packed_case(dev, rows: int, zero: bool, seed: int):
    """An unaligned (Fw, rows) window view of (Fw, N) words and its
    weights (90% of the rows weighted), or zero weights."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, BINS, size=(4 * FW, N)).astype(np.uint8)
    words = pack_bin_words(torch.from_numpy(codes).to(dev))
    bag = (rng.rand(N) < 0.9).astype(np.float32)
    w = np.stack([rng.randn(N) * bag, rng.rand(N) * bag, bag])
    if zero:
        w[:] = 0.0
    w = torch.from_numpy(w.astype(np.float32)).to(dev)
    off = 0 if rows == N else 777
    return words[:, off:off + rows], w[:, off:off + rows]


def multislot_case(dev, k: int, share: float, seed: int, pad: bool = False):
    """(Fw, N) words, random float32 weights (90% of the rows bagged) and
    root-order slots with ``share`` of the rows in a slot of [0, K), the
    rest in slot K (dropped).  ``pad``: features 28-31 hold code 0 in every
    row, as the dataset pads the bench's 28 features to 32."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, BINS, size=(4 * FW, N)).astype(np.uint8)
    if pad:
        codes[F:] = 0
    words = pack_bin_words(torch.from_numpy(codes).to(dev))
    bag = (rng.rand(N) < 0.9).astype(np.float32)
    w = np.stack([rng.randn(N) * bag, rng.rand(N) * bag, bag])
    slot = np.where(rng.rand(N) < share, rng.randint(0, k, N), k)
    return (words, torch.from_numpy(w.astype(np.float32)).to(dev),
            torch.from_numpy(slot.astype(np.int32)).to(dev))


def fused_case(dev, k: int, seed: int, h: int = 574):
    """One quantized growth wave's fused step at F = 28, B = 255: random
    float32 smaller-child histograms, parents in distinct pool slots,
    fresh right-child slots, child sums and feature metadata."""
    rng = np.random.RandomState(seed)
    hs = np.stack([rng.randn(k, F, BINS) * 20, rng.rand(k, F, BINS) * 20,
                   rng.rand(k, F, BINS) * 80], -1).astype(np.float32)
    pool = rng.randn(h, F, BINS, 3).astype(np.float32)
    slots = rng.permutation(h)
    pool[slots[:k]] += hs
    sums = np.abs(rng.randn(3, 2 * k)).astype(np.float32) * 1000
    nb = np.full(F, BINS, np.int32)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        hs, pool, slots[:k].astype(np.int64), slots[k:2 * k].astype(np.int64),
        rng.rand(k) < 0.5, sums[0], sums[1], sums[2], nb,
        rng.randint(0, 3, F).astype(np.int32),
        rng.randint(0, 99, F).astype(np.int32), np.ones(F, bool))]
    return t


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="reports/profile_kernel_shapes.json")
    ap.add_argument("--only", default="split_scan,hist_segments,hist_full,"
                    "hist_packed,hist_multislot,fused_scan",
                    help="comma-separated kernels to time")
    ap.add_argument("--passes", action="store_true",
                    help="also each pass's device time (torch.profiler)")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    flush = torch.zeros(16 * 1024 * 1024, dtype=torch.float32, device=dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    keys = ("split_scan", "hist_segments", "hist_full", "hist_packed",
            "hist_multislot", "fused_scan")
    out = {"nvidia_smi": smi, **{key: [] for key in keys}}
    kw = dict(lambda_l1=0.1, lambda_l2=0.5, min_data_in_leaf=3)
    for k in (2, 8, 128) if "split_scan" in only else ():
        for b in (16, 64, 255):
            a = scan_case(dev, k, b, k * 1000 + b)
            ms = kernel_ms(lambda: find_best_splits_batched(*a, **kw), flush)
            out["split_scan"].append({"K": k, "B": b, "kernel_ms": ms})
    # the wrapper's host bound: the old kernel took the largest member
    # window, the redesigned one a bound on the sum of the counts
    takes_rows = "rows_bound" in inspect.signature(
        build_histogram_segments).parameters
    rng = np.random.RandomState(3)
    cuts = np.sort(rng.choice(np.arange(1, N - 100), 63, replace=False))
    fixture = np.diff(np.concatenate([[0], cuts, [N - 100]])).tolist()
    for name, members in (("fixture_64", fixture), ("one_25000", [25_000]),
                          ("one_500000", [500_000])
                          ) if "hist_segments" in only else ():
        for zero in (False, True):
            words, w, (lid, start, cnt, leaf) = segments_case(
                dev, members, zero, len(members))
            bound = ({"rows_bound": int(sum(members))} if takes_rows
                     else {"max_cnt": int(max(members))})
            ms = kernel_ms(lambda: build_histogram_segments(
                words, w, lid, start, cnt, leaf, num_bins=BINS, **bound),
                flush)
            out["hist_segments"].append({"case": name, "members":
                                         len(members), "rows": sum(members),
                                         "zero_weights": zero,
                                         "kernel_ms": ms})
    for share in (1.0, 0.05, 0.002, 0.0) if "hist_full" in only else ():
        bins, w = full_case(dev, share, 5)
        ms = kernel_ms(lambda: build_histogram_full(bins, w, num_bins=1023),
                       flush)
        out["hist_full"].append({"F": F, "rows": N, "num_bins": 1023,
                                 "weighted_share": share, "kernel_ms": ms})
        if args.passes:
            call = (lambda: build_histogram_full(bins, w, num_bins=1023))
            out["hist_full"][-1].update(passes_us=pass_us(call, flush),
                                        host_us=host_us(call))
    for rows in (N, 65_536, 8192, 4096) if "hist_packed" in only else ():
        for zero in (False, True):
            words, w = packed_case(dev, rows, zero, 6)
            ms = kernel_ms(lambda: build_histogram_packed(
                words, w, num_bins=BINS), flush)
            out["hist_packed"].append({"Fw": FW, "rows": rows,
                                       "zero_weights": zero,
                                       "kernel_ms": ms})
            if args.passes:
                call = (lambda: build_histogram_packed(words, w,
                                                       num_bins=BINS))
                out["hist_packed"][-1].update(passes_us=pass_us(call, flush),
                                              host_us=host_us(call))
    cases = ([(k, 0.5, False) for k in (1, 2, 4, 8, 16)]
             + [(16, 16 / 18, False), (1, 0.5, True), (4, 0.35, True),
                (16, 0.35, True)] if "hist_multislot" in only else [])
    for k, share, pad in cases:
        words, w, slot = multislot_case(dev, k, share, 7, pad)
        call = (lambda: build_histogram_multislot(
            words, w, slot, num_bins=BINS, n_slots=k))
        out["hist_multislot"].append({
            "Fw": FW, "rows": N, "K": k, "share": share,
            "padding_features_constant": pad,
            "rows_in_slot": int(((slot >= 0) & (slot < k)).sum()),
            "kernel_ms": kernel_ms(call, flush)})
        if args.passes:
            out["hist_multislot"][-1].update(passes_us=pass_us(call, flush),
                                             host_us=host_us(call))
    for k in (1, 8, 16, 64) if "fused_scan" in only else ():
        a = fused_case(dev, k, 8)
        call = (lambda: fused_child_scans(*a, lambda_l2=0.5,
                                          min_data_in_leaf=20))
        out["fused_scan"].append({"K": k, "F": F, "B": BINS,
                                  "kernel_ms": kernel_ms(call, flush)})
        if args.passes:
            out["fused_scan"][-1].update(passes_us=pass_us(call, flush),
                                         host_us=host_us(call))
    for key in keys:
        print(json.dumps({key: out[key]}))
    print(smi)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
