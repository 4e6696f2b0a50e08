"""Time the predict binner kernel (``csrc/bin_predict.cu``) on the card at
``chip_smoke.py``'s ``bin_predict`` shapes.

    python3 profiling/profile_bin_predict.py [--root DIR] [--shapes a,b]
        [--levels] [--reps 20]

``--root DIR`` imports ``lightgbm_tpu_torch`` from ``DIR``, another commit's
tree unpacked (``git archive``) into a git-ignored directory, so that two
versions are timed in turns in one call on one card, for example:

    for r in old . . old; do python3 profiling/profile_bin_predict.py \\
        --root $r; done

The shapes and the timing helpers come from this checkout's
``chip_smoke.py`` whatever the root.  One JSON line per shape: the
wrapper's time and the kernel's alone (CUDA events over ``--reps``
launches, the L2 flushed before each), its device time (the profiler's
kernel records), the bound (``chip_smoke.py:_bin_bytes``: the used
columns, the tables at their own width, the codes, at 3.35 TB/s; the same
bytes for both trees) and, for a tree with ``bin_plan``, the plan; the
predict shape also at its first 37 and 1,024 rows.  ``--levels`` times the
kernel with its
descent cut to 1, 4, 5, 6 and 7 of the tree's levels (the rows read and
the codes written as at full depth; the codes are not meaningful): what
the search adds to the memory traffic, level by level.  Each line carries
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_timing",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cut_search(binner, x, a, out, w: int):
    """A launch of the kernel over ``x`` as ``bin_predict`` lays it out,
    but told that the search rows are ``w`` wide: the descent takes
    log2(w) levels over the first ``w`` nodes of rows ``w`` apart (the
    plan's shared memory holds them: ``w`` is below the rows' width)."""
    from lightgbm_tpu_torch import native

    n, ldx = x.shape
    p = binner.plan_for(x, a)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return lambda: native.launch(
        "bin_predict", binner._lib().lgbt_bin_predict, x, ldx, n, a.fu,
        a.f_pad, a.meta, a.tree, w, a.cat_lut, a.cat_lut.shape[1], out,
        int(p.rows), int(p.staged), p.group, p.groups, p.stripes,
        p.tile_rows, p.stages, p.stage_doubles, p.smem, stream)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(REPO),
                    help="the tree whose lightgbm_tpu_torch is timed")
    ap.add_argument("--shapes", default="",
                    help="comma-separated chip_smoke.py BIN_SHAPES tags "
                         "(default all)")
    ap.add_argument("--levels", action="store_true",
                    help="also time this tree's kernel with its descent "
                         "cut short")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_bin_predict: no CUDA device", file=sys.stderr)
        return 2
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    sys.path.insert(1, str(REPO))         # expo_data, beside chip_smoke
    cs = _chip_smoke()
    import lightgbm_tpu_torch.binner as binner
    from lightgbm_tpu_torch.dataset import upload

    check_pkg = Path(binner.__file__).resolve()
    assert str(check_pkg).startswith(root), check_pkg
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    flush = torch.zeros(16 * 1024 * 1024, dtype=torch.float32, device=dev)
    want = [t for t in args.shapes.split(",") if t]
    has_plan = hasattr(binner, "bin_plan")
    for tag, max_bin in cs.BIN_SHAPES:
        if want and tag not in want:
            continue
        data, Xp, _ = cs.bin_predict_case(tag, max_bin)
        a = binner.BinnerArrays.for_data(data).device_arrays(dev)
        x = upload(Xp, dev)
        got = binner.bin_predict(x, a)
        ok = bool(torch.equal(got, binner.bin_plain(x, a)))
        # the bounds a row before any padding (the parent's arrays have
        # none)
        b = getattr(a, "num_bounds", a.bounds.shape[1])
        tables = a.meta.numel() * 4 + a.meta.shape[0] * b * 8 \
            + a.cat_lut.numel() * 4
        # the predict shape's first 37 and 1,024 rows: small requests
        subs = (x, *(x[:r].contiguous() for r in (37, 1024))) \
            if tag == "higgs_255" else (x,)
        for xs in subs:
            n = xs.shape[0]
            nbytes = n * a.fu * 8 + tables + a.f_pad * n * 4
            call = (lambda: binner.bin_predict(xs, a))
            line = {"root": root, "tag": tag, "rows": n, "fu": a.fu,
                    "ldx": xs.shape[1], "equal_to_plain": ok,
                    "ms": cs.cuda_ms(call, args.reps, flush),
                    "kernel_ms": cs.cuda_ms(cs.staged(call), args.reps,
                                            flush),
                    "device_ms": cs._device_ms(call, "bin_predict_rows"),
                    "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
                    "bytes": nbytes, "nvidia_smi": smi}
            if has_plan:
                line["plan"] = binner.plan_for(xs, a)._asdict()
            print(json.dumps(line), flush=True)
        if args.levels and has_plan:
            out = torch.empty_like(got)
            for w in (2, 16, 32, 64, 128):
                if w >= a.bounds.shape[1]:
                    continue
                fn = _cut_search(binner, x, a, out, w)
                print(json.dumps({
                    "tag": tag, "levels": w.bit_length() - 1,
                    "of_levels": a.bounds.shape[1].bit_length() - 1,
                    "kernel_ms": cs.cuda_ms(fn, args.reps, flush),
                    "device_ms": cs._device_ms(fn, "bin_predict_rows"),
                    "nvidia_smi": smi}), flush=True)
        del x, got, a, data, Xp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
