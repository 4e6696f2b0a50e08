"""How many device records torch.profiler keeps of a short window, and when.

    python3 profiling/profiler_records.py [--out records.json]

The card tests used to count a kernel wrapper's device operations with
torch.profiler: a window of one spin kernel and ``calls`` launches, the
records of the launches counted.  Run alone, those tests saw every record;
in a run of the whole card-test file some windows came back short.  This
script repeats such windows in one process under conditions a test file
goes through (a fresh process, after CUDA graph captures and replays, after
a profiler window with CPU activities, with and without the spin kernel)
and prints, per condition, the records each window saw of the launches it
made, beside the count a CUDA graph capture of the same calls gives
(``cuGraphGetNodes``: the card tests' count since).  The last conditions
follow what the test file runs before its short windows: the categorical
split kernel at every width (B up to 10,000), then its plain version on
the CPU.  Needs a CUDA card;
imports torch and the port only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def profiler_count(fn, name: str, spin: bool = True,
                   cpu: bool = False) -> int:
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        if spin:
            torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and name in e.name)


def graph_count(fn) -> int:
    """The nodes of a CUDA graph capturing ``fn``."""
    cuda = ctypes.CDLL("libcuda.so.1")
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    return int(n.value)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="")
    ap.add_argument("--windows", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from lightgbm_tpu_torch.ops.scan import find_best_splits_batched

    dev = torch.device("cuda", 0)
    scan_args = [t.to(dev) for t in cs.scan_inputs(61, False, k=1)]
    x = torch.zeros(1 << 20, device=dev)
    cases = {"split_scan": (lambda: find_best_splits_batched(
        *scan_args, **cs.SCAN_KW), "split_scan"),
        "add": (lambda: x.add_(1.0), "elementwise")}
    for fn, _ in cases.values():
        fn()
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "name": torch.cuda.get_device_name(0), "windows": args.windows}

    def windows(tag, calls=3, **kw):
        res = {}
        for case, (fn, name) in cases.items():
            seen = [profiler_count(lambda: [fn() for _ in range(calls)],
                                   name, **kw) for _ in range(args.windows)]
            res[case] = {"launched": calls, "seen": seen}
        out[tag] = res

    windows("fresh_one_call", calls=1)
    windows("fresh_three_calls")
    windows("no_spin", spin=False)
    windows("cpu_and_cuda_activities", cpu=True)
    windows("after_cpu_window")
    out["graph_nodes"] = {case: graph_count(lambda: [fn() for _ in range(3)])
                          for case, (fn, _) in cases.items()}
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        x.add_(1.0)
    for _ in range(10):
        g.replay()
    torch.cuda.synchronize()
    windows("after_graph_replays")
    windows("after_graph_replays_one_call", calls=1)
    # what the card-test file runs before the windows that came back short:
    # the categorical split kernel at every width, then its plain version
    # on the CPU (tests/test_torch_cuda.py:test_split_cat_kernel_...)
    from lightgbm_tpu_torch.ops.split_cat import (
        categorical_candidates, categorical_candidates_plain)

    for b in (256, 1024, 2047, 4096, 10000):
        cpu = cs.split_cat_inputs(21 + b, True, b=b)
        card = [t.to(dev) for t in cpu]
        cs._cat_run(categorical_candidates, card, cs._cat_start(card), {})
    torch.cuda.synchronize()
    windows("after_split_cat_kernels")
    for b in (4096, 10000):
        cpu = cs.split_cat_inputs(21 + b, True, b=b)
        cs._cat_run(categorical_candidates_plain, cpu, cs._cat_start(cpu),
                    {})
    windows("after_split_cat_plain_on_the_cpu")
    text = json.dumps(out)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
