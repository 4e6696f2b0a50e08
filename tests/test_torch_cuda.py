"""The port's CUDA kernels on the card (``cuda`` marker; skipped without one).

The kernels have no CPU mode, so these tests run only where a CUDA device is
present; each decides that inside the ``cuda_device`` fixture.  They need
torch, numpy and the port only, so the card's machine runs them without
JAX installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -m cuda

(``--noconftest`` skips the suite's conftest, which imports JAX.)
"""

import threading

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops.hist_packed import (
    build_histogram_packed, build_histogram_packed_plain, pack_bin_words)

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    return torch.device("cuda", 0)


def _inputs(dev, fw, n, b, seed, dyadic):
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, b, size=(4 * fw, n)).astype(np.uint8)
    words = pack_bin_words(torch.from_numpy(codes).to(dev))
    bag = (rng.rand(n) < 0.8).astype(np.float32)
    if dyadic:
        g = rng.randint(-16, 17, n) / 16.0
        h = rng.randint(0, 17, n) / 16.0
    else:
        g, h = rng.randn(n), rng.rand(n)
    w = np.stack([g * bag, h * bag, bag]).astype(np.float32)
    return words, torch.from_numpy(w).to(dev)


@pytest.mark.parametrize("fw,n,b", [(1, 1024, 2), (2, 4096, 63),
                                    (8, 65536, 255), (3, 7168, 256)])
def test_kernel_bitwise_on_dyadic_inputs(cuda_device, fw, n, b):
    words, w = _inputs(cuda_device, fw, n, b, fw + n, dyadic=True)
    k = build_histogram_packed(words, w, num_bins=b)
    p = build_histogram_packed_plain(words, w, num_bins=b)
    assert k.shape == (4 * fw, b, 3)
    assert torch.equal(k, p)


def test_kernel_skewed_bins_and_dropped_codes(cuda_device):
    """Most rows in one bin (32-lane groups summed by one leader), and codes
    at or past num_bins, which both versions drop."""
    rng = np.random.RandomState(9)
    n = 8192
    codes = np.where(rng.rand(8, n) < 0.9, 3,
                     rng.randint(0, 256, (8, n))).astype(np.uint8)
    words = pack_bin_words(torch.from_numpy(codes).to(cuda_device))
    g = rng.randint(-16, 17, n) / 16.0
    w = torch.from_numpy(np.stack([g, np.abs(g), np.ones(n)])
                         .astype(np.float32)).to(cuda_device)
    for b in (4, 63, 256):
        k = build_histogram_packed(words, w, num_bins=b)
        p = build_histogram_packed_plain(words, w, num_bins=b)
        assert torch.equal(k, p), b


def test_kernel_window_views_and_relaunch(cuda_device):
    words, w = _inputs(cuda_device, 8, 1 << 16, 255, 3, dyadic=False)
    before = build_histogram_packed.launches
    for off, size in ((0, 1024), (777, 2048), (12345, 8192)):
        wv, ww = words[:, off:off + size], w[:, off:off + size]
        k1 = build_histogram_packed(wv, ww, num_bins=255)
        k2 = build_histogram_packed(wv, ww, num_bins=255)
        p = build_histogram_packed_plain(wv, ww, num_bins=255)
        assert torch.equal(k1, k2)
        # float32 sums in other orders: bound by the channel's mass
        atol = 1e-5 * ww.abs().sum(dim=1)
        assert bool(((k1 - p).abs() <= 1e-5 * p.abs() + atol).all())
    assert build_histogram_packed.launches == before + 6


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    words, w = _inputs(cuda_device, 2, 4096, 63, 5, dyadic=True)
    with pytest.raises(ValueError):
        build_histogram_packed(words[:, :1000], w[:, :1000], num_bins=63)
    with pytest.raises(ValueError):
        build_histogram_packed(words, w.double(), num_bins=63)
    with pytest.raises(ValueError):
        build_histogram_packed(words, w, num_bins=300)
    with pytest.raises(ValueError):
        build_histogram_packed(words.cpu(), w, num_bins=63)


def test_training_on_card_matches_cpu(cuda_device):
    rng = np.random.RandomState(0)
    X = rng.randn(9000, 12)
    X[rng.rand(9000) < 0.1, 3] = np.nan
    # columns 8..11 mutually exclusive: EFB bundles them
    X[:, 8:] = 0.0
    owner = rng.randint(8, 12, 9000)
    X[np.arange(9000), owner] = rng.rand(9000) + 0.5
    y = (X[:, 0] + np.nan_to_num(X[:, 3]) + X[:, 8]
         + 0.5 * rng.randn(9000) > 0).astype(float)
    out = {}
    for dev in ("cuda", "cpu"):
        p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
             "verbosity": -1, "device_type": dev, "tpu_learner": "compact",
             "metric": "auc,binary_logloss", "bagging_fraction": 0.8,
             "bagging_freq": 1}
        ds = lt.Dataset(X[:8192], label=y[:8192], params=p)
        dv = ds.create_valid(X[8192:], label=y[8192:])
        ev = {}
        bst = lt.train(p, ds, 4, valid_sets=[dv], evals_result=ev,
                       verbose_eval=False)
        assert bst.gbdt.train_data.bundle is not None
        out[dev] = ev["valid_0"]
    for m in ("auc", "binary_logloss"):
        np.testing.assert_allclose(out["cuda"][m], out["cpu"][m], rtol=0,
                                   atol=1e-4)


def test_segments_kernel_bitwise_on_dyadic_inputs(cuda_device):
    from lightgbm_tpu_torch.ops.hist_segments import (
        build_histogram_segments, build_histogram_segments_plain)

    words, w = _inputs(cuda_device, 2, 8192, 63, 11, dyadic=True)
    rng = np.random.RandomState(12)
    lid = torch.from_numpy(rng.randint(0, 3, 8192).astype(np.int32)) \
        .to(cuda_device)
    # unaligned windows, one span shared by leaves 1 and 2
    start = torch.tensor([0, 1000, 1000, 5001], device=cuda_device)
    cnt = torch.tensor([999, 3000, 3000, 3191], device=cuda_device)
    leaf = torch.tensor([0, 1, 2, 0], device=cuda_device)
    lid[:999] = 0
    lid[5001:] = 0
    k = build_histogram_segments(words, w, lid, start, cnt, leaf,
                                 num_bins=63, rows_bound=10_190)
    k2 = build_histogram_segments(words, w, lid, start, cnt, leaf,
                                  num_bins=63, rows_bound=10_190)
    p = build_histogram_segments_plain(words, w, lid, start, cnt, leaf,
                                       num_bins=63)
    assert k.shape == (4, 8, 63, 3)
    assert torch.equal(k, p) and torch.equal(k, k2)


def _wave_members(dev, k, n, seed):
    """K members over n rows as a wave lays them out: disjoint windows at
    unaligned starts, one member of more than a hundred 128-row tiles, a
    frozen pair sharing a span (K >= 4) and an empty member (K >= 3)."""
    rng = np.random.RandomState(seed)
    lid = np.full(n, 9999, np.int32)
    cuts = np.sort(rng.choice(np.arange(1, n - 20_000), 2 * k, replace=False))
    start, cnt = [int(cuts[0])], [20_000]     # the large member first
    for i in range(1, k):
        start.append(int(cuts[2 * i - 1]) + 20_000)
        cnt.append(int(cuts[2 * i] - cuts[2 * i - 1]))
    leaf = list(range(100, 100 + k))
    for i in range(k):
        lid[start[i]:start[i] + cnt[i]] = leaf[i]
    if k >= 4:                                # members 2 and 3 share a span
        start[3], cnt[3] = start[2], cnt[2]
        s, c = start[2], cnt[2]
        lid[s:s + c] = np.where(rng.rand(c) < 0.5, leaf[2], leaf[3])
    if k >= 3:
        cnt[-1] = 0
    t = [torch.tensor(a, device=dev) for a in (start, cnt, leaf)]
    return torch.from_numpy(lid).to(dev), t[0], t[1], t[2]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("k", [1, 2, 64])
def test_segments_kernel_bitwise_at_wave_shapes(cuda_device, k, quant):
    """Dyadic (and quant-grid) weights sum exactly in any order: the kernel
    equals the plain version bitwise whether a member's tiles sit in one
    block (a loose bound, many blocks) or spread over several (grids from
    small and large row bounds)."""
    from lightgbm_tpu_torch.ops.hist_segments import (
        build_histogram_segments, build_histogram_segments_plain)

    n = 300_000
    words, w = _inputs(cuda_device, 8, n, 255, k, dyadic=True)
    if quant:
        w = _quant_weights(cuda_device, n, k)
    lid, start, cnt, leaf = _wave_members(cuda_device, k, n, k)
    p = build_histogram_segments_plain(words, w, lid, start, cnt, leaf,
                                       num_bins=255, quant=quant)
    for bound in (1, int(cnt.sum()), 4 * n):
        got = build_histogram_segments(words, w, lid, start, cnt, leaf,
                                       num_bins=255, rows_bound=bound,
                                       quant=quant)
        assert got.shape == (k, 32, 255, 3)
        assert torch.equal(got, p), bound


def test_segments_kernel_relaunch_bitwise_on_random(cuda_device):
    from lightgbm_tpu_torch.ops.hist_segments import (
        build_histogram_segments, build_histogram_segments_plain)

    n = 300_000
    words, w = _inputs(cuda_device, 8, n, 255, 5, dyadic=False)
    lid, start, cnt, leaf = _wave_members(cuda_device, 64, n, 6)
    before = build_histogram_segments.launches
    a = build_histogram_segments(words, w, lid, start, cnt, leaf,
                                 num_bins=255, rows_bound=n)
    b = build_histogram_segments(words, w, lid, start, cnt, leaf,
                                 num_bins=255, rows_bound=n)
    assert build_histogram_segments.launches == before + 2
    assert torch.equal(a, b)
    p = build_histogram_segments_plain(words, w, lid, start, cnt, leaf,
                                       num_bins=255)
    mass = build_histogram_segments_plain(words, w.abs(), lid, start, cnt,
                                          leaf, num_bins=255)
    assert bool(((a - p).abs() <= 1e-5 * p.abs() + 1e-5 * mass).all())


#: cuGraphNodeGetType's kinds (CUgraphNodeType)
_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
               5: "empty", 6: "wait_event", 7: "event_record",
               8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
               11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


def _device_ops(fn):
    """The device operations ``fn`` issues (kernels, copies, fills), by
    kind: the nodes of a CUDA graph capturing one run of ``fn``, read with
    the driver's ``cuGraphGetNodes``.  The capture records every operation
    the call queues and nothing else, whatever ran before it in the
    process; the profiler's records, which these tests counted before,
    came back short in runs of the whole file (ROADMAP Queue C item 7)."""
    import ctypes

    drv = ctypes.CDLL("libcuda.so.1")
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert drv.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert drv.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert drv.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)) == 0
        kinds.append(_NODE_KINDS.get(kind.value, str(kind.value)))
    return kinds


@pytest.mark.parametrize("k", [1, 2, 128])
def test_scan_kernel_one_launch_bitwise_to_cpu(cuda_device, k):
    """Random float32 histograms at the bench width and a (K, F) feature
    mask: every SplitCandidates field bitwise equal to the plain version on
    the CPU, and the call issues exactly one kernel and no other device
    op."""
    from lightgbm_tpu_torch.ops.scan import find_best_splits_batched
    from lightgbm_tpu_torch.ops.split import find_best_splits

    rng = np.random.RandomState(40 + k)
    f, b, rows = 28, 255, 4096
    nb = rng.randint(2, b + 1, f).astype(np.int32)
    codes = (rng.rand(k, f, rows) * nb[None, :, None]).astype(np.int64)
    wts = np.stack([rng.randn(k, rows), rng.rand(k, rows),
                    np.ones((k, rows))]).astype(np.float32)
    flat = ((np.arange(k)[:, None, None] * f
             + np.arange(f)[None, :, None]) * b + codes).reshape(-1)
    hist = np.stack([np.bincount(flat, weights=np.broadcast_to(
        wts[c][:, None, :], codes.shape).reshape(-1), minlength=k * f * b)
        for c in range(3)], -1).reshape(k, f, b, 3).astype(np.float32)
    sums = wts.astype(np.float64).sum(axis=2).astype(np.float32)
    cpu = [torch.from_numpy(a) for a in (
        hist, sums[0], sums[1], sums[2], nb,
        rng.randint(0, 3, f).astype(np.int32),
        (rng.randint(0, 99, f) % nb).astype(np.int32),
        rng.rand(k, f) < 0.9)]
    dev = [t.to(cuda_device) for t in cpu]
    kw = dict(lambda_l1=0.1, lambda_l2=0.5, min_data_in_leaf=3,
              min_gain_to_split=0.01)
    before = find_best_splits_batched.launches
    got = find_best_splits_batched(*dev, **kw)
    assert find_best_splits_batched.launches == before + 1
    ref = find_best_splits(*cpu, **kw)
    for fld in got._fields:
        a, r = getattr(got, fld).cpu(), getattr(ref, fld)
        assert a.dtype == r.dtype and a.shape == r.shape, fld
        assert bool(((a == r) | (torch.isnan(a) & torch.isnan(r))).all()), \
            fld
    assert bool(torch.isinf(got.gain[~dev[-1]]).all())
    n0 = find_best_splits_batched.launches
    ops = _device_ops(lambda: find_best_splits_batched(*dev, **kw))
    assert ops == ["kernel"], ops
    assert find_best_splits_batched.launches == n0 + 1


def test_partition_kernel_is_the_plain_permutation(cuda_device):
    from lightgbm_tpu_torch.ops.partition import (apply_partition,
                                                  apply_partition_plain)

    rng = np.random.RandomState(13)
    n = 5000
    bins = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, (3, n))
                            .astype(np.int32)).to(cuda_device)
    w = torch.from_numpy(rng.randn(3, n).astype(np.float32)).to(cuda_device)
    w[0, :7] = float("nan")
    w[1, 7:14] = -0.0
    rid = torch.arange(n, device=cuda_device)
    lid = torch.from_numpy(rng.randint(0, 99, n).astype(np.int32)) \
        .to(cuda_device)
    dest = torch.from_numpy(rng.permutation(n).astype(np.int32)) \
        .to(cuda_device)
    before = apply_partition.launches
    k = apply_partition(bins, w, rid, lid, dest)
    p = apply_partition_plain(bins, w, rid, lid, dest)
    assert apply_partition.launches == before + 1
    assert torch.equal(k[0], p[0]) and torch.equal(k[2], p[2])
    assert torch.equal(k[1].view(torch.int32), p[1].view(torch.int32))
    assert torch.equal(k[3], p[3])
    with pytest.raises(ValueError):
        apply_partition(bins, w, rid, lid, dest.to(torch.int64))


@pytest.mark.parametrize("start,count", [(0, 1024), (4096, 2048),
                                         (0, 1_000_000), (333_333, 250_001)])
def test_partition_window_kernel_equals_plain(cuda_device, start, count):
    """The windowed partition kernel against its plain version at a
    1,024-row window, one at the default sort cutoff (2,048), all
    1,000,000 rows and a non-zero start: sort and mask mode, a NaN-typed
    numerical, a bundled and a categorical feature; every lane (weights as
    bits) and the result bitwise; a do = 0 split changes nothing."""
    from lightgbm_tpu_torch.ops.partition import (partition_window,
                                                  partition_window_plain)

    rng = np.random.RandomState(start + count)
    n, dev = 1_000_448, cuda_device
    lanes = [torch.from_numpy(a).to(dev) for a in (
        rng.randint(-2**31, 2**31 - 1, (8, n)).astype(np.int32),
        np.stack([rng.randn(n), rng.randn(n),
                  rng.rand(n) < 0.8]).astype(np.float32),
        np.arange(n, dtype=np.int64),
        np.where(rng.rand(n) < 0.9, 17, rng.randint(0, 300, n))
        .astype(np.int32))]
    lanes[1][0, :9] = float("nan")
    lanes[1][1, 9:19] = -0.0
    ftab = torch.tensor([[3, 16, 2, 0, 200, 0, 0], [5, 8, 0, 7, 40, 30, 1],
                         [6, 24, 0, 0, 256, 0, 0]], device=dev)
    bits = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, 8)
                            .astype(np.int32)).to(dev)

    def bitwise(ts):
        return [t.view(torch.int32) if t.dtype == torch.float32 else t
                for t in ts]

    for feat, (thr, flags) in enumerate(((99, 1), (12, 0), (0, 2))):
        for mask_max, do in ((0, 1), (1 << 30, 1), (0, 0)):
            split = torch.tensor([17, 254, feat, thr, flags, do, start,
                                  count], device=dev)
            k = [t.clone() for t in lanes]
            p = [t.clone() for t in lanes]
            n0 = partition_window.launches
            ko = partition_window(*k, split, ftab, bits, mask_max=mask_max)
            po = partition_window_plain(*p, split, ftab, bits,
                                        mask_max=mask_max)
            assert partition_window.launches == n0 + 1
            assert torch.equal(ko, po), (feat, mask_max, do)
            assert all(torch.equal(a, b) for a, b in
                       zip(bitwise(k), bitwise(p))), (feat, mask_max, do)
            if not do:
                assert all(torch.equal(a, b) for a, b in
                           zip(bitwise(k), bitwise(lanes)))
            elif mask_max == 0:
                assert int(ko[1]) + int(ko[3]) == count


def test_compact_graphed_tree_equals_eager_tree(cuda_device):
    """The compact learner's second tree replays its step as a CUDA graph;
    on the same gradients it equals a fresh learner's first tree, grown by
    the eager device step, record for record, with the same kernel calls
    and launches, and makes no blocking read but the records'."""
    from lightgbm_tpu_torch.learner_compact import CompactTreeLearner
    from lightgbm_tpu_torch.ops.hist_segments import build_histogram_segments
    from lightgbm_tpu_torch.ops.partition import partition_window

    cfg, data, g, h, bag = _wave_problem(cuda_device, {})
    graphed = CompactTreeLearner(cfg, data, cuda_device)
    assert graphed.use_graphs
    graphed.grow(g, h, bag)
    out = {}
    for name, ln in (("graphed", graphed),
                     ("eager", CompactTreeLearner(cfg, data, cuda_device))):
        calls = dict(ln.kernel_calls)
        n0 = (build_histogram_segments.launches, partition_window.launches)
        res = ln.grow(g * 0.5, h, bag)
        n1 = (build_histogram_segments.launches, partition_window.launches)
        out[name] = (res, {k: v - calls[k]
                           for k, v in ln.kernel_calls.items()},
                     (n1[0] - n0[0], n1[1] - n0[1]), ln.tree_stats[-1])
    (ra, ca, la, sa), (rb, cb, lb, sb) = out["graphed"], out["eager"]
    assert np.array_equal(ra[0], rb[0]) and np.array_equal(ra[1], rb[1])
    assert torch.equal(ra[2], rb[2]) and torch.equal(ra[3], rb[3])
    assert int((ra[0][:, 0] > 0.5).sum()) > 30
    assert ca == cb and la == lb == (cfg.num_leaves - 1,) * 2
    assert sa["graph_launches"] == sa["steps"] == cfg.num_leaves - 1
    assert sb["graph_launches"] == 0 and sa["host_syncs"] == 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tree = graphed.train_async(g, h, bag)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tree.host_stats["graph_launches"] == cfg.num_leaves - 1


def test_partition_kernel_fails_loudly_on_out_of_range_dest(cuda_device):
    """A dest outside [0, N) traps the kernel (the plain version's
    index_copy_ raises); a trap spoils the CUDA context, so it runs in a
    child process."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import torch\n"
        "from lightgbm_tpu_torch.ops.partition import apply_partition\n"
        "d, n = torch.device('cuda', 0), 1024\n"
        "dest = torch.arange(n, dtype=torch.int32, device=d)\n"
        "dest[5] = n\n"
        "apply_partition(torch.zeros(2, n, dtype=torch.int32, device=d),\n"
        "                torch.zeros(3, n, device=d),\n"
        "                torch.arange(n, device=d),\n"
        "                torch.zeros(n, dtype=torch.int32, device=d), dest)\n"
        "torch.cuda.synchronize()\n"
        "print('no error')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode != 0 and "no error" not in proc.stdout
    assert "CUDA" in proc.stderr, proc.stderr[-2000:]


def test_scan_kernel_equals_plain_on_dyadic_and_cpu_on_random(cuda_device):
    from lightgbm_tpu_torch.ops.scan import find_best_splits_batched
    from lightgbm_tpu_torch.ops.split import find_best_splits

    rng = np.random.RandomState(14)
    k, f, b = 5, 7, 40
    hist = np.stack([rng.randint(-256, 256, (k, f, b)) / 16.0,
                     rng.randint(1, 64, (k, f, b)) / 16.0,
                     rng.randint(0, 30, (k, f, b)).astype(float)],
                    -1).astype(np.float32)
    nb = rng.randint(2, b + 1, f).astype(np.int32)
    hist *= (np.arange(b)[None, :] < nb[:, None])[None, :, :, None]
    cpu = [torch.from_numpy(a) for a in (
        hist, hist[..., 0].sum((1, 2)) / f, hist[..., 1].sum((1, 2)) / f,
        hist[..., 2].sum((1, 2)) / f, nb,
        rng.randint(0, 3, f).astype(np.int32),
        (rng.randint(0, 99, f) % nb).astype(np.int32), np.ones(f, bool))]
    kw = dict(lambda_l2=0.5, min_data_in_leaf=3)
    for dyadic in (True, False):
        if not dyadic:
            cpu[0] = cpu[0] + torch.from_numpy(
                rng.randn(k, f, b, 3).astype(np.float32) * 1e-3)
        dev = [t.to(cuda_device) for t in cpu]
        got = find_best_splits_batched(*dev, **kw)
        ref = find_best_splits(*(dev if dyadic else cpu), **kw)
        for fld in got._fields:
            a = getattr(got, fld).cpu()
            r = getattr(ref, fld).cpu()
            assert bool(((a == r) | (torch.isnan(a) & torch.isnan(r)))
                        .all()), fld


def _quant_weights(dev, n, seed):
    rng = np.random.RandomState(seed)
    bag = (rng.rand(n) < 0.8).astype(np.float32)
    g = rng.randint(-7, 8, n) * 2.0 ** -5 * bag
    h = rng.randint(0, 16, n) * 2.0 ** -7 * bag
    return torch.from_numpy(np.stack([g, h, bag]).astype(np.float32)).to(dev)


def test_quant_modes_of_packed_and_segments_bitwise(cuda_device):
    from lightgbm_tpu_torch.ops.hist_segments import (
        build_histogram_segments, build_histogram_segments_plain)

    words, _ = _inputs(cuda_device, 2, 8192, 63, 21, dyadic=True)
    w = _quant_weights(cuda_device, 8192, 22)
    k = build_histogram_packed(words, w, num_bins=63, quant=True)
    p = build_histogram_packed_plain(words, w, num_bins=63, quant=True)
    assert torch.equal(k, p) and torch.equal(k[..., 2], k[..., 1])
    lid = torch.zeros(8192, dtype=torch.int32, device=cuda_device)
    lid[4000:] = 1
    start = torch.tensor([100, 4000], device=cuda_device)
    cnt = torch.tensor([3900, 4192], device=cuda_device)
    leaf = torch.tensor([0, 1], device=cuda_device)
    before = build_histogram_segments.quant_launches
    k = build_histogram_segments(words, w, lid, start, cnt, leaf,
                                 num_bins=63, rows_bound=8092, quant=True)
    p = build_histogram_segments_plain(words, w, lid, start, cnt, leaf,
                                       num_bins=63, quant=True)
    assert torch.equal(k, p)
    assert build_histogram_segments.quant_launches == before + 1


@pytest.mark.parametrize("k_slots,n,layout", [
    (1, 20480, "spread"), (2, 20480, "spread"), (3, 20480, "spread"),
    (4, 20480, "spread"), (8, 20480, "spread"), (16, 20480, "spread"),
    (17, 20480, "spread"), (64, 20480, "spread"), (2, 4096, "spread"),
    (1, 65536, "half"), (3, 20480, "empty"), (4, 20480, "constant")])
def test_multislot_kernel_bitwise_and_quant(cuda_device, k_slots, n, layout):
    """Every layout of the kernel's plan: K from one slot (the opening's
    first level) to 64, many chunks and one chunk (n = 4096: the output
    written directly), about half the rows in slot 0 in root order, and an
    empty slot; slot K and -1 rows dropped.  Bitwise to the plain version
    on dyadic weights and in the quant mode, and across two launches.
    ``constant``: four features hold one code in every row (the dataset's
    padding features), whose steps the kernel sums by a butterfly."""
    from lightgbm_tpu_torch.ops.hist_multislot import (
        build_histogram_multislot, build_histogram_multislot_plain,
        multislot_plan)

    words, w = _inputs(cuda_device, 3, n, 200, k_slots, dyadic=True)
    if layout == "constant":
        words[2] = 0x07070707           # features 8-11: code 7 everywhere
    rng = np.random.RandomState(k_slots)
    if layout == "half":
        slot = np.where(rng.rand(n) < 0.5, 0, 1)
    else:
        slot = rng.randint(-1, k_slots + 1, n)
        if layout == "empty":
            slot[slot == 1] = 0
    slot = torch.from_numpy(slot.astype(np.int32)).to(cuda_device)
    assert (multislot_plan(3, k_slots, n, 200).nchunks == 1) == (n == 4096)
    for quant, ww in ((False, w), (True, _quant_weights(cuda_device, n, 3))):
        a = build_histogram_multislot(words, ww, slot, num_bins=200,
                                      n_slots=k_slots, quant=quant)
        b = build_histogram_multislot(words, ww, slot, num_bins=200,
                                      n_slots=k_slots, quant=quant)
        p = build_histogram_multislot_plain(words, ww, slot, num_bins=200,
                                            n_slots=k_slots, quant=quant)
        assert a.shape == (k_slots, 12, 200, 3)
        assert torch.equal(a, p) and torch.equal(a, b)
        if layout == "empty":
            assert not a[1].any()


def _fused_case(dev, exact, seed, k=5, f=6, b=70, h=16):
    rng = np.random.RandomState(seed)
    nb = rng.randint(3, b + 1, f).astype(np.int32)
    mt = rng.randint(0, 3, f).astype(np.int32)
    db = (rng.randint(0, 99, f) % nb).astype(np.int32)
    bm = (np.arange(b)[None, :] < nb[:, None])[None, :, :, None]

    def hist():
        if exact:
            g = rng.randint(-280, 281, (k, f, b)) * 2.0 ** -6
            hh = rng.randint(0, 601, (k, f, b)) * 2.0 ** -8
        else:
            g, hh = rng.randn(k, f, b) * 5, rng.rand(k, f, b) * 5
        return (np.stack([g, hh, hh * 3.0], -1) * bm).astype(np.float32)

    hs, ho = hist(), hist()
    ls = rng.rand(k) < 0.5
    hl = np.where(ls[:, None, None, None], hs, ho)
    hr = np.where(ls[:, None, None, None], ho, hs)
    tot = np.stack([hl[:, 0].sum(1), hr[:, 0].sum(1)], 1).reshape(2 * k, 3)
    slots = rng.permutation(h)
    pool = rng.randn(h, f, b, 3).astype(np.float32)
    pool[slots[:k]] = hs + ho
    arrs = (hs, pool, slots[:k], slots[k:2 * k], ls, tot[:, 0], tot[:, 1],
            tot[:, 2], nb, mt, db, np.ones(f, bool))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]


@pytest.mark.parametrize("exact", [True, False])
def test_fused_kernel_equals_plain_and_unfused_step(cuda_device, exact):
    """Quant-grid and random float32 histograms: every field and both pool
    rows bitwise equal to the plain version on the CPU (the kernel's scan
    is the split scan's and its FixHistogram sum the plain pairwise
    tree)."""
    from lightgbm_tpu_torch.ops.fused_scan import (fused_child_scans,
                                                   fused_child_scans_plain)

    args = _fused_case(cuda_device, exact, 31 + exact)
    cpu = [t.cpu() for t in args]
    kw = dict(lambda_l2=0.5, min_data_in_leaf=3)
    pk = args[1].clone()
    before = fused_child_scans.launches
    got = fused_child_scans(args[0], pk, *args[2:], **kw)
    assert fused_child_scans.launches == before + 1
    ref = fused_child_scans_plain(*cpu, **kw)
    for fld in got._fields:
        a, r = getattr(got, fld).cpu(), getattr(ref, fld)
        assert bool(((a == r) | (torch.isnan(a) & torch.isnan(r))).all()), fld
    assert torch.equal(pk.cpu(), cpu[1])


@pytest.mark.parametrize("k", [1, 2, 64])
def test_fused_kernel_one_launch_bitwise_to_cpu(cuda_device, k):
    """The bench width (F = 28, B = 255), random float32, a feature with
    default_bin > 0 and a NaN-missing feature, the learner's tensor types
    (int64 slots, a bool flag, child sums as strided views): every field
    and both pool rows bitwise equal to the plain version on the CPU, and
    the call issues exactly one kernel and no other device op."""
    from lightgbm_tpu_torch.ops.fused_scan import (fused_child_scans,
                                                   fused_child_scans_plain)

    f, b, h = 28, 255, 2 * k + 7
    rng = np.random.RandomState(60 + k)
    nb = rng.randint(2, b + 1, f).astype(np.int32)
    nb[:2] = b
    mt = rng.randint(0, 3, f).astype(np.int32)
    mt[0], mt[1] = 2, 1                      # NaN-missing, Zero-missing
    db = (rng.randint(0, 99, f) % nb).astype(np.int32)
    db[1] = 17                               # default_bin > 0
    bm = (np.arange(b)[None, :] < nb[:, None])[None, :, :, None]
    hs = (np.stack([rng.randn(k, f, b) * 20, rng.rand(k, f, b) * 20,
                    rng.rand(k, f, b) * 80], -1) * bm).astype(np.float32)
    par = hs + (np.stack([rng.randn(k, f, b) * 20, rng.rand(k, f, b) * 20,
                          rng.rand(k, f, b) * 80], -1) * bm) \
        .astype(np.float32)
    slots = rng.permutation(h)
    pool = rng.randn(h, f, b, 3).astype(np.float32)
    pool[slots[:k]] = par
    ls = rng.rand(k) < 0.5
    tot = np.stack([par[:, 0].astype(np.float64).sum(1)] * 2, 1) \
        .reshape(2 * k, 3) * 0.5
    sums = torch.from_numpy(tot.astype(np.float32))   # (2K, 3): strided
    cpu = [torch.from_numpy(a) for a in (
        hs, pool, slots[:k].astype(np.int64), slots[k:2 * k].astype(np.int64),
        ls)] + [sums[:, 0], sums[:, 1], sums[:, 2]] + [torch.from_numpy(a)
                                                      for a in (nb, mt, db)] \
        + [torch.from_numpy(rng.rand(f) < 0.9)]
    sums_dev = sums.to(cuda_device)
    dev = [t.to(cuda_device) for t in cpu[:5]] + \
        [sums_dev[:, 0], sums_dev[:, 1], sums_dev[:, 2]] + \
        [t.to(cuda_device) for t in cpu[8:]]
    assert dev[5].stride(0) == 3
    kw = dict(lambda_l1=0.1, lambda_l2=0.5, min_data_in_leaf=3,
              min_gain_to_split=0.01)
    pk = dev[1].clone()
    before = fused_child_scans.launches
    got = fused_child_scans(dev[0], pk, *dev[2:], **kw)
    assert fused_child_scans.launches == before + 1
    pool_cpu = cpu[1].clone()
    ref = fused_child_scans_plain(cpu[0], pool_cpu, *cpu[2:], **kw)
    for fld in got._fields:
        a, r = getattr(got, fld).cpu(), getattr(ref, fld)
        assert a.dtype == r.dtype and a.shape == r.shape, fld
        assert bool(((a == r) | (torch.isnan(a) & torch.isnan(r))).all()), \
            fld
    assert torch.equal(pk.cpu(), pool_cpu)
    assert bool(torch.isfinite(got.gain).any())
    n0 = fused_child_scans.launches
    ops = _device_ops(lambda: [fused_child_scans(dev[0], pk, *dev[2:], **kw)
                               for _ in range(3)])
    assert ops == ["kernel"] * 3, ops
    assert fused_child_scans.launches == n0 + 3


def _full_inputs(dev, dtype, f, n, b, seed, dyadic=True, code_max=None):
    """The first ``f`` of 2*f code rows (a view with the padded row stride,
    as the masked learner passes them) and (3, n) weights."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, code_max or b, size=(2 * f, n)).astype(dtype)
    bag = (rng.rand(n) < 0.8).astype(np.float32)
    if dyadic:
        g, h = rng.randint(-16, 17, n) / 16.0, rng.randint(0, 17, n) / 16.0
    else:
        g, h = rng.randn(n), rng.rand(n)
    w = np.stack([g * bag, h * bag, bag]).astype(np.float32)
    return torch.from_numpy(codes).to(dev)[:f], torch.from_numpy(w).to(dev)


@pytest.mark.parametrize("dtype,f,n,b,code_max", [
    (np.uint8, 3, 1000, 2, None), (np.uint8, 7, 5000, 255, 256),
    (np.uint16, 28, 20_000, 1023, 1100), (np.uint16, 4, 9000, 2047, None),
    (np.uint16, 2, 3000, 65_536, None)])      # the widest uint16 histogram
def test_hist_full_bitwise_on_dyadic_inputs(cuda_device, dtype, f, n, b,
                                            code_max):
    from lightgbm_tpu_torch.ops.hist_full import build_histogram_full
    from lightgbm_tpu_torch.ops.histogram import build_histogram_onehot

    bins, w = _full_inputs(cuda_device, dtype, f, n, b, n + b,
                           code_max=code_max)
    before = build_histogram_full.launches
    k = build_histogram_full(bins, w, num_bins=b)
    k2 = build_histogram_full(bins, w, num_bins=b)
    assert build_histogram_full.launches == before + 2
    assert k.shape == (f, b, 3)
    assert torch.equal(k, build_histogram_onehot(bins, w, num_bins=b))
    assert torch.equal(k, k2)


def test_hist_full_random_float32_and_relaunch(cuda_device):
    from lightgbm_tpu_torch.ops.hist_full import build_histogram_full
    from lightgbm_tpu_torch.ops.histogram import build_histogram_onehot

    bins, w = _full_inputs(cuda_device, np.uint16, 28, 1 << 16, 1023, 3,
                           dyadic=False)
    k1 = build_histogram_full(bins, w, num_bins=1023)
    k2 = build_histogram_full(bins, w, num_bins=1023)
    p = build_histogram_onehot(bins, w, num_bins=1023)
    mass = build_histogram_onehot(bins, w.abs(), num_bins=1023)
    assert torch.equal(k1, k2)
    assert bool(((k1 - p).abs() <= 1e-5 * p.abs() + 1e-5 * mass).all())


def test_hist_full_wrapper_rejects_what_the_kernel_does_not_take(
        cuda_device):
    from lightgbm_tpu_torch.ops.hist_full import build_histogram_full

    bins, w = _full_inputs(cuda_device, np.uint16, 4, 4096, 300, 5)
    for bad_bins, bad_w, nb in (
            (bins, w, 65_537),                    # past a uint16 code
            (bins, w, 0),
            (bins.to(torch.int32), w, 300),       # codes not uint8/uint16
            (bins.view(torch.int16), w, 300),
            (bins.t().contiguous().t(), w, 300),  # rows not contiguous
            (bins, w.double(), 300),
            (bins, w[:, :4000], 300),
            (bins.cpu(), w, 300)):
        with pytest.raises(ValueError):
            build_histogram_full(bad_bins, bad_w, num_bins=nb)


def test_masked_training_on_card_matches_cpu(cuda_device):
    from lightgbm_tpu_torch.learner import MaskedTreeLearner
    from lightgbm_tpu_torch.ops.hist_full import build_histogram_full

    rng = np.random.RandomState(1)
    X = rng.randn(9000, 10)
    X[rng.rand(9000) < 0.1, 3] = np.nan
    y = (X[:, 0] + np.nan_to_num(X[:, 3]) + 0.5 * rng.randn(9000) > 0) \
        .astype(float)
    out = {}
    for dev in ("cuda", "cpu"):
        p = {"objective": "binary", "num_leaves": 31, "max_bin": 511,
             "verbosity": -1, "device_type": dev,
             "metric": "auc,binary_logloss"}
        ds = lt.Dataset(X[:8192], label=y[:8192], params=p)
        dv = ds.create_valid(X[8192:], label=y[8192:])
        ev = {}
        before = build_histogram_full.launches
        bst = lt.train(p, ds, 4, valid_sets=[dv], evals_result=ev,
                       verbose_eval=False)
        learner = bst.gbdt.learner
        assert type(learner) is MaskedTreeLearner
        assert learner.bins.dtype == torch.uint16
        launched = build_histogram_full.launches - before
        assert launched == (learner.kernel_calls["hist_full"]
                            if dev == "cuda" else 0)
        out[dev] = ev["valid_0"]
    # float32 histograms summed in other orders on the card and the CPU
    for m in ("auc", "binary_logloss"):
        np.testing.assert_allclose(out["cuda"][m], out["cpu"][m], rtol=0,
                                   atol=1e-4)


def test_device_predictor_on_card_equals_host_trees(cuda_device):
    from lightgbm_tpu_torch.predictor import DevicePredictor

    rng = np.random.RandomState(2)
    X = rng.randn(6000, 8)
    X[::11, 2] = np.nan
    X[rng.rand(6000) < 0.3, 4] = 0.0
    y = (X[:, 0] + X[:, 1] * np.nan_to_num(X[:, 2]) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1}
    bst = lt.train(p, lt.Dataset(X, label=y), 12, verbose_eval=False)
    Xt = rng.randn(40_000, 8)
    Xt[::7, 2] = np.nan
    host = np.zeros(len(Xt))
    for t in bst.gbdt.models:
        host += t.predict(Xt)
    dp = DevicePredictor(bst.gbdt, bst.gbdt.train_data)
    assert dp.nodes.is_cuda
    np.testing.assert_allclose(dp.predict_raw(Xt), host, rtol=0, atol=1e-9)
    before = bst.gbdt.device_predictions
    np.testing.assert_allclose(bst.predict(Xt, raw_score=True), host,
                               rtol=0, atol=1e-9)     # 40,000 x 12 trees
    assert bst.gbdt.device_predictions == before + 1


# -- the redesigned full-pass histograms: weighted shares, edge weights ----

def _bits_equal(a, b):
    """Bitwise equal (NaN payloads included)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _nan_equal(a, b):
    """Equal where not NaN, NaN at the same places (the plain version's
    NaN payload may differ)."""
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _shared_weights(dev, n, share, seed, edge=False):
    """Dyadic (3, n) weights with a ``share`` of the rows weighted, the
    rest exactly zero; with ``edge``, some weighted rows carry -0.0 in one
    or two lanes, some rows carry -0.0 in all three (skipped: all zero), and
    a few carry a NaN (not skipped)."""
    rng = np.random.RandomState(seed)
    keep = rng.rand(n) < share
    g = rng.randint(-16, 17, n) / 16.0 * keep
    h = rng.randint(0, 17, n) / 16.0 * keep
    w = np.stack([g, h, keep.astype(np.float64)]).astype(np.float32)
    if edge:
        w[0, rng.rand(n) < 0.1] = -0.0
        w[1, rng.rand(n) < 0.1] = -0.0
        w[:, rng.rand(n) < 0.05] = -0.0
        w[0, rng.choice(n, 3, replace=False)] = np.nan
    return torch.from_numpy(w).to(dev)


FULL_SHARES = [1.0, 0.05, 0.002, 0.0]


@pytest.mark.parametrize("share", FULL_SHARES)
@pytest.mark.parametrize("dtype,f,n,b", [
    (np.uint8, 7, 70_001, 255), (np.uint16, 28, 100_000, 1023),
    (np.uint16, 5, 40_000, 2048)])
def test_hist_full_weighted_shares_bitwise(cuda_device, dtype, f, n, b,
                                           share):
    """Every weighted share, bitwise to the plain version on dyadic inputs
    and across two launches; codes past num_bins dropped; at 2,048 bins
    two bin tiles."""
    from lightgbm_tpu_torch.ops.hist_full import build_histogram_full
    from lightgbm_tpu_torch.ops.histogram import build_histogram_onehot

    bins, _ = _full_inputs(cuda_device, dtype, f, n, b, n + b,
                           code_max=b + 40)
    w = _shared_weights(cuda_device, n, share, n)
    k1 = build_histogram_full(bins, w, num_bins=b)
    k2 = build_histogram_full(bins, w, num_bins=b)
    assert k1.shape == (f, b, 3)
    assert _bits_equal(k1, build_histogram_onehot(bins, w, num_bins=b))
    assert _bits_equal(k1, k2)
    if share == 0.0:
        assert not bool(k1.ne(0).any())


@pytest.mark.parametrize("dtype,b", [(np.uint8, 255), (np.uint16, 1023)])
def test_hist_full_skew_and_edge_weights(cuda_device, dtype, b):
    """Every row in one bin (one 32-lane group per step), and -0.0 and NaN
    weights: all-zero rows skipped, a NaN row counted."""
    from lightgbm_tpu_torch.ops.hist_full import build_histogram_full
    from lightgbm_tpu_torch.ops.histogram import build_histogram_onehot

    n, f = 50_000, 6
    bins = torch.from_numpy(np.full((f, n), b - 1, dtype)).to(cuda_device)
    w = _shared_weights(cuda_device, n, 0.5, 3)
    k = build_histogram_full(bins, w, num_bins=b)
    assert _bits_equal(k, build_histogram_onehot(bins, w, num_bins=b))
    assert not bool(k[:, :b - 1].ne(0).any())
    bins, _ = _full_inputs(cuda_device, dtype, f, n, b, 4)
    w = _shared_weights(cuda_device, n, 0.3, 5, edge=True)
    k1 = build_histogram_full(bins, w, num_bins=b)
    k2 = build_histogram_full(bins, w, num_bins=b)
    assert _bits_equal(k1, k2)
    p = build_histogram_onehot(bins, w, num_bins=b)
    assert bool(torch.isnan(k1).any())
    assert _nan_equal(k1, p)
    ok = ~torch.isnan(p)
    assert torch.equal(k1[ok].view(torch.int32), p[ok].view(torch.int32))


@pytest.mark.parametrize("share", FULL_SHARES)
@pytest.mark.parametrize("off,s", [(0, 1024), (333, 1024), (5, 65_536),
                                   (0, 65_536), (1001, 200_704)])
def test_packed_weighted_shares_and_views_bitwise(cuda_device, off, s,
                                                  share):
    """Window views at unaligned row offsets, every weighted share: bitwise
    to the plain version on dyadic inputs and across two launches."""
    fw, b = 8, 255
    rng = np.random.RandomState(s + off)
    codes = rng.randint(0, 256, size=(4 * fw, off + s)).astype(np.uint8)
    words = pack_bin_words(torch.from_numpy(codes).to(cuda_device))
    w = _shared_weights(cuda_device, off + s, share, off)
    wv, ww = words[:, off:], w[:, off:]
    k1 = build_histogram_packed(wv, ww, num_bins=b)
    k2 = build_histogram_packed(wv, ww, num_bins=b)
    assert _bits_equal(k1, build_histogram_packed_plain(wv, ww, num_bins=b))
    assert _bits_equal(k1, k2)


@pytest.mark.parametrize("quant", [False, True])
def test_packed_skew_edge_weights_and_quant(cuda_device, quant):
    """Every row in one bin, -0.0 and NaN weights, codes past num_bins, in
    both modes; the quant mode bitwise with channel 2 the hessian's sums."""
    n, fw = 65_536, 3
    skew = pack_bin_words(torch.full((4 * fw, n), 7, dtype=torch.uint8)
                          .to(cuda_device))
    w = _shared_weights(cuda_device, n, 0.6, 8)
    k = build_histogram_packed(skew, w, num_bins=63, quant=quant)
    assert _bits_equal(k, build_histogram_packed_plain(skew, w, num_bins=63,
                                                       quant=quant))
    words, _ = _inputs(cuda_device, fw, n, 256, 9, dyadic=True)
    w = _shared_weights(cuda_device, n, 0.4, 10, edge=True)
    k1 = build_histogram_packed(words, w, num_bins=100, quant=quant)
    k2 = build_histogram_packed(words, w, num_bins=100, quant=quant)
    p = build_histogram_packed_plain(words, w, num_bins=100, quant=quant)
    assert _bits_equal(k1, k2)
    assert bool(torch.isnan(k1).any()) and _nan_equal(k1, p)
    ok = ~torch.isnan(p)
    assert torch.equal(k1[ok].view(torch.int32), p[ok].view(torch.int32))
    if quant:
        assert _nan_equal(k1[..., 2], k1[..., 1])


# -- the device-resident wave tree: replay kernel, graphs, no host read ----

def _replay_tables(dev, seed, m, grown, dtype):
    from test_torch_replay import _forest

    g, split, child0, width, nn = _forest(np.random.RandomState(seed), m,
                                          grown)
    return [torch.from_numpy(g).to(dtype), torch.from_numpy(split),
            torch.from_numpy(child0), torch.from_numpy(width)], nn


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("budget,kb,extras_cap,vec_cap,seed", [
    (30, 1, 29, 1 << 17, 30), (62, 4, 2, 600, 248),
    (254, 4, 64, 1 << 17, 1017), (254, 16, 64, 1 << 17, 4064)])
def test_replay_kernel_bitwise_to_plain(cuda_device, budget, kb, extras_cap,
                                        vec_cap, seed, dtype):
    """Pass by pass over random node tables with exact gain ties, the
    kernel's carried state, members and counters equal the plain version's
    on the CPU; each correction gives the members random children on both
    sides; a pass after the end is a no-op."""
    from test_torch_replay import GAINS, _state
    from lightgbm_tpu_torch.ops.replay import (CTL_FLAG, FLAG_DONE,
                                               replay_pass, replay_pass_plain)

    rng = np.random.RandomState(budget + kb)
    m = 1 + 2 * (budget + budget + extras_cap)
    tab, nn = _replay_tables(cuda_device, seed, m, budget // 2, dtype)
    cpu = list(_state(m, budget, kb))
    card = [t.to(cuda_device) for t in cpu]
    kw = dict(budget=budget, stall_batch=kb, extras_cap=extras_cap,
              vec_cap=vec_cap, pad_slot=m)
    n0 = replay_pass.launches
    for step in range(budget + 2):
        replay_pass_plain(*tab, *cpu, **kw)
        replay_pass(*[t.to(cuda_device) for t in tab], *card, **kw)
        torch.cuda.synchronize()
        for a, b in zip(cpu, card):
            assert torch.equal(a, b.cpu()), step
        if int(cpu[3][CTL_FLAG]) == FLAG_DONE:
            break
        members, mvalid = cpu[4], cpu[5]
        for s in members[mvalid].tolist():
            tab[1][s] = True
            tab[2][s] = nn
            tab[0][nn:nn + 2] = torch.from_numpy(
                rng.choice(GAINS, 2)).to(dtype)
            tab[3][nn:nn + 2] = torch.tensor([1, tab[3][s] - 1])
            nn += 2
    assert int(cpu[3][CTL_FLAG]) == FLAG_DONE and step > 2
    after = [t.clone() for t in card]
    replay_pass(*[t.to(cuda_device) for t in tab], *card, **kw)
    assert all(torch.equal(a, b) for a, b in zip(after, card))
    assert replay_pass.launches == n0 + step + 2


@pytest.mark.parametrize("case", ["half_grown", "half_grown_vec_cap",
                                  "grown", "num_leaves_4095",
                                  "num_leaves_4097", "num_leaves_8191"])
def test_replay_kernel_at_the_check_forests(cuda_device, case):
    """The forests of chip_smoke.py's replay phase (M = 1,145: half grown,
    with a binding vector cap, grown to the budget) and forests at the
    sizing of num_leaves=4095 (M = 16,505, the node table in global
    memory), 4,097 (the list buffers in global memory) and 8,191 (both):
    every pass bitwise to the plain version on the CPU, run to the replay's
    end, a pass after it a no-op."""
    import chip_smoke as cs
    from lightgbm_tpu_torch.ops.replay import CTL_POPS, replay_pass

    if case.startswith("num_leaves_"):
        m, b = cs.replay_dims(int(case.split("_")[-1]))
        rng = np.random.RandomState(6)
        tab, nn = cs.replay_ordered_forest(rng, m, b, holes=0.002)
        kw = dict(cs.REPLAY_KW, budget=b, pad_slot=m)
        vals = cs.REPLAY_GAINS[2:]
    else:
        m, b = cs.REPLAY_M, cs.REPLAY_BUDGET
        seed, grown, vec_cap = {"half_grown": (11, 127, 1 << 17),
                                "half_grown_vec_cap": (12, 127, 5000),
                                "grown": (13, b, 1 << 17)}[case]
        rng = np.random.RandomState(seed)
        tab, nn = cs.replay_forest(rng, grown)
        kw = dict(cs.REPLAY_KW, vec_cap=vec_cap)
        vals = cs.REPLAY_GAINS
    cpu = cs.replay_state(m=m, b=b)
    card = [t.to(cuda_device) for t in cpu]
    passes = cs.replay_to_end(rng, tab, nn, cpu, kw, card, vals=vals)
    assert passes >= 1 and int(cpu[3][CTL_POPS]) > 0
    after = [t.clone() for t in card]
    replay_pass(*[t.to(cuda_device) for t in tab], *card, **kw)
    assert all(torch.equal(x, y) for x, y in zip(after, card))


@pytest.mark.parametrize("b,dyadic", [
    (256, True), (256, False), (1024, True), (1024, False), (2047, True),
    (2047, False), (4096, True), (10000, True)])
def test_split_cat_kernel_bitwise_at_every_width(cuda_device, b, dyadic):
    """The categorical split kernel at K = 128 leaves of chip_smoke.py's
    eight-column fixture (one-hot, many-vs-many, NaN-typed, Zero-missing,
    a CTR tie) at B = 256, 1,024 and 2,047, and on dyadic counts at 4,096
    and 10,000 (over 2,048 and 8,192 eligible bins: the shared-memory sort
    and its cut rounds), in every regime of its phase:
    every field and bitset bitwise equal to the plain version on the CPU,
    the numerical columns carried untouched, one launch per call."""
    import chip_smoke as cs
    from lightgbm_tpu_torch.ops.split_cat import (
        categorical_candidates, categorical_candidates_plain)

    cpu = cs.split_cat_inputs(21 + b, dyadic, b=b)
    for regime, kw in cs.CAT_REGIMES.items():
        card = [t.to(cuda_device) for t in cpu]
        sk = cs._cat_start(card)
        sc = (type(sk[0])(*(t.cpu() for t in sk[0])), sk[1].cpu())
        n0 = categorical_candidates.launches
        k = cs._cat_run(categorical_candidates, card, sk, kw)
        assert categorical_candidates.launches == n0 + 1
        pc = cs._cat_run(categorical_candidates_plain, cpu, sc, kw)
        assert cs._cat_same(k, pc), regime


def _wave_problem(dev, params, n=20_000, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 10)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * rng.randn(n) > 0).astype(float)
    p = dict({"objective": "binary", "num_leaves": 63, "max_bin": 63,
              "verbosity": -1, "min_data_in_leaf": 20}, **params)
    data = lt.Dataset(X, label=y, params=p).construct().constructed
    npad = data.num_data_padded
    g = torch.from_numpy(np.concatenate(
        [rng.randn(n), np.zeros(npad - n)]).astype(np.float32)).to(dev)
    h = torch.from_numpy(np.concatenate(
        [rng.rand(n) + 0.1, np.zeros(npad - n)]).astype(np.float32)).to(dev)
    bag = torch.from_numpy((np.arange(npad) < n).astype(np.float32)).to(dev)
    return lt.Config.from_params(p), data, g, h, bag


@pytest.mark.parametrize("params", [
    {}, {"tpu_wave_stall_batch": 1, "tpu_wave_width": 8},
    {"tpu_quantized_grad": "on", "tpu_wave_open_levels": 3}])
def test_graphed_tree_equals_eager_tree(cuda_device, params):
    """A learner's second tree replays every split pass as a CUDA graph
    (its first runs them eagerly and warms up); on the same gradients it
    equals a fresh learner's first tree, run eagerly, record for record,
    with the same kernel calls and wrapper launches."""
    from lightgbm_tpu_torch.learner_wave import WaveTreeLearner
    from lightgbm_tpu_torch.ops.hist_segments import build_histogram_segments
    from lightgbm_tpu_torch.ops.replay import replay_pass

    cfg, data, g, h, bag = _wave_problem(cuda_device, params)
    graphed = WaveTreeLearner(cfg, data, cuda_device)
    assert graphed.use_graphs
    graphed.grow(g, h, bag)
    out = {}
    for name, ln in (("graphed", graphed),
                     ("eager", WaveTreeLearner(cfg, data, cuda_device))):
        calls = dict(ln.kernel_calls)
        n0 = (build_histogram_segments.launches, replay_pass.launches)
        res = ln.grow(g * 0.5, h, bag)
        n1 = (build_histogram_segments.launches, replay_pass.launches)
        out[name] = (res, {k: v - calls[k]
                           for k, v in ln.kernel_calls.items()},
                     (n1[0] - n0[0], n1[1] - n0[1]), ln.tree_stats[-1])
    (ra, ca, la, sa), (rb, cb, lb, sb) = out["graphed"], out["eager"]
    assert np.array_equal(ra[0], rb[0]) and np.array_equal(ra[1], rb[1])
    assert torch.equal(ra[2], rb[2]) and torch.equal(ra[3], rb[3])
    assert int((ra[0][:, 0] > 0.5).sum()) > 30
    assert ca == cb and la == lb
    assert la == (ca["hist_segments"], ca["replay"]) and la[1] > 0
    assert sa["graph_launches"] == sa["passes"] > 0 and sb["graph_launches"] == 0
    assert sa["host_syncs"] == 1 and sa["stall_events"] == sb["stall_events"]


def test_passes_make_no_blocking_read(cuda_device):
    """One growth wave, one replay pass, one correction and the record
    emission, run eagerly, then a whole graphed tree, under
    ``set_sync_debug_mode("error")``: no operation blocks on the card.
    (Capturing a graph synchronizes once, so the learner captures in its
    second tree, before the window.)"""
    from lightgbm_tpu_torch.learner_wave import WaveTreeLearner

    cfg, data, g, h, bag = _wave_problem(cuda_device, {})
    ln = WaveTreeLearner(cfg, data, cuda_device)
    for _ in range(2):                           # builds, warms, captures
        ln.grow(g, h, bag)
    st = ln._init_root_wave(g, h, bag, ln._all_features)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ln._wave_pass(st, ln.W, False)
        st.par ^= 1
        ln._replay_pass(st)
        ln._correct_pass(st)
        ln._emit(st)
        tree = ln.train_async(g, h, bag)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rec_f, _ = ln.host_records(tree.records.cpu().numpy(), {})
    assert int((rec_f[:, 0] > 0.5).sum()) > 30
    assert tree.host_stats["graph_launches"] == tree.host_stats["passes"]


def test_pipelined_training_reads_only_at_the_flush(cuda_device):
    """Pipelined boosting on the card at chip_smoke.py's wave_pipelined
    size (1M x 28 rows, 255 leaves, 255 bins; no validation set): a
    boosting iteration makes no blocking read until trees are assembled,
    and the model equals the one a run with a flush every 16 iterations
    assembles."""
    rng = np.random.RandomState(6)
    X = rng.randn(1_000_000, 28)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
         "verbosity": -1, "metric": "none", "tpu_pipeline_flush_depth": 4}
    ds = lt.Dataset(X, label=y, params=p)
    bst = lt.Booster(p, ds)
    assert bst.gbdt._can_pipeline()
    for _ in range(2):       # an eager tree, then one that captures graphs
        bst.update()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            bst.update()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(bst.gbdt._pending) == 4 and bst.gbdt.pipeline_waits == 0
    for _ in range(2):
        bst.update()
    assert bst.gbdt.pipeline_waits == 2
    text = bst.model_to_string()
    assert bst.gbdt.pipeline_waits == 6
    b0 = lt.Booster(dict(p, tpu_pipeline_flush_depth=0), ds)
    for _ in range(6):
        b0.update()
    assert b0.model_to_string() == text


def test_masked_pipelined_training_on_card(cuda_device):
    """The masked learner (511 bins) without a validation set takes the
    pipelined loop on the card: no record read until the flush, a rolling
    flush (depth 2) giving the model text of a run that flushes at the end
    (depth 0), and the first tree the synchronous loop's."""
    from lightgbm_tpu_torch.learner import MaskedTreeLearner

    rng = np.random.RandomState(1)
    X = rng.randn(9000, 10)
    X[rng.rand(9000) < 0.1, 3] = np.nan
    y = (X[:, 0] + np.nan_to_num(X[:, 3]) + 0.5 * rng.randn(9000) > 0) \
        .astype(float)
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 511,
         "verbosity": -1, "metric": "none", "tpu_pipeline_flush_depth": 2}
    ds = lt.Dataset(X[:8192], label=y[:8192], params=p)
    bst = lt.Booster(p, ds)
    gbdt = bst.gbdt
    assert type(gbdt.learner) is MaskedTreeLearner and gbdt._can_pipeline()
    for _ in range(2):
        bst.update()
    assert gbdt.learner.host_syncs == 0 and gbdt.pipeline_waits == 0
    for _ in range(3):
        bst.update()
    assert gbdt.learner.host_syncs == 0 and gbdt.pipeline_waits == 3
    text = bst.model_to_string()
    assert gbdt.pipeline_waits == 5 and gbdt.learner.host_syncs == 0
    b0 = lt.Booster(dict(p, tpu_pipeline_flush_depth=0), ds)
    for _ in range(5):
        b0.update()
    assert b0.model_to_string() == text
    sync = lt.Booster(p, ds)
    sync.add_valid(ds.create_valid(X[8192:], label=y[8192:]), "heldout")
    assert not sync.gbdt._can_pipeline()
    sync.update()
    assert sync.gbdt.learner.host_syncs == 1
    assert sync.gbdt.models[0].to_string() == gbdt.models[0].to_string()
    assert all(t.num_leaves > 1 for t in gbdt.models)


@pytest.mark.parametrize("k", [1, 2, 128])
def test_scan_kernel_constrained_bitwise_to_cpu(cuda_device, k):
    """Monotone signs, per-leaf bounds and the penalty through the split
    scan kernel: every field bitwise equal to the plain version on the CPU,
    one kernel per call, counted as a constrained launch; a call without
    them takes the unconstrained kernel and equals the plain version
    too."""
    import chip_smoke as cs
    from lightgbm_tpu_torch.ops.scan import find_best_splits_batched
    from lightgbm_tpu_torch.ops.split import find_best_splits

    cpu = cs.scan_inputs(60 + k, False, k=k)
    dev = [t.to(cuda_device) for t in cpu]
    con_cpu = cs.scan_constraints(k, cpu[0].shape[1], k)
    con = [t.to(cuda_device) for t in con_cpu]
    kw = dict(cs.SCAN_KW)
    n0 = (find_best_splits_batched.launches,
          find_best_splits_batched.con_launches)
    got = find_best_splits_batched(*dev, *con[:3], penalty=con[3], **kw)
    free = find_best_splits_batched(*dev, **kw)
    assert (find_best_splits_batched.launches - n0[0],
            find_best_splits_batched.con_launches - n0[1]) == (2, 1)
    ref = find_best_splits(*cpu, *con_cpu[:3], penalty=con_cpu[3], **kw)
    ref_free = find_best_splits(*cpu, **kw)
    for fld in got._fields:
        assert cs.same(getattr(got, fld).cpu(), getattr(ref, fld)), fld
        assert cs.same(getattr(free, fld).cpu(), getattr(ref_free, fld)), fld
    assert not torch.equal(got.gain.cpu(), free.gain.cpu())
    n0 = find_best_splits_batched.con_launches
    ops = _device_ops(lambda: find_best_splits_batched(
        *dev, *con[:3], penalty=con[3], **kw))
    assert ops == ["kernel"], ops
    assert find_best_splits_batched.con_launches == n0 + 1


@pytest.mark.parametrize("dyadic", [True, False])
def test_split_cat_kernel_constrained_bitwise(cuda_device, dyadic):
    """Per-leaf bounds and the penalty through the categorical kernel at
    K = 128, B = 256: every field and bitset bitwise equal to the plain
    version on the CPU, the bounds binding."""
    import chip_smoke as cs
    from lightgbm_tpu_torch.ops.split_cat import (
        categorical_candidates, categorical_candidates_plain)

    cpu = cs.split_cat_inputs(70, dyadic)
    card = [t.to(cuda_device) for t in cpu]
    k, f = cpu[0].shape[:2]
    _, mn, mx, pen = (t.to(cuda_device)
                      for t in cs.scan_constraints(k, f, 3))
    con = (mn, mx, pen)
    sk = cs._cat_start(card)
    sc = (type(sk[0])(*(t.cpu() for t in sk[0])), sk[1].cpu())
    n0 = categorical_candidates.con_launches
    got = cs._cat_run(categorical_candidates, card, sk, {}, con)
    assert categorical_candidates.con_launches == n0 + 1
    ref = cs._cat_run(categorical_candidates_plain, cpu, sc, {},
                      tuple(t.cpu() for t in con))
    assert cs._cat_same(got, ref)
    free = cs._cat_run(categorical_candidates, card, sk, {})
    assert not cs._cat_same(got, free)


def test_constrained_wave_tree_on_card_equals_cpu(cuda_device):
    """One wave tree with monotone constraints and penalties from dyadic
    gradients (every float32 sum exact): the kernels on the card and the
    plain versions on the CPU grow the same records and leaf ids, the
    scans all constrained launches, no fused kernel."""
    from lightgbm_tpu_torch.learner_wave import WaveTreeLearner
    from lightgbm_tpu_torch.ops.scan import find_best_splits_batched

    params = {"monotone_constraints": "1,-1,0,1,0,0,-1,0,0,0",
              "feature_contri": "1,1,0.5,1,1,0.25,1,1,1,1"}
    cfg, data, g, h, bag = _wave_problem(cuda_device, params)
    g = torch.round(g * 16) / 16
    h = torch.round(h * 16) / 16 * (bag > 0)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        n0 = find_best_splits_batched.con_launches
        ln = WaveTreeLearner(cfg, data, dev)
        rec = ln.grow(g.to(dev), h.to(dev), bag.to(dev))
        out[dev.type] = (rec, ln, find_best_splits_batched.con_launches - n0)
    (rc, lc, nc), (rp, lp, _) = out["cuda"], out["cpu"]
    assert np.array_equal(rc[0], rp[0]) and np.array_equal(rc[1], rp[1])
    assert torch.equal(rc[2].cpu(), rp[2])
    assert int((rc[0][:, 0] > 0.5).sum()) > 30
    assert lc.has_monotone and lc.has_penalty and not lc._use_fused
    assert nc == lc.kernel_calls["split_scan"] > 0
    assert lc.tree_stats[-1]["host_syncs"] == 1


def _goss_inputs(kind, k, n=1_000_448, seed=0):
    """(K, N) gradients and hessians, the valid-row mask, uniform draws:
    ``tied`` draws its magnitudes from four values, so ties straddle the
    top-k cut."""
    rng = np.random.RandomState(seed)
    if kind == "tied":
        g = rng.choice([-1.0, -0.5, 0.5, 1.0], (k, n)).astype(np.float32)
        h = np.full((k, n), 0.25, np.float32)
    else:
        g = rng.randn(k, n).astype(np.float32)
        h = (rng.rand(k, n) + 0.1).astype(np.float32)
    valid = np.zeros(n, np.float32)
    valid[:n - 448] = 1.0
    u = rng.rand(n).astype(np.float32)
    return [torch.from_numpy(a) for a in (g, h, valid, u)]


@pytest.mark.parametrize("kind,k", [("random", 1), ("tied", 1),
                                    ("tied", 3)])
def test_goss_selection_on_card_bitwise_to_cpu(cuda_device, kind, k):
    """GOSS's selection on the card (a stable device sort, no host read)
    against the CPU on the same draws: the same bag, the amplification
    bitwise."""
    from lightgbm_tpu_torch.boosting.goss import goss_select

    args = _goss_inputs(kind, k)
    n = args[2].shape[0] - 448
    top_k, other_k = int(n * 0.2), int(n * 0.1)
    cpu = goss_select(*args, top_k, other_k)
    card = goss_select(*(a.to(cuda_device) for a in args), top_k, other_k)
    assert card[0].is_cuda
    assert torch.equal(card[0].cpu(), cpu[0])
    assert torch.equal(card[1].cpu(), cpu[1])
    assert int(cpu[0].sum()) > top_k


def _bin_check(arrs, a, x, xs):
    """The kernel's codes of the card matrix ``x`` (host copy ``xs``):
    bitwise equal to the plain version on the card and to ``bin_host``,
    one launch counted, one kernel node per call."""
    from lightgbm_tpu_torch.binner import bin_plain, bin_predict

    n0 = bin_predict.launches
    got = bin_predict(x, a)
    assert bin_predict.launches == n0 + 1
    assert torch.equal(got, bin_plain(x, a))
    assert torch.equal(got.cpu(), torch.from_numpy(arrs.bin_host(xs)))
    assert _device_ops(lambda: bin_predict(x, a)) == ["kernel"]
    return got


@pytest.mark.parametrize("tag,max_bin", [
    ("higgs_255", 255), ("expo_categorical", 255), ("higgs_1023", 1023),
    ("global_bounds_10000", 10000), ("higgs_11m", 255), ("ms_ltr_137", 255)])
def test_bin_predict_kernel_bitwise_to_plain(cuda_device, tag, max_bin):
    """The predict binner at chip_smoke.py's shapes (100,000 rows, and
    11,000,000 for the whole Higgs set; NaN, +-inf, -0.0, every bound and
    its ulp neighbours; unseen, negative and fractional categories; a
    bounds row searched in global memory; two feature groups at 137
    features): the kernel bitwise equal to the plain version on the card
    and to ``bin_host``, one kernel per call, and the predictor's path
    through it; then 1 row, 37 rows and a tile and one row."""
    import chip_smoke as cs
    from lightgbm_tpu_torch.binner import BinnerArrays, bin_plain, plan_for
    from lightgbm_tpu_torch.dataset import upload

    data, Xp, _ = cs.bin_predict_case(tag, max_bin)
    arrs = BinnerArrays.for_data(data)
    a = arrs.device_arrays(cuda_device)
    x = upload(Xp, cuda_device)
    _bin_check(arrs, a, x, Xp)
    if tag == "ms_ltr_137":
        assert plan_for(x, a).groups == 2
    if tag == "global_bounds_10000":
        assert not plan_for(x, a).staged
    # a few rows: one partial tile, and a matrix passed as numpy
    assert torch.equal(arrs.bin_device(Xp[:37], cuda_device),
                       bin_plain(x[:37].contiguous(), a))
    tile = plan_for(x, a).tile_rows
    for n in (1, tile + 1):
        _bin_check(arrs, a, x[:n].contiguous(), Xp[:n])


def test_bin_predict_reads_a_wider_matrix(cuda_device):
    """A matrix with more columns than the model reads, the unused columns
    between the used ones: 28 of 41 columns (whole rows read; 400,001
    rows, so the last tile is one row of 41 doubles, whose odd last double
    the bulk copy cannot take), and 4 of 201 (the used columns read
    strided); each also from row 1 (8 bytes past a 16-byte boundary: read
    strided) and, for 41 columns, from row 2 (aligned: whole rows again,
    an odd last tile of 127 rows)."""
    from lightgbm_tpu_torch.binner import BinnerArrays, plan_for
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.dataset import _ConstructedDataset, upload

    rng = np.random.RandomState(21)
    # whole rows need four row tiles a block (binner.py:ROW_TILES)
    for ldx, used, n, want_rows in (
            (41, [c for c in range(41) if c % 10 not in (3, 7, 9)][:28],
             400_001, True),
            (201, [3, 53, 103, 153], 50_001, False)):
        train = np.zeros((5000, ldx))
        train[:, used] = rng.randn(5000, len(used))
        train[::13, used[1]] = np.nan
        data = _ConstructedDataset.from_matrix(
            train, Config.from_params({"max_bin": 255, "verbosity": -1,
                                       "enable_bundle": False}))
        assert list(data.used_feature_map) == used
        arrs = BinnerArrays.for_data(data)
        a = arrs.device_arrays(cuda_device)
        Xp = rng.randn(n, ldx) * 3.0
        Xp[::17, used[0]] = np.nan
        Xp[::19, used[2]] = np.inf
        x = upload(Xp, cuda_device)
        p = plan_for(x, a)
        assert p.rows == want_rows
        _bin_check(arrs, a, x, Xp)
        assert x[1:].data_ptr() % 16 == 8 and not plan_for(x[1:], a).rows
        _bin_check(arrs, a, x[1:], Xp[1:])
        if want_rows:
            assert x[2:].data_ptr() % 16 == 0 and plan_for(x[2:], a).rows
            _bin_check(arrs, a, x[2:], Xp[2:])


def test_bin_predict_categorical_mix_at_137_features(cuda_device):
    """MS LTR's width with every tenth feature categorical (two feature
    groups, category tables probed beside searched rows), also from an odd
    row offset of the 137-column matrix (8 bytes past a 16-byte boundary),
    at 1 row and a tile and one row."""
    import chip_smoke as cs
    from lightgbm_tpu_torch.binner import BinnerArrays, plan_for
    from lightgbm_tpu_torch.dataset import upload

    data, Xp, _ = cs.bin_predict_case("ms_ltr_137_cat", 255)
    arrs = BinnerArrays.for_data(data)
    assert arrs.is_cat.sum() == 14
    a = arrs.device_arrays(cuda_device)
    x = upload(Xp, cuda_device)
    assert plan_for(x, a).groups == 2
    _bin_check(arrs, a, x, Xp)
    assert x[1:].data_ptr() % 16 == 8
    _bin_check(arrs, a, x[1:], Xp[1:])
    tile = plan_for(x, a).tile_rows
    for n in (1, tile + 1):
        _bin_check(arrs, a, x[:n].contiguous(), Xp[:n])


def test_bin_predict_wrapper_rejects_what_the_kernel_does_not_take(
        cuda_device):
    import chip_smoke as cs
    from lightgbm_tpu_torch.binner import BinnerArrays, bin_predict

    data, Xp, _ = cs.bin_predict_case("expo_categorical", 255, rows=1000)
    a = BinnerArrays.for_data(data).device_arrays(cuda_device)
    x = torch.from_numpy(Xp).to(cuda_device)
    with pytest.raises(ValueError, match="float64"):
        bin_predict(x.float(), a)
    with pytest.raises(ValueError, match="columns"):
        bin_predict(x[:, :3].contiguous(), a)
    with pytest.raises(ValueError, match="one CUDA device"):
        bin_predict(x.cpu(), a)


# -- the prediction server's device path (serving/registry.py) ---------------

SERVE_BUCKETS = [32, 64, 128, 256, 512, 1024]
_SERVE = {}


def _serve_rows(rng, n):
    """Rows of a 5-feature problem whose column 1 is categorical, with NaN,
    unseen, negative and fractional categories and +-inf."""
    X = np.column_stack([rng.randn(n), rng.randint(-3, 25, n).astype(float),
                         rng.randn(n) * 10, rng.randn(n),
                         np.where(rng.rand(n) < 0.4, 0.0, rng.randn(n))])
    X[::11, 0] = np.nan
    X[::5, 1] = np.nan
    X[3, 1] = 7.9
    X[7, 2], X[9, 3] = np.inf, -np.inf
    return X


def _served(dev):
    """A booster trained on the card (8 trees, 31 leaves) and a registry
    holding it warmed over the 32 to 1,024-row ladder."""
    from lightgbm_tpu_torch.serving import ModelRegistry

    if "reg" not in _SERVE:
        rng = np.random.RandomState(5)
        X = _serve_rows(rng, 5000)
        X[X[:, 1] < 0, 1] = 0.0
        X[X[:, 1] > 11, 1] = 11.0
        y = (np.nan_to_num(X[:, 0]) + (X[:, 1] % 3 == 1) > 0.5).astype(float)
        bst = lt.train({"objective": "binary", "num_leaves": 31,
                        "verbosity": -1, "min_data_in_leaf": 5},
                       lt.Dataset(X, label=y, categorical_feature=[1]), 8,
                       verbose_eval=False)
        assert bst.gbdt.device == dev
        reg = ModelRegistry(warm_buckets=SERVE_BUCKETS)
        reg.load(booster=bst)
        _SERVE.update(bst=bst, reg=reg, X=_serve_rows(rng, 1024))
    return _SERVE["bst"], _SERVE["reg"], _SERVE["X"]


@pytest.mark.parametrize("bucket", SERVE_BUCKETS)
def test_serving_graph_replay_bitwise_to_eager(cuda_device, bucket):
    """A bucket's graph replay equals bin_predict + the traversal run
    eagerly on the card, and bin_plain + the traversal, bit for bit; one
    bin_predict launch credited per replay; the host trees within 1e-9."""
    from lightgbm_tpu_torch.binner import bin_plain, bin_predict

    bst, reg, X = _served(cuda_device)
    model = reg.get()
    assert model.jit_entries() == len(SERVE_BUCKETS)
    Xpad = np.ascontiguousarray(X[:bucket])
    launches, replays = bin_predict.launches, model.replays
    got = model.predict_padded(Xpad, bucket)
    assert bin_predict.launches == launches + 1
    assert model.replays == replays + 1 and model.eager_batches == 0
    x = torch.from_numpy(Xpad).to(cuda_device)
    eager = model.predictor.predict_binned(bin_predict(x, model.dev_arrays))
    plain = model.predictor.predict_binned(bin_plain(x, model.dev_arrays))
    assert np.array_equal(got, eager[0].cpu().numpy())
    assert np.array_equal(got, plain[0].cpu().numpy())
    np.testing.assert_allclose(got, model.host_raw(Xpad), rtol=1e-9,
                               atol=1e-9)
    m = bucket // 2 + 1
    assert np.array_equal(model.predict_padded(Xpad, m), got[:m])


def test_serving_requests_capture_no_graph_after_warmup(cuda_device):
    """20 requests of mixed sizes inside the ladder through a live server:
    the graph count and the compile-cache misses stay as warmup left them,
    every batch a replay (none eager, none on the host)."""
    from lightgbm_tpu_torch.serving import ServingClient

    bst, _, X = _served(cuda_device)
    server = bst.serve(port=0, max_batch_rows=1024, min_bucket=32,
                       deadline_ms=1.0)
    try:
        model = server.registry.get()
        before = (server.registry.jit_entries(), model.replays)
        with ServingClient(server.host, server.port) as c:
            rng = np.random.RandomState(0)
            for n in rng.randint(1, 1025, 20):
                got = c.predict(X[:n], raw_score=True)
                np.testing.assert_allclose(got, model.host_raw(X[:n]),
                                           rtol=1e-9, atol=1e-9)
            srv = c.stats()["serving"]
    finally:
        server.stop()
    assert before == (len(SERVE_BUCKETS), len(SERVE_BUCKETS) + 1)
    assert server.registry.jit_entries() == len(SERVE_BUCKETS)
    assert srv["compile_cache"]["misses"] == len(SERVE_BUCKETS)
    assert srv["fallback_batches"] == 0 and srv["errors"] == 0
    assert model.eager_batches == 0
    assert model.replays - before[1] == srv["batches"] >= 1


def test_serving_failed_bin_predict_build_refuses_the_swap(cuda_device,
                                                           monkeypatch):
    """A bin_predict library that cannot be built at prepare raises there:
    the live version keeps serving and nothing was swapped."""
    from lightgbm_tpu_torch import binner, native
    from lightgbm_tpu_torch.serving import ModelRegistry

    bst, _, X = _served(cuda_device)
    reg = ModelRegistry(warm_buckets=[32, 64])
    reg.load(booster=bst)
    live = reg.get()

    def refuse(names):
        raise RuntimeError("nvcc refused bin_predict.cu (forced)")

    monkeypatch.setattr(binner, "_LIB", None)
    monkeypatch.delitem(native._LOADED, "bin_predict")
    monkeypatch.setattr(native, "build_all", refuse)
    with pytest.raises(RuntimeError, match="forced"):
        reg.load(model_str=bst.model_to_string())
    assert reg.get() is live and reg.versions() == {"default": 1}
    monkeypatch.undo()
    Xpad = np.ascontiguousarray(X[:32])
    np.testing.assert_allclose(live.predict_padded(Xpad, 32),
                               live.host_raw(Xpad), rtol=1e-9, atol=1e-9)


def test_serving_device_error_fails_the_batch_and_health(cuda_device,
                                                         monkeypatch):
    """A real device error of a CUDA model fails the batch's requests, is
    not re-scored on the host and makes ``health`` not ready; the injected
    ``serve.predict.fail`` still degrades to the host, counted."""
    from lightgbm_tpu_torch.reliability import faults
    from lightgbm_tpu_torch.serving import ServingClient, registry

    bst, _, X = _served(cuda_device)
    server = bst.serve(port=0, max_batch_rows=64, min_bucket=32,
                       warmup=False)
    try:
        model = server.registry.get()
        with ServingClient(server.host, server.port, retries=0) as c:
            faults.arm("serve.predict.fail:count=1")
            np.testing.assert_allclose(
                c.predict(X[:16], raw_score=True), model.host_raw(X[:16]),
                rtol=1e-9, atol=1e-9)
            faults.disarm()
            assert c.health()["ready"]

            def launch_fails(x, a):
                raise RuntimeError("bin_predict kernel launch failed: "
                                   "CUDA error 700 (forced)")

            monkeypatch.setattr(registry, "bin_predict", launch_fails)
            with pytest.raises(RuntimeError, match="forced"):
                c.predict(X[:16], raw_score=True)
            health = c.health()
            srv = c.stats()["serving"]
    finally:
        faults.disarm()
        server.stop()
    assert not health["ready"]
    assert "forced" in health["device_errors"]["default"]
    assert srv["fallback_batches"] == 1 and srv["fallback_rows"] == 16
    assert srv["errors"] >= 1


# -- the serving fleet (serving/fleet/) ---------------------------------------

def _fleet_on_card(dev, **kw):
    """The served booster behind a two-replica fleet on the one card (both
    replicas on ``cuda:0``, each with its own stream and bucket graphs)."""
    bst, _, X = _served(dev)
    srv = bst.serve(replicas=2, port=0, max_batch_rows=1024, min_bucket=32,
                    deadline_ms=1.0, **kw)
    return bst, srv, X


def test_fleet_two_replicas_on_one_card_answer_the_host_trees(cuda_device):
    """Two replicas on cuda:0 warm one graph per bucket each and run
    nothing eagerly; requests sent to each replica replay its graphs and
    answer the host trees within 1e-9."""
    from lightgbm_tpu_torch.serving import ServingClient

    bst, srv, X = _fleet_on_card(cuda_device)
    try:
        models = [r.registry.get() for r in srv.replicas.replicas]
        assert [r.device for r in srv.replicas.replicas] == [cuda_device] * 2
        assert models[0] is not models[1]
        for m in models:
            assert m.device == cuda_device and m.cuda
            assert m.jit_entries() == len(SERVE_BUCKETS)
            assert m.replays == len(SERVE_BUCKETS) + 1
        r0 = srv.replicas.replicas[0]
        X2 = np.vstack([X, X])
        with ServingClient(srv.host, srv.port) as c:
            for busy in (False, True):
                with r0._lock:
                    r0._inflight = 1000 if busy else 0  # steer to replica 1
                for n in (1, 37, 1024, 1500):      # 1,500: two batches
                    np.testing.assert_allclose(
                        c.predict(X2[:n], raw_score=True),
                        models[0].host_raw(X2[:n]), rtol=1e-9, atol=1e-9)
            with r0._lock:
                r0._inflight = 0
            srv_stats = c.stats()["serving"]
        for m in models:
            assert m.replays > len(SERVE_BUCKETS) + 1
            assert m.eager_batches == 0
        assert srv_stats["fallback_batches"] == 0
        assert srv_stats["errors"] == 0
    finally:
        srv.stop()


@pytest.mark.parametrize("spare_models", [0, 40])
def test_fleet_prepare_all_captures_while_a_replica_replays(cuda_device,
                                                             spare_models):
    """``prepare_all``, called from a thread of its own as a wire ``swap``
    is, captures a candidate's bucket graphs on both replicas while requests
    keep replaying replica 1's live graphs from another thread; every answer
    is the host trees of the version that served it, and after the rolling
    commit both replicas serve the candidate.  With 40 more serving models
    built first, PyTorch's pool of 32 default-priority streams per card has
    wrapped, and still no serving model's stream is the capture stream."""
    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.serving.registry import ServingModel

    bst, srv, X = _fleet_on_card(cuda_device)
    r0, r1 = srv.replicas.replicas
    spare = [ServingModel(bst, device=cuda_device)
             for _ in range(spare_models)]
    serving = {m._stream.cuda_stream for m in
               spare + [r0.registry.get(), r1.registry.get()]}
    assert native.capture_stream(cuda_device).cuda_stream not in serving
    cand = lt.train({"objective": "binary", "num_leaves": 15,
                     "verbosity": -1},
                    lt.Dataset(np.nan_to_num(X[:, :5]),
                               label=(X[:, 0] > 0).astype(float)), 3,
                    verbose_eval=False)
    stop, errors, answers = threading.Event(), [], []
    started = threading.Event()

    def traffic():
        rng = np.random.RandomState(1)
        while not stop.is_set():
            n = int(rng.randint(1, 1025))
            done = threading.Event()
            out = {}

            def cb(h, out=out, done=done):
                out["r"], out["e"] = h.result, h.error
                done.set()
            r1.submit_async(X[:n], "default", cb)
            if not done.wait(60):
                errors.append("timeout")
                return
            if out["e"] is not None:
                errors.append(repr(out["e"]))
                return
            answers.append((n, out["r"]))
            started.set()

    t = threading.Thread(target=traffic)
    try:
        live = r1.registry.get()
        t.start()
        assert started.wait(60)
        before = live.replays
        swap = {}
        th = threading.Thread(target=lambda: swap.update(
            prepared=srv.replicas.prepare_all(
                model_str=cand.model_to_string())))
        th.start()
        th.join(300)
        assert not th.is_alive()
        prepared = swap["prepared"]
        during = live.replays - before
        stop.set()
        t.join(60)
        assert not t.is_alive() and errors == []
        assert during > 0, "no replay ran while the candidate captured"
        for p in prepared:
            assert p.jit_entries() == len(SERVE_BUCKETS)
        for n, got in answers:
            np.testing.assert_allclose(got, live.host_raw(X[:n]),
                                       rtol=1e-9, atol=1e-9)
        assert srv.replicas.commit_rolling(prepared) == {0: 2, 1: 2}
        for r in (r0, r1):
            m = r.registry.get()
            Xpad = np.ascontiguousarray(X[:64])
            np.testing.assert_allclose(m.predict_padded(Xpad, 64),
                                       m.host_raw(Xpad), rtol=1e-9,
                                       atol=1e-9)
    finally:
        stop.set()
        t.join(60)
        srv.stop()


def test_fleet_device_error_ejects_and_fails_the_batch(cuda_device,
                                                       monkeypatch):
    """A real device error on a replica fails its batch (no host re-score),
    ejects the replica and makes ``health`` name it, not ready; the injected
    ``serving.replica_fault`` re-scores on the host instead."""
    from lightgbm_tpu_torch.reliability import faults
    from lightgbm_tpu_torch.serving import ServingClient

    bst, srv, X = _fleet_on_card(cuda_device, recovery_s=3600.0)
    try:
        r0, r1 = srv.replicas.replicas
        with ServingClient(srv.host, srv.port, retries=0) as c:
            faults.arm("serving.replica_fault:rank=0:count=1")
            np.testing.assert_allclose(
                c.predict(X[:16], raw_score=True),
                r0.registry.get().host_raw(X[:16]), rtol=1e-9, atol=1e-9)
            faults.disarm()
            assert srv.replicas.section()[0]["ejections"] == 1
            assert c.health()["ready"]
            model = r1.registry.get()

            def launch_fails(Xpad, m):
                raise RuntimeError("CUDA error 700 (forced)")

            monkeypatch.setattr(model, "predict_padded", launch_fails)
            with pytest.raises(RuntimeError, match="forced"):
                c.predict(X[:16], raw_score=True)
            health = c.health()
        snap = srv.replicas.section()
        assert snap[1]["ejections"] == 1 and snap[1]["device_failures"] == 1
        assert not health["ready"]
        assert "forced" in health["device_errors"]["1"]["default"]
        assert "restart" in health["device_errors_note"]
        assert srv.stats.fallback_batches == 1
    finally:
        faults.reset()
        srv.stop()


def test_two_rank_data_parallel_tree_on_card(cuda_device):
    """Two gloo ranks share the card (NCCL refuses two ranks on one
    device), their collectives staged through the host: one data-parallel
    wave tree from dyadic gradients (sums exact in any order), its records
    and counts on both ranks bitwise the serial wave learner's on the
    card, every wave kernel launched on both ranks."""
    import os
    import sys

    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.learner_wave import WaveTreeLearner
    from lightgbm_tpu_torch.parallel.launch import RankPool
    sys.path.insert(0, os.path.dirname(__file__))
    import _torch_parallel_tasks as tasks

    rng = np.random.RandomState(8)
    n, f = 8192, 12
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(n) > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
              "min_data_in_leaf": 20, "enable_bundle": False}
    data = tasks._dataset(params, X, y)
    n_pad = data.num_data_padded
    g = (rng.randint(-16, 17, n_pad) / 16.0).astype(np.float32)
    h = (rng.randint(1, 17, n_pad) / 16.0).astype(np.float32)
    b = np.zeros(n_pad, np.float32)
    b[:n] = rng.rand(n) < 0.9
    serial = WaveTreeLearner(Config.from_params(params), data, cuda_device)
    rf, ri, lid, _ = serial.grow(*(torch.from_numpy(a).to(cuda_device)
                                   for a in (g, h, b)))
    with RankPool(2, "gloo") as pool:
        outs = pool.run(tasks.learner_records, "ShardedWaveLearner", params,
                        X, y, g, h, b, (2,), None, "cuda")
    for o in outs:
        assert o["device"].startswith("cuda")
        np.testing.assert_array_equal(o["rec_f"], rf)
        np.testing.assert_array_equal(o["rec_i"], ri)
        np.testing.assert_array_equal(o["leaf_id"], lid.cpu().numpy())
        assert all(v > 0 for v in o["launches"].values()), o["launches"]


def test_two_ranks_on_one_card_choose_gloo(cuda_device):
    """The backend is the world's choice from every rank's card UUID
    (``sharding.default_backend``): two ranks on the one card share a UUID,
    so a pool that leaves the backend open takes gloo (NCCL refuses two
    ranks on one device); one rank with a card of its own would take
    NCCL."""
    import os
    import sys

    from lightgbm_tpu_torch.parallel.launch import RankPool
    from lightgbm_tpu_torch.parallel.sharding import card_id, default_backend
    sys.path.insert(0, os.path.dirname(__file__))
    import _torch_parallel_tasks as tasks

    uuid = card_id(cuda_device)
    assert uuid and default_backend([uuid]) == "nccl"
    assert default_backend([uuid, uuid]) == "gloo"
    if torch.cuda.device_count() > 1:
        pytest.skip("two ranks get two cards here")
    with RankPool(2) as pool:
        assert pool.backend == "gloo"
        assert [r[2] for r in pool.run(tasks.rank_info)] == ["gloo", "gloo"]
