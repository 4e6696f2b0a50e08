"""Port compact learner vs lightgbm_tpu's CompactTPUTreeLearner.

One tree from the same numpy gradients, hessians and bag mask through both
packages.  With ``gpu_use_dp`` both accumulate float64 sums of the same
float32 weights, which are exact here in any order, so the per-split records
and the leaf partition must be EXACTLY equal.  In float32 the histogram sums
run in other orders (XLA's one-hot contraction vs ``index_add_``), so the
structure must match and leaf values agree within 1e-5.  The windows cover
both partition modes: physically compacted (bucket above
``tpu_sort_cutoff``) and frozen mask mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.learner_compact import CompactTPUTreeLearner
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.learner import (
    REC_GAIN, REC_INTERNAL_CNT, REC_INTERNAL_VALUE, REC_LEFT_CNT,
    REC_LEFT_OUT, REC_LEFT_SUM_G, REC_LEFT_SUM_H, REC_RIGHT_CNT,
    REC_RIGHT_OUT, REC_RIGHT_SUM_G, REC_RIGHT_SUM_H)
from lightgbm_tpu_torch.learner_compact import CompactTreeLearner
from lightgbm_tpu_torch.ops.hist_packed import build_histogram_packed_plain

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _problem(seed, efb=False, n=4000, f=12):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.1, 2] = np.nan
    X[rng.rand(n) < 0.6, 3] = 0.0
    if efb:
        # mutually exclusive sparse columns 6..11 bundle under EFB
        X[:, 6:] = 0.0
        owner = rng.randint(6, f, n)
        active = rng.rand(n) < 0.6
        X[np.arange(n)[active], owner[active]] = rng.rand(active.sum()) + 0.5
    y = (X[:, 0] * 1.5 + np.nan_to_num(X[:, 2]) - X[:, 6]
         + 0.5 * rng.randn(n) > 0).astype(np.float32)
    return X.astype(np.float32), y


def _grads(seed, y, n_pad):
    """Binary-logloss-like gradients with noise, a 90% bag; zero padding.
    They lie on a 2**-20 grid, so float64 sums of them are exact in any
    order: the dp comparison then sees no summation-order rounding (with
    arbitrary float32 values the two packages' float64 sums can differ in
    the last bit, which decides near-ties such as the missing-direction
    choice of a leaf that holds no missing rows)."""
    rng = np.random.RandomState(seed + 100)
    n = len(y)
    grad = np.zeros(n_pad, np.float32)
    hess = np.zeros(n_pad, np.float32)
    bag = np.zeros(n_pad, np.float32)
    p = 1.0 / (1.0 + np.exp(-rng.randn(n)))
    grid = 2.0 ** 20
    grad[:n] = np.round((p - y) * grid) / grid
    hess[:n] = np.round(np.maximum(p * (1.0 - p), 1e-3) * grid) / grid
    bag[:n] = rng.rand(n) < 0.9
    return grad, hess, bag


def _both(params, efb=False, seed=0):
    X, y = _problem(seed, efb)
    dj = lj.Dataset(X, label=y, params=params).construct().constructed
    dt = lt.Dataset(X, label=y, params=dict(params, device_type="cpu")) \
        .construct().constructed
    assert (dj.bundle is not None) == efb == (dt.bundle is not None)
    g, h, b = _grads(seed, y, dj.num_data_padded)
    rj = CompactTPUTreeLearner(JConfig.from_params(params), dj).train_async(
        jnp.asarray(g), jnp.asarray(h), jnp.asarray(b))
    learner = CompactTreeLearner(TConfig.from_params(params), dt, CPU)
    rt = learner.grow(torch.from_numpy(g), torch.from_numpy(h),
                      torch.from_numpy(b))
    return rj, rt, learner


BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "min_data_in_leaf": 10, "tpu_min_window": 1024, "verbosity": -1}


@pytest.mark.parametrize("extra", [
    {"tpu_sort_cutoff": 0},             # every window compacted
    {"tpu_sort_cutoff": 2048},          # both partition modes
    {"tpu_sort_cutoff": 1 << 20},       # every window frozen (mask mode)
    {"max_depth": 4, "lambda_l1": 0.1, "lambda_l2": 1.0,
     "max_delta_step": 0.5, "min_gain_to_split": 0.01,
     "min_sum_hessian_in_leaf": 0.5},
])
def test_dp_records_exactly_equal(extra):
    params = dict(BASE, gpu_use_dp=True, **extra)
    (rec_f, rec_i, _, leaf_j, _), (rf, ri, leaf_t, _), learner = \
        _both(params)
    splits = int((rf[:, 0] > 0.5).sum())
    assert splits >= 10
    np.testing.assert_array_equal(rf, np.asarray(rec_f))
    np.testing.assert_array_equal(ri, np.asarray(rec_i))
    np.testing.assert_array_equal(leaf_t.numpy(), np.asarray(leaf_j))
    # the device step: one host read per tree, the records
    assert learner.host_syncs == 1


def test_dp_records_exactly_equal_with_efb_bundles():
    params = dict(BASE, gpu_use_dp=True)
    (rec_f, rec_i, _, leaf_j, _), (rf, ri, leaf_t, _), _ = \
        _both(params, efb=True, seed=3)
    np.testing.assert_array_equal(rf, np.asarray(rec_f))
    np.testing.assert_array_equal(ri, np.asarray(rec_i))
    np.testing.assert_array_equal(leaf_t.numpy(), np.asarray(leaf_j))


def test_f32_structure_equal_values_close():
    (rec_f, rec_i, _, leaf_j, _), (rf, ri, leaf_t, _), _ = \
        _both(dict(BASE), seed=1)
    rec_f = np.asarray(rec_f)
    # valid / leaf / feature / threshold / default_left, exact counts
    np.testing.assert_array_equal(rf[:, :5], rec_f[:, :5])
    np.testing.assert_array_equal(ri, np.asarray(rec_i))
    np.testing.assert_array_equal(leaf_t.numpy(), np.asarray(leaf_j))
    # float32 histograms summed in another order: leaf values within 1e-5,
    # gains and child sums within 1e-5 of their scale, counts exact
    out = [REC_LEFT_OUT, REC_RIGHT_OUT, REC_INTERNAL_VALUE]
    np.testing.assert_allclose(rf[:, out], rec_f[:, out], rtol=0, atol=1e-5)
    cnt = [REC_LEFT_CNT, REC_RIGHT_CNT, REC_INTERNAL_CNT]
    np.testing.assert_array_equal(rf[:, cnt], rec_f[:, cnt])
    for col in (REC_GAIN, REC_LEFT_SUM_G, REC_RIGHT_SUM_G, REC_LEFT_SUM_H,
                REC_RIGHT_SUM_H):
        np.testing.assert_allclose(
            rf[:, col], rec_f[:, col], rtol=1e-5,
            atol=1e-5 * np.abs(rec_f[:, col]).max())


def test_vectorized_assembly_equals_replay():
    params = dict(BASE, gpu_use_dp=True)
    _, (rf, ri, _, _), learner = _both(params, seed=2)
    a = learner._assemble_vec(rf, ri).to_string()
    b = learner._assemble(rf, ri).to_string()
    assert a == b and a.startswith("num_leaves=15")


def test_histogram_argument_grows_the_same_tree():
    """The ``kernels`` argument (every plain version here) grows the tree
    the default wrappers grow; on CPU tensors both run the plain versions,
    on the card the default launches the kernels."""
    from lightgbm_tpu_torch.learner_compact import PLAIN_COMPACT, CompactKernels

    X, y = _problem(4)
    params = dict(BASE, device_type="cpu")
    dt = lt.Dataset(X, label=y, params=params).construct().constructed
    g, h, b = (torch.from_numpy(a) for a in _grads(4, y, dt.num_data_padded))
    cfg = TConfig.from_params(params)
    r1 = CompactTreeLearner(cfg, dt, CPU).grow(g, h, b)
    for kernels in (PLAIN_COMPACT,
                    CompactKernels(packed=build_histogram_packed_plain)):
        r2 = CompactTreeLearner(cfg, dt, CPU, kernels=kernels).grow(g, h, b)
        np.testing.assert_array_equal(r1[0], r2[0])
        assert torch.equal(r1[2], r2[2])


def test_pipelined_compact_model_text_equals_jax():
    """The compact learner's ``train_async``: without a validation set both
    packages pipeline it (the pipelined rule: trees grown with no host
    read, the score updated on the device, host trees built behind), and
    in dp the model text is equal."""
    X, y = _problem(5)
    yr = (y + X[:, 0]).astype(np.float32)
    params = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
              "learning_rate": 0.3, "min_data_in_leaf": 20, "verbosity": -1,
              "metric": "none", "gpu_use_dp": True, "tpu_learner": "compact"}
    bj = lj.train(params, lj.Dataset(X, label=yr, params=params), 5,
                  verbose_eval=False)
    pt = dict(params, device_type="cpu")
    bt = lt.train(pt, lt.Dataset(X, label=yr, params=pt), 5,
                  verbose_eval=False)
    assert type(bt.gbdt.learner) is CompactTreeLearner
    assert bt.gbdt._can_pipeline() and bt.gbdt.learner.host_syncs == 0
    assert bt.model_to_string() == bj.model_to_string()
    assert bt.gbdt.pipeline_waits == 5
    assert [s["total_splits"] for s in bt.gbdt.learner.tree_stats] \
        == [t.num_leaves - 1 for t in bt.gbdt.models]


def _slice_reference(bins, w, rid, lid, split, tab, bits):
    """The window split as slice code over numpy arrays: the decision, then
    a stable sort by side (sort mode) or the leaf-id rewrite (mask
    mode)."""
    leaf, new, _, thr, flags, do, s, c = split
    word = bins[tab[0], s:s + c].astype(np.int64)
    code = (word >> tab[1]) & 0xFF
    if tab[6]:
        r = code - tab[5]
        code = np.where((r >= 0) & (r < tab[4] - 1), r + (r >= tab[3]),
                        tab[3])
    if flags & 2:
        go = ((bits.astype(np.int64)[np.minimum(code >> 5, len(bits) - 1)]
               >> (code & 31)) & 1) == 1
    else:
        miss = ((tab[2] == 1) & (code == tab[3])) \
            | ((tab[2] == 2) & (code == tab[4] - 1))
        go = np.where(miss, bool(flags & 1), code <= thr)
    return go


@pytest.mark.parametrize("mask_max", [0, 1 << 20])
@pytest.mark.parametrize("feat,thr,flags", [(0, 99, 1), (1, 12, 0),
                                            (2, 0, 2)])
def test_plain_window_partition_equals_slice_code(mask_max, feat, thr,
                                                  flags):
    """``partition_window_plain`` (the learner's window split on a CPU
    tensor) against slice code over numpy on dyadic lanes: a NaN-typed
    numerical, a bundled (EFB) and a categorical feature, sort mode
    (``mask_max`` 0) and mask mode; rows outside the window untouched; a
    ``do = 0`` split a no-op."""
    from lightgbm_tpu_torch.ops.partition import partition_window_plain

    rng = np.random.RandomState(feat * 7 + mask_max % 5)
    n = 6000
    bins = rng.randint(-2**31, 2**31 - 1, (3, n)).astype(np.int32)
    w = np.stack([rng.randint(-64, 65, n) / 64.0, rng.randint(0, 65, n)
                  / 64.0, rng.rand(n) < 0.8]).astype(np.float32)
    lid = np.where(rng.rand(n) < 0.85, 2, rng.randint(0, 6, n)) \
        .astype(np.int32)
    tabs = np.array([[1, 16, 2, 0, 200, 0, 0], [2, 8, 0, 7, 40, 30, 1],
                     [0, 24, 0, 0, 256, 0, 0]], np.int64)
    bits = rng.randint(-2**31, 2**31 - 1, 8).astype(np.int32)
    for s, c in ((0, 1024), (777, 4000)):
        split = [2, 9, feat, thr, flags, 1, s, c]
        lanes = [torch.from_numpy(a.copy()) for a in
                 (bins, w, np.arange(n), lid)]
        res = partition_window_plain(
            *lanes, torch.tensor(split), torch.from_numpy(tabs),
            torch.from_numpy(bits), mask_max=mask_max).tolist()
        go = _slice_reference(bins, w, None, lid, split, tabs[feat], bits)
        bag = w[2, s:s + c] > 0.5
        if c > mask_max:
            order = np.concatenate([np.flatnonzero(go),
                                    np.flatnonzero(~go)]) + s
            nl = int(go.sum())
            assert res == [s, nl, s + nl, c - nl, int((go & bag).sum()),
                           int(bag.sum())]
            np.testing.assert_array_equal(lanes[0][:, s:s + c],
                                          bins[:, order])
            np.testing.assert_array_equal(lanes[1][:, s:s + c], w[:, order])
            np.testing.assert_array_equal(lanes[2][s:s + c], order)
            np.testing.assert_array_equal(
                lanes[3][s:s + c], np.where(np.arange(c) < nl, 2, 9))
        else:
            seg = lid[s:s + c] == 2
            assert res == [s, c, s, c, int((seg & go & bag).sum()),
                           int((seg & bag).sum())]
            np.testing.assert_array_equal(
                lanes[3][s:s + c], np.where(seg & ~go, 9, lid[s:s + c]))
            np.testing.assert_array_equal(lanes[0], bins)
        np.testing.assert_array_equal(lanes[3][:s], lid[:s])
        np.testing.assert_array_equal(lanes[0][:, s + c:], bins[:, s + c:])
        # a split that is not done changes no lane
        noop = [torch.from_numpy(a.copy()) for a in
                (bins, w, np.arange(n), lid)]
        out = partition_window_plain(
            *noop, torch.tensor(split[:5] + [0] + split[6:]),
            torch.from_numpy(tabs), torch.from_numpy(bits),
            mask_max=mask_max)
        assert out.tolist() == [s, 0, s, 0, 0, 0]
        assert all(np.array_equal(a.numpy(), b) for a, b in
                   zip(noop, (bins, w, np.arange(n), lid)))
