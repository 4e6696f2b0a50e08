"""Monotone constraints and feature_contri penalties: port vs lightgbm_tpu.

The split search first, on the same numpy histograms:

  * the plain ``find_best_splits`` with a monotone sign per feature, value
    bounds per leaf (a batch of leaves in one call) and the gain penalty,
    against the JAX function leaf by leaf with the penalty applied as the
    JAX learner applies it (`learner.py:274-277`);
  * the plain categorical search with the leaves' bounds, and
    ``categorical_candidates`` with the penalty;

equal in float64 up to 1e-12 relative and in float32 up to 1e-6 (the
thresholds, directions, bitsets and counts exactly).  Then one tree from the
same gradients (on a 2**-20 grid, so float64 sums are exact in any order)
through both packages with ``gpu_use_dp``: the wave, compact and masked
learners against the JAX learner of the same kind, records, counts, leaf
ids and leaf outputs exactly equal; a quantized constrained wave tree (the
fused child-scan kernel off, as in the JAX package) with the structure and
counts exact.  Last, the port's own models: ``tests/test_monotone.py``'s
checks (predictions monotone along the constrained features; a zero
penalty keeps a feature out) and ``lt.train`` against ``lj.train`` end to
end on the L2 objective in dp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.learner_compact import CompactTPUTreeLearner
from lightgbm_tpu.learner_wave import WaveTPUTreeLearner
from lightgbm_tpu.ops.split import find_best_splits as jax_find
from lightgbm_tpu.ops.split_cat import \
    find_best_splits_categorical as jax_find_cat
from lightgbm_tpu_torch.binning import (MISSING_NAN, MISSING_NONE,
                                        MISSING_ZERO)
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.learner import MaskedTreeLearner
from lightgbm_tpu_torch.learner_compact import CompactTreeLearner
from lightgbm_tpu_torch.learner_wave import WaveTreeLearner
from lightgbm_tpu_torch.ops.split import (apply_penalty, find_best_splits,
                                          forced_split_info)
from lightgbm_tpu_torch.ops.split_cat import (categorical_candidates,
                                              find_best_splits_categorical)
from test_torch_learner import _grads
from test_torch_masked import _jax_unfused

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

CPU = torch.device("cpu")
FIELDS = ("gain", "left_sum_g", "left_sum_h", "left_cnt", "right_sum_g",
          "right_sum_h", "right_cnt", "left_output", "right_output")
MONO = "1,-1,0,1,0"
CONTRI = "1,1,0.5,1,0.8"
BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "min_data_in_leaf": 20, "verbosity": -1, "tpu_min_window": 1024,
        "monotone_constraints": MONO, "feature_contri": CONTRI}


# ---------------------------------------------------------------------------
# The split search.
# ---------------------------------------------------------------------------

def _scan_inputs(dtype, k=4, f=6, b=32, seed=5):
    """K leaves' histograms of F features (missing types none, zero, NaN)
    with per-leaf bounds that bind: none, a tight band, a floor, a
    ceiling.  The sums are dyadic, so float32 sums are exact in any order
    (the two packages' cumulative sums run in different orders)."""
    rng = np.random.RandomState(seed)
    cnt = rng.randint(0, 60, size=(k, f, b)).astype(np.float64)
    g = np.round((rng.randn(k, f, b) * np.sqrt(cnt + 1.0) + 0.2 * cnt
                  * np.sin(np.arange(b) / 3.0)) * 64) / 64
    h = cnt * 0.25 + 1 / 128
    hist = np.stack([g, h, cnt], -1).astype(dtype)
    num_bin = np.array([32, 20, 32, 12, 32, 2], np.int32)
    missing = np.array([MISSING_NONE, MISSING_ZERO, MISSING_NAN,
                        MISSING_NONE, MISSING_ZERO, MISSING_NAN], np.int32)
    default_bin = np.array([0, 4, 0, 0, 9, 0], np.int32)
    for j in range(f):
        hist[:, j, num_bin[j]:] = 0.0
    mono = np.array([1, -1, 1, 0, -1, 1], np.int8)
    pen = np.array([1.0, 0.5, 1.0, 0.25, 1.0, 0.0], np.float32)
    mn = np.array([-np.inf, -0.05, 0.0, -np.inf], dtype)
    mx = np.array([np.inf, 0.05, np.inf, -0.01], dtype)
    return hist, num_bin, missing, default_bin, mono, pen, mn, mx


def _assert_fields(got, want, dtype, rtol, i=None):
    pick = (lambda a: a[i]) if i is not None else (lambda a: a)
    np.testing.assert_array_equal(pick(got.threshold).numpy(),
                                  np.asarray(want.threshold))
    np.testing.assert_array_equal(pick(got.default_left).numpy(),
                                  np.asarray(want.default_left))
    for name in FIELDS:
        a = pick(getattr(got, name)).numpy()
        w = np.asarray(getattr(want, name))
        assert a.dtype == w.dtype == dtype, name
        np.testing.assert_allclose(a, w, rtol=rtol, atol=0, err_msg=name)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_find_best_splits_constrained_equals_jax(dtype):
    hist, nb, mt, db, mono, pen, mn, mx = _scan_inputs(dtype)
    k, f = hist.shape[:2]
    tg, th, tn = (hist[:, 0, :, c].sum(1) for c in range(3))
    fmask = np.ones(f, bool)
    fmask[2] = False
    kw = dict(min_data_in_leaf=5, min_sum_hessian_in_leaf=1e-3,
              lambda_l2=0.5)
    t = torch.from_numpy
    got = find_best_splits(t(hist), t(tg), t(th), t(tn), t(nb), t(mt),
                           t(db), t(fmask), t(mono), t(mn), t(mx),
                           penalty=t(pen), **kw)
    free = find_best_splits(t(hist), t(tg), t(th), t(tn), t(nb), t(mt),
                            t(db), t(fmask), **kw)
    rtol = 1e-12 if dtype == np.float64 else 1e-6
    for i in range(k):
        want = jax_find(jnp.asarray(hist[i]), jnp.asarray(tg[i]),
                        jnp.asarray(th[i]), jnp.asarray(tn[i]),
                        jnp.asarray(nb), jnp.asarray(mt), jnp.asarray(db),
                        jnp.asarray(fmask), jnp.asarray(mono),
                        jnp.asarray(mn[i]), jnp.asarray(mx[i]), **kw)
        gain = np.asarray(want.gain)
        with np.errstate(invalid="ignore"):
            want = want._replace(gain=np.where(np.isneginf(gain), gain,
                                               gain * pen.astype(dtype)))
        _assert_fields(got, want, dtype, rtol, i)
    # the constraints bind: clipped outputs, other winners, gains scaled
    lo = got.left_output.numpy()
    assert (lo[1] <= 0.05).all() and (lo[1] >= -0.05).all()
    assert not torch.equal(got.threshold, free.threshold)
    assert (got.gain[:, 5] <= 0).all() or torch.isneginf(got.gain[:, 5]).all()
    # apply_penalty leaves -inf and scales the rest
    assert torch.equal(apply_penalty(free.gain, None), free.gain)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_categorical_search_bounds_equal_jax(dtype):
    rng = np.random.RandomState(11)
    k, b = 3, 40
    hist = np.zeros((k, 2, b, 3))
    for j, nbins in enumerate((25, 4)):
        cnt = rng.randint(0, 120, size=(k, b)).astype(np.float64)
        cnt[:, nbins:] = 0.0
        g = rng.randn(k, b) * np.sqrt(np.maximum(cnt, 1e-9))
        hist[:, j] = np.stack([g, cnt * 0.25 + 0.01 * (cnt > 0), cnt], -1)
    hist = hist.astype(dtype)
    nb = np.array([25, 4], np.int32)
    mt = np.full(2, MISSING_NONE, np.int32)
    mn = np.array([-np.inf, -0.02, 0.0], dtype)
    mx = np.array([np.inf, 0.02, 0.5], dtype)
    kw = dict(min_data_in_leaf=5, min_data_per_group=20)
    tg, th, tn = (hist[:, 0, :, c].sum(1) for c in range(3))
    t = torch.from_numpy
    ones = torch.ones(2, dtype=torch.bool)
    got = find_best_splits_categorical(t(hist), t(tg), t(th), t(tn), t(nb),
                                       t(mt), ones, t(mn), t(mx), **kw)
    rtol = 1e-12 if dtype == np.float64 else 1e-6
    for i in range(k):
        want = jax_find_cat(jnp.asarray(hist[i]), jnp.asarray(tg[i]),
                            jnp.asarray(th[i]), jnp.asarray(tn[i]),
                            jnp.asarray(nb), jnp.asarray(mt),
                            jnp.ones(2, bool), jnp.asarray(mn[i]),
                            jnp.asarray(mx[i]), **kw)
        np.testing.assert_array_equal(got.bits[i].numpy(),
                                      np.asarray(want.bits).view(np.int32))
        for name in FIELDS:
            np.testing.assert_allclose(getattr(got, name)[i].numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=rtol, atol=0, err_msg=name)
    lo = got.left_output[1].numpy()
    assert (np.abs(lo[np.isfinite(got.gain[1].numpy())]) <= 0.02).all()
    # the learners' entry point writes the penalised gains of the
    # categorical columns only
    free = find_best_splits(t(hist), t(tg), t(th), t(tn), t(nb), t(mt),
                            torch.zeros(2, dtype=torch.int32),
                            torch.zeros(2, dtype=torch.bool))
    bits = torch.zeros((k, 2, 2), dtype=torch.int32)
    pen = torch.tensor([0.5, 1.0])
    categorical_candidates(free, bits, t(hist), t(tg), t(th), t(tn), t(nb),
                           t(mt), ones, torch.tensor([0], dtype=torch.int32),
                           t(mn), t(mx), pen, **kw)
    g0 = got.gain[:, 0]
    assert torch.equal(free.gain[:, 0],
                       torch.where(torch.isneginf(g0), g0, g0 * 0.5))
    assert torch.equal(bits[:, 0], got.bits[:, 0])
    assert not bits[:, 1].any()


@pytest.mark.parametrize("case", ["none", "zero", "nan", "cat", "refused"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_forced_split_info_equals_jax(case, dtype):
    from lightgbm_tpu.ops.split import forced_split_info as jax_forced
    rng = np.random.RandomState(2)
    b = 24
    cnt = rng.randint(1, 50, b).astype(np.float64)
    # dyadic sums: any order gives the same float32 totals
    g = np.round(rng.randn(b) * 64) / 64
    g[9] = 30.0        # the forced bin stands out: a split worth making
    hrow = np.stack([g, cnt * 0.25, cnt], -1).astype(dtype)
    mt = {"zero": MISSING_ZERO, "nan": MISSING_NAN}.get(case, MISSING_NONE)
    thr = 0 if case == "refused" else 9
    static = dict(threshold=thr, num_bin=20, missing_type=mt, default_bin=5,
                  is_cat=case == "cat", lambda_l1=0.0, lambda_l2=1.0,
                  max_delta_step=0.0, min_gain_to_split=0.0)
    hrow[20:] = 0.0
    sg, sh, sn = (hrow[:, c].sum() for c in range(3))
    if case == "refused":
        # every row on one side of the threshold: no gain over the leaf
        hrow[0] += hrow[1:].sum(0)
        hrow[1:] = 0.0
    got = forced_split_info(torch.from_numpy(hrow),
                            *(torch.tensor(v) for v in (sg, sh, sn)),
                            **static)
    want = jax_forced(jnp.asarray(hrow),
                      *(jnp.asarray(v) for v in (sg, sh, sn)), **static)
    assert bool(got[-1]) == bool(want[-1]) == (case != "refused")
    rtol = 1e-12 if dtype == np.float64 else 1e-6
    for a, w in zip(got[:-1], want[:-1]):
        assert a.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=rtol,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# Trees.
# ---------------------------------------------------------------------------

def _mono_problem(seed=0, n=3000):
    """tests/test_monotone.py's rows (feature 0 up, feature 1 down) with
    three more: noise, a NaN-typed one and a zero-heavy one."""
    rng = np.random.RandomState(seed)
    x1, x2 = rng.random_sample(n), rng.random_sample(n)
    x3 = rng.randn(n)
    x4 = rng.randn(n)
    x4[rng.rand(n) < 0.1] = np.nan
    x5 = np.where(rng.rand(n) < 0.6, 0.0, rng.randn(n))
    X = np.column_stack([x1, x2, x3, x4, x5])
    y = (5 * x1 + np.sin(10 * np.pi * x1) - 5 * x2
         - np.cos(10 * np.pi * x2) + 0.3 * x3 + rng.normal(0, 0.01, n))
    return X.astype(np.float32), y


def _datasets(params, seed=0):
    X, y = _mono_problem(seed)
    yb = (y > np.median(y)).astype(np.float32)
    dj = lj.Dataset(X, label=yb, params=params).construct().constructed
    dt = lt.Dataset(X, label=yb, params=dict(params, device_type="cpu")) \
        .construct().constructed
    return dj, dt, _grads(seed, yb, dj.num_data_padded)


def _assert_bounds_hold(rf, mono):
    """Every recorded split on a monotone feature has its outputs in the
    constrained order."""
    nv = int((rf[:, 0] > 0.5).sum())
    assert nv > 0
    for r in rf[:nv]:
        m = mono[int(r[2])]
        if m > 0:
            assert r[6] <= r[7]
        elif m < 0:
            assert r[6] >= r[7]


@pytest.mark.parametrize("learner", ["wave", "compact", "masked"])
def test_dp_constrained_tree_equals_jax(learner):
    # (7 leaves on the wave learner: its JAX program compiles in seconds)
    params = dict(BASE, gpu_use_dp=True, tpu_learner=learner,
                  num_leaves=7 if learner == "wave" else 15)
    dj, dt, (g, h, b) = _datasets(params)
    tg = [torch.from_numpy(a) for a in (g, h, b)]
    cfg = TConfig.from_params(params)
    if learner == "masked":
        rec_f, rec_i, leaf_j, tree_j = _jax_unfused(params, dj, g, h, b)
        port = MaskedTreeLearner(cfg, dt, CPU)
        rf, ri, leaf_t, _ = port.grow(*tg)
        np.testing.assert_array_equal(rf, rec_f)
        np.testing.assert_array_equal(ri, rec_i)
        np.testing.assert_array_equal(leaf_t.numpy(), leaf_j)
        assert port.assemble_host(rf, ri).to_string() == tree_j.to_string()
    else:
        jcls = WaveTPUTreeLearner if learner == "wave" \
            else CompactTPUTreeLearner
        tcls = WaveTreeLearner if learner == "wave" else CompactTreeLearner
        rj = jcls(JConfig.from_params(params), dj).train_async(
            *(jnp.asarray(a) for a in (g, h, b)))
        port = tcls(cfg, dt, CPU)
        rf, ri, leaf_t, out_t = port.grow(*tg)
        rec_j, cnt_j, _, leaf_j, out_j = (np.asarray(a) for a in rj)
        np.testing.assert_array_equal(rf, rec_j)
        np.testing.assert_array_equal(ri, cnt_j)
        np.testing.assert_array_equal(leaf_t.numpy(), leaf_j)
        np.testing.assert_array_equal(out_t.to(torch.float32).numpy(),
                                      out_j)
    assert port.has_monotone and port.has_penalty
    _assert_bounds_hold(rf, port.np_monotone)
    # the settings change the tree
    free = {k: v for k, v in params.items()
            if k not in ("monotone_constraints", "feature_contri")}
    rf_free = type(port)(TConfig.from_params(free), dt, CPU).grow(*tg)[0]
    assert not np.array_equal(rf, rf_free)


def test_quant_constrained_wave_tree_equals_jax():
    """Quantized with constraints: the fused child-scan kernel stays off in
    both packages; the same float32 gradients quantize to the same lanes,
    so the structure and the exact counts are equal and the renewed leaf
    values agree within 1e-6."""
    params = dict(BASE, tpu_quantized_grad="on", tpu_wave_sort_cutoff=512,
                  tpu_sort_cutoff=256, num_leaves=7)
    dj, dt, (g, h, b) = _datasets(params)
    jl = WaveTPUTreeLearner(JConfig.from_params(params), dj)
    rj = jl.train_async(*(jnp.asarray(a) for a in (g, h, b)))
    wave = WaveTreeLearner(TConfig.from_params(params), dt, CPU)
    rf, ri, leaf_t, out_t = wave.grow(*(torch.from_numpy(a)
                                        for a in (g, h, b)))
    assert jl._quant and not jl._fused_ok()
    assert wave._quant and not wave._use_fused
    rec_j, cnt_j, _, leaf_j, out_j = (np.asarray(a) for a in rj)
    np.testing.assert_array_equal(rf[:, :5], rec_j[:, :5])
    np.testing.assert_array_equal(ri, cnt_j)
    np.testing.assert_array_equal(leaf_t.numpy(), leaf_j)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=0, atol=1e-6)
    # the child sums are float32 differences of the parent's sums, summed
    # in other orders by the two packages: an absolute bound
    np.testing.assert_allclose(rf, rec_j, rtol=1e-5, atol=1e-4)
    assert wave.kernel_calls["fused_scan"] == 0
    assert wave.kernel_calls["hist_segments_quant"] > 0


# ---------------------------------------------------------------------------
# The port's own models (tests/test_monotone.py).
# ---------------------------------------------------------------------------

def _is_correctly_constrained(booster, n=100):
    """tests/test_monotone.py's check on a two-feature model."""
    variable_x = np.linspace(0, 1, n).reshape((n, 1))
    for fv in np.linspace(0, 1, 20):
        fixed_x = fv * np.ones((n, 1))
        inc_y = booster.predict(np.column_stack((variable_x, fixed_x)))
        dec_y = booster.predict(np.column_stack((fixed_x, variable_x)))
        if not ((np.diff(inc_y) >= 0.0).all()
                and (np.diff(dec_y) <= 0.0).all()):
            return False
    return True


@pytest.mark.parametrize("learner", ["wave", "compact", "masked"])
def test_monotone_constraint(learner):
    X, y = _mono_problem(3)
    X = X[:, :2].astype(np.float64)
    params = {"min_data": 20, "num_leaves": 15, "verbosity": -1,
              "device_type": "cpu", "tpu_learner": learner}
    constrained = lt.train(dict(params, monotone_constraints="1,-1"),
                           lt.Dataset(X, label=y), 5)
    assert _is_correctly_constrained(constrained)
    # without constraints the same data violates monotonicity
    free = lt.train(params, lt.Dataset(X, label=y), 5)
    assert not _is_correctly_constrained(free)


def test_feature_contri_penalty():
    """tests/test_monotone.py:test_feature_contri_penalty on the port: a
    zero penalty on feature 0 keeps it out of the trees."""
    X, y = _mono_problem(4, 1500)
    X = X[:, :2].astype(np.float64)
    params = {"num_leaves": 15, "verbosity": -1, "min_data": 20,
              "device_type": "cpu"}
    base = lt.train(params, lt.Dataset(X, label=y), 5)
    assert base.feature_importance("split")[0] > 0
    pen = lt.train(dict(params, feature_contri="0.0,1.0"),
                   lt.Dataset(X, label=y), 5)
    assert pen.feature_importance("split")[0] == 0
    assert pen.feature_importance("split")[1] > 0


def test_end_to_end_equals_jax():
    """``lt.train`` and ``lj.train`` with both settings, L2 in dp, through
    the default (wave) learner: the same trees and predictions."""
    X, y = _mono_problem(5, 2000)
    params = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
              "min_data_in_leaf": 20, "verbosity": -1, "gpu_use_dp": True,
              "monotone_constraints": MONO, "feature_contri": CONTRI}
    bj = lj.train(params, lj.Dataset(X, label=y), 3)
    bt = lt.train(dict(params, device_type="cpu"), lt.Dataset(X, label=y), 3)
    for tj, tt in zip(bj.gbdt.models, bt.gbdt.models):
        nl = tj.num_leaves
        assert nl == tt.num_leaves > 1
        np.testing.assert_array_equal(tt.split_feature[:nl - 1],
                                      tj.split_feature[:nl - 1])
        np.testing.assert_array_equal(tt.threshold_in_bin[:nl - 1],
                                      tj.threshold_in_bin[:nl - 1])
        np.testing.assert_array_equal(tt.decision_type[:nl - 1],
                                      tj.decision_type[:nl - 1])
        np.testing.assert_array_equal(tt.leaf_count[:nl], tj.leaf_count[:nl])
        np.testing.assert_allclose(tt.leaf_value[:nl], tj.leaf_value[:nl],
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=0,
                               atol=1e-5)
