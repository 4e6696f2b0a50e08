"""Port frontier-wave learner vs lightgbm_tpu's WaveTPUTreeLearner.

One tree from the same numpy float32 gradients, hessians and 90% bag
(``tests/test_torch_learner.py``: values on a 2**-20 grid, so float64 sums
are exact in any order) goes through both packages with ``gpu_use_dp``.  The
records (pop order, leaf numbering, every float), the exact bagged counts,
the leaf id of every row and the leaf outputs must be EXACTLY equal, and
equal to the port's compact learner on the same inputs.  The JAX learner
runs with ``tpu_wave_defer_sorts=False`` (the flow its TPU partition mode
runs, which the port implements) except in one case that keeps its
defaults.  The cases cover stall batches 1 and 4 (each with replay stalls),
a narrow wave, sortable and frozen members, feature sampling,
regularization with ``max_depth``, EFB bundles and a budget that runs out
of positive gains early.
"""

import dataclasses
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.learner_wave import WaveTPUTreeLearner
from lightgbm_tpu.learner_wave import \
    wave_transient_bytes as jax_wave_bytes
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.learner_compact import CompactTreeLearner
from lightgbm_tpu_torch.learner_wave import (
    EAGER_PASSES, GRAPHED_PASSES, NUM_P, PLAIN_KERNELS, STATE_TERMS,
    WaveKernels, WaveTreeLearner, wave_ineligible_reason,
    wave_transient_bytes)
from lightgbm_tpu_torch.ops.replay import replay_plan
from test_torch_learner import _grads, _problem

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

CPU = torch.device("cpu")
BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "min_data_in_leaf": 10, "tpu_min_window": 1024, "verbosity": -1,
        "gpu_use_dp": True}
JAX_FLOW = {"tpu_wave_defer_sorts": False}

# name: (params, JAX-only params, feature fraction, keep the NaN column).
# A NaN-typed feature in a leaf without NaN rows gives the missing-left and
# missing-right scans the same split, and the two packages break that tie
# by the last bits of their gain arithmetic (ROADMAP.md Queue C, also
# between their compact learners), so the larger trees drop the NaN column.
CASES = {
    "defaults": ({}, JAX_FLOW, None, True),
    "jax_defaults": ({}, {}, None, True),
    "stall1_sorted": ({"tpu_wave_stall_batch": 1, "tpu_sort_cutoff": 0,
                       "tpu_wave_sort_cutoff": 0, "num_leaves": 31,
                       "tpu_wave_overshoot": 0.0}, JAX_FLOW, None, False),
    "stall1_frozen": ({"tpu_wave_stall_batch": 1, "tpu_wave_width": 8,
                       "num_leaves": 31, "tpu_wave_overshoot": 0.0},
                      JAX_FLOW, None, False),
    "stall4_narrow": ({"tpu_wave_width": 4, "num_leaves": 31}, JAX_FLOW,
                      None, False),
    "stall4_mixed_features": ({"tpu_wave_sort_cutoff": 512,
                               "tpu_sort_cutoff": 256, "num_leaves": 63},
                              JAX_FLOW, 0.7, False),
    "regularized_depth_exhausted": ({"max_depth": 5, "num_leaves": 63,
                                     "min_data_in_leaf": 150,
                                     "lambda_l1": 0.1, "lambda_l2": 1.0,
                                     "max_delta_step": 0.5,
                                     "min_gain_to_split": 0.01,
                                     "min_sum_hessian_in_leaf": 0.5,
                                     "tpu_wave_sort_cutoff": 512},
                                    JAX_FLOW, None, True),
}


def _grow(params, jax_extra, frac=None, nan=True, efb=False, seed=0):
    X, y = _problem(seed, efb)
    if not nan:
        X[:, 2] = np.nan_to_num(X[:, 2])
    dj = lj.Dataset(X, label=y, params=params).construct().constructed
    dt = lt.Dataset(X, label=y, params=dict(params, device_type="cpu")) \
        .construct().constructed
    assert (dj.bundle is not None) == efb == (dt.bundle is not None)
    g, h, b = _grads(seed, y, dj.num_data_padded)
    f = dt.num_used_features
    fmask = np.ones(f, bool)
    if frac is not None:
        rng = np.random.RandomState(seed + 7)
        fmask[:] = False
        fmask[rng.choice(f, max(1, int(round(f * frac))), replace=False)] = \
            True
    rj = WaveTPUTreeLearner(JConfig.from_params(dict(params, **jax_extra)),
                            dj).train_async(jnp.asarray(g), jnp.asarray(h),
                                            jnp.asarray(b),
                                            jnp.asarray(fmask))
    args = [torch.from_numpy(a) for a in (g, h, b, fmask)]
    wave = WaveTreeLearner(TConfig.from_params(params), dt, CPU)
    rw = wave.grow(*args)
    rc = CompactTreeLearner(TConfig.from_params(params), dt, CPU).grow(*args)
    return rj, rw, rc, wave


def _check(rj, rw, rc):
    rec_j, cnt_j, _, leaf_j, out_j = (np.asarray(a) for a in rj)
    rf, ri, leaf_t, out_t = rw
    np.testing.assert_array_equal(rf, rec_j)
    np.testing.assert_array_equal(ri, cnt_j)
    np.testing.assert_array_equal(leaf_t.numpy(), leaf_j)
    np.testing.assert_array_equal(out_t.to(torch.float32).numpy(), out_j)
    # the compact learner grows the same tree (its unused record rows are
    # zeros, the wave learner's repeat the root's with REC_VALID = 0)
    nv = int((rf[:, 0] > 0.5).sum())
    assert nv == int((rc[0][:, 0] > 0.5).sum())
    np.testing.assert_array_equal(rf[:nv], rc[0][:nv])
    np.testing.assert_array_equal(ri[:nv], rc[1][:nv])
    assert torch.equal(leaf_t, rc[2])
    assert torch.equal(out_t, rc[3])
    return nv


@pytest.mark.parametrize("name", list(CASES))
def test_dp_records_equal_jax_wave_and_compact(name):
    extra, jax_extra, frac, nan = CASES[name]
    params = dict(BASE, **extra)
    rj, rw, rc, wave = _grow(params, jax_extra, frac, nan)
    nv = _check(rj, rw, rc)
    stats = wave.tree_stats[-1]
    budget = wave.budget
    if name == "regularized_depth_exhausted":
        assert 0 < nv < budget
    else:
        assert nv >= budget // 2
    if name.startswith("stall"):
        assert stats["stall_events"] > 0          # the replay corrected
    # every growth wave partitions (the identity for rows of windows at or
    # below the cutoff); the rows move only where a window was sortable
    rows_moved = not torch.equal(wave._st.rid_p,
                                 torch.arange(wave.n_pad))
    if "sorted" in name or "mixed" in name:
        assert wave.kernel_calls["partition"] > 0 and rows_moved
    if "frozen" in name or name == "defaults":
        assert not rows_moved
    # one host read (the records); the lagged flag waits: one per growth
    # wave (at least the one that ended an empty growth) and one per
    # replay pass; the replay ends one pass after its last stall
    assert stats["host_syncs"] == 1
    assert stats["replay_passes"] == stats["stall_events"] + 1
    assert stats["flag_waits"] == max(stats["waves"] - stats["open_levels"],
                                      1) + stats["replay_passes"]


def test_dp_records_equal_with_efb_bundles():
    rj, rw, rc, wave = _grow(BASE, JAX_FLOW, efb=True, seed=3)
    assert wave._bundle is not None
    _check(rj, rw, rc)


def test_f32_wave_equals_compact_and_plain_kernels():
    """Without dp: the wave learner through its kernel functions (the plain
    versions on the CPU) and through PLAIN_KERNELS, and the compact learner,
    grow the same records."""
    X, y = _problem(1)
    params = dict(BASE, gpu_use_dp=False, num_leaves=31,
                  tpu_wave_sort_cutoff=512, tpu_sort_cutoff=256)
    dt = lt.Dataset(X, label=y, params=dict(params, device_type="cpu")) \
        .construct().constructed
    g, h, b = (torch.from_numpy(a) for a in _grads(1, y, dt.num_data_padded))
    cfg = TConfig.from_params(params)
    wave = WaveTreeLearner(cfg, dt, CPU)
    a = wave.grow(g, h, b)
    p = WaveTreeLearner(cfg, dt, CPU, PLAIN_KERNELS).grow(g, h, b)
    c = CompactTreeLearner(cfg, dt, CPU).grow(g, h, b)
    np.testing.assert_array_equal(a[0], p[0])
    assert torch.equal(a[2], p[2])
    nv = int((a[0][:, 0] > 0.5).sum())
    assert nv == 30
    np.testing.assert_array_equal(a[0][:, :5], c[0][:, :5])
    np.testing.assert_array_equal(a[1], c[1])
    assert torch.equal(a[2], c[2])
    np.testing.assert_allclose(a[0], c[0], rtol=1e-5, atol=1e-6)
    calls = wave.kernel_calls
    assert calls["hist_packed"] == 1 and calls["partition"] > 0
    assert calls["hist_segments"] == calls["split_scan"] - 1 > 0


class _LiveBytes(TorchDispatchMode):
    """Live bytes of the tensors that the torch ops run under this mode
    create: a storage counts from the op that allocates it until its last
    tensor is freed (views and in-place results allocate nothing).  While
    ``paused`` (inside a kernel function) no op is tracked; ``track`` then
    counts the kernel's outputs."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.paused = 0
        self.refs, self.size = {}, {}

    def _gone(self, key):
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.live -= self.size.pop(key)

    def track(self, t, fresh=True):
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        key = st.data_ptr()
        if key not in self.refs:
            if not fresh or st.nbytes() == 0:
                return
            self.refs[key], self.size[key] = 0, st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
        self.refs[key] += 1
        weakref.finalize(t, self._gone, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused:
            rets = func._schema.returns
            for i, t in enumerate(tree_flatten(out)[0]):
                alias = rets[i].alias_info if i < len(rets) else None
                self.track(t, fresh=alias is None)
        return out


#: the learner's passes and the estimate's term for each
_PASSES = {"_init_root_wave": "root_pass_bytes",
           "_split_members": "split_pass_bytes",
           "_materialize": "materialize_pass_bytes",
           "_replay_pass": "replay_pass_bytes",
           "_emit": "emit_pass_bytes"}


def _pass_peaks(params, X, y):
    """A CPU wave learner's second tree (the first allocates the state) with
    each pass's peak live bytes beyond those live when it starts, and the
    quantized gradients the tree holds for its renewal.  The
    kernel functions' own temporaries go untracked (the estimate counts
    the card kernels' scratch); their outputs count."""
    d = lt.Dataset(X, label=y, params=dict(params, device_type="cpu")) \
        .construct().constructed
    mode = _LiveBytes()

    def kernel(fn):
        def call(*a, **kw):
            mode.paused += 1
            try:
                out = fn(*a, **kw)
            finally:
                mode.paused -= 1
            if "out" not in kw:
                for t in out if isinstance(out, (tuple, list)) else [out]:
                    mode.track(t)
            return out
        return call

    kern = WaveKernels(**{f.name: kernel(getattr(WaveKernels(), f.name))
                          for f in dataclasses.fields(WaveKernels)})
    wave = WaveTreeLearner(TConfig.from_params(params), d, CPU, kern)
    peaks = dict.fromkeys(_PASSES.values(), 0)

    def measured(key, fn):
        def call(*a, **kw):
            base = mode.peak = mode.live
            out = fn(*a, **kw)
            peaks[key] = max(peaks[key], mode.peak - base)
            return out
        return call

    for name, key in _PASSES.items():
        setattr(wave, name, measured(key, getattr(wave, name)))
    renew = wave._renew_leaf_outputs

    def renew_held(*a):                 # the renewal drops what it reads
        peaks["quant_state_bytes"] = sum(t.nbytes for t in wave._q_raw)
        return renew(*a)

    wave._renew_leaf_outputs = renew_held
    peaks["quant_state_bytes"] = 0
    g, h, bag = (torch.from_numpy(a)
                 for a in _grads(3, y, d.num_data_padded))
    wave.train_async(g, h, bag)
    with mode:
        wave.train_async(g, h, bag)
    return wave, d, peaks


def test_sizing_equals_jax():
    """The wave learner's shape fields (M, H, grow budget, W) are the JAX
    learner's; the port's byte estimate (no leaf lookup: the port gathers)
    holds each state term equal to the tensors a CPU learner allocates and
    each pass term at or above that pass's measured peak, for a float32, a
    quantized and an opening tree; ``auto`` keeps the wave learner at
    1,000,000 x 32 x 255 with 4,095 leaves under the default budget, which
    the JAX formula refuses, and at Higgs's 11,000,000 rows with 31, 255
    and 4,095 leaves."""
    X, y = _problem(0)
    dj = lj.Dataset(X, label=y, params=BASE).construct().constructed
    dt = lt.Dataset(X, label=y, params=dict(BASE, device_type="cpu")) \
        .construct().constructed
    for over in ({}, {"num_leaves": 255}, {"tpu_wave_stall_batch": 1},
                 {"tpu_wave_width": 8, "tpu_wave_vec_cap": 4096}):
        p = dict(BASE, **over)
        jw = WaveTPUTreeLearner(JConfig.from_params(p), dj)
        tw = WaveTreeLearner(TConfig.from_params(p), dt, CPU)
        assert (tw.M, tw.H, tw.grow_budget, tw.W) == \
            (jw.M, jw.H, jw.grow_budget, jw.W), over

    # trees on 8 dense features (f_pad = the histogram's columns); 20,000
    # rows and a narrow wave, so the per-row terms outweigh the histograms
    X8, y8 = _problem(5, n=20000, f=8)
    p = dict(BASE, num_leaves=7, max_bin=15, gpu_use_dp=False)
    for over in ({}, {"tpu_quantized_grad": "on"},
                 {"tpu_wave_open_levels": 2}):
        wave, d8, peaks = _pass_peaks(dict(p, **over), X8, y8)
        f_pad, n_pad, b = d8.bins.shape[0], d8.num_data_padded, \
            d8.max_num_bin
        assert f_pad == d8.num_used_features == 8
        est = wave_transient_bytes(wave.cfg, n_pad, f_pad, b)
        assert "leaf_lookup_bytes" not in est
        for key in _PASSES.values():
            assert peaks[key] <= est[key], (over, key, peaks[key], est[key])
        assert peaks["split_pass_bytes"] > n_pad * NUM_P * 4
        assert (peaks["materialize_pass_bytes"] > 0) == \
            (wave.open_levels > 0) == (est["materialize_pass_bytes"] > 0)
        st = wave._st
        assert est["quant_state_bytes"] == peaks["quant_state_bytes"]
        assert (peaks["quant_state_bytes"] > 0) == wave._quant
        assert est["lane_bytes"] == sum(t.nbytes for lane in st.lanes
                                        for t in lane) + wave._pos.nbytes
        assert est["bins_bytes"] == wave.bins_packed().nbytes \
            + d8.device_bins(CPU).nbytes
        assert est["hist_pool_bytes"] == st.hist_pool.nbytes
        tables = [getattr(st, f.name) for f in dataclasses.fields(st)
                  if f.name not in ("lanes", "hist_pool", "par")]
        assert est["node_table_bytes"] == sum(t.nbytes for t in tables
                                              if t is not None)
        assert est["replay_pass_bytes"] == \
            replay_plan(wave.M, wave.budget).scratch
        # the state, the widest graphed pass and the widest eager pass
        assert est["total_bytes"] == sum(est[k] for k in STATE_TERMS) \
            + max(est[k] for k in GRAPHED_PASSES) \
            + max(est[k] for k in EAGER_PASSES)

    class Bench:          # what the learner choice reads of a dataset
        num_data_padded, max_num_bin, bundle = 1_000_448, 255, None
        num_used_features = 28
        bins = np.empty((32, 0), np.uint8)

        def feature_meta_arrays(self):
            return (None, None, None, np.zeros(28, bool))

    # the bench width at 4,095 leaves: the default 4 GiB admits it
    big = TConfig.from_params({"num_leaves": 4095})
    est = wave_transient_bytes(big, 1_000_448, 32, 255, hist_cols=28)
    fits = est["total_bytes"] <= int(big.tpu_wave_max_bytes)
    assert fits and est["hist_pool_bytes"] > est["total_bytes"] / 2
    assert (wave_ineligible_reason(big, Bench()) is None) == fits
    jax = jax_wave_bytes(JConfig.from_params({"num_leaves": 4095}),
                         1_000_448, 32, 255)
    assert jax["total_bytes"] > int(big.tpu_wave_max_bytes) \
        > jax["total_bytes"] - jax["leaf_lookup_bytes"]
    # Higgs's 11,000,000 rows keep the wave learner at 31, 255 and 4,095
    # leaves; 16,000,000 rows at 255 leaves, which the JAX formula admits,
    # do not (the card holds 4.74 GB for them, ``wave_memory.py``)
    Bench.num_data_padded = 11_000_832
    for leaves in (31, 255, 4095):
        assert wave_ineligible_reason(
            TConfig.from_params({"num_leaves": leaves}), Bench()) is None
    Bench.num_data_padded = 16_000_000
    c255 = TConfig.from_params({"num_leaves": 255})
    assert wave_ineligible_reason(c255, Bench()) is not None
    jax = jax_wave_bytes(JConfig.from_params({"num_leaves": 255}),
                         16_000_000, 32, 255)
    assert jax["total_bytes"] <= int(c255.tpu_wave_max_bytes)


# ---------------------------------------------------------------------------
# Routing and end to end.
# ---------------------------------------------------------------------------


def _small(n=1000, f=5, seed=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


@pytest.mark.parametrize("mode,want", [("auto", WaveTreeLearner),
                                       ("wave", WaveTreeLearner),
                                       ("compact", CompactTreeLearner)])
def test_routing(mode, want):
    X, y = _small()
    p = {"objective": "binary", "device_type": "cpu", "num_leaves": 7,
         "verbosity": -1, "tpu_learner": mode}
    bst = lt.train(p, lt.Dataset(X, label=y), 1, verbose_eval=False)
    assert type(bst.gbdt.learner) is want


def test_ineligible_wave_falls_back_with_the_jax_message(capsys):
    X, y = _small()
    p = {"objective": "binary", "device_type": "cpu", "num_leaves": 7,
         "verbosity": 1, "tpu_wave_max_bytes": 1}
    bst = lt.train(p, lt.Dataset(X, label=y), 1, verbose_eval=False)
    assert type(bst.gbdt.learner) is CompactTreeLearner
    assert "wave learner ineligible" in capsys.readouterr().out
    with pytest.warns(UserWarning, match="tpu_learner=wave was requested"):
        lt.train(dict(p, tpu_learner="wave"), lt.Dataset(X, label=y), 1,
                 verbose_eval=False)


@pytest.mark.parametrize("extra", [
    {"tpu_wave_open_levels": 5}, {"tpu_wave_open_levels": 1},
    {"tpu_wave_open_levels": 8, "tpu_quantized_grad": "on"}])
def test_unported_wave_settings_raise(extra):
    """The level-wise opening and quantized gradients, once refused here,
    now train through the wave learner: every level splits, then one
    materialization."""
    X, y = _small()
    p = {"objective": "binary", "device_type": "cpu", "num_leaves": 8,
         "verbosity": -1, **extra}
    bst = lt.train(p, lt.Dataset(X, label=y), 2, verbose_eval=False)
    learner = bst.gbdt.learner
    levels = min(extra["tpu_wave_open_levels"], 3)  # capped: log2(leaves)
    assert type(learner) is WaveTreeLearner
    assert learner.open_levels == levels
    assert all(s["open_levels"] == levels for s in learner.tree_stats)
    assert learner.kernel_calls["hist_multislot"] == 2 * levels
    assert learner._quant == ("tpu_quantized_grad" in extra)
    assert learner.kernel_calls["hist_multislot_quant"] == \
        (2 * levels if learner._quant else 0)
    assert len(bst.gbdt.models) == 2


def test_end_to_end_default_learner_matches_jax():
    """``train`` with the default tpu_learner in both packages (the wave
    learner in each), L2 objective in dp: the same split structure, leaf
    values and predictions within 1e-5."""
    rng = np.random.RandomState(7)
    n = 3000
    X = rng.randn(n, 8)
    X[rng.rand(n) < 0.1, 2] = np.nan
    y = (X[:, 0] * 1.5 + np.nan_to_num(X[:, 2]) * X[:, 4]
         + 0.5 * rng.randn(n)).astype(np.float32)
    X = X.astype(np.float32)
    params = {"objective": "regression", "num_leaves": 31, "max_bin": 63,
              "learning_rate": 0.2, "min_data_in_leaf": 20, "verbosity": -1,
              "metric": "l2", "gpu_use_dp": True, "bagging_fraction": 0.8,
              "bagging_freq": 1, "bagging_seed": 5}
    out = []
    for lib, p in ((lj, params), (lt, dict(params, device_type="cpu"))):
        ds = lib.Dataset(X[:2400], label=y[:2400], params=p)
        bst = lib.train(p, ds, 3, verbose_eval=False)
        out.append((bst, bst.predict(X[2400:])))
    (bj, pj), (bt, pt) = out
    assert type(bj.gbdt.learner) is WaveTPUTreeLearner
    assert type(bt.gbdt.learner) is WaveTreeLearner
    assert len(bj.gbdt.models) == len(bt.gbdt.models) == 3
    for tj, tt in zip(bj.gbdt.models, bt.gbdt.models):
        nl = tj.num_leaves
        assert nl == tt.num_leaves > 1
        np.testing.assert_array_equal(tt.split_feature[:nl - 1],
                                      tj.split_feature[:nl - 1])
        np.testing.assert_array_equal(tt.threshold_in_bin[:nl - 1],
                                      tj.threshold_in_bin[:nl - 1])
        np.testing.assert_array_equal(tt.leaf_count[:nl], tj.leaf_count[:nl])
        np.testing.assert_allclose(tt.leaf_value[:nl], tj.leaf_value[:nl],
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Quantized gradients and the level-wise opening.
# ---------------------------------------------------------------------------

F32 = dict(BASE, gpu_use_dp=False, min_data_in_leaf=20,
           tpu_wave_sort_cutoff=512, tpu_sort_cutoff=256)
# the JAX learner runs its batched (and, under quant, fused) scan kernels
# in interpret mode on the CPU
JAX_SCAN = dict(JAX_FLOW, tpu_wave_pallas_scan="on")


def _dyadic_grads(y, n_pad, seed=0):
    """Gradients on a 2**-8 grid: every float32 histogram sum is exact."""
    g, h, b = _grads(seed, y, n_pad)
    return (np.round(g * 256) / 256).astype(np.float32), \
        (np.round(h * 256) / 256 + 1 / 256).astype(np.float32) * (b > 0), b


def _grow_f32(params, dyadic=False, seed=0):
    """One tree of each package on the same float32 inputs (no dp)."""
    X, y = _problem(seed)
    X[:, 2] = np.nan_to_num(X[:, 2])
    dj = lj.Dataset(X, label=y, params=params).construct().constructed
    dt = lt.Dataset(X, label=y, params=dict(params, device_type="cpu")) \
        .construct().constructed
    n_pad = dj.num_data_padded
    g, h, b = _dyadic_grads(y, n_pad, seed) if dyadic \
        else _grads(seed, y, n_pad)
    jl = WaveTPUTreeLearner(JConfig.from_params(dict(params, **JAX_SCAN)),
                            dj)
    rj = jl.train_async(jnp.asarray(g), jnp.asarray(h), jnp.asarray(b))
    wave = WaveTreeLearner(TConfig.from_params(params), dt, CPU)
    rw = wave.grow(*(torch.from_numpy(a) for a in (g, h, b)))
    return jl, rj, wave, rw


@pytest.mark.parametrize("open_levels", [0, 5])
def test_quant_tree_equals_jax(open_levels):
    """Quant on (and with the opening): the same float32 gradients
    quantize to the same lanes, so the structure and the exact counts are
    equal; the renewed leaf values agree within 1e-6 (the count channel's
    FixHistogram sums are not exact, so its float fields may differ in the
    last bits)."""
    params = dict(F32, tpu_quantized_grad="on",
                  tpu_wave_open_levels=open_levels)
    jl, rj, wave, rw = _grow_f32(params)
    assert jl._quant and jl._use_fused and wave._quant and wave._use_fused
    rec_j, cnt_j, _, leaf_j, out_j = (np.asarray(a) for a in rj)
    rf, ri, leaf_t, out_t = rw
    nv = int((rf[:, 0] > 0.5).sum())
    assert nv == int((rec_j[:, 0] > 0.5).sum()) == wave.budget
    np.testing.assert_array_equal(rf[:, :5], rec_j[:, :5])
    np.testing.assert_array_equal(rf[:, -1], rec_j[:, -1])
    np.testing.assert_array_equal(ri, cnt_j)
    np.testing.assert_array_equal(leaf_t.numpy(), leaf_j)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(rf, rec_j, rtol=1e-5, atol=1e-6)
    calls = wave.kernel_calls
    stats = wave.tree_stats[-1]
    # every growth wave runs the fused kernel, the one queued past the
    # last (a no-op) too
    assert calls["fused_scan"] == stats["waves"] - stats["open_levels"] + 1
    assert stats["waves"] > stats["open_levels"]
    assert calls["hist_packed_quant"] == 1
    assert calls["hist_multislot_quant"] == stats["open_levels"] \
        == wave.open_levels == min(open_levels, 3)
    assert calls["hist_segments_quant"] == calls["hist_segments"] > 0


def test_f32_opening_tree_equals_jax_dyadic():
    """Float32 with the opening on dyadic gradients: records exact."""
    params = dict(F32, tpu_wave_open_levels=3)
    _, rj, wave, rw = _grow_f32(params, dyadic=True)
    rec_j, cnt_j, _, leaf_j, out_j = (np.asarray(a) for a in rj)
    rf, ri, leaf_t, out_t = rw
    np.testing.assert_array_equal(rf, rec_j)
    np.testing.assert_array_equal(ri, cnt_j)
    np.testing.assert_array_equal(leaf_t.numpy(), leaf_j)
    np.testing.assert_array_equal(out_t.numpy(), out_j)
    assert wave.tree_stats[-1]["open_levels"] == 3
    assert wave.kernel_calls["hist_multislot"] == 3
    assert wave.kernel_calls["fused_scan"] == 0


def _port_booster(params, X, y, rounds, fused=True):
    ds = lt.Dataset(X, label=y, params=params)
    bst = lt.Booster(params, ds)
    if not fused:
        bst.gbdt.learner._use_fused = False
    for _ in range(rounds):
        bst.update()
    return bst


def _auc(y, s):
    order = np.argsort(s, kind="stable")
    r = np.empty(len(s))
    r[order] = np.arange(1, len(s) + 1)
    npos = int((y == 1).sum())
    return (r[y == 1].sum() - npos * (npos + 1) / 2) / (npos * (len(y)
                                                                - npos))


QP = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
      "verbosity": -1, "device_type": "cpu"}


def test_fused_equals_unfused_four_rounds():
    rng = np.random.RandomState(0)
    X = rng.randn(512, 6)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    p = dict(QP, tpu_quantized_grad="on")
    fused = _port_booster(p, X, y, 4)
    unf = _port_booster(p, X, y, 4, fused=False)
    assert fused.gbdt.learner._use_fused and not unf.gbdt.learner._use_fused
    assert fused.gbdt.learner.kernel_calls["fused_scan"] > 0
    assert unf.gbdt.learner.kernel_calls["fused_scan"] == 0
    assert fused.model_to_string() == unf.model_to_string()
    np.testing.assert_array_equal(fused.predict(X), unf.predict(X))


def test_opening_equals_no_opening_dyadic_first_tree():
    """Round 1 of binary logloss without boost_from_average: gradients
    +-0.5 and hessians 0.25, exact float32 sums in any order, so the
    opening changes nothing in the model."""
    rng = np.random.RandomState(3)
    X = rng.randn(3000, 8)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * rng.randn(3000) > 0) \
        .astype(float)
    p = dict(QP, num_leaves=63, min_data_in_leaf=20, max_bin=63,
             boost_from_average=False)
    a = _port_booster(p, X, y, 1)
    b = _port_booster(dict(p, tpu_wave_open_levels=5), X, y, 1)
    assert b.gbdt.learner.open_levels == 5
    assert b.gbdt.learner.tree_stats[0]["open_levels"] == 5
    assert a.model_to_string() == b.model_to_string()


def test_quant_auc_within_contract():
    rng = np.random.RandomState(0)
    X = rng.randn(1024, 8)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.2 * rng.randn(1024) > 0).astype(float)
    f32 = _port_booster(QP, X, y, 20)
    qnt = _port_booster(dict(QP, tpu_quantized_grad="on"), X, y, 20)
    assert qnt.gbdt.learner._quant and not f32.gbdt.learner._quant
    a_f, a_q = _auc(y, f32.predict(X)), _auc(y, qnt.predict(X))
    assert a_f > 0.9
    assert abs(a_f - a_q) <= 1e-3, (a_f, a_q)


def test_quant_gate_silences_follow_jax():
    """``on`` with dp trains float32 sums in dp and keeps the reason;
    ``auto`` stays off; the compact learner never quantizes; bundled data
    quantizes without the fused kernel."""
    X, y = _small()
    p = dict(QP, num_leaves=7)
    auto = _port_booster(p, X, y, 1).gbdt.learner
    assert not auto._quant and "opt-in" in auto._quant_reason
    on = _port_booster(dict(p, tpu_quantized_grad="on"), X, y, 1)
    assert on.gbdt.learner._quant and on.gbdt.learner._quant_reason is None
    dp = _port_booster(dict(p, tpu_quantized_grad="on", gpu_use_dp=True),
                       X, y, 1).gbdt.learner
    assert not dp._quant and "hist_dp" in dp._quant_reason
    cmp = _port_booster(dict(p, tpu_quantized_grad="on",
                             tpu_learner="compact"), X, y, 1).gbdt.learner
    assert type(cmp) is CompactTreeLearner and not cmp._quant
    Xe, ye = _problem(3, efb=True)
    bnd = _port_booster(dict(BASE, gpu_use_dp=False, device_type="cpu",
                             tpu_quantized_grad="on"), Xe, ye, 2)
    ln = bnd.gbdt.learner
    assert ln._bundle is not None and ln._quant and not ln._use_fused
    assert ln.kernel_calls["fused_scan"] == 0
    assert ln.kernel_calls["hist_segments_quant"] > 0
