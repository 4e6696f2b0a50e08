"""Port masked learner vs lightgbm_tpu's TPUTreeLearner, routing, end to end.

One tree from the same float32 gradients (on a 2**-20 grid, so float64 sums
are exact in any order) through both packages with ``gpu_use_dp``: the
records, their exact counts, the leaf ids and the assembled tree must be
EXACTLY equal.  The JAX side runs its unfused step loop (``_jit_init`` then
``num_leaves - 1`` ``_jit_step`` calls, `learner.py:606-624`), the loop the
port carries over, so even the no-op records after an early stop match.  In
float32 the structure must match and leaf values agree within 1e-4 of
themselves.  The fixture's NaN column is dropped from the 31-leaf trees: a
leaf without missing rows makes ``default_left`` a rounding near-tie
(ROADMAP.md Queue C).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.learner import TPUTreeLearner
from lightgbm_tpu.learner_compact import \
    create_tree_learner as j_create_tree_learner
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.learner import (REC_GAIN, REC_LEFT_OUT,
                                        REC_RIGHT_OUT, MaskedTreeLearner)
from lightgbm_tpu_torch.learner_compact import (CompactTreeLearner,
                                                create_tree_learner)
from lightgbm_tpu_torch.learner_wave import WaveTreeLearner

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

CPU = torch.device("cpu")
BASE = {"objective": "binary", "min_data_in_leaf": 10, "verbosity": -1,
        "tpu_learner": "masked"}


def _problem(seed, nan_col=True, n=4000, f=8):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.1, 2] = np.nan
    X[rng.rand(n) < 0.6, 3] = 0.0
    if not nan_col:
        X[:, 2] = np.nan_to_num(X[:, 2])
    y = (X[:, 0] * 1.5 + np.nan_to_num(X[:, 2]) + 0.5 * rng.randn(n) > 0)
    return X.astype(np.float32), y.astype(np.float32)


def _grads(seed, y, n_pad):
    """Binary-logloss-like gradients on a 2**-20 grid, a 90% bag, zero
    padding."""
    rng = np.random.RandomState(seed + 100)
    n = len(y)
    grad, hess, bag = (np.zeros(n_pad, np.float32) for _ in range(3))
    p = 1.0 / (1.0 + np.exp(-rng.randn(n)))
    grid = 2.0 ** 20
    grad[:n] = np.round((p - y) * grid) / grid
    hess[:n] = np.round(np.maximum(p * (1.0 - p), 1e-3) * grid) / grid
    bag[:n] = rng.rand(n) < 0.9
    return grad, hess, bag


def _datasets(params, seed, nan_col):
    X, y = _problem(seed, nan_col)
    dj = lj.Dataset(X, label=y, params=params).construct().constructed
    dt = lt.Dataset(X, label=y, params=dict(params, device_type="cpu")) \
        .construct().constructed
    return dj, dt, _grads(seed, y, dj.num_data_padded)


def _jax_unfused(params, dj, g, h, b):
    jl = TPUTreeLearner(JConfig.from_params(params), dj)
    fm = jnp.ones(jl.num_features, bool)
    args = [jnp.asarray(a) for a in (g, h, b)]
    st = jl._jit_init(*args, fm)
    for i in range(jl.num_leaves - 1):
        st = jl._jit_step(st, *args, fm, jnp.asarray(i, jnp.int32))
    rec_f, rec_i = np.asarray(st.records), np.asarray(st.rec_i)
    tree = jl._assemble(rec_f, np.asarray(st.rec_cat), rec_i)
    return rec_f, rec_i, np.asarray(st.leaf_id), tree


@pytest.mark.parametrize("max_bin,leaves,nan_col,extra", [
    (511, 31, False, {}),          # uint16 codes
    (511, 15, True, {}),           # uint16 codes, NaN-typed feature
    # uint8 codes; the depth limit stops the tree early, so the last steps
    # are no-ops whose (invalid) records must match too
    (63, 31, False, {"max_depth": 4, "lambda_l1": 0.1, "lambda_l2": 1.0,
                     "min_gain_to_split": 0.01,
                     "min_sum_hessian_in_leaf": 0.5}),
])
def test_dp_tree_exactly_equals_jax(max_bin, leaves, nan_col, extra):
    params = dict(BASE, max_bin=max_bin, num_leaves=leaves, gpu_use_dp=True,
                  **extra)
    dj, dt, (g, h, b) = _datasets(params, max_bin + leaves, nan_col)
    assert dt.bins.dtype == (np.uint16 if max_bin > 255 else np.uint8)
    rec_f, rec_i, leaf_j, tree_j = _jax_unfused(params, dj, g, h, b)
    learner = MaskedTreeLearner(TConfig.from_params(params), dt, CPU)
    tree, leaf_t, _ = learner.train(*(torch.from_numpy(a) for a in (g, h, b)))
    rf, ri, _, _ = learner.grow(*(torch.from_numpy(a) for a in (g, h, b)))
    splits = int((rf[:, 0] > 0.5).sum())
    assert splits == leaves - 1 if not extra else 0 < splits <= 15
    np.testing.assert_array_equal(rf, rec_f)
    np.testing.assert_array_equal(ri, rec_i)
    np.testing.assert_array_equal(leaf_t.numpy(), leaf_j)
    assert tree.to_string() == tree_j.to_string()
    # one host read per tree (the records); dp runs the plain float64
    # histogram on every device, so no kernel call is counted
    assert learner.host_syncs == 2
    assert learner.kernel_calls["hist_full"] == 0


def test_f32_structure_equal_values_close():
    params = dict(BASE, max_bin=511, num_leaves=31)
    dj, dt, (g, h, b) = _datasets(params, 5, False)
    rec_f, rec_i, leaf_j, _ = _jax_unfused(params, dj, g, h, b)
    learner = MaskedTreeLearner(TConfig.from_params(params), dt, CPU)
    rf, ri, leaf_t, _ = learner.grow(*(torch.from_numpy(a) for a in (g, h, b)))
    # valid / leaf / feature / threshold / default_left, exact counts
    np.testing.assert_array_equal(rf[:, :5], rec_f[:, :5])
    np.testing.assert_array_equal(ri, rec_i)
    np.testing.assert_array_equal(leaf_t.numpy(), leaf_j)
    # float32 histograms summed in two orders, the larger child's by a
    # subtraction from its parent: leaf values and gains move by ~1e-4 of
    # themselves (ROADMAP.md Queue C measures that scale on split gains)
    out = [REC_LEFT_OUT, REC_RIGHT_OUT]
    np.testing.assert_allclose(rf[:, out], rec_f[:, out], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(rf[:, REC_GAIN], rec_f[:, REC_GAIN], rtol=1e-4)
    # every histogram of the tree went through the hist_full wrapper
    assert learner.kernel_calls["hist_full"] == 31


@pytest.mark.parametrize("dp", [False, True])
def test_masked_equals_compact_and_wave(dp):
    """Within the port at 63 bins, as tests/test_compact.py holds the JAX
    learners: the same records, counts and leaf ids from all three."""
    params = dict(BASE, max_bin=63, num_leaves=31, gpu_use_dp=dp)
    _, dt, grads = _datasets(params, 9, False)
    cfg = TConfig.from_params(params)
    g, h, b = (torch.from_numpy(a) for a in grads)
    rm, im, lm, om = MaskedTreeLearner(cfg, dt, CPU).grow(g, h, b)
    for cls in (CompactTreeLearner, WaveTreeLearner):
        r, i, lid, out = cls(cfg, dt, CPU).grow(g, h, b)
        np.testing.assert_array_equal(r, rm)
        np.testing.assert_array_equal(i, im)
        assert torch.equal(lid, lm)
        assert torch.equal(out.to(torch.float32), om.to(torch.float32))


def _route(create, cfg, data, capsys):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        learner = create(cfg, data)
    said = capsys.readouterr().out.replace("[lightgbm_tpu]",
                                           "[lightgbm_tpu_torch]")
    return learner, said, [str(w.message) for w in caught
                           if "requested" in str(w.message)]


@pytest.mark.parametrize("mode,max_bin", [("masked", 63), ("auto", 511),
                                          ("wave", 511), ("compact", 511)])
def test_factory_routes_and_says_what_jax_says(mode, max_bin, capsys):
    params = {"objective": "binary", "max_bin": max_bin, "num_leaves": 7,
              "tpu_learner": mode, "verbosity": 1}
    X, y = _problem(1)
    dj = lj.Dataset(X, label=y, params=params).construct().constructed
    dt = lt.Dataset(X, label=y, params=dict(params, device_type="cpu")) \
        .construct().constructed
    lj_, said_j, warn_j = _route(
        j_create_tree_learner, JConfig.from_params(params), dj, capsys)
    lt_, said_t, warn_t = _route(
        lambda c, d: create_tree_learner(c, d, CPU),
        TConfig.from_params(dict(params, device_type="cpu")), dt, capsys)
    assert type(lj_) is TPUTreeLearner
    assert type(lt_) is MaskedTreeLearner
    assert said_t == said_j
    assert warn_t == warn_j
    assert ("masked learner" in said_t + "".join(warn_t)) == (mode != "masked")


def test_parallel_tree_learner_still_raises():
    """``num_machines`` trains as in the JAX package (it deals only a
    stream's rows); ``tree_learner=data`` past 256 bins gets the masked
    learner from the factory and, in a world of one rank, trains the serial
    model (under a process group the masked learner trains sharded:
    ``tests/test_torch_parallel.py``)."""
    X, y = _problem(2)
    params = dict(BASE, max_bin=511, tree_learner="data", device_type="cpu")
    two = dict(params, num_machines=2)
    jtwo = {k: v for k, v in two.items() if k != "device_type"}
    assert lt.train(two, lt.Dataset(X, label=y), 1,
                    verbose_eval=False).num_trees() \
        == lj.train(jtwo, lj.Dataset(X, label=y), 1,
                    verbose_eval=False).num_trees() == 1
    dt = lt.Dataset(X, label=y, params=params).construct().constructed
    assert type(create_tree_learner(TConfig.from_params(params), dt,
                                    CPU)) is MaskedTreeLearner
    serial = dict(params, tree_learner="serial")
    texts = [[ln for ln in lt.train(p, lt.Dataset(X, label=y), 2,
                                    verbose_eval=False)
              .model_to_string().splitlines()
              if not ln.startswith("[tree_learner")]
             for p in (params, serial)]
    assert texts[0] == texts[1]


def test_compact_learner_refuses_codes_past_a_byte():
    """The factory sends such data to the masked learner; the compact
    learner itself still refuses it (its codes pack four to a word)."""
    X, y = _problem(3)
    params = dict(BASE, max_bin=511, device_type="cpu")
    dt = lt.Dataset(X, label=y, params=params).construct().constructed
    with pytest.raises(ValueError, match="masked learner"):
        CompactTreeLearner(TConfig.from_params(params), dt, CPU)


def test_train_end_to_end_equals_jax():
    """``lt.train`` against ``lj.train`` at 511 bins (auto routes both to the
    masked learner), L2 objective with ``gpu_use_dp`` and a held-out set:
    the same model text, predictions within 1e-5."""
    rng = np.random.RandomState(7)
    n = 4000
    X = rng.randn(n, 8)
    X[rng.rand(n) < 0.6, 3] = 0.0
    y = X[:, 0] * 1.5 + X[:, 1] * X[:, 4] * 0.5 + 0.5 * rng.randn(n)
    X, y = X.astype(np.float32), y.astype(np.float32)
    params = {"objective": "regression", "num_leaves": 15, "max_bin": 511,
              "learning_rate": 0.2, "min_data_in_leaf": 20, "verbosity": -1,
              "metric": "l2", "gpu_use_dp": True}
    out = {}
    for lib, extra in ((lj, {}), (lt, {"device_type": "cpu"})):
        p = dict(params, **extra)
        ds = lib.Dataset(X[:3000], label=y[:3000], params=p)
        dv = ds.create_valid(X[3000:], label=y[3000:])
        bst = lib.train(p, ds, 5, valid_sets=[dv], verbose_eval=False)
        out[lib] = (bst, bst.model_to_string(), bst.predict(X[3000:]))
    assert type(out[lt][0].gbdt.learner) is MaskedTreeLearner
    assert type(out[lj][0].gbdt.learner) is TPUTreeLearner
    assert out[lt][1] == out[lj][1]
    np.testing.assert_allclose(out[lt][2], out[lj][2], rtol=0, atol=1e-5)
