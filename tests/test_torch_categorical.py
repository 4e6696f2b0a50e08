"""Categorical trees of the port vs lightgbm_tpu's, per tree and end to end.

One tree from the same numpy gradients (``tests/test_torch_learner.py``'s,
on a 2**-20 grid, so float64 sums are exact in any order) goes through both
packages on ``tests/test_wave.py:test_wave_categorical``'s data (two
categorical columns of 12 and 40 categories, ``max_cat_to_onehot=8``):

  * in dp, the port's wave learner against the JAX ``WaveTPUTreeLearner``
    and the port's compact learner: records, counts, bitsets, leaf ids and
    leaf outputs exactly equal;
  * in dp, the port's masked learner against the JAX ``TPUTreeLearner``'s
    step loop (uint8 and uint16 codes): the same, and the host tree's text;
  * in dp with ``tpu_wave_open_levels=3``, the wave learner against JAX;
  * quantized (float32): structure, counts, bitsets and leaf ids exact,
    floats within 1e-5, as ``test_torch_wave.py:test_quant_tree_equals_jax``.

End to end on ``tests/test_categorical.py``'s data (a one-hot column of 4
categories and a sorted-CTR one of 25): ``lt.train`` and ``lj.train`` write
the same model text, the JAX ``Booster`` loaded from the port's text
predicts what the port predicts, and the held-out metric from the device
traversal equals that of the host predict.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.learner_wave import WaveTPUTreeLearner
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.learner import REC_IS_CAT, MaskedTreeLearner
from lightgbm_tpu_torch.learner_compact import CompactTreeLearner
from lightgbm_tpu_torch.learner_wave import WaveTreeLearner
from test_categorical import PARAMS as E2E_PARAMS
from test_categorical import _make_data
from test_torch_learner import _grads
from test_torch_masked import _jax_unfused

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

CPU = torch.device("cpu")
CATS = [3, 4]
BASE = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
        "min_data_in_leaf": 20, "max_cat_to_onehot": 8, "verbosity": -1,
        "tpu_min_window": 1024, "tpu_wave_defer_sorts": False}


def _wave_data():
    """``tests/test_wave.py:test_wave_categorical``'s rows."""
    rng = np.random.RandomState(13)
    n = 12000
    xn = rng.randn(n, 3)
    c1 = rng.randint(0, 12, n)
    c2 = rng.randint(0, 40, n)
    X = np.column_stack([xn, c1, c2])
    y = ((c1 % 3 == 0).astype(float) * 1.5 + xn[:, 0]
         + (c2 > 20) + 0.3 * rng.randn(n) > 1).astype(float)
    return X, y


def _datasets(params):
    X, y = _wave_data()
    dj = lj.Dataset(X, label=y, categorical_feature=CATS, params=params) \
        .construct().constructed
    dt = lt.Dataset(X, label=y, categorical_feature=CATS,
                    params=dict(params, device_type="cpu")) \
        .construct().constructed
    return dj, dt, _grads(0, y.astype(np.float32), dj.num_data_padded)


def _check_jax(rj, rw, exact=True):
    """The port's (rec_f, rec_i, leaf_id, leaf_out) against the JAX
    learner's (rec_f, rec_i, rec_cat, leaf_id, leaf_out)."""
    rec_j, cnt_j, cat_j, leaf_j, out_j = (np.asarray(a) for a in rj)
    rf, ri, leaf_t, out_t = rw
    np.testing.assert_array_equal(ri[:, :2], cnt_j)
    np.testing.assert_array_equal(ri[:, 2:], cat_j.astype(np.int64))
    np.testing.assert_array_equal(leaf_t.numpy(), leaf_j)
    if exact:
        np.testing.assert_array_equal(rf, rec_j)
        np.testing.assert_array_equal(out_t.to(torch.float32).numpy(), out_j)
    else:
        np.testing.assert_array_equal(rf[:, :5], rec_j[:, :5])
        np.testing.assert_array_equal(rf[:, REC_IS_CAT], rec_j[:, REC_IS_CAT])
        np.testing.assert_allclose(rf, rec_j, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-5,
                                   atol=1e-6)
    nv = int((rf[:, 0] > 0.5).sum())
    cat = rf[:nv, REC_IS_CAT] > 0.5
    assert nv > 0 and cat.any() and (ri[:nv][cat, 2:] != 0).any()
    assert not ri[:nv][~cat, 2:].any()
    return nv


def _grow(params):
    dj, dt, (g, h, b) = _datasets(params)
    jl = WaveTPUTreeLearner(JConfig.from_params(params), dj)
    rj = jl.train_async(*(jnp.asarray(a) for a in (g, h, b)))
    port = WaveTreeLearner(TConfig.from_params(params), dt, CPU)
    rw = port.grow(*(torch.from_numpy(a) for a in (g, h, b)))
    return rj, rw, port, dt, (g, h, b)


def test_dp_wave_tree_equals_jax_and_compact():
    params = dict(BASE, gpu_use_dp=True)
    rj, rw, wave, dt, gh = _grow(params)
    nv = _check_jax(rj, rw)
    assert nv == wave.budget
    rc = CompactTreeLearner(TConfig.from_params(params), dt, CPU).grow(
        *(torch.from_numpy(a) for a in gh))
    np.testing.assert_array_equal(rw[0][:nv], rc[0][:nv])
    np.testing.assert_array_equal(rw[1][:nv], rc[1][:nv])
    assert torch.equal(rw[2], rc[2]) and torch.equal(rw[3], rc[3])
    # the host tree carries the categorical splits, the NaN / "other" bin
    # in no category set
    tree = wave.assemble_host(rw[0], rw[1])
    assert tree.num_cat == int((rw[0][:nv, REC_IS_CAT] > 0.5).sum()) > 0
    assert wave.kernel_calls["split_cat"] == 0      # dp: plain float64


@pytest.mark.parametrize("max_bin", [63, 511])
def test_dp_masked_tree_equals_jax(max_bin):
    params = dict(BASE, gpu_use_dp=True, max_bin=max_bin)
    dj, dt, (g, h, b) = _datasets(params)
    assert dt.bins.dtype == (np.uint16 if max_bin > 255 else np.uint8)
    rec_f, rec_i, leaf_j, tree_j = _jax_unfused(params, dj, g, h, b)
    learner = MaskedTreeLearner(TConfig.from_params(params), dt, CPU)
    rf, ri, leaf_t, _ = learner.grow(
        *(torch.from_numpy(a) for a in (g, h, b)))
    np.testing.assert_array_equal(rf, rec_f)
    np.testing.assert_array_equal(ri[:, :2], rec_i)
    np.testing.assert_array_equal(leaf_t.numpy(), leaf_j)
    tree = learner.assemble_host(rf, ri)
    assert tree.num_cat > 0
    assert tree.to_string() == tree_j.to_string()


def test_dp_opening_tree_equals_jax():
    params = dict(BASE, gpu_use_dp=True, tpu_wave_open_levels=3)
    rj, rw, wave, _, _ = _grow(params)
    _check_jax(rj, rw)
    assert wave.tree_stats[-1]["open_levels"] == 3


def test_quant_tree_equals_jax():
    """Quantized float32 gradients: the JAX package keeps its fused scan
    off with categorical features, and so does the port."""
    params = dict(BASE, tpu_quantized_grad="on")
    rj, rw, wave, _, _ = _grow(params)
    assert wave._quant and not wave._use_fused
    _check_jax(rj, rw, exact=False)
    calls = wave.kernel_calls
    assert calls["fused_scan"] == 0
    assert calls["split_cat"] == calls["split_scan"] > 0


def test_f32_kernel_functions_equal_plain_and_compact():
    """Float32: the wave learner through its kernel functions (the plain
    versions on the CPU) and through PLAIN_KERNELS, the compact and the
    masked learner grow the same tree."""
    from lightgbm_tpu_torch.learner_wave import PLAIN_KERNELS

    params = dict(BASE, tpu_wave_sort_cutoff=512, tpu_sort_cutoff=256)
    _, dt, gh = _datasets(params)
    args = [torch.from_numpy(a) for a in gh]
    cfg = TConfig.from_params(params)
    wave = WaveTreeLearner(cfg, dt, CPU)
    a = wave.grow(*args)
    for other in (WaveTreeLearner(cfg, dt, CPU, PLAIN_KERNELS),
                  CompactTreeLearner(cfg, dt, CPU),
                  MaskedTreeLearner(cfg, dt, CPU)):
        r = other.grow(*args)
        nv = int((a[0][:, 0] > 0.5).sum())
        np.testing.assert_array_equal(a[0][:nv], r[0][:nv])
        np.testing.assert_array_equal(a[1][:nv], r[1][:nv])
        assert torch.equal(a[2], r[2])
    assert wave.kernel_calls["split_cat"] == wave.kernel_calls["split_scan"]


# ---------------------------------------------------------------------------
# End to end.
# ---------------------------------------------------------------------------


def test_train_model_text_equals_jax_and_loads_there():
    X, y = _make_data()
    params = dict(E2E_PARAMS, gpu_use_dp=True)
    bj = lj.train(params, lj.Dataset(X, label=y, categorical_feature=[0, 2]),
                  8)
    bt = lt.train(dict(params, device_type="cpu"),
                  lt.Dataset(X, label=y, categorical_feature=[0, 2]), 8,
                  verbose_eval=False)
    text = bt.model_to_string()
    assert text == bj.model_to_string()
    assert all(t.num_cat > 0 for t in bt.gbdt.models)
    # the JAX package loads the port's text and predicts the same
    np.testing.assert_array_equal(lj.Booster(model_str=text).predict(X),
                                  bt.predict(X))


@pytest.mark.parametrize("cats", [[0, 2], "0,2", "name:c0,c2"])
def test_valid_device_traversal_equals_host_predict(cats):
    X, y = _make_data()
    names = ["c0", "num", "c2"]
    ds = lt.Dataset(X[:1500], label=y[:1500], categorical_feature=cats,
                    feature_name=names)
    dv = ds.create_valid(X[1500:], label=y[1500:])
    evals = {}
    bst = lt.train(dict(E2E_PARAMS, device_type="cpu"), ds, 8,
                   valid_sets=[dv], valid_names=["v"], evals_result=evals,
                   verbose_eval=False)
    assert bst.gbdt.models[0].num_cat > 0
    want = float(np.mean((bst.predict(X[1500:]) - y[1500:]) ** 2))
    np.testing.assert_allclose(evals["v"]["l2"][-1], want, rtol=1e-5)


def test_pandas_category_column_still_raises():
    pd = pytest.importorskip("pandas")
    X, y = _make_data()
    df = pd.DataFrame({"c0": pd.Categorical(X[:, 0].astype(int)),
                       "num": X[:, 1], "c2": X[:, 2]})
    with pytest.raises(NotImplementedError, match="pandas categorical"):
        lt.Dataset(df, label=y, params={"device_type": "cpu"}).construct()
