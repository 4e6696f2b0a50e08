"""Predict-time binning: the port's three binners against lightgbm_tpu's.

``BinnerArrays.bin_host`` (numpy), ``bin_plain`` (torch, the CPU side of
``bin_predict``, whose CUDA kernel ``csrc/bin_predict.cu`` the card tests
hold against it) and the JAX package's jitted ``_bin_device`` and host
``bin_host`` must give the same codes, bit for bit, over mappers fitted on
the same data: numerical features with and without a NaN bin, a
zero-as-missing feature, categorical features with and without NaN, at 63,
255 and 1,023 bins.  The rows hold the adversarial values: NaN, +-inf, -0.0,
values exactly on a bin bound and one ulp either side, 1e30; categories
unseen, negative, fractional (-0.5 is category 0), past the table and NaN.
The suite runs JAX with x64, so the JAX binner searches float64 bounds as
the port does.  Then a model loaded from its text predicts through the
port's device path on a CPU device within 1e-12 of the JAX
``Booster.predict`` of the same text.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.dataset import _ConstructedDataset as JConstructed
from lightgbm_tpu.serving.binner import BinnerArrays as JBinnerArrays
from lightgbm_tpu_torch.binner import (OOV_BIN, BinnerArrays, bin_plain,
                                       bin_predict)
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.dataset import _ConstructedDataset

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

#: columns: 0-1 numerical, 2 numerical with NaN (a NaN bin), 3 numerical
#: zero as missing, 4 categorical (20 levels), 5 categorical with NaN
CATEGORICAL = [4, 5]


def _train_matrix(rng, n=4000):
    X = np.empty((n, 6))
    X[:, 0] = rng.randn(n)
    X[:, 1] = rng.exponential(3.0, n).round(1)        # many ties
    X[:, 2] = rng.randn(n)
    X[::7, 2] = np.nan
    X[:, 3] = np.where(rng.rand(n) < 0.4, 0.0, rng.randn(n))
    X[:, 4] = rng.randint(0, 20, n)
    X[:, 5] = rng.randint(3, 12, n)
    X[::9, 5] = np.nan
    return X


def _adversarial(rng, mappers, used, n=3000):
    """Rows holding every hard value in each column (consecutive blocks),
    the rest random; at least ``n`` rows."""
    hard_num = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e30, -1e30, 1e-40]
    hard_cat = [np.nan, -1.0, -0.5, -0.0, 0.5, 2.7, 19.99, 20.0, 25.0,
                1e10, 1e30, np.inf, -np.inf, -3.5, 2.0 ** 31 + 5]
    cols = []
    for k, j in enumerate(used):
        if j in CATEGORICAL:
            cols.append((j, np.asarray(hard_cat)))
        else:
            b = np.asarray(mappers[k].bin_upper_bound, dtype=np.float64)
            b = b[np.isfinite(b)]
            cols.append((j, np.concatenate([hard_num, b,
                                            np.nextafter(b, np.inf),
                                            np.nextafter(b, -np.inf)])))
    X = _train_matrix(rng, max(n, sum(len(v) for _, v in cols) + 100))
    r = 0
    for j, vals in cols:
        X[r:r + len(vals), j] = vals
        r += len(vals)
    return X


def _datasets(max_bin, seed=0):
    rng = np.random.RandomState(seed)
    X = _train_matrix(rng)
    params = {"max_bin": max_bin, "min_data_in_bin": 1, "verbosity": -1}
    import lightgbm_tpu.config as jconfig

    t = _ConstructedDataset.from_matrix(X, Config.from_params(params),
                                        categorical=CATEGORICAL)
    j = JConstructed.from_matrix(X, jconfig.Config.from_params(params),
                                 categorical=CATEGORICAL)
    return rng, t, j


@pytest.mark.parametrize("max_bin", [63, 255, 1023])
def test_bin_plain_equals_bin_host_and_jax(max_bin):
    rng, t, j = _datasets(max_bin)
    # str: the NaN bin's bound is NaN, which == would not match
    assert str([m.to_dict() for m in t.bin_mappers]) \
        == str([m.to_dict() for m in j.bin_mappers])
    Xp = _adversarial(rng, t.bin_mappers, t.used_feature_map)
    arrs = BinnerArrays.for_data(t)
    host = arrs.bin_host(Xp)
    plain = bin_plain(torch.from_numpy(Xp), arrs.device_arrays("cpu"))
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), host)
    jarr = JBinnerArrays.for_data(j)
    np.testing.assert_array_equal(jarr.bin_host(Xp), host)
    jdev = np.asarray(jarr.bin_device(jarr.select_used(Xp)))
    np.testing.assert_array_equal(jdev, host)
    # the hard values landed where the rules say
    k_cat = list(t.used_feature_map).index(4)
    col = Xp[:, 4]
    oov = ~(np.trunc(np.nan_to_num(col)) >= 0) \
        | (np.trunc(np.nan_to_num(col)) > arrs.cat_max[k_cat])
    assert (host[k_cat][oov] == OOV_BIN).all() and oov.sum() > 5
    assert host[k_cat][col == -0.5][0] == host[k_cat][col == -0.0][0]
    k_nan = list(t.used_feature_map).index(2)
    assert (host[k_nan][np.isnan(Xp[:, 2])] == arrs.nan_bin[k_nan]).all()


def test_bin_predict_on_cpu_is_the_plain_version_and_counts_nothing():
    rng, t, _ = _datasets(255, seed=3)
    arrs = BinnerArrays.for_data(t)
    Xp = _adversarial(rng, t.bin_mappers, t.used_feature_map)
    before = bin_predict.launches
    got = arrs.bin_device(Xp, "cpu")
    assert bin_predict.launches == before
    np.testing.assert_array_equal(got.numpy(), arrs.bin_host(Xp))
    assert arrs.device_arrays("cpu") is arrs.device_arrays("cpu")


def test_padding_rows_and_empty_input():
    rng, t, _ = _datasets(63, seed=4)
    arrs = BinnerArrays.for_data(t)
    assert arrs.f_pad == t.bins.shape[0] > t.num_used_features
    Xp = _adversarial(rng, t.bin_mappers, t.used_feature_map)
    got = bin_plain(torch.from_numpy(Xp), arrs.device_arrays("cpu"))
    assert got.shape == (arrs.f_pad, len(Xp))
    assert int(got[t.num_used_features:].abs().sum()) == 0
    empty = bin_plain(torch.zeros((0, 6), dtype=torch.float64),
                      arrs.device_arrays("cpu"))
    assert empty.shape == (arrs.f_pad, 0)


def test_device_path_bins_on_the_device_not_the_host():
    """A model carried by its text into both packages (categorical splits
    included) predicts through the port's device path on a CPU device:
    binned by ``bin_device`` (never ``bin_host``) over a bin schema rebuilt
    from the text, within 1e-12 of the JAX ``Booster.predict``."""
    rng = np.random.RandomState(8)
    X = _train_matrix(rng, 3000)
    y = (np.nan_to_num(X[:, 0]) + (X[:, 4] > 9) > 0.5).astype(float)
    params = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
              "min_data_in_leaf": 10, "max_bin": 63, "device_type": "cpu"}
    text = lt.train(params, lt.Dataset(X, label=y, params=params,
                                       categorical_feature=CATEGORICAL),
                    4, verbose_eval=False).model_to_string()
    bj = lj.Booster(model_str=text)
    assert any(t.num_cat > 0 for t in bj.gbdt.models)
    Xp = _adversarial(rng, [], [], n=50_000)
    bl = lt.Booster(params={"device_type": "cpu"}, model_str=text)
    host_calls = BinnerArrays.host_calls
    got = bl.predict(Xp, raw_score=True)           # 50,000 x 4 trees
    assert bl.gbdt.device_predictions == 1
    assert BinnerArrays.host_calls == host_calls
    np.testing.assert_allclose(got, bj.predict(Xp, raw_score=True), rtol=0,
                               atol=1e-12)
