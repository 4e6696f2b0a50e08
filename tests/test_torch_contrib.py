"""TreeSHAP contributions and the C++ if-else export: the port against
lightgbm_tpu.

Models trained by the port (binary, five classes, one with categorical
splits) go to the JAX package by their text.  ``Booster.predict(...,
pred_contrib=True)`` must equal the JAX package's ``predict_contrib`` on
the same model within 1e-9 (both host float64; the order of the sums is
the same), each row's contributions must sum to the raw score, and
``convert.model_to_if_else`` must write the JAX package's C++ source
character for character.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.contrib import predict_contrib as j_predict_contrib
from lightgbm_tpu.convert import model_to_if_else as j_model_to_if_else
from lightgbm_tpu_torch.convert import model_to_if_else

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

BASE = {"num_leaves": 7, "min_data_in_leaf": 10, "max_bin": 63,
        "verbosity": -1, "device_type": "cpu"}


def _data(seed=0, n=1500):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    X[::9, 2] = np.nan
    X[:, 4] = rng.randint(0, 12, n)
    z = X[:, 0] + np.nan_to_num(X[:, 2]) * X[:, 1] + 0.3 * (X[:, 4] % 3)
    return X, z


@pytest.fixture(scope="module", params=["binary", "multiclass",
                                        "categorical"])
def model(request):
    X, z = _data()
    p = dict(BASE)
    kw = {}
    if request.param == "multiclass":
        p.update(objective="multiclass", num_class=5)
        y = np.digitize(z, np.quantile(z, [0.2, 0.4, 0.6, 0.8]))
    else:
        p.update(objective="binary")
        y = (z > 0.2).astype(float)
        if request.param == "categorical":
            kw["categorical_feature"] = [4]
    bt = lt.train(p, lt.Dataset(X, label=y, params=p, **kw), 4,
                  verbose_eval=False)
    if request.param == "categorical":
        assert any(t.num_cat > 0 for t in bt.gbdt.models)
    return request.param, bt, lj.Booster(model_str=bt.model_to_string())


def test_pred_contrib_equals_jax_and_sums_to_the_raw_score(model):
    kind, bt, bj = model
    n = 80                               # TreeSHAP is a host loop per row
    X, _ = _data(seed=1, n=n)
    X[5, 4] = 40.0                       # an unseen category
    got = bt.predict(X, pred_contrib=True)
    want = j_predict_contrib(bj.gbdt, X)
    k = 5 if kind == "multiclass" else 1
    assert got.shape == want.shape == (n, k * 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    raw = bt.predict(X, raw_score=True).reshape(n, k)
    sums = got.reshape(n, k, 6).sum(axis=2)
    np.testing.assert_allclose(sums, raw, rtol=0, atol=1e-9)


def test_model_to_if_else_equals_jax(model):
    _, bt, bj = model
    src = model_to_if_else(bt.gbdt)
    assert src == j_model_to_if_else(bj.gbdt)
    assert src.count("double PredictTree") == len(bt.gbdt.models)
