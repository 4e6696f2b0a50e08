"""Pandas ``category`` columns at predict time: the port against lightgbm_tpu.

A model trained by the JAX package on a DataFrame with an integer
``category`` column stores the column's category list
(``pandas_categorical``).  Carried into the port by its text, the port's
``Booster.predict`` must code a DataFrame's ``category`` columns through
that list, as the JAX ``Booster.predict`` does: a category the model never
saw becomes NaN, and a DataFrame whose count of ``category`` columns differs
from the model's raises ``ValueError``.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

pd = pytest.importorskip("pandas")

PARAMS = {"objective": "binary", "num_leaves": 7, "max_bin": 63,
          "min_data_in_leaf": 5, "verbosity": -1, "metric": "none"}


def _frame(rng, n, cats):
    c = rng.choice(cats, n)
    x0, x1 = rng.randn(n), rng.randn(n)
    df = pd.DataFrame({"x0": x0,
                       "col": pd.Categorical(c, categories=sorted(set(cats))),
                       "x1": x1})
    y = (x0 + 0.08 * (c - 30) + 0.2 * rng.randn(n) > 0).astype(float)
    return df, y


@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.RandomState(21)
    df, y = _frame(rng, 600, np.arange(10, 51))
    bst = lj.train(PARAMS, lj.Dataset(df, label=y, params=PARAMS),
                   num_boost_round=5, verbose_eval=False)
    return bst, rng


def test_port_predicts_a_jax_pandas_model_as_jax(jax_model):
    bst, rng = jax_model
    port = lt.Booster(model_str=bst.model_to_string(),
                      params={"device_type": "cpu"})
    assert port.gbdt.pandas_categorical == bst.gbdt.pandas_categorical
    # categories 0-60: 10-50 seen in training, the others unseen (NaN);
    # the DataFrame's own category list is in another order
    df, _ = _frame(rng, 300, np.arange(0, 61))
    df["col"] = df["col"].cat.reorder_categories(
        list(reversed(df["col"].cat.categories)))
    want = bst.predict(df)
    got = port.predict(df)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    # the codes matter: the raw values predict otherwise
    assert np.abs(port.predict(df.astype({"col": float})) - want).max() \
        > 1e-3


def test_category_column_mismatch_raises_in_both(jax_model):
    bst, rng = jax_model
    port = lt.Booster(model_str=bst.model_to_string(),
                      params={"device_type": "cpu"})
    df, _ = _frame(rng, 50, np.arange(10, 51))
    df["x1"] = pd.Categorical(np.zeros(50, int))
    for b in (bst, port):
        with pytest.raises(ValueError, match="categorical_feature do not "
                                             "match"):
            b.predict(df)
