"""The scikit-learn estimators and the plotting helpers: the port against
lightgbm_tpu.

``LGBMRegressor``, ``LGBMClassifier`` (string labels) and ``LGBMRanker``
fitted with the same arguments in both packages must predict within 1e-6 of
each other, with ``gpu_use_dp`` (ROADMAP.md "What held against the
reference means"; the regressor's L2 model text is equal, the binary and
ranking gradients are float64 in the JAX package and float32 in the port).
The estimators run the masked learner in both packages: the JAX package
compiles its programs in a few seconds, where the wave learner's take three
times as long.  Neither module imports scikit-learn.  The plotting helpers
draw from a fitted estimator where matplotlib and graphviz are installed.
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

KW = dict(n_estimators=5, num_leaves=15, min_child_samples=20, max_bin=63,
          gpu_use_dp=True, silent=True, tpu_learner="masked")


def _data(seed=0, n=1200):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    z = X[:, 0] + 0.5 * X[:, 1] ** 2 + 0.1 * rng.randn(n)
    return X, z


@pytest.fixture(scope="module")
def regressors():
    X, z = _data()
    return (X, lt.LGBMRegressor(device_type="cpu", **KW).fit(X, z),
            lj.LGBMRegressor(**KW).fit(X, z))


def test_regressor_equals_jax(regressors):
    X, t, j = regressors
    Xt, _ = _data(seed=1, n=300)
    np.testing.assert_allclose(t.predict(Xt), j.predict(Xt), rtol=0,
                               atol=1e-6)
    assert t.booster_.model_to_string() == j.booster_.model_to_string()
    np.testing.assert_array_equal(t.feature_importances_,
                                  j.feature_importances_)
    assert t.n_features_ == 6 and t.get_params()["num_leaves"] == 15
    contrib = t.predict(Xt[:20], pred_contrib=True)
    np.testing.assert_allclose(contrib.sum(axis=1),
                               t.predict(Xt[:20], raw_score=True), rtol=0,
                               atol=1e-9)


def test_classifier_equals_jax():
    X, z = _data(seed=2)
    y = np.where(z > 0.3, "yes", "no")
    t = lt.LGBMClassifier(device_type="cpu", **KW).fit(X, y)
    j = lj.LGBMClassifier(**KW).fit(X, y)
    Xt, _ = _data(seed=3, n=300)
    np.testing.assert_allclose(t.predict_proba(Xt), j.predict_proba(Xt),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t.predict(Xt), j.predict(Xt))
    assert list(t.classes_) == ["no", "yes"] and t.n_classes_ == 2


def test_ranker_equals_jax():
    X, z = _data(seed=4)
    rel = np.digitize(z, [0, 0.7, 1.5])
    group = np.full(40, 30)
    t = lt.LGBMRanker(device_type="cpu", **KW).fit(X, rel, group=group)
    j = lj.LGBMRanker(**KW).fit(X, rel, group=group)
    Xt, _ = _data(seed=5, n=300)
    np.testing.assert_allclose(t.predict(Xt), j.predict(Xt), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="group"):
        lt.LGBMRanker(device_type="cpu", **KW).fit(X, rel)


def test_no_scikit_learn_import():
    import lightgbm_tpu_torch.sklearn as mod

    src = open(mod.__file__).read()
    assert "import sklearn" not in src and "from sklearn" not in src
    with pytest.raises(ValueError, match="not fitted"):
        lt.LGBMRegressor().predict(np.zeros((2, 6)))


def test_plotting(regressors):
    X, t, _ = regressors
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    ax = lt.plot_importance(t)
    assert len(ax.patches) > 0
    fitted = lt.LGBMRegressor(device_type="cpu", **KW).fit(
        X, X[:, 0], eval_set=[(X, X[:, 0])], eval_metric="l2")
    ax = lt.plot_metric(fitted)
    assert ax.get_lines()
    graphviz = pytest.importorskip("graphviz")
    graph = lt.create_tree_digraph(t, tree_index=1,
                                   show_info=["leaf_count"])
    assert isinstance(graph, graphviz.Digraph)
    assert graph.source.count("leaf") >= 2
