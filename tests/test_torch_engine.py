"""End to end: lightgbm_tpu_torch.train + predict vs lightgbm_tpu.

Both packages train the compact learner (``tpu_learner=compact``) on the
same float32 numpy data with a held-out set.

  * ``gpu_use_dp`` with the L2 objective: its gradients are float32 in both
    packages (binary logloss gradients come out float64 in the JAX package
    under this suite's ``jax_enable_x64``, float32 in the port), and their
    float64 histogram sums agree, so the trees must match in structure
    (split features, threshold bins, default directions, leaf counts), with
    leaf values and predictions within 1e-5.
  * float32 with the binary objective (the bench workload's): histogram
    sums run in other orders, so the held-out metrics must agree within 1e-4
    per iteration.

A model trained by the JAX package is carried into the port through its
arrays and through model text and must predict within 1e-12 on the host.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.interop import booster_from_jax_arrays

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "learning_rate": 0.2, "min_data_in_leaf": 20, "verbosity": -1,
          "metric": "auc,binary_logloss", "tpu_learner": "compact",
          "bagging_fraction": 0.8, "bagging_freq": 1, "bagging_seed": 5,
          "feature_fraction": 0.9}
ROUNDS = 5


def _problem(regression=False):
    rng = np.random.RandomState(7)
    n, f = 4000, 10
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.1, 2] = np.nan
    X[rng.rand(n) < 0.6, 3] = 0.0
    logit = (X[:, 0] * 1.5 + np.nan_to_num(X[:, 1]) * X[:, 4] * 0.5
             + np.sin(np.nan_to_num(X[:, 2])) + 0.5 * rng.randn(n))
    y = logit if regression else (logit > 0)
    return X.astype(np.float32), y.astype(np.float32)


def _train(lib, params):
    X, y = _problem(params["objective"] == "regression")
    ds = lib.Dataset(X[:3000], label=y[:3000], params=params)
    dv = ds.create_valid(X[3000:], label=y[3000:])
    evals = {}
    bst = lib.train(params, ds, ROUNDS, valid_sets=[dv],
                    valid_names=["heldout"], evals_result=evals,
                    verbose_eval=False)
    return bst, evals, bst.predict(X[3000:])


@pytest.fixture(scope="module")
def dp_pair():
    params = dict(PARAMS, gpu_use_dp=True, objective="regression",
                  metric="l2")
    return (_train(lj, params), _train(lt, dict(params, device_type="cpu")))


def test_dp_trees_match(dp_pair):
    (bj, _, pj), (bt, _, pt) = dp_pair
    assert len(bj.gbdt.models) == len(bt.gbdt.models) == ROUNDS
    for tj, tt in zip(bj.gbdt.models, bt.gbdt.models):
        nl = tj.num_leaves
        assert nl == tt.num_leaves > 1
        ni = nl - 1
        np.testing.assert_array_equal(tt.split_feature[:ni],
                                      tj.split_feature[:ni])
        np.testing.assert_array_equal(tt.threshold_in_bin[:ni],
                                      tj.threshold_in_bin[:ni])
        np.testing.assert_array_equal(tt.decision_type[:ni],
                                      tj.decision_type[:ni])   # default dir
        np.testing.assert_array_equal(tt.leaf_count[:nl], tj.leaf_count[:nl])
        np.testing.assert_allclose(tt.leaf_value[:nl], tj.leaf_value[:nl],
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
    assert bt.model_to_string().splitlines()[:8] == \
        bj.model_to_string().splitlines()[:8]


def test_f32_heldout_metrics_match():
    (_, ej, pj), (_, et, pt) = (_train(lj, PARAMS),
                                _train(lt, dict(PARAMS, device_type="cpu")))
    for m in ("auc", "binary_logloss"):
        a, b = np.asarray(ej["heldout"][m]), np.asarray(et["heldout"][m])
        assert len(a) == len(b) == ROUNDS
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=m)
    assert np.asarray(et["heldout"]["binary_logloss"])[-1] < 0.6


def _tree_arrays(tree):
    out = {k: v for k, v in vars(tree).items() if isinstance(v, np.ndarray)}
    out.update(num_leaves=tree.num_leaves, max_leaves=tree.max_leaves,
               shrinkage=tree.shrinkage, num_cat=tree.num_cat)
    return out


def test_carried_state_predicts_as_jax(dp_pair, tmp_path):
    (bj, _, _), _ = dp_pair
    X, _ = _problem()
    data = bj.gbdt.train_data
    carried = booster_from_jax_arrays(
        [_tree_arrays(t) for t in bj.gbdt.models],
        [m.to_dict() for m in data.bin_mappers], "regression",
        used_feature_map=data.used_feature_map,
        num_total_features=data.num_total_features,
        params={"device_type": "cpu"})
    want = bj.predict(X)
    np.testing.assert_allclose(carried.predict(X), want, rtol=0, atol=1e-12)
    # model text is byte-identical for identical trees
    text = bj.model_to_string()
    assert carried.model_to_string() == text
    via_text = lt.Booster(params={"device_type": "cpu"}, model_str=text)
    np.testing.assert_allclose(via_text.predict(X), want, rtol=0, atol=1e-12)
    path = tmp_path / "model.txt"
    carried.save_model(str(path))
    from_file = lt.Booster(params={"device_type": "cpu"},
                           model_file=str(path))
    np.testing.assert_array_equal(from_file.predict(X), carried.predict(X))


def test_port_model_text_round_trip(dp_pair):
    _, (bt, et, pt) = dp_pair
    X, _ = _problem()
    text = bt.model_to_string()
    again = lt.Booster(params={"device_type": "cpu"}, model_str=text)
    assert again.model_to_string() == text
    np.testing.assert_array_equal(again.predict(X[3000:]), pt)
    np.testing.assert_array_equal(again.predict(X[3000:], raw_score=True),
                                  pt)
    l2 = et["heldout"]["l2"]
    assert all(b < a for a, b in zip(l2, l2[1:]))


def test_device_scores_match_host_predict(dp_pair):
    """The held-out scores the loop keeps on the device (tree traversal over
    bin codes) agree with the host traversal of the raw features."""
    _, (bt, _, pt) = dp_pair
    dev = bt.gbdt.valid_scores[0].np_score().astype(np.float64)
    np.testing.assert_allclose(dev, pt, rtol=0, atol=1e-5)


def test_early_stopping_callback():
    """A learning rate of 1.5 overfits at the second round: training stops
    there and the best iteration is the first."""
    X, y = _problem()
    params = dict(PARAMS, device_type="cpu", learning_rate=1.5,
                  min_data_in_leaf=2, metric="binary_logloss")
    ds = lt.Dataset(X[:3000], label=y[:3000], params=params)
    dv = ds.create_valid(X[3000:], label=y[3000:])
    bst = lt.train(params, ds, ROUNDS, valid_sets=[dv], verbose_eval=False,
                   callbacks=[lt.early_stopping(1, verbose=False)])
    assert bst.best_iteration == 1
    assert bst.num_trees() == 2
    assert set(bst.best_score["valid_0"]) == {"binary_logloss"}
