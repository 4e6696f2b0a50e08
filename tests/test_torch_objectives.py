"""Port objectives and score plumbing vs lightgbm_tpu: sample weights,
init scores, label weighting.

Same float32 data through both packages' ``train`` with the compact
learner.  The L2 case runs in dp, where both packages' gradients are
float32 and their float64 histogram sums agree, so the trees match in
structure and leaf values within 1e-5; the binary case runs in float32
(summation order differs): held-out metrics within 1e-4 per iteration.
"""

import numpy as np

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt

ROUNDS = 4


def _data(seed, binary):
    rng = np.random.RandomState(seed)
    n = 3000
    X = rng.randn(n, 8).astype(np.float32)
    z = X[:, 0] - 0.7 * X[:, 1] * X[:, 2] + 0.4 * rng.randn(n)
    y = (z > 0.3) if binary else z
    w = rng.uniform(0.2, 2.0, n)
    init = 0.1 * rng.randn(n)
    return X, y.astype(np.float32), w.astype(np.float32), init


def _train(lib, params, binary, seed):
    X, y, w, init = _data(seed, binary)
    ds = lib.Dataset(X[:2400], label=y[:2400], weight=w[:2400],
                     init_score=init[:2400], params=params)
    dv = ds.create_valid(X[2400:], label=y[2400:], weight=w[2400:],
                         init_score=init[2400:])
    ev = {}
    bst = lib.train(params, ds, ROUNDS, valid_sets=[dv],
                    valid_names=["heldout"], evals_result=ev,
                    verbose_eval=False)
    return bst, ev


BASE = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 20,
        "verbosity": -1, "tpu_learner": "compact", "learning_rate": 0.3}


def test_weighted_l2_with_init_score_dp_trees_match():
    params = dict(BASE, objective="regression", metric="l2,l1",
                  gpu_use_dp=True)
    (bj, ej), (bt, et) = (_train(lj, params, False, 0),
                          _train(lt, dict(params, device_type="cpu"), False,
                                 0))
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
    for m in ("l2", "l1"):
        np.testing.assert_allclose(et["heldout"][m], ej["heldout"][m],
                                   rtol=1e-6, atol=1e-7, err_msg=m)
    X, *_ = _data(0, False)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=0,
                               atol=1e-5)


def test_weighted_unbalanced_binary_f32_metrics_match():
    params = dict(BASE, objective="binary", metric="auc,binary_logloss",
                  scale_pos_weight=2.0)
    (_, ej), (_, et) = (_train(lj, params, True, 1),
                        _train(lt, dict(params, device_type="cpu"), True, 1))
    for m in ("auc", "binary_logloss"):
        a, b = np.asarray(ej["heldout"][m]), np.asarray(et["heldout"][m])
        assert len(a) == len(b) == ROUNDS
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=m)
