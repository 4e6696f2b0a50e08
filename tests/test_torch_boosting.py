"""The port's boosting variants against ``lightgbm_tpu``'s: GOSS, DART and
random forest on the same data and config.

Trees are held as the ROADMAP's ground rules say: the L2 objective with
``gpu_use_dp``, where the wave learner's trees are exact in both packages,
so split features, thresholds, default directions and counts must be equal
and leaf values within 1e-5.  GOSS's uniform draws cannot be the JAX
package's threefry stream, so ``GOSS._goss_uniform`` is replaced with JAX's
draws for the comparison; the selection itself (``goss_select``) is held
bitwise against JAX ``_goss_select`` on the same draws, ties included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.boosting.goss import _goss_select
from lightgbm_tpu_torch.boosting import GOSS, create_boosting
from lightgbm_tpu_torch.boosting.goss import goss_select

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

PARAMS = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
          "learning_rate": 0.3, "min_data_in_leaf": 20, "verbosity": -1,
          "metric": "l2", "gpu_use_dp": True}


def _data(n=1200, f=6, seed=4):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
         + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _jax_uniform(self, iter_):
    """JAX GOSS's draws of iteration ``iter_`` (``goss.py:75-77``)."""
    key = jax.random.fold_in(jax.random.PRNGKey(self.cfg.bagging_seed),
                             iter_)
    n = self.train_data.num_data_padded
    return torch.from_numpy(np.asarray(jax.random.uniform(key, (n,))))


def _train(lib, params, rounds, X, y, valid=False, **kw):
    p = dict(params, device_type="cpu") if lib is lt else dict(params)
    ds = lib.Dataset(X, label=y, params=p)
    vs = [ds.create_valid(X[:300], label=y[:300])] if valid else None
    ev = {}
    bst = lib.train(p, ds, rounds, valid_sets=vs, evals_result=ev,
                    verbose_eval=False, **kw)
    return bst, ev


def tree_fields(bst):
    """Per tree the model text's fields, parsed."""
    out = []
    for t in bst.model_to_string().split("Tree=")[1:]:
        t = t.split("end of trees")[0]
        out.append(dict(ln.split("=", 1) for ln in t.splitlines()
                        if "=" in ln))
    return out


def assert_same_trees(bt, bj, rtol=1e-5):
    """Structure, thresholds, default directions and counts equal; leaf
    and internal values within ``rtol``; gains within 1e-5 relative."""
    ft, fj = tree_fields(bt), tree_fields(bj)
    assert len(ft) == len(fj)
    for i, (a, b) in enumerate(zip(ft, fj)):
        assert a.keys() == b.keys(), i
        for key in a:
            if key in ("leaf_value", "internal_value", "split_gain",
                       "shrinkage"):
                x = np.array(a[key].split(), np.float64)
                z = np.array(b[key].split(), np.float64)
                np.testing.assert_allclose(x, z, rtol=rtol, atol=1e-9,
                                           err_msg=f"tree {i} {key}")
            else:
                assert a[key] == b[key], (i, key)


# ---------------------------------------------------------------------------
# GOSS
# ---------------------------------------------------------------------------


def _goss_fixture(kind, n=1024, k=1, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "tied":
        # a few distinct magnitudes: ties straddle the top-k cut
        g = rng.choice([-1.0, -0.5, 0.5, 1.0], (k, n)).astype(np.float32)
        h = np.full((k, n), 0.25, np.float32)
    else:
        g = rng.randn(k, n).astype(np.float32)
        h = rng.rand(k, n).astype(np.float32) + 0.1
    valid = np.zeros(n, np.float32)
    valid[:n - 24] = 1.0
    return g, h, valid


@pytest.mark.parametrize("kind,k", [("random", 1), ("tied", 1),
                                    ("random", 3), ("tied", 3)])
def test_goss_select_equals_jax(kind, k):
    g, h, valid = _goss_fixture(kind, k=k)
    n = g.shape[1]
    top_k, other_k = int(1000 * 0.2), int(1000 * 0.1)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    u = np.asarray(jax.random.uniform(key, (n,)))
    bj, aj = _goss_select(jnp.asarray(g), jnp.asarray(h), jnp.asarray(valid),
                          key, top_k=top_k, other_k=other_k)
    bt, at = goss_select(torch.from_numpy(g), torch.from_numpy(h),
                         torch.from_numpy(valid), torch.from_numpy(u.copy()),
                         top_k, other_k)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert at.dtype == torch.float32
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj, np.float32))
    assert (bt.numpy()[n - 24:] == 0).all()
    if kind == "tied":
        # the top set keeps the lowest row indices among equal magnitudes
        mag = np.abs(g * h).sum(0)
        cut = np.sort(mag[:n - 24])[::-1][top_k - 1]
        tied = np.flatnonzero((mag == cut) & (valid > 0))
        top = bt.numpy()[tied] > 0
        assert top[:1].all() and not top.all()


@pytest.mark.parametrize("learner", ["wave", "compact"])
def test_goss_trees_equal_jax(learner, monkeypatch):
    """learning_rate 0.5: iterations 0 and 1 unsampled, 2.. sampled."""
    monkeypatch.setattr(GOSS, "_goss_uniform", _jax_uniform)
    X, y = _data()
    params = dict(PARAMS, boosting="goss", learning_rate=0.5,
                  tpu_learner=learner, top_rate=0.3, other_rate=0.2)
    bj, _ = _train(lj, params, 5, X, y)
    draws = []

    def record(env):               # the sampled iterations' draws
        d = env.model.gbdt.last_draw
        if d is not None and (not draws or draws[-1][0] != d[0]):
            draws.append(d)

    bt, _ = _train(lt, params, 5, X, y, callbacks=[record])
    assert type(bt.gbdt) is GOSS
    assert type(bt.gbdt.learner).__name__ == {
        "wave": "WaveTreeLearner", "compact": "CompactTreeLearner"}[learner]
    # both learners grow trees with no host read (train_async): GOSS
    # pipelines on either, as in the JAX package
    assert bt.gbdt._can_pipeline()
    assert [d[0] for d in draws] == [2, 3, 4]
    assert_same_trees(bt, bj)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-5,
                               atol=1e-6)
    # a sampled tree's root holds top_k plus the drawn rest
    for (it, top_k, rows), tree in zip(draws, bt.gbdt.models[2:]):
        assert int(rows) == tree.internal_count[0]
        assert top_k < int(rows) < 1200


def test_goss_refuses_bagging_and_bad_rates():
    X, y = _data(n=300)
    for extra in ({"bagging_fraction": 0.5, "bagging_freq": 1},
                  {"top_rate": 0.8, "other_rate": 0.5}):
        p = dict(PARAMS, boosting="goss", device_type="cpu", **extra)
        with pytest.raises(ValueError):
            lt.train(p, lt.Dataset(X, label=y, params=p), 1,
                     verbose_eval=False)


# ---------------------------------------------------------------------------
# DART
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [
    {"uniform_drop": True}, {}, {"xgboost_dart_mode": True},
    {"skip_drop": 0.0, "drop_rate": 0.5, "max_drop": 2}])
def test_dart_trees_equal_jax(extra):
    X, y = _data()
    params = dict(dict(PARAMS, boosting="dart", skip_drop=0.2,
                       drop_rate=0.3), **extra)
    bj, ej = _train(lj, params, 6, X, y, valid=True)
    bt, et = _train(lt, params, 6, X, y, valid=True)
    assert not bt.gbdt._can_pipeline()
    assert bt.gbdt.tree_weight == pytest.approx(bj.gbdt.tree_weight)
    assert bt.gbdt.drop_index == bj.gbdt.drop_index
    assert_same_trees(bt, bj)
    np.testing.assert_allclose(et["valid_0"]["l2"], ej["valid_0"]["l2"],
                               rtol=1e-5)
    # large batches take the device predictor, rebuilt after every
    # iteration's in-place edits
    Xb = np.tile(X, (30, 1))
    dev = bt.predict(Xb)
    assert bt.gbdt.device_predictions == 1
    host = np.zeros(len(Xb))
    for t in bt.gbdt.models:
        host += t.predict(Xb.astype(np.float64))
    np.testing.assert_allclose(dev, host, rtol=1e-5, atol=1e-6)


def test_dart_never_stops_early():
    X, y = _data(n=600)
    p = dict(PARAMS, boosting="dart", device_type="cpu")
    ds = lt.Dataset(X, label=y, params=p)
    with pytest.warns(UserWarning, match="dart"):
        bst = lt.train(p, ds, 6, valid_sets=[ds.create_valid(X, label=y)],
                       early_stopping_rounds=1, verbose_eval=False)
    assert bst.num_trees() == 6
    assert not bst.gbdt.eval_and_check_early_stopping()


# ---------------------------------------------------------------------------
# Random forest
# ---------------------------------------------------------------------------


def test_rf_binary_equals_jax():
    X, y = _data()
    yb = (y > 0).astype(np.float32)
    params = dict(PARAMS, objective="binary", boosting="rf",
                  bagging_fraction=0.632, bagging_freq=1,
                  feature_fraction=0.8, metric="binary_logloss")
    bj, ej = _train(lj, params, 5, X, yb, valid=True)
    bt, et = _train(lt, params, 5, X, yb, valid=True)
    assert bt.gbdt.average_output and "average_output" in \
        bt.model_to_string()
    assert_same_trees(bt, bj)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-5)
    np.testing.assert_allclose(et["valid_0"]["binary_logloss"],
                               ej["valid_0"]["binary_logloss"], rtol=1e-5)
    # the averaged raw score on the device path and the host path
    Xb = np.tile(X, (40, 1))
    raw = bt.predict(Xb, raw_score=True)
    assert bt.gbdt.device_predictions == 1
    host = sum(t.predict(Xb.astype(np.float64)) for t in bt.gbdt.models)
    np.testing.assert_allclose(raw, host / 5, rtol=1e-6, atol=1e-9)


def test_rf_multiclass_equals_jax():
    X, y = _data()
    yc = np.digitize(y, [-0.5, 0.5]).astype(np.float32)
    params = dict(PARAMS, objective="multiclass", num_class=3, boosting="rf",
                  bagging_fraction=0.7, bagging_freq=1, num_leaves=7,
                  metric="multi_logloss")
    bj, _ = _train(lj, params, 4, X, yc)
    bt, _ = _train(lt, params, 4, X, yc)
    assert bt.num_trees() == 12
    assert_same_trees(bt, bj)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-5,
                               atol=1e-7)


def test_rf_requires_bagging():
    X, y = _data(n=300)
    p = dict(PARAMS, boosting="random_forest", device_type="cpu")
    with pytest.raises(ValueError, match="bagging"):
        lt.train(p, lt.Dataset(X, label=y, params=p), 1, verbose_eval=False)


def test_factory_table_and_unknown_name():
    cfg = lt.Config.from_params({"boosting": "gbrt"})
    assert type(create_boosting(cfg, torch.device("cpu"))).__name__ == "GBDT"
    for name, cls in (("dart", "DART"), ("goss", "GOSS"), ("rf", "RF"),
                      ("random_forest", "RF")):
        b = create_boosting(cfg, torch.device("cpu"), name)
        assert type(b).__name__ == cls
    with pytest.raises(ValueError, match="Unknown boosting"):
        create_boosting(cfg, torch.device("cpu"), "adaboost")
    X, y = _data(n=300)
    p = {"boosting": "adaboost", "device_type": "cpu", "verbosity": -1}
    with pytest.raises(ValueError, match="Unknown boosting"):
        lt.train(p, lt.Dataset(X, label=y), 1, verbose_eval=False)
