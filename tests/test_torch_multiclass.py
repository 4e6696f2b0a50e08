"""Port multiclass training vs lightgbm_tpu.

K = 3 trees per iteration over one joint softmax (``GBDT._gradients``).
The learner-level route: the float32 gradients the port's loop computes for
each class go to the JAX ``WaveTPUTreeLearner`` too, and in dp the port's
trees, grown one class after another by one wave learner whose buffers the
next class reuses, equal the JAX learner's trees field for field.  Then
whole models: held-out multi_logloss within 1e-4 of the JAX package per
iteration, the pipelined loop's model text equal to the synchronous loop's,
early stopping dropping K x ``early_stopping_round`` trees as the JAX GBDT
does, and models carried over from the JAX package predicting (n, K)
probabilities within 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.learner_wave import WaveTPUTreeLearner
from lightgbm_tpu_torch.interop import booster_from_jax_arrays
from lightgbm_tpu_torch.predictor import DevicePredictor
from test_torch_engine import _tree_arrays

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

K = 3
PARAMS = {"objective": "multiclass", "num_class": K, "num_leaves": 15,
          "max_bin": 63, "min_data_in_leaf": 20, "learning_rate": 0.3,
          "verbosity": -1, "metric": "multi_logloss,multi_error"}


def _data(n=2400, f=6, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    z = X[:, :K] + 0.5 * rng.randn(n, K)
    return X, np.argmax(z, axis=1).astype(np.float32)


def _train(lib, params, rounds, valid=True, **kw):
    X, y = _data()
    p = dict(params, device_type="cpu") if lib is lt else dict(params)
    ds = lib.Dataset(X[:2000], label=y[:2000], params=p)
    vs = [ds.create_valid(X[2000:], label=y[2000:])] if valid else []
    ev = {}
    bst = lib.train(p, ds, rounds, valid_sets=vs, valid_names=["heldout"],
                    evals_result=ev, verbose_eval=False, **kw)
    return bst, ev.get("heldout", {})


def test_loop_trees_equal_jax_learner_on_shared_gradients():
    """dp, the wave learner: each class's tree from the port's loop equals
    the JAX wave learner's tree grown from the same float32 gradients."""
    params = dict(PARAMS, gpu_use_dp=True, tpu_learner="wave")
    X, y = _data()
    ds = lt.Dataset(X[:2000], label=y[:2000],
                    params=dict(params, device_type="cpu"))
    bst = lt.Booster(dict(params, device_type="cpu"), ds)
    gbdt = bst.gbdt
    seen = []
    inner = gbdt._gradients

    def record():
        grads = inner()
        seen.append([(g.numpy().copy(), h.numpy().copy()) for g, h in grads])
        return grads

    gbdt._gradients = record
    for _ in range(3):
        bst.update()
    assert len(seen) == 3 and all(len(s) == K for s in seen)
    assert all(g.dtype == np.float32 for s in seen for g, _ in s)
    dj = lj.Dataset(X[:2000], label=y[:2000], params=params) \
        .construct().constructed
    jl = WaveTPUTreeLearner(JConfig.from_params(
        dict(params, tpu_wave_defer_sorts=False)), dj)
    bag = jnp.asarray(gbdt._np_bag_mask)
    trees = gbdt.models
    assert len(trees) == 3 * K
    for it, grads in enumerate(seen):
        for k, (g, h) in enumerate(grads):
            tj, _ = jl.train(jnp.asarray(g), jnp.asarray(h), bag)
            tj.apply_shrinkage(params["learning_rate"])
            tt = trees[it * K + k]
            nl = tj.num_leaves
            assert nl == tt.num_leaves > 1, (it, k)
            for f in ("split_feature", "threshold_in_bin", "decision_type"):
                np.testing.assert_array_equal(getattr(tt, f)[:nl - 1],
                                              getattr(tj, f)[:nl - 1])
            np.testing.assert_array_equal(tt.leaf_count[:nl],
                                          tj.leaf_count[:nl])
            np.testing.assert_allclose(tt.leaf_value[:nl],
                                       tj.leaf_value[:nl], rtol=0, atol=1e-5)


@pytest.mark.parametrize("learner", ["wave", "compact"])
def test_f32_heldout_metrics_and_predictions_match(learner):
    params = dict(PARAMS, tpu_learner=learner)
    (bj, ej), (bt, et) = (_train(lj, params, 4), _train(lt, params, 4))
    assert len(bt.gbdt.models) == 4 * K
    for m in ("multi_logloss", "multi_error"):
        assert len(et[m]) == len(ej[m]) == 4
        np.testing.assert_allclose(et[m], ej[m], rtol=0, atol=1e-4,
                                   err_msg=m)
    ll = et["multi_logloss"]
    assert all(b < a for a, b in zip(ll, ll[1:]))
    X, _ = _data()
    pt, pj = bt.predict(X), bj.predict(X)
    assert pt.shape == pj.shape == (len(X), K)
    np.testing.assert_allclose(pt.sum(axis=1), 1.0, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
    # the device traversal (K scores per row) against the host trees
    raw = DevicePredictor(bt.gbdt, bt.gbdt.train_data).predict_raw(X)
    np.testing.assert_allclose(raw, bt.predict(X, raw_score=True), rtol=0,
                               atol=1e-9)
    # the held-out scores the loop kept on the device
    dev = bt.gbdt.valid_scores[0].np_score().astype(np.float64)
    np.testing.assert_allclose(dev, bt.predict(X[2000:], raw_score=True),
                               rtol=0, atol=1e-5)


def test_pipelined_model_text_equals_synchronous():
    """No validation set: K trees queued per iteration, the host trees
    built ``tpu_pipeline_flush_depth`` x K trees behind.  A dyadic learning
    rate makes both loops' score updates round alike (ROADMAP.md Queue C,
    the pipelined score update), so the model text equals the synchronous
    loop's."""
    params = dict(PARAMS, learning_rate=0.5, tpu_pipeline_flush_depth=2,
                  gpu_use_dp=True)
    piped, _ = _train(lt, params, 5, valid=False)
    gbdt = piped.gbdt
    assert gbdt._can_pipeline() and gbdt.num_tree_per_iteration == K
    assert len(gbdt._pending) == 2 * K           # depth x K queued
    assert gbdt.learner.host_syncs == 0
    assert gbdt.pipeline_waits == 3 * K
    sync, _ = _train(lt, params, 5)
    assert not sync.gbdt._can_pipeline()
    assert piped.model_to_string() == sync.model_to_string()
    assert gbdt.pipeline_waits == 5 * K and len(gbdt.models) == 5 * K


def test_early_stopping_drops_k_trees_per_round_as_jax():
    """The GBDT's own early stop (``early_stopping_round``): a learning rate
    of 1.5 overfits, the stop comes at the same iteration in both packages
    and drops ``early_stopping_round`` x K trees."""
    params = dict(PARAMS, learning_rate=1.5, min_data_in_leaf=2,
                  early_stopping_round=2, metric="multi_logloss")
    X, y = _data()
    counts = []
    for lib in (lj, lt):
        p = dict(params, device_type="cpu") if lib is lt else params
        ds = lib.Dataset(X[:2000], label=y[:2000], params=p)
        bst = lib.Booster(p, ds)
        bst.add_valid(ds.create_valid(X[2000:], label=y[2000:]), "heldout")
        g = bst.gbdt
        for it in range(20):
            g.train_one_iter()
            if g.eval_and_check_early_stopping():
                break
        counts.append((it, len(g.models), g.iter_))
    assert counts[0] == counts[1]
    it, n_models, iters = counts[1]
    assert it < 19 and n_models == (iters - 2) * K


def test_early_stopping_callback_keeps_best_iteration():
    params = dict(PARAMS, learning_rate=1.5, min_data_in_leaf=2,
                  metric="multi_logloss")
    (bj, _), (bt, _) = (
        _train(lj, params, 20, callbacks=[lj.early_stopping(2,
                                                            verbose=False)]),
        _train(lt, params, 20, callbacks=[lt.early_stopping(2,
                                                            verbose=False)]))
    assert bt.best_iteration == bj.best_iteration > 0
    assert bt.num_trees() == bj.num_trees() == K * (bt.best_iteration + 2)
    text = bt.model_to_string()
    assert text.count("Tree=") == K * bt.best_iteration


def _rank_booster():
    rng = np.random.RandomState(11)
    n = 240
    X = rng.randn(n, 5)
    y = np.digitize(X[:, 0] + 0.3 * rng.randn(n), [-0.5, 0.3, 1.0]) * 1.0
    p = {"objective": "lambdarank", "num_leaves": 7, "min_data_in_leaf": 2,
         "verbosity": -1, "min_sum_hessian_in_leaf": 1e-3}
    ds = lj.Dataset(X, label=y, group=np.full(20, 12), params=p)
    return lj.train(p, ds, 4, verbose_eval=False), X, p


@pytest.mark.parametrize("kind", ["multiclass", "lambdarank"])
def test_jax_models_carried_into_the_port(kind):
    """A multiclass and a lambdarank model trained by lightgbm_tpu, carried
    as arrays (``booster_from_jax_arrays``) and as model text: the port's
    predictions within 1e-9 of the JAX package's."""
    if kind == "multiclass":
        bj, _ = _train(lj, PARAMS, 3)
        X, _ = _data()
        params = {"num_class": K}
    else:
        bj, X, params = _rank_booster()
        params = {}
    data = bj.gbdt.train_data
    carried = booster_from_jax_arrays(
        [_tree_arrays(t) for t in bj.gbdt.models],
        [m.to_dict() for m in data.bin_mappers], kind,
        used_feature_map=data.used_feature_map,
        num_total_features=data.num_total_features,
        params=dict(params, device_type="cpu"))
    text = bj.model_to_string()
    via_text = lt.Booster(params={"device_type": "cpu"}, model_str=text)
    want = bj.predict(X)
    for bt in (carried, via_text):
        assert bt.gbdt.num_tree_per_iteration == \
            bj.gbdt.num_tree_per_iteration
        got = bt.predict(X)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert carried.model_to_string() == text
    if kind == "multiclass":
        assert want.shape == (len(X), K)
        np.testing.assert_allclose(via_text.predict(X).sum(axis=1), 1.0,
                                   rtol=0, atol=1e-12)
        assert torch.equal(torch.from_numpy(via_text.predict(X)),
                           torch.from_numpy(carried.predict(X)))
