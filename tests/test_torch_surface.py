"""The port's training API against ``lightgbm_tpu``'s: custom objectives
and metrics, early stopping, learning-rate schedules, continued training,
``rollback_one_iter``, ``refit``, ``dump_model``, ``cv`` and pickling; then
the assertions of ``tests/test_engine.py`` on the port's models.

Trees are held with the L2 objective and ``gpu_use_dp`` (the ROADMAP's
ground rules), where both packages grow the same trees exactly.  The
engine does not care which learner grows them; the comparisons run the
compact learner, the JAX package's fastest on the CPU.
"""

import pickle

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.engine import _stratified_folds as jax_folds
from lightgbm_tpu_torch.engine import CVBooster, _stratified_folds

from test_torch_boosting import assert_same_trees

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

PARAMS = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
          "learning_rate": 0.3, "min_data_in_leaf": 20, "verbosity": -1,
          "metric": "l2", "gpu_use_dp": True, "tpu_learner": "compact"}


def _data(n=1200, f=6, seed=5, noise=0.1):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
         + noise * rng.randn(n)).astype(np.float32)
    return X, y


def _p(lib, params):
    return dict(params, device_type="cpu") if lib is lt else dict(params)


def _train(lib, params, rounds, X, y, valid=None, **kw):
    p = _p(lib, params)
    ds = lib.Dataset(X, label=y, params=p)
    vs = None
    if valid is not None:
        vs = [ds.create_valid(valid[0], label=valid[1])]
    ev = {}
    bst = lib.train(p, ds, rounds, valid_sets=vs, evals_result=ev,
                    verbose_eval=False, **kw)
    return bst, ev


def _host_predict(bst, X):
    out = np.zeros(len(X))
    for t in bst.gbdt.models:
        out += t.predict(np.asarray(X, np.float64))
    return out


# ---------------------------------------------------------------------------
# custom objective and metric, early stopping, learning-rate schedules
# ---------------------------------------------------------------------------


def _l2_obj(preds, dataset):
    lab = dataset.get_label()
    return preds - lab, np.ones_like(preds)


def _l2_eval(preds, dataset):
    return "my_l2", float(np.mean((preds - VALID[1]) ** 2)), False


VALID = _data(n=300, seed=9)


def test_fobj_and_feval_equal_jax():
    X, y = _data(n=800)
    params = dict(PARAMS, metric="none")
    bj, ej = _train(lj, params, 4, X, y, valid=VALID, fobj=_l2_obj,
                    feval=_l2_eval)
    bt, et = _train(lt, params, 4, X, y, valid=VALID, fobj=_l2_obj,
                    feval=_l2_eval)
    assert bt.gbdt.objective is None
    assert_same_trees(bt, bj)
    np.testing.assert_allclose(et["valid_0"]["my_l2"],
                               ej["valid_0"]["my_l2"], rtol=1e-6)
    assert len(et["valid_0"]["my_l2"]) == 4
    # raw scores: no objective converts them
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-5,
                               atol=1e-6)


def test_early_stopping_rounds_equal_jax():
    X, y = _data(n=800, noise=1.5)
    Xv, yv = _data(n=300, seed=11, noise=1.5)
    params = dict(PARAMS, learning_rate=0.8)
    bj, ej = _train(lj, params, 12, X, y, valid=(Xv, yv),
                    early_stopping_rounds=2)
    bt, et = _train(lt, params, 12, X, y, valid=(Xv, yv),
                    early_stopping_rounds=2)
    assert 0 < bt.best_iteration == bj.best_iteration < 12
    assert bt.best_score["valid_0"]["l2"] == pytest.approx(
        bj.best_score["valid_0"]["l2"], rel=1e-6)
    assert bt.num_trees() == bj.num_trees()
    assert bt.model_to_string() == bj.model_to_string()


def test_learning_rates_equal_jax():
    """A schedule through ``reset_parameter``: the synchronous loop equals
    the JAX package's; the pipelined loop (no validation set) shrinks each
    queued tree by the rate its score update used, where the JAX package
    takes the rate at flush time (ROADMAP.md Queue C), so its model
    predicts its own training score."""
    X, y = _data(n=800)
    rates = [0.5, 0.4, 0.3, 0.2]
    bj, _ = _train(lj, PARAMS, 4, X, y, valid=VALID, learning_rates=rates)
    bt, _ = _train(lt, PARAMS, 4, X, y, valid=VALID, learning_rates=rates)
    assert bt.model_to_string() == bj.model_to_string()
    bp, _ = _train(lt, dict(PARAMS, tpu_learner="wave"), 4, X, y,
                   learning_rates=rates)
    assert bp.gbdt._can_pipeline()
    shr = [t.shrinkage for t in bp.gbdt.models[1:]]
    np.testing.assert_allclose(shr, rates[1:])
    np.testing.assert_allclose(bp.predict(X), bp.gbdt.train_score.np_score(),
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# continued training, rollback, refit, dump_model, pickling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["jax_file", "port_booster"])
def test_init_model_continues_like_jax(source, tmp_path):
    X, y = _data(n=800)
    path = str(tmp_path / "m.txt")
    # validation sets keep both packages' compact learners synchronous
    b0, _ = _train(lj, PARAMS, 3, X, y, valid=VALID)
    b0.save_model(path)
    bj, _ = _train(lj, PARAMS, 3, X, y, valid=VALID, init_model=path)
    if source == "jax_file":
        init = path
    else:
        init, _ = _train(lt, PARAMS, 3, X, y, valid=VALID)
        assert init.model_to_string() == b0.model_to_string()
    bt, _ = _train(lt, PARAMS, 3, X, y, valid=VALID, init_model=init)
    assert bt.num_trees() == bj.num_trees() == 6
    assert bt.current_iteration == 6
    assert bt.gbdt.train_score.has_init_score
    assert_same_trees(bt, bj)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("boosting", ["gbdt", "rf"])
def test_valid_scores_start_from_the_trees_held(boosting, tmp_path):
    """A validation set joined to a model that already holds trees (an
    init model's, or its own) starts from their output, as `gbdt.cpp` and
    `rf.hpp` AddValidDataset replay them, averaged for a random forest; the
    JAX package starts it from zero (ROADMAP Queue C)."""
    X, y = _data(n=800)
    Xv, yv = VALID
    params = dict(PARAMS, boosting=boosting)
    if boosting == "rf":
        params.update(bagging_fraction=0.6, bagging_freq=1,
                      feature_fraction=0.8)
    path = str(tmp_path / "m.txt")
    _train(lt, params, 3, X, y)[0].save_model(path)
    bt, ev = _train(lt, params, 2, X, y, valid=VALID, init_model=path)
    assert bt.num_trees() == 5
    ds = lt.Dataset(X, label=y, params=_p(lt, params))
    bt.add_valid(ds.create_valid(Xv, label=yv), "late")
    raw = bt.predict(Xv, raw_score=True)
    # the held-out score the loop kept, with the init model's trees
    np.testing.assert_allclose(bt.gbdt.valid_scores[0].np_score(), raw,
                               rtol=0, atol=1e-5)
    assert ev["valid_0"]["l2"][-1] == pytest.approx(
        np.mean((raw - yv) ** 2), rel=1e-5)
    np.testing.assert_allclose(bt.gbdt.valid_scores[1].np_score(), raw,
                               rtol=0, atol=1e-5)
    ((_, name, value, _),) = [r for r in bt.eval_valid() if r[0] == "late"]
    assert name == "l2"
    assert value == pytest.approx(np.mean((raw - yv) ** 2), rel=1e-5)


def test_rollback_then_update_serves_a_fresh_device_predictor():
    """Rollback, then one more iteration at another rate: the model has as
    many trees as before, so only ``_model_version`` tells the cached
    predictor from the new model."""
    X, y = _data(n=800)
    Xb = np.tile(X, (50, 1))          # rows x trees past 200,000
    bt, _ = _train(lt, PARAMS, 5, X, y, valid=VALID)
    bj, _ = _train(lj, PARAMS, 5, X, y, valid=VALID)
    before = bt.predict(Xb)
    assert bt.gbdt.device_predictions == 1
    for b in (bt, bj):
        b.rollback_one_iter()
        assert b.num_trees() == 4 and b.current_iteration == 4
        b.gbdt.shrinkage_rate = 0.1
        b.update()
    assert bt.model_to_string() == bj.model_to_string()
    after = bt.predict(Xb)
    assert bt.gbdt.device_predictions == 2
    np.testing.assert_allclose(after, _host_predict(bt, Xb), rtol=1e-6,
                               atol=1e-6)
    assert not np.allclose(after, before)
    # the training score was rolled back and moved on as the JAX one
    np.testing.assert_allclose(bt.gbdt.train_score.np_score(),
                               bj.gbdt.train_score.np_score(), rtol=1e-6,
                               atol=1e-6)


def test_refit_equals_jax():
    X, y = _data(n=800)
    X2, y2 = _data(n=600, seed=21)
    params = dict(PARAMS, gpu_use_dp=False)
    b0, _ = _train(lt, params, 4, X, y)
    s = b0.model_to_string()
    bj = lj.Booster(model_str=s, params=params)
    bt = lt.Booster(model_str=s, params=_p(lt, params))
    rj = bj.refit(X2, y2, decay_rate=0.7)
    rt = bt.refit(X2, y2, decay_rate=0.7)
    assert rt.num_trees() == 4
    for a, b in zip(rt.gbdt.models, rj.gbdt.models):
        np.testing.assert_allclose(a.leaf_value[:a.num_leaves],
                                   b.leaf_value[:b.num_leaves], rtol=0,
                                   atol=1e-9)
    # refit trees keep this model's thresholds: predictions walk the
    # host trees, large batches included
    Xb = np.tile(X2, (50, 1))
    np.testing.assert_allclose(rt.predict(Xb), _host_predict(rt, Xb),
                               rtol=0, atol=1e-12)
    assert rt.gbdt.device_predictions == 0
    np.testing.assert_allclose(rt.predict(X2), rj.predict(X2), rtol=0,
                               atol=1e-9)


def test_dump_model_equals_jax():
    X, y = _data(n=800)
    yc = np.digitize(y, [-0.5, 0.5]).astype(np.float32)
    params = dict(PARAMS, objective="multiclass", num_class=3, num_leaves=7,
                  metric="multi_logloss")
    bt, _ = _train(lt, params, 3, X, yc)
    s = bt.model_to_string()
    dj = lj.Booster(model_str=s).dump_model()
    dt = lt.Booster(model_str=s, params={"device_type": "cpu"}).dump_model()
    assert dt == dj
    assert dt["num_tree_per_iteration"] == 3 and len(dt["tree_info"]) == 9
    assert dt["pandas_categorical"] is None
    # the trained booster dumps its own trees (gains unrounded)
    own = bt.dump_model(num_iteration=2)["tree_info"]
    assert [t["num_leaves"] for t in own] == \
        [t["num_leaves"] for t in dt["tree_info"][:6]]


def test_pickle_round_trip():
    X, y = _data(n=600)
    for extra in ({}, {"boosting": "dart"}):
        bt, _ = _train(lt, dict(PARAMS, **extra), 4, X, y)
        bt2 = pickle.loads(pickle.dumps(bt))
        # a loaded model is a plain GBDT, as in the JAX package: only the
        # model text's first line (the boosting name) differs
        a, b = bt2.model_to_string(), bt.model_to_string()
        assert a.split("\n", 1)[1] == b.split("\n", 1)[1]
        assert a.startswith("gbdt\n")
        np.testing.assert_allclose(bt2.predict(X), bt.predict(X), rtol=1e-9)
        assert bt2.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# cv
# ---------------------------------------------------------------------------


def test_stratified_folds_equal_jax():
    y = (np.random.RandomState(0).rand(500) > 0.7).astype(float)
    a = _stratified_folds(y, 4, np.random.RandomState(3), True)
    b = jax_folds(y, 4, np.random.RandomState(3), True)
    for (ta, sa), (tb, sb) in zip(a, b):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(sa, sb)


@pytest.mark.parametrize("stratified", [True, False])
def test_cv_means_equal_jax(stratified):
    X, y = _data(n=600, noise=1.5)
    if stratified:
        y = (y > 0).astype(np.float32)
        params = dict(PARAMS, objective="binary", metric="binary_logloss",
                      learning_rate=0.9, num_leaves=7)
    else:
        params = dict(PARAMS, learning_rate=0.9, num_leaves=7)
    res = {}
    for lib in (lj, lt):
        p = _p(lib, params)
        res[lib] = lib.cv(p, lib.Dataset(X, label=y, params=p),
                          num_boost_round=8, nfold=2,
                          stratified=stratified, early_stopping_rounds=2,
                          seed=7, verbose_eval=False)
    rj, rt = res[lj], res[lt]
    assert rt.keys() == rj.keys()
    for key in rj:
        assert len(rt[key]) == len(rj[key]) < 8
        np.testing.assert_allclose(rt[key], rj[key], rtol=0, atol=1e-6)


def test_cvbooster_fans_out():
    cvb = CVBooster()
    X, y = _data(n=400)
    for seed in (0, 1):
        bt, _ = _train(lt, dict(PARAMS, seed=seed), 2, X, y)
        cvb._append(bt)
    assert cvb.num_trees() == [2, 2]
    assert callable(lt.cv)


def test_dataset_accessors_and_subset():
    X, y = _data(n=400)
    w = np.linspace(0.5, 1.5, 400)
    init = np.full(400, 0.25)
    p = {"device_type": "cpu", "max_bin": 63}
    ds = lt.Dataset(X, label=y, weight=w, group=[100, 300], init_score=init,
                    params=p)
    assert ds.get_weight() is w
    assert list(ds.get_group()) == [100, 300]
    ds.construct()
    np.testing.assert_allclose(ds.get_weight(), w.astype(np.float32))
    np.testing.assert_array_equal(ds.get_group(), [100, 300])
    np.testing.assert_allclose(ds.get_init_score(), init)
    idx = np.arange(50, 150)
    sub = ds.subset(idx)
    js = lj.Dataset(X, label=y, weight=w, group=[100, 300],
                    init_score=init, params=p).subset(idx)
    np.testing.assert_array_equal(sub.constructed.bins,
                                  js.constructed.bins)
    np.testing.assert_array_equal(sub.get_group(), [50, 50])
    np.testing.assert_allclose(sub.get_label(), y[idx])
    ds2 = lt.Dataset(X, label=y).set_feature_name(
        [f"f{i}" for i in range(6)]).set_categorical_feature([1])
    assert ds2.constructed.feature_names[1] == "f1"
    assert ds2.constructed.bin_mappers[1].bin_type == 1


def test_resume_stays_refused(tmp_path):
    """``resume`` is ported (``tests/test_torch_resume.py``): with no
    snapshot beside ``output_model`` both packages train from scratch to
    the same trees.  ``num_machines`` beside it trains too, to the same
    trees as the JAX package's same call (it deals only a stream's rows)."""
    X, y = _data(n=200)
    params = dict(PARAMS, output_model=str(tmp_path / "model.txt"))
    bt = lt.train(_p(lt, params), lt.Dataset(X, label=y), 2, resume=True,
                  verbose_eval=False)
    bj = lj.train(_p(lj, params), lj.Dataset(X, label=y), 2, resume=True,
                  verbose_eval=False)
    assert bt.num_trees() == 2
    assert_same_trees(bt, bj)
    two = dict(params, num_machines=2,
               output_model=str(tmp_path / "two.txt"))
    bt2 = lt.train(_p(lt, two), lt.Dataset(X, label=y), 1, resume=True,
                   verbose_eval=False)
    bj2 = lj.train(_p(lj, two), lj.Dataset(X, label=y), 1, resume=True,
                   verbose_eval=False)
    assert bt2.num_trees() == 1
    assert_same_trees(bt2, bj2)


# ---------------------------------------------------------------------------
# tests/test_engine.py's assertions on the port's models
# ---------------------------------------------------------------------------


def _binary_data(rng, n=600, f=8):
    X = rng.randn(n, f)
    logit = X[:, 0] * 1.2 + X[:, 1] * 0.7 - 0.3 * X[:, 2]
    y = (logit + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


CPU = {"device_type": "cpu", "verbosity": -1}


def test_engine_early_stopping(rng):
    X, y = _binary_data(rng)
    ds = lt.Dataset(X[:400], label=y[:400], params={"min_data_in_leaf": 5})
    dv = ds.create_valid(X[400:], label=y[400:])
    bst = lt.train({"objective": "binary", "metric": "binary_logloss",
                    "num_leaves": 31, "min_data_in_leaf": 5, **CPU},
                   ds, 200, valid_sets=[dv],
                   early_stopping_rounds=5, verbose_eval=False)
    assert 0 < bst.best_iteration < 200


def test_engine_continue_train(rng, tmp_path):
    X, y = _binary_data(rng)
    p = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
         **CPU}
    bst1 = lt.train(p, lt.Dataset(X, label=y, params=p), 10,
                    verbose_eval=False)
    pred1 = bst1.predict(X, raw_score=True)
    path = str(tmp_path / "cont.txt")
    bst1.save_model(path)
    bst2 = lt.train(p, lt.Dataset(X, label=y, params=p), 10,
                    init_model=path, verbose_eval=False)
    assert bst2.num_trees() == 20
    pred2 = bst2.predict(X, raw_score=True)
    assert np.corrcoef(pred1, pred2)[0, 1] > 0.9


def test_engine_cv(rng):
    X, y = _binary_data(rng)
    ds = lt.Dataset(X, label=y, params={"min_data_in_leaf": 5})
    res = lt.cv({"objective": "binary", "metric": "binary_logloss",
                 "num_leaves": 7, "min_data_in_leaf": 5, **CPU},
                ds, num_boost_round=8, nfold=3, verbose_eval=False)
    assert len(res["binary_logloss-mean"]) == 8
    assert res["binary_logloss-mean"][-1] < res["binary_logloss-mean"][0]


def test_engine_pickling_and_text_round_trip(rng):
    X, y = _binary_data(rng, n=300)
    ds = lt.Dataset(X, label=y, params={"min_data_in_leaf": 5})
    bst = lt.train({"objective": "binary", "num_leaves": 7,
                    "min_data_in_leaf": 5, **CPU}, ds, 5,
                   verbose_eval=False)
    bst2 = pickle.loads(pickle.dumps(bst))
    np.testing.assert_allclose(bst.predict(X), bst2.predict(X), rtol=1e-9)
    s = bst.model_to_string()
    bst3 = lt.Booster(model_str=s, params={"device_type": "cpu"})
    np.testing.assert_allclose(bst.predict(X), bst3.predict(X), rtol=1e-12)
    assert bst3.model_to_string() == s


def test_engine_custom_objective(rng):
    X, y = _binary_data(rng, n=400)
    ds = lt.Dataset(X, label=y, params={"min_data_in_leaf": 5})

    def logloss_obj(preds, dataset):
        p = 1.0 / (1.0 + np.exp(-preds))
        return p - ds.get_label(), p * (1 - p)

    bst = lt.train({"num_leaves": 7, "min_data_in_leaf": 5,
                    "objective": "none", **CPU}, ds, 15, fobj=logloss_obj,
                   verbose_eval=False)
    assert ((bst.predict(X) > 0) == y).mean() > 0.9


def test_engine_weights_change_model(rng):
    X, y = _binary_data(rng, n=400)
    w = np.where(y > 0, 10.0, 1.0)
    p = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
         **CPU}
    b1 = lt.train(p, lt.Dataset(X, label=y, params=p), 5, verbose_eval=False)
    b2 = lt.train(p, lt.Dataset(X, label=y, weight=w, params=p), 5,
                  verbose_eval=False)
    assert not np.allclose(b1.predict(X), b2.predict(X))


@pytest.mark.parametrize("boosting,rounds,extra,bound", [
    ("gbdt", 30, {"bagging_fraction": 0.8, "bagging_freq": 2,
                  "feature_fraction": 0.7}, 0.3),
    ("dart", 20, {}, 0.4),
    ("goss", 20, {"learning_rate": 0.2}, 0.35)])
def test_engine_variants_logloss(rng, boosting, rounds, extra, bound):
    n = 400 if boosting == "dart" else 600
    X, y = _binary_data(rng, n=n)
    p = {"objective": "binary", "boosting": boosting, "num_leaves": 15,
         "min_data_in_leaf": 5, "metric": "binary_logloss", **CPU, **extra}
    ds = lt.Dataset(X, label=y, params=p)
    evals = {}
    lt.train(p, ds, rounds, valid_sets=[ds.create_valid(X, label=y)],
             evals_result=evals, verbose_eval=False)
    assert evals["valid_0"]["binary_logloss"][-1] < bound


def test_engine_rf(rng):
    X, y = _binary_data(rng)
    p = {"objective": "binary", "boosting": "rf", "num_leaves": 15,
         "min_data_in_leaf": 5, "bagging_fraction": 0.7, "bagging_freq": 1,
         "feature_fraction": 0.8, **CPU}
    bst = lt.train(p, lt.Dataset(X, label=y, params=p), 10,
                   verbose_eval=False)
    assert ((bst.predict(X) > 0.5) == y).mean() > 0.85


def test_engine_constant_features():
    X = np.full((100, 3), 7.0)
    y = np.concatenate([np.ones(70), np.zeros(30)])
    bst = lt.train({"objective": "binary", "min_data_in_leaf": 1, **CPU},
                   lt.Dataset(X, label=y), 2, verbose_eval=False)
    np.testing.assert_allclose(bst.predict(X), 0.7, atol=1e-6)


def test_engine_cv_early_stopping_aggregated(rng):
    X = rng.randn(600, 5)
    y = X[:, 0] * 2 + rng.randn(600) * 2.0
    res = lt.cv({"objective": "regression", "num_leaves": 7,
                 "min_data_in_leaf": 10, "learning_rate": 0.3,
                 "metric": "l2", **CPU},
                lt.Dataset(X, label=y), num_boost_round=200, nfold=3,
                early_stopping_rounds=5, stratified=False, seed=7)
    means = res["l2-mean"]
    assert 0 < len(means) < 200
    assert means[-1] == min(means)
    assert len(res["l2-stdv"]) == len(means)
