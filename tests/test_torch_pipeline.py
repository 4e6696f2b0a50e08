"""The port's pipelined boosting loop against ``lightgbm_tpu``'s.

With no validation set, an objective without leaf renewal and a learner
with ``train_async``, both packages pipeline (``gbdt.py:_can_pipeline``):
trees are grown with no host read, the training score is updated on the
device as ``score + float32(lr) * leaf_out[leaf_id]`` rounded once (the
fused multiply-add XLA compiles on the CPU), and host trees are built
``tpu_pipeline_flush_depth`` iterations behind, with the stop check deferred
and post-stop trees rolled back.  In ``gpu_use_dp`` the wave learner's trees
are exact in both packages, so the model text must be equal, a run that
stops early must stop at the same iteration with the same trees and
training score, and the flush depth must change nothing.
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

PARAMS = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
          "learning_rate": 0.3, "min_data_in_leaf": 20, "verbosity": -1,
          "metric": "none", "gpu_use_dp": True}


def _data(n=2000, f=6, seed=4):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
         + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _train(lib, params, rounds, X, y):
    p = dict(params, device_type="cpu") if lib is lt else params
    return lib.train(p, lib.Dataset(X, label=y, params=p), rounds,
                     verbose_eval=False)


@pytest.mark.parametrize("learner", ["wave", "masked"])
def test_pipelined_model_text_equals_jax(learner):
    X, y = _data()
    params = dict(PARAMS, tpu_learner=learner)
    bj = _train(lj, params, 6, X, y)
    bt = _train(lt, params, 6, X, y)
    assert type(bt.gbdt.learner).__name__ == {
        "wave": "WaveTreeLearner", "masked": "MaskedTreeLearner"}[learner]
    assert bt.gbdt._can_pipeline()
    assert bt.model_to_string() == bj.model_to_string()
    assert bt.gbdt.pipeline_waits == 6
    np.testing.assert_array_equal(bt.predict(X), bj.predict(X))


def test_early_stop_rolls_back_like_jax():
    """A split threshold that the shrinking gradients stop reaching after a
    few iterations: the stop is found up to the flush depth late, the later
    iterations are rolled back out of the training score."""
    X, y = _data()
    params = dict(PARAMS, min_gain_to_split=25.0,
                  tpu_pipeline_flush_depth=4)
    bj = _train(lj, params, 20, X, y)
    bt = _train(lt, params, 20, X, y)
    nj, nt = len(bj.gbdt.models), len(bt.gbdt.models)
    assert 1 < nt == nj < 20
    assert bt.gbdt.iter_ == bj.gbdt.iter_ == nt
    assert bt.gbdt._stopped and bt.update()
    assert bt.model_to_string() == bj.model_to_string()
    sj = np.asarray(bj.gbdt.train_score.score)
    st = bt.gbdt.train_score.score.numpy()
    np.testing.assert_array_equal(st, sj)


def test_models_flush_on_predict_and_save(tmp_path):
    X, y = _data()
    bst = _train(lt, PARAMS, 3, X, y)
    gbdt = bst.gbdt
    assert len(gbdt._pending) == 3 and gbdt.pipeline_waits == 0
    pred = bst.predict(X[:50])
    assert not gbdt._pending and gbdt.pipeline_waits == 3
    assert all(t is not None for t in gbdt._models)
    want = np.zeros(50)
    for t in gbdt._models:
        want += t.predict(np.asarray(X[:50], np.float64))
    np.testing.assert_allclose(pred, want, rtol=0, atol=1e-12)
    bst2 = _train(lt, PARAMS, 3, X, y)
    assert len(bst2.gbdt._pending) == 3
    path = tmp_path / "m.txt"
    bst2.save_model(str(path))
    assert not bst2.gbdt._pending
    assert path.read_text() == bst.model_to_string()
    # the learner's per-tree counters flush too
    bst3 = _train(lt, PARAMS, 2, X, y)
    assert len(bst3.gbdt.learner.tree_stats) == 2
    assert not bst3.gbdt._pending


@pytest.mark.parametrize("depth", [0, 1])
def test_flush_depth_changes_nothing(depth):
    X, y = _data()
    base = _train(lt, PARAMS, 5, X, y).model_to_string()
    other = _train(lt, dict(PARAMS, tpu_pipeline_flush_depth=depth), 5, X,
                   y)
    assert other.model_to_string() == base


def test_valid_set_keeps_the_synchronous_loop():
    X, y = _data()
    p = dict(PARAMS, device_type="cpu")
    ds = lt.Dataset(X[:1500], label=y[:1500], params=p)
    dv = ds.create_valid(X[1500:], label=y[1500:])
    bst = lt.train(p, ds, 2, valid_sets=[dv], verbose_eval=False)
    assert not bst.gbdt._can_pipeline() and bst.gbdt.pipeline_waits == 0
    assert len(bst.gbdt.models) == 2
    assert torch.is_tensor(bst.gbdt.train_score.score)
