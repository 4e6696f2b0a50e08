"""Port lambdarank and query groups vs lightgbm_tpu.

The same float32 scores through both packages' ``LambdarankNDCG`` on ragged
queries (one-document queries, queries past a power of two, tied scores,
labels 0-4, weights on and off): gradients and hessians within 1e-5 of the
JAX ``_grads_impl``.  The ranking fixture of ``tests/test_engine.py``
through both packages' ``train``: ndcg@3 per iteration within 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import Metadata as JMetadata
from lightgbm_tpu.rank_objective import LambdarankNDCG as JLambdarank
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.rank_objective import LambdarankNDCG as TLambdarank
from lightgbm_tpu_torch.rank_objective import (default_label_gain,
                                               max_dcg_at_k)

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _ragged(seed, weighted, params=None):
    rng = np.random.RandomState(seed)
    sizes = np.r_[1, 1, 9, 33, rng.randint(1, 40, 60)]
    n = int(sizes.sum())
    n_pad = n + 64
    y = rng.randint(0, 5, n).astype(np.float64)
    w = rng.uniform(0.2, 2.0, n) if weighted else None
    objs = []
    for meta_cls, obj_cls, cfg_cls, extra in (
            (JMetadata, JLambdarank, JConfig, ()),
            (TMetadata, TLambdarank, TConfig, (CPU,))):
        meta = meta_cls(n)
        meta.set_label(y)
        meta.set_weights(w)
        meta.set_group(sizes)
        obj = obj_cls(cfg_cls.from_params(dict(
            {"objective": "lambdarank"}, **(params or {}))), *extra)
        obj.init(meta, n, n_pad)
        objs.append(obj)
    score = (rng.randn(n_pad) * 0.8).astype(np.float32)
    score[10:20] = 0.5                      # ties inside the 33-doc query
    score[2:11] = 0.25                      # one query of equal scores
    return objs, score, n, rng


@pytest.mark.parametrize("weighted", [False, True])
def test_lambdarank_gradients_match_jax(weighted):
    (oj, ot), score, n, _ = _ragged(0, weighted)
    assert ot.q_pad == oj.q_pad == 64 and ot.q_batch == oj.q_batch
    gj, hj = (np.asarray(a) for a in oj._grads_impl(jnp.asarray(score)))
    gt, ht = ot.get_gradients(torch.from_numpy(score))
    assert gt.dtype == ht.dtype == torch.float32
    assert tuple(gt.shape) == gj.shape == (len(score),)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ht.numpy(), hj, rtol=0, atol=1e-5)
    # every document of a query with two labels has a gradient; the
    # padding rows none
    assert np.all(gt.numpy()[n:] == 0) and np.abs(gt.numpy()).max() > 0.01


def test_lambdarank_batches_and_options_match_jax():
    """Several query batches (``q_batch`` forced small), a label gain, a
    truncation level and a sigmoid other than the defaults."""
    params = {"label_gain": [0, 1, 3, 7, 15], "max_position": 3,
              "sigmoid": 2.0}
    (oj, ot), score, _, _ = _ragged(1, False, params)
    oj.q_batch = ot.q_batch = 7
    gj, hj = (np.asarray(a) for a in oj._grads_impl(jnp.asarray(score)))
    gt, ht = ot.get_gradients(torch.from_numpy(score))
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ht.numpy(), hj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ot.inverse_max_dcgs.numpy(),
                               np.asarray(oj.inverse_max_dcgs), rtol=0,
                               atol=0)


def test_dcg_helpers_and_refusals():
    np.testing.assert_array_equal(default_label_gain(4), [0, 1, 3, 7, 15])
    lab = np.array([3, 0, 2, 3, 1])
    want = (7 + 7 / np.log2(3) + 3 / np.log2(4))
    assert max_dcg_at_k(3, lab, default_label_gain()) == pytest.approx(want)
    meta = TMetadata(10)
    meta.set_label(np.arange(10) % 3)
    obj = TLambdarank(TConfig.from_params({"objective": "lambdarank"}), CPU)
    with pytest.raises(ValueError, match="query information"):
        obj.init(meta, 10, 16)
    with pytest.raises(ValueError, match="Sum of group sizes"):
        meta.set_group([3, 3])
    meta.set_group([3, 7])
    np.testing.assert_array_equal(meta.query_boundaries, [0, 3, 10])
    with pytest.raises(ValueError, match="Sigmoid"):
        TLambdarank(TConfig.from_params({"objective": "lambdarank",
                                         "sigmoid": -1.0}), CPU)


def _rank_fixture():
    """``tests/test_engine.py::test_lambdarank``'s data (its ``rng``
    fixture: RandomState(42))."""
    rng = np.random.RandomState(42)
    nq, per = 30, 12
    n = nq * per
    X = rng.randn(n, 5)
    rel = X[:, 0] * 1.5 + rng.randn(n) * 0.3
    y = np.digitize(rel, np.percentile(rel, [50, 75, 90])).astype(float)
    return X, y, np.full(nq, per)


def test_lambdarank_ndcg_per_iteration_matches_jax():
    X, y, group = _rank_fixture()
    p = {"objective": "lambdarank", "metric": "ndcg", "eval_at": [3],
         "num_leaves": 7, "min_data_in_leaf": 2, "verbosity": -1,
         "min_sum_hessian_in_leaf": 1e-3}
    res = []
    for lib, params in ((lj, p), (lt, dict(p, device_type="cpu"))):
        ds = lib.Dataset(X, label=y, group=group, params=params)
        ev = {}
        bst = lib.train(params, ds, 20, valid_sets=[
            ds.create_valid(X, label=y, group=group)], evals_result=ev,
            verbose_eval=False)
        res.append((ev["valid_0"]["ndcg@3"], bst))
    (nj, bj), (nt, bt) = res
    assert len(nt) == len(nj) == 20 and nt[-1] > 0.75
    np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-3)
    assert bt.gbdt._can_pipeline() is False        # a validation set
    assert bt.model_to_string().split("\n")[6] == "objective=lambdarank"
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=0,
                               atol=1e-3)


def test_lambdarank_pipelined_equals_synchronous():
    """Without a validation set lambdarank pipelines; with a dyadic
    learning rate the score update rounds alike in both loops, so the
    model text equals the synchronous loop's."""
    X, y, group = _rank_fixture()
    p = {"objective": "lambdarank", "num_leaves": 7, "min_data_in_leaf": 2,
         "verbosity": -1, "min_sum_hessian_in_leaf": 1e-3,
         "learning_rate": 0.5, "device_type": "cpu", "metric": "ndcg",
         "eval_at": [3], "tpu_pipeline_flush_depth": 2}
    ds = lt.Dataset(X, label=y, group=group, params=p)
    piped = lt.train(p, ds, 6, verbose_eval=False)
    assert piped.gbdt._can_pipeline()
    ds2 = lt.Dataset(X, label=y, group=group, params=p)
    sync = lt.train(p, ds2, 6, valid_sets=[
        ds2.create_valid(X, label=y, group=group)], verbose_eval=False)
    assert piped.model_to_string() == sync.model_to_string()
