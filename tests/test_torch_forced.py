"""Forced splits (``forcedsplits_filename``): port vs lightgbm_tpu.

``load_forced_splits`` on a JSON tree written here (the reference's example
file is not in the repo) parses to the JAX package's BFS list, and
``forced_split_info`` is held against the JAX function in
``test_torch_constraints.py``.  One tree from the same gradients (on a
2**-20 grid, so float64 sums are exact in any order) with ``gpu_use_dp``
through the port's compact and masked learners and the JAX learner of the
same kind (the JAX masked learner's fused tree, whose forced phase the
port's step loop carries): the valid records, the counts, the leaf ids and
the leaf outputs exactly equal, the forced splits first.  A forced split
that cannot beat no split aborts the rest of the queue and the tree equals
the unforced one.  End to end, ``lt.train`` moves the default wave learner
to the compact one and writes the JAX package's trees.
"""

import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.forced import load_forced_splits as jax_load
from lightgbm_tpu.learner import TPUTreeLearner
from lightgbm_tpu.learner_compact import CompactTPUTreeLearner
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.forced import load_forced_splits
from lightgbm_tpu_torch.learner import MaskedTreeLearner
from lightgbm_tpu_torch.learner_compact import CompactTreeLearner
from test_torch_learner import _grads

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

CPU = torch.device("cpu")
BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "min_data_in_leaf": 20, "verbosity": -1, "tpu_min_window": 1024,
        "gpu_use_dp": True}
#: three forced nodes: the root on feature 1, its left child on feature 3
#: (NaN-typed), its right child on the categorical feature 4
FORCED = {"feature": 1, "threshold": 0.2,
          "left": {"feature": 3, "threshold": -0.4},
          "right": {"feature": 4, "threshold": 2}}


def _problem(seed=0, n=3000):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    X[rng.rand(n) < 0.1, 3] = np.nan
    X[:, 4] = rng.randint(0, 6, n)
    y = (X[:, 0] + 0.5 * np.nan_to_num(X[:, 3]) + (X[:, 4] == 2)
         + 0.5 * rng.randn(n) > 0.5).astype(np.float32)
    return X.astype(np.float32), y


def _write(tmp_path, spec, name="forced.json"):
    path = tmp_path / name
    path.write_text(json.dumps(spec))
    return str(path)


def _datasets(params, seed=0):
    X, y = _problem(seed)
    dj = lj.Dataset(X, label=y, categorical_feature=[4], params=params) \
        .construct().constructed
    dt = lt.Dataset(X, label=y, categorical_feature=[4],
                    params=dict(params, device_type="cpu")) \
        .construct().constructed
    return dj, dt, _grads(seed, y, dj.num_data_padded)


def test_load_forced_splits_equals_jax(tmp_path):
    params = dict(BASE)
    dj, dt, _ = _datasets(params)
    spec = dict(FORCED, right=dict(FORCED["right"], right={
        "feature": 0, "threshold": 0.1,
        "left": {"feature": 2, "threshold": -1.5}}))
    path = _write(tmp_path, spec)
    want = jax_load(path, dj)
    got = load_forced_splits(path, dt)
    assert [(f.leaf, f.feature_inner, f.threshold_bin, f.is_cat)
            for f in got] == [(f.leaf, f.feature_inner, f.threshold_bin,
                               f.is_cat) for f in want]
    # BFS order with the reference's leaf numbering: split k's right child
    # is leaf k + 1
    assert [(f.leaf, f.feature_inner) for f in got] == \
        [(0, 1), (0, 3), (1, 4), (3, 0), (3, 2)]
    assert [f.is_cat for f in got] == [False, False, True, False, False]
    # an unknown feature ends the list with the JAX package's warning
    bad = _write(tmp_path, dict(FORCED, left={"feature": 9,
                                              "threshold": 0.0}), "bad.json")
    with pytest.warns(UserWarning, match="forced split on feature 9"):
        short = load_forced_splits(bad, dt)
    assert [(f.leaf, f.feature_inner) for f in short] == [(0, 1)]
    assert load_forced_splits(_write(tmp_path, {}, "empty.json"), dt) is None


def _jax_tree(kind, params, dj, forced, g, h, b):
    cls = CompactTPUTreeLearner if kind == "compact" else TPUTreeLearner
    jl = cls(JConfig.from_params(params), dj)
    jl.set_forced_splits(forced)
    rec_f, rec_i, _, leaf_id, leaf_out = (np.asarray(a) for a in jl.train_async(
        *(jnp.asarray(a) for a in (g, h, b))))
    return rec_f, rec_i, leaf_id, leaf_out


def _port_tree(kind, params, dt, forced, g, h, b):
    cls = CompactTreeLearner if kind == "compact" else MaskedTreeLearner
    port = cls(TConfig.from_params(params), dt, CPU)
    port.set_forced_splits(forced)
    rf, ri, leaf_id, leaf_out = port.grow(*(torch.from_numpy(a)
                                            for a in (g, h, b)))
    return port, rf, ri, leaf_id, leaf_out


@pytest.mark.parametrize("kind", ["compact", "masked"])
def test_dp_forced_tree_equals_jax(tmp_path, kind):
    params = dict(BASE, tpu_learner=kind)
    dj, dt, (g, h, b) = _datasets(params)
    path = _write(tmp_path, FORCED)
    rec_j, cnt_j, leaf_j, out_j = _jax_tree(kind, params, dj,
                                            jax_load(path, dj), g, h, b)
    port, rf, ri, leaf_t, out_t = _port_tree(
        kind, params, dt, load_forced_splits(path, dt), g, h, b)
    nv = int((rf[:, 0] > 0.5).sum())
    assert nv == int((rec_j[:, 0] > 0.5).sum()) == port.num_leaves - 1
    assert not rf[nv:, 0].any()
    np.testing.assert_array_equal(rf[:nv], rec_j[:nv])
    np.testing.assert_array_equal(ri[:nv, :2], cnt_j[:nv])
    np.testing.assert_array_equal(leaf_t.numpy(), leaf_j)
    np.testing.assert_array_equal(out_t.to(torch.float32).numpy(),
                                  out_j.astype(np.float32))
    # the forced splits come first: (leaf, feature) of the BFS
    np.testing.assert_array_equal(rf[:3, 1:3], [[0, 1], [0, 3], [1, 4]])
    assert rf[2, -1] == 1.0                          # categorical
    if kind == "compact":
        # one read per split and one for the records
        assert port.host_syncs == nv + 1


@pytest.mark.parametrize("kind", ["compact", "masked"])
def test_forced_abort_on_negative_gain(tmp_path, kind):
    """A forced split that cannot beat no split (a category no row holds
    goes left alone) aborts the remaining forced queue
    (`serial_tree_learner.cpp:612-616`) and growth goes on as without
    forced splits."""
    params = dict(BASE, tpu_learner=kind)
    _, dt, (g, h, b) = _datasets(params)
    bad = {"feature": 4, "threshold": 99,
           "left": {"feature": 3, "threshold": 0.0}}
    forced = load_forced_splits(_write(tmp_path, bad), dt)
    assert len(forced) == 2
    _, rf, ri, leaf_f, out_f = _port_tree(kind, params, dt, forced, g, h, b)
    _, rp, rip, leaf_p, out_p = _port_tree(kind, params, dt, None, g, h, b)
    nv = int((rp[:, 0] > 0.5).sum())
    np.testing.assert_array_equal(rf[:nv], rp[:nv])
    np.testing.assert_array_equal(ri[:nv], rip[:nv])
    assert torch.equal(leaf_f, leaf_p) and torch.equal(out_f, out_p)


def test_end_to_end_equals_jax(tmp_path, capsys):
    """``lt.train`` with the default learner: the factory moves it to the
    compact learner, as the JAX factory does, and the trees equal
    ``lj.train``'s (L2 in dp); the truncation warning for a forced tree
    larger than the leaves allow."""
    X, y = _problem(1, 2000)
    yr = y + X[:, 0]
    path = _write(tmp_path, FORCED)
    params = {"objective": "regression", "num_leaves": 7, "max_bin": 63,
              "min_data_in_leaf": 20, "verbosity": 1, "gpu_use_dp": True,
              "forcedsplits_filename": path}
    bt = lt.train(dict(params, device_type="cpu"),
                  lt.Dataset(X, label=yr, categorical_feature=[4]), 3)
    assert "forcedsplits_filename set" in capsys.readouterr().out
    assert type(bt.gbdt.learner) is CompactTreeLearner
    bj = lj.train(params, lj.Dataset(X, label=yr, categorical_feature=[4]),
                  3)
    assert bt.model_to_string() == bj.model_to_string()
    for tree in bt.gbdt.models:
        assert list(tree.split_feature[:3]) == [1, 3, 4]
    with pytest.warns(UserWarning, match="truncating in BFS order"):
        small = lt.train(dict(params, device_type="cpu", num_leaves=3,
                              verbosity=-1),
                         lt.Dataset(X, label=yr, categorical_feature=[4]), 1)
    assert list(small.gbdt.models[0].split_feature[:2]) == [1, 3]
    warnings.simplefilter("default")
