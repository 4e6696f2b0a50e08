"""Port 2-D data x feature learning vs lightgbm_tpu's ShardedWave2DLearner.

As ``tests/test_torch_parallel.py``: gloo ranks started with ``spawn`` (one
module-scoped pool per world size), the JAX learner in this process on its
8-virtual-device mesh at the same mesh shape, the same float32 gradients
on a 2**-20 grid with ``gpu_use_dp``.  The records must be EXACTLY the JAX
learner's at (1, 2), (2, 1) and (2, 2), on every rank; ``lt.train`` with
``tree_learner=data_feature`` must give the serial model; the router's
fall-back from the 2-D mode to data-parallel must name its gate.
"""

import os
import sys


import numpy as np
import pytest
import torch

from lightgbm_tpu.parallel.sharding import AXIS_DATA, AXIS_FEATURE
from lightgbm_tpu.parallel.sharding import make_mesh as jmesh
from lightgbm_tpu.parallel.wave2d_sharded import ShardedWave2DLearner
from lightgbm_tpu_torch.parallel.launch import RankPool

sys.path.insert(0, os.path.dirname(__file__))
import _torch_parallel_tasks as tasks  # noqa: E402
from test_torch_parallel import (BASE, _assert_same_records,  # noqa: E402
                                 _inputs, _jax_booster, _jax_tree, _problem,
                                 _structure)

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, "gloo", timeout_s=300) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, "gloo", timeout_s=300) as pool:
        yield pool


def _mesh2d(shape):
    return jmesh(shape=shape, axis_names=(AXIS_DATA, AXIS_FEATURE))


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)],
                         ids=["1x2", "2x1", "2x2"])
def test_wave2d_records_equal_jax(pool2, pool4, shape):
    X, y = _problem(n=4096, f=16, seed=3)
    params = dict(BASE, gpu_use_dp=True)
    dj, g, h, b = _inputs(params, X, y)
    rf_j, ri_j = _jax_tree(ShardedWave2DLearner, params, dj, g, h, b,
                           _mesh2d(shape))
    pool = pool4 if shape == (2, 2) else pool2
    outs = pool.run(tasks.learner_records, "ShardedWave2DLearner", params, X,
                    y, g, h, b, shape)
    _assert_same_records(outs, rf_j, ri_j, f"2-D {shape}")
    assert outs[0]["stats"][-1]["pops"] == params["num_leaves"] - 1


def test_train_data_feature_equals_serial_and_jax(pool4):
    X, y = _problem(n=4096, f=16, seed=6)
    params = dict(BASE, tree_learner="data_feature",
                  parallel_mesh="2x2", gpu_use_dp=True)
    ser = tasks.train_model(dict(params, tree_learner="serial"), X, y, 4)
    outs = pool4.run(tasks.train_model, params, X, y, 4)
    assert outs[0]["learner"] == "ShardedWave2DLearner"
    assert all(o["text"] == outs[0]["text"] for o in outs)
    assert _structure(outs[0]["text"]) == _structure(ser["text"])
    np.testing.assert_allclose(outs[0]["pred"], ser["pred"], rtol=1e-6,
                               atol=1e-6)
    jb = _jax_booster(params, X, y, 4, "data_feature", _mesh2d((2, 2)))
    assert _structure(outs[0]["text"]) == _structure(jb.model_to_string())
    np.testing.assert_allclose(outs[0]["pred"], jb.predict(X), rtol=1e-5,
                               atol=1e-5)


def test_wave2d_fallback_to_data_names_gate(pool2, capsys):
    """8 features pack into 2 words; a 1 x 2 mesh splits them, but
    ``tpu_learner=compact`` is not the 2-D learner's: the router falls back
    to data-parallel over the flat mesh in the JAX router's words."""
    X, y = _problem()
    params = dict(BASE, verbosity=1, tree_learner="data_feature",
                  parallel_mesh="1x2", tpu_learner="compact")
    capsys.readouterr()
    _jax_booster(params, X, y, 0, "data_feature", _mesh2d((1, 2)))
    j_lines = [ln.split("] ", 1)[1] for ln in
               capsys.readouterr().out.splitlines()
               if ln.startswith("[lightgbm_tpu] tree_learner=")]
    outs = pool2.run(tasks.router_lines, params, X, y)
    assert outs[0] == outs[1] == j_lines[-2:], (outs, j_lines)
    assert "falling back to tree_learner=data" in outs[0][0]
