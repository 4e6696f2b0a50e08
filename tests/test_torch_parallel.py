"""Port parallel tree learning vs lightgbm_tpu's mesh learners.

The port runs one process per rank over a gloo group (``RankPool``: ranks
started with ``spawn``, shared by the module's tests); the JAX package
runs its sharded learners in this process on its 8-virtual-device CPU
mesh, ``make_mesh(d)`` with the port's world size ``d``.  The same numpy
inputs go through both:

  * the mesh grammar and the placement tables;
  * the quantized packing and the int16 exchange tier, bitwise;
  * one tree of each sharded learner class, from the same float32
    gradients on a 2**-20 grid with ``gpu_use_dp`` (sums exact in any
    order): records and counts EXACTLY equal to the JAX learner of the
    same class and mesh size, every rank the same;
  * a quantized tree on the int16 tier, its reduced histograms bitwise the
    serial learner's;
  * the replicated batched-stall gate (local windows that straddle the cap
    on one rank only);
  * ``lt.train`` with ``tree_learner=data`` against JAX ``train`` on a
    2-device mesh; the report's collective sites; the router's lines; a
    rank that dies; each spawned rank's card and the backend rule.
"""

import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.parallel import compact_sharded as jcs
from lightgbm_tpu.parallel import feature_sharded as jfs
from lightgbm_tpu.parallel import wave_sharded as jws
from lightgbm_tpu.parallel.learners import apply_parallel_sharding
from lightgbm_tpu.parallel.sharding import make_mesh as jmesh
from lightgbm_tpu_torch.learner import (REC_DEFAULT_LEFT, REC_FEATURE,
                                        REC_IS_CAT, REC_LEAF, REC_THRESHOLD,
                                        REC_VALID)
from lightgbm_tpu_torch.parallel.launch import (RankFailure, RankPool,
                                                free_port)

sys.path.insert(0, os.path.dirname(__file__))
import _torch_parallel_tasks as tasks  # noqa: E402
from test_torch_learner import _grads  # noqa: E402

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
        "verbosity": -1, "enable_bundle": False}
STRUCT = [REC_VALID, REC_LEAF, REC_FEATURE, REC_THRESHOLD, REC_DEFAULT_LEFT,
          REC_IS_CAT]


def _problem(n=2048, f=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.3, 3] = 0.0
    y = (X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 3] + 0.3 * rng.randn(n)
         > 0).astype(np.float64)
    return X, y


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, "gloo", timeout_s=300) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, "gloo", timeout_s=300) as pool:
        yield pool


def _inputs(params, X, y):
    dj = lj.Dataset(X, label=y, params=params).construct().constructed
    dt = tasks._dataset(params, X, y)
    assert dj.num_data_padded == dt.num_data_padded
    g, h, b = _grads(0, y.astype(np.float32), dj.num_data_padded)
    return dj, g, h, b


def _jax_tree(cls, params, dj, g, h, b, mesh):
    learner = cls(JConfig.from_params(params), dj, mesh)
    out = learner.train_async(jnp.asarray(g), jnp.asarray(h),
                              jnp.asarray(b))
    return np.asarray(out[0]), np.asarray(out[1])


def _assert_same_records(outs, rf_j, ri_j, what):
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["rec_f"], outs[0]["rec_f"],
                                      err_msg=f"{what} rank {r}")
        np.testing.assert_array_equal(o["rec_f"][:, STRUCT], rf_j[:, STRUCT],
                                      err_msg=f"{what} structure")
        np.testing.assert_array_equal(o["rec_f"], rf_j, err_msg=what)
        np.testing.assert_array_equal(o["rec_i"][:, :2], ri_j[:, :2],
                                      err_msg=f"{what} counts")


# -- (a) the mesh grammar and the placement tables ---------------------------

def test_mesh_grammar_and_placement_tables_match_jax():
    from lightgbm_tpu.parallel import sharding as js
    from lightgbm_tpu_torch.parallel import sharding as ts
    for spec in ("", "auto", "8", "2x4", "4*2", "2,2", " 3X1 "):
        assert ts.parse_mesh_shape(spec) == js.parse_mesh_shape(spec), spec
    for bad in ("2x2x2", "0x2", "ax2"):
        with pytest.raises(ValueError):
            js.parse_mesh_shape(bad)
        with pytest.raises(ValueError):
            ts.parse_mesh_shape(bad)
    for n in range(1, 17):
        assert ts.default_mesh_shape_2d(n) == js.default_mesh_shape_2d(n)
    names = ["bins", "score", "label_onehot", "grad", "hess", "bag",
             "valid_rows", "bag_mask", "label", "weights", "trans_label",
             "label_sign", "label_w", "label_weight", "rows", "hist",
             "feature/num_bin", "obj/label", "pool"]
    for mode, shape in (("data", None), ("voting", None), ("feature", None),
                        ("data_feature", (1, 1))):
        tm = ts.make_mesh(shape=shape) if shape else ts.make_mesh()
        jm = jmesh(shape=(2, 4)) if shape else jmesh(4)
        trules, jrules = ts.rules_for_mode(mode, tm), \
            js.rules_for_mode(mode, jm)
        for name in names:
            assert trules.spec_for(name) == tuple(jrules.spec_for(name)), \
                (mode, name)
    with pytest.raises(ValueError):
        ts.rules_for_mode("model", ts.make_mesh())


# -- (b) the quantized packing, bitwise --------------------------------------

def test_quant_packing_bitwise_vs_jax():
    from lightgbm_tpu.ops import quant as jq
    from lightgbm_tpu_torch.ops import quant as tq
    rng = np.random.RandomState(3)
    assert tq.PACKED_SAFE_ROWS == jq.PACKED_SAFE_ROWS
    for n in (1, 2184, 2185, 10 ** 6):
        assert tq.exchange_tier(n) == jq.exchange_tier(n)
    gq = rng.randint(-jq.GMAX, jq.GMAX + 1, 9000).astype(np.int32)
    hq = rng.randint(0, jq.HMAX + 1, 9000).astype(np.int32)
    w_t = tq.pack_gh(torch.from_numpy(gq), torch.from_numpy(hq))
    w_j = np.asarray(jq.pack_gh(jnp.asarray(gq), jnp.asarray(hq)))
    np.testing.assert_array_equal(w_t.numpy(), w_j)
    for a, b in zip(tq.unpack_gh(w_t), jq.unpack_gh(jnp.asarray(w_j))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    bins = rng.randint(0, 16, (3, 9000)).astype(np.int32)
    n0 = jq.PACKED_SAFE_ROWS
    one_t = tq.hist_accumulate_packed(torch.from_numpy(bins[:, :n0]),
                                      w_t[:n0], num_bins=16)
    one_j = jq.hist_accumulate_packed(jnp.asarray(bins[:, :n0]),
                                      jnp.asarray(w_j[:n0]), num_bins=16)
    np.testing.assert_array_equal(one_t.numpy(), np.asarray(one_j))
    for chunk in (512, 4096):
        ct = tq.hist_accumulate_packed_chunked(
            torch.from_numpy(bins), torch.from_numpy(gq),
            torch.from_numpy(hq), num_bins=16, chunk=chunk)
        cj = jq.hist_accumulate_packed_chunked(
            jnp.asarray(bins), jnp.asarray(gq), jnp.asarray(hq),
            num_bins=16, chunk=chunk)
        for a, b in zip(ct, cj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(
            ct[1].numpy(), np.stack([np.bincount(bins[f], hq, 16)
                                     for f in range(3)]).astype(np.int32))
    # the int16 tier: a quantized-unit histogram (scales 2**-3, 2**-5, the
    # count channel sum(hq) / m with m = 1.75) through both packers
    sg, sh, mbar = np.float32(0.125), np.float32(0.03125), np.float32(1.75)
    hist = np.stack([rng.randint(-900, 900, (4, 32)) * sg,
                     rng.randint(0, 2000, (4, 32)) * sh,
                     np.zeros((4, 32))], -1).astype(np.float32)
    hist[..., 2] = hist[..., 1] * (np.float32(1.0) / sh / mbar)
    p_t = tq.pack_hist_int16(torch.from_numpy(hist), 1 / sg, 1 / sh, mbar)
    p_j = jq.pack_hist_int16(jnp.asarray(hist), 1 / sg, 1 / sh, mbar)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    u_t = tq.unpack_hist_int16(p_t, sg, sh, np.float32(1.0) / mbar)
    u_j = jq.unpack_hist_int16(p_j, sg, sh, np.float32(1.0) / mbar)
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
    # the words the port's wire carries decode to the same floats
    words = tq.pack_hist_words(torch.from_numpy(hist), 1 / sg, 1 / sh)
    assert words.dtype == torch.int32 and words.shape == hist.shape[:-1]
    np.testing.assert_array_equal(
        tq.unpack_hist_words(words, sg, sh, np.float32(1.0) / mbar).numpy(),
        np.asarray(u_j))


# -- (c) split records of every sharded learner class ------------------------

CLASSES = [
    ("ShardedCompactLearner", jcs.ShardedCompactLearner, {}),
    ("ShardedWaveLearner", jws.ShardedWaveLearner, {}),
    ("ShardedVotingLearner", jcs.ShardedVotingLearner, {"top_k": 2}),
    ("ShardedVotingWaveLearner", jws.ShardedVotingWaveLearner,
     {"top_k": 3}),
    ("FeatureShardedCompactLearner", jfs.FeatureShardedCompactLearner, {}),
    ("FeatureShardedWaveLearner", jfs.FeatureShardedWaveLearner, {}),
]


@pytest.mark.parametrize("name,jcls,extra", CLASSES,
                         ids=[c[0] for c in CLASSES])
def test_sharded_records_equal_jax(pool2, name, jcls, extra):
    X, y = _problem()
    params = dict(BASE, gpu_use_dp=True, **extra)
    dj, g, h, b = _inputs(params, X, y)
    rf_j, ri_j = _jax_tree(jcls, params, dj, g, h, b, jmesh(2))
    outs = pool2.run(tasks.learner_records, name, params, X, y, g, h, b,
                     (2,))
    _assert_same_records(outs, rf_j, ri_j, name)
    assert rf_j[:, REC_VALID].sum() == params["num_leaves"] - 1


def test_sharded_records_equal_jax_four_ranks(pool4):
    """Four row shards (data) and four feature slices (feature)."""
    X, y = _problem(n=4096, f=16, seed=1)
    params = dict(BASE, gpu_use_dp=True)
    dj, g, h, b = _inputs(params, X, y)
    for name, jcls in (("ShardedWaveLearner", jws.ShardedWaveLearner),
                       ("FeatureShardedWaveLearner",
                        jfs.FeatureShardedWaveLearner)):
        rf_j, ri_j = _jax_tree(jcls, params, dj, g, h, b, jmesh(4))
        outs = pool4.run(tasks.learner_records, name, params, X, y, g, h, b,
                         (4,))
        _assert_same_records(outs, rf_j, ri_j, name)


def test_voting_elects_all_features_equals_data(pool2):
    """With ``top_k`` covering every feature the vote elects them all and
    voting's tree is data-parallel's (JAX ``test_parallel.py:165-176``)."""
    X, y = _problem()
    params = dict(BASE, top_k=8)
    _, g, h, b = _inputs(params, X, y)
    vote = pool2.run(tasks.learner_records, "ShardedVotingWaveLearner",
                     params, X, y, g, h, b, (2,))
    data = pool2.run(tasks.learner_records, "ShardedWaveLearner", params, X,
                     y, g, h, b, (2,))
    np.testing.assert_array_equal(vote[0]["rec_f"], data[0]["rec_f"])
    np.testing.assert_array_equal(vote[1]["leaf_id"], data[1]["leaf_id"])


# -- (d) quantized training on the int16 tier ---------------------------------

def test_quantized_int16_tier_bitwise(pool2):
    """n_pad = 2048 <= 2184 rows: the reduced histograms travel as packed
    integer units; the rank's pool slice of the root is bitwise the serial
    learner's, and the records equal the JAX sharded learner's (whose
    int16 tier is the same units)."""
    from lightgbm_tpu_torch.config import Config as TConfig
    from lightgbm_tpu_torch.learner_wave import WaveTreeLearner
    from lightgbm_tpu_torch.ops.quant import exchange_tier
    X, y = _problem()
    params = dict(BASE, tpu_quantized_grad="on", tpu_wave_open_levels=2)
    dj, g, h, b = _inputs(params, X, y)
    assert exchange_tier(dj.num_data_padded) == "int16"
    serial = WaveTreeLearner(TConfig.from_params(dict(params,
                                                      device_type="cpu")),
                             tasks._dataset(params, X, y), tasks.CPU)
    rf_s, ri_s, lid_s, _ = serial.grow(*(torch.from_numpy(a)
                                         for a in (g, h, b)))
    root = serial._st.hist_pool[0].numpy()
    outs = pool2.run(tasks.learner_records, "ShardedWaveLearner", params, X,
                     y, g, h, b, (2,))
    assert root.shape[0] == 8                  # no padding feature
    for o in outs:
        fs = o["pool0"].shape[0]
        assert fs == 4
        np.testing.assert_array_equal(o["pool0"],
                                      root[o["f_off"]:o["f_off"] + fs])
        np.testing.assert_array_equal(o["rec_f"], rf_s)
        np.testing.assert_array_equal(o["leaf_id"], lid_s.numpy())
        calls = o["kernel_calls"]
        assert calls["hist_segments_quant"] > 0 and calls["fused_scan"] > 0
        assert calls["hist_multislot"] > 0
        assert any(s["op"] == "psum_scatter" and s["bytes_per_call"] > 0
                   for s in o["sites"]) or not o["sites"]
    rf_j, ri_j = _jax_tree(jws.ShardedWaveLearner,
                           dict(params, tpu_wave_open_levels=0), dj, g, h, b,
                           jmesh(2))
    np.testing.assert_array_equal(outs[0]["rec_f"][:, STRUCT],
                                  rf_j[:, STRUCT])
    np.testing.assert_array_equal(outs[0]["rec_i"], ri_j)


# -- (e) a decision every rank must take alike --------------------------------

def test_stall_gate_replicated_across_ranks(pool2):
    """JAX ``test_telemetry.py:test_stall_batch_gate_replicated_across_
    devices``: every split lands in the last row shard, so rank 0's local
    windows are empty, under the batched-stall cap, while rank 1's and the
    serial learner's straddle it.  With a rank-local gate the ranks'
    replays would diverge; the maximum over the ranks keeps them equal."""
    from lightgbm_tpu_torch.config import Config as TConfig
    from lightgbm_tpu_torch.learner_wave import WaveTreeLearner
    rng = np.random.RandomState(5)
    n, f = 4096, 6
    X = np.empty((n, f))
    X[:, 0] = np.arange(n)
    X[:, 1:] = rng.randn(n, f - 1)
    y = (rng.rand(n) > 0.5).astype(float)
    params = dict(BASE, num_leaves=31, tpu_wave_stall_batch=4,
                  tpu_wave_vec_cap=128, tpu_wave_overshoot=0.0,
                  tpu_wave_sort_cutoff=256, tpu_sort_cutoff=256,
                  gpu_use_dp=True)
    dt = tasks._dataset(params, X, y)
    n_pad = dt.num_data_padded
    g = np.round(rng.randn(n_pad) * 2 ** 20) / 2 ** 20
    g[:n // 2] = 0.0
    g = g.astype(np.float32)
    h = np.full(n_pad, 0.25, np.float32)
    b = np.zeros(n_pad, np.float32)
    b[:n] = 1.0
    serial = WaveTreeLearner(TConfig.from_params(dict(params,
                                                      device_type="cpu")),
                             dt, tasks.CPU)
    rf_s, ri_s, _, _ = serial.grow(*(torch.from_numpy(a) for a in (g, h, b)))
    assert serial.tree_stats[-1]["stall_splits"] > 0, \
        "the problem no longer stalls: the gate is not exercised"
    outs = pool2.run(tasks.learner_records, "ShardedWaveLearner", params, X,
                     y, g, h, b, (2,))
    for o in outs:
        np.testing.assert_array_equal(o["rec_f"], rf_s)
        np.testing.assert_array_equal(o["rec_i"], ri_s)
        for k in ("waves", "stall_events", "stall_splits", "pops"):
            assert o["stats"][-1][k] == serial.tree_stats[-1][k], k
    dj = lj.Dataset(X, label=y, params=params).construct().constructed
    rf_j, ri_j = _jax_tree(jws.ShardedWaveLearner, params, dj, g, h, b,
                           jmesh(2))
    _assert_same_records(outs, rf_j, ri_j, "stall gate")


# -- (f) lt.train against JAX train on a 2-device mesh ------------------------

def _jax_booster(params, X, y, rounds, mode, mesh):
    ds = lj.Dataset(X, label=y, params=params)
    bst = lj.Booster(params, ds)
    apply_parallel_sharding(bst.gbdt, mesh, mode)
    for _ in range(rounds):
        bst.update()
    return bst


def _structure(text):
    keep = ("split_feature=", "threshold=", "left_child=", "right_child=",
            "num_leaves=", "decision_type=")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


def test_train_data_parallel_equals_jax(pool2):
    X, y = _problem(seed=2)
    params = dict(BASE, tree_learner="data", bagging_fraction=0.8,
                  bagging_freq=1, feature_fraction=0.9)
    jb = _jax_booster(params, X, y, 5, "data", jmesh(2))
    assert type(jb.gbdt.learner).__name__ == "ShardedWaveLearner"
    outs = pool2.run(tasks.train_model, params, X, y, 5)
    assert outs[0]["learner"] == "ShardedWaveLearner"
    assert outs[0]["text"] == outs[1]["text"]
    assert _structure(outs[0]["text"]) == _structure(jb.model_to_string())
    np.testing.assert_allclose(outs[0]["pred"], jb.predict(X), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("extra", [
    {"objective": "regression_l1", "metric": "l1"},
    {"objective": "multiclass", "num_class": 3, "metric": "multi_logloss"},
    {"boosting": "goss", "learning_rate": 0.5},
    {"max_bin": 300},
], ids=["l1_renew", "multiclass", "goss", "masked_300_bins"])
def test_train_modes_equal_serial(pool2, extra):
    """The row placement's global views (leaf renewal, multiclass, GOSS's
    global selection, the masked learner's summed histograms) leave the
    model text the serial one, in every mode."""
    X, y = _problem(seed=4)
    if extra.get("objective") == "multiclass":
        y = np.digitize(X[:, 0] + 0.3 * X[:, 1], [-0.5, 0.5]).astype(float)
    if extra.get("objective") == "regression_l1":
        y = X[:, 0] * 2 + X[:, 1]
    params = dict(BASE, gpu_use_dp=True, **extra)
    ser = tasks.train_model(dict(params, tree_learner="serial"), X, y, 4)
    for mode in ("data", "voting", "feature"):
        outs = pool2.run(tasks.train_model,
                         dict(params, tree_learner=mode, top_k=8), X, y, 4)
        assert outs[0]["text"] == outs[1]["text"], mode
        assert _structure(outs[0]["text"]) == _structure(ser["text"]), mode
        np.testing.assert_allclose(outs[0]["pred"], ser["pred"], rtol=1e-6,
                                   atol=1e-6, err_msg=mode)


def test_forced_splits_ride_the_sequential_sharded_learner(pool2, tmp_path):
    """A forced-split tree moves data and voting to the sequential sharded
    learners (the forced feature's pool row fetched from the rank that
    pools it) and feature to the feature-sharded compact learner: the
    serial model, the forced splits first."""
    import json
    path = tmp_path / "forced.json"
    path.write_text(json.dumps({
        "feature": 1, "threshold": 0.2,
        "left": {"feature": 3, "threshold": -0.4},
        "right": {"feature": 6, "threshold": 0.5}}))
    X, y = _problem(seed=8)
    params = dict(BASE, gpu_use_dp=True, forcedsplits_filename=str(path))
    ser = tasks.train_model(dict(params, tree_learner="serial"), X, y, 3)
    for mode, cls in (("data", "ShardedCompactLearner"),
                      ("voting", "ShardedVotingLearner"),
                      ("feature", "FeatureShardedCompactLearner")):
        outs = pool2.run(tasks.train_model,
                         dict(params, tree_learner=mode, top_k=8), X, y, 3)
        assert outs[0]["learner"] == cls
        assert outs[0]["text"] == outs[1]["text"], mode
        assert _structure(outs[0]["text"]) == _structure(ser["text"]), mode
    first = [ln for ln in _structure(ser["text"])
             if ln.startswith("split_feature=")][0]
    assert first.split("=")[1].split()[:3] == ["1", "3", "6"]


def test_crash_and_resume_data_parallel(pool2, tmp_path):
    """A data-parallel run killed after its third iteration resumes from
    its snapshot (the score gathered from both ranks, rank 0 writing) to
    the uninterrupted run's model text, on every rank."""
    X, y = _problem(seed=7)
    params = dict(BASE, tree_learner="data", bagging_fraction=0.8,
                  bagging_freq=1)
    outs = pool2.run(tasks.train_crash_resume, params, X, y, 5,
                     str(tmp_path))
    for whole, resumed in outs:
        assert resumed == whole == outs[0][0]
    assert (tmp_path / "m.txt.snapshot_iter_2").exists()


# -- (g) the report's collective sites ----------------------------------------

def _site_set(sites):
    return {(s["op"], s["phase"], s["cadence"], s["bytes_per_call"])
            for s in sites}


def test_collective_sites_equal_jax_report(pool2):
    """The data-parallel compact learner issues the JAX learner's
    collectives at the JAX learner's seams: the same (op, phase, cadence,
    payload bytes) sites; the counted calls fill ``per_tree_estimate``;
    a serial run reports no site."""
    X, y = _problem()
    params = dict(BASE, tree_learner="data", tpu_learner="compact",
                  telemetry=True)
    jb = _jax_booster(params, X, y, 2, "data", jmesh(2))
    j_sites = jb.get_telemetry()["collectives"]["sites"]
    outs = pool2.run(tasks.train_model, params, X, y, 2)
    coll = outs[0]["collectives"]
    assert outs[0]["learner"] == "ShardedCompactLearner"
    assert _site_set(coll["sites"]) == _site_set(j_sites)
    assert coll["per_tree_estimate"]["count"] > 0
    assert coll["per_tree_estimate"]["bytes"] > 0
    assert coll["transport"] == "direct"        # gloo on CPU tensors
    assert coll["report_errors"] == []
    ser = tasks.train_model(dict(params, tree_learner="serial"), X, y, 2)
    assert ser["collectives"]["sites"] == []


# -- (h) a rank that dies -----------------------------------------------------

def test_dead_rank_raises_within_timeout(tmp_path):
    """Rank 1 exits once the group is up: rank 0, waiting in an all-reduce
    with it and with no pool to kill it, raises within the group timeout
    (it does not hang) and exits non-zero."""
    flag = tmp_path / "rank0.txt"
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=tasks.survivor,
                         args=(r, 2, port, str(flag), 20))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=90)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} did not exit"
    assert procs[1].exitcode == 3
    assert procs[0].exitcode not in (0, None)
    secs, err = flag.read_text().split()
    assert float(secs) < 20 and err


def test_pool_fails_when_a_rank_dies(tmp_path):
    """A rank that dies in a task fails the pool's run, naming a rank; the
    pool kills the other ranks and closes."""
    pool = RankPool(2, "gloo", timeout_s=20)
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="rank"):
        pool.run(tasks.die_in_collective, str(tmp_path / "rank0.txt"), 20)
    assert pool.closed
    assert not any(p.is_alive() for p in pool._procs)
    with pytest.raises(RankFailure, match="closed"):
        pool.run(tasks.rank_info)
    assert time.monotonic() - t0 < 45


def test_spawned_ranks_pick_their_own_card(pool2):
    """The pool's ranks are local ranks, as under ``torchrun``:
    ``resolve_device`` gives rank r card r on a host with a card each."""
    assert pool2.run(tasks.local_device) == [("0", "2", "cuda:0"),
                                             ("1", "2", "cuda:1")]


def test_default_backend(monkeypatch):
    """The world's backend from every rank's card: NCCL only when each rank
    has a card and no two share one; gloo otherwise (the CPU, two ranks on
    one card).  A pool without a backend lets its ranks choose."""
    from lightgbm_tpu_torch.parallel.sharding import card_id, default_backend
    assert default_backend(["GPU-a", "GPU-b"]) == "nccl"
    assert default_backend(["GPU-a", "GPU-a"]) == "gloo"
    assert default_backend(["GPU-a", None]) == "gloo"
    assert default_backend([None, None]) == "gloo"
    assert default_backend([]) == "gloo"
    assert card_id("cpu") is None
    with RankPool(2) as pool:
        assert pool.backend == "gloo"
        assert [r[2] for r in pool.run(tasks.rank_info)] == ["gloo", "gloo"]


def test_failing_task_names_the_rank():
    """A task that raises on one rank fails the whole run with that rank's
    traceback, and the pool closes."""
    with RankPool(2, "gloo") as pool:
        assert [r[:2] for r in pool.run(tasks.rank_info)] == [(0, 2), (1, 2)]
        with pytest.raises(RankFailure,
                           match="(?s)rank 1 raised.*failure on rank 1"):
            pool.run(tasks.fail_on_rank, 1)
        assert pool.closed


# -- (i) the router's lines ---------------------------------------------------

def test_router_lines_equal_jax(pool2, capsys):
    """JAX ``test_parallel.py:391-407``: the chosen learner named, and a
    refused fast path named with its gate, in the JAX router's words."""
    X, y = _problem(n=2049)
    for extra in ({}, {"max_bin": 300}, {"tpu_learner": "compact"}):
        params = dict(BASE, verbosity=1, tree_learner="data", **extra)
        capsys.readouterr()
        _jax_booster(params, X, y, 0, "data", jmesh(2))
        # (the JAX Booster routes once over all eight devices, then over
        # the 2-device mesh: its last line is the one to compare)
        j_lines = [ln.split("] ", 1)[1] for ln in
                   capsys.readouterr().out.splitlines()
                   if ln.startswith("[lightgbm_tpu] tree_learner=")]
        outs = pool2.run(tasks.router_lines, params, X, y)
        assert j_lines and outs[0] == j_lines[-1:] == outs[1], \
            (outs, j_lines)


def test_world_of_one_meshes_are_identities():
    """Without a process group the mesh is one rank and every collective
    returns its operand."""
    from lightgbm_tpu_torch.parallel.sharding import make_mesh, world_size
    assert world_size() == 1
    m = make_mesh()
    x = torch.arange(6.0).view(2, 3)
    assert m.psum(x, "data") is x and m.pmax(x) is x
    assert m.psum_scatter(x, "data", 1) is x
    assert m.all_gather(x, "data").shape == (1, 2, 3)
    assert m.transport("cpu") == "none" and m.calls == 0
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(2)


def test_placement_and_gather_in_ranks(pool2):
    out = pool2.run(tasks.place_and_gather, 11)
    for r, (block, whole) in enumerate(out):
        np.testing.assert_array_equal(block, np.arange(11)[r * 6:(r + 1) * 6])
        np.testing.assert_array_equal(whole, np.arange(11))
