"""Port objectives and score plumbing vs lightgbm_tpu: the whole objective
table, the percentile leaf renewal, sample weights, init scores, label
weighting.

Every objective of the JAX table on the same float32 scores: gradients
within 1e-6 relative, ``boost_from_score`` and ``convert_output`` within
1e-12.  The renewal of L1, quantile and MAPE on the same tree, leaf ids,
residuals and bag: equal leaf outputs.  Then the same float32 data through
both packages' ``train``.  The L2, L1, quantile and ``reg_sqrt`` cases run in
dp, where both packages' gradients are exact and their float64 histogram
sums agree, so the trees match in structure and leaf values within 1e-5;
the others run in float32 (summation order differs): held-out metrics
within 1e-4 per iteration.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import objectives as jobj
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import Metadata as JMetadata
from lightgbm_tpu.tree import Tree as JTree
from lightgbm_tpu_torch import objectives as tobj
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.tree import Tree as TTree

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

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
    _tree_fields_equal(bj, bt)
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


# --------------------------------------------------------------------------
# The whole objective table: gradients, boost_from_score, convert_output
# --------------------------------------------------------------------------

CPU = torch.device("cpu")
#: the JAX package's table (``objectives.py:542-559``), reg_sqrt as its own
#: case; K = 3 for the multiclass objectives
TABLE = {
    "regression": {}, "reg_sqrt": {"objective": "regression",
                                   "reg_sqrt": True},
    "regression_l1": {}, "huber": {}, "fair": {}, "poisson": {},
    "quantile": {}, "mape": {}, "gamma": {}, "tweedie": {}, "binary": {},
    "multiclass": {"num_class": 3}, "multiclassova": {"num_class": 3},
    "cross_entropy": {}, "cross_entropy_lambda": {}, "lambdarank": {},
}
N, N_PAD = 500, 512


def _objective_pair(case, weighted, seed=0):
    """Both packages' objectives initialised on the same metadata, with a
    label valid for the objective."""
    rng = np.random.RandomState(seed)
    params = dict({"objective": case}, **TABLE[case])
    name = params["objective"]
    k = params.get("num_class", 1)
    if name in ("poisson", "gamma", "tweedie", "mape"):
        y = rng.gamma(2.0, 1.0, N)
    elif name.startswith("cross_entropy"):
        y = rng.rand(N)
    elif name == "binary":
        y = (rng.rand(N) > 0.5) * 1.0
    elif k > 1:
        y = rng.randint(0, k, N) * 1.0
    elif name == "lambdarank":
        y = rng.randint(0, 5, N) * 1.0
    else:
        y = rng.randn(N) * 2.0
    w = rng.uniform(0.2, 2.0, N) if weighted else None
    group = np.diff(np.r_[0, np.sort(rng.choice(np.arange(1, N), 40,
                                                replace=False)), N])
    metas = JMetadata(N), TMetadata(N)
    for m in metas:
        m.set_label(y)
        m.set_weights(w)
        if name == "lambdarank":
            m.set_group(group)
    oj = jobj.create_objective(JConfig.from_params(params))
    ot = tobj.create_objective(TConfig.from_params(params), CPU)
    oj.init(metas[0], N, N_PAD)
    ot.init(metas[1], N, N_PAD)
    return oj, ot, k, rng


def _close(t, j):
    """Within 1e-6 of the reference, relative to its largest magnitude
    (elementwise relative error is unbounded where a gradient cancels to
    near zero, e.g. Poisson's exp(s) - y); NaN where the reference is NaN
    (the weighted cross-entropy-lambda on zero-weight padding rows)."""
    j = np.asarray(j, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    scale = float(np.nanmax(np.abs(j)))
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", list(TABLE))
def test_objective_table_matches_jax(case, weighted):
    """Every objective of the JAX table on the same float32 scores:
    gradients and hessians (multiclass softmax jointly over (K, N)) within
    1e-6 relative, boost_from_score within 1e-12, convert_output within
    1e-12, the model-text name equal."""
    oj, ot, k, rng = _objective_pair(case, weighted)
    s = (rng.randn(k, N_PAD) * 0.5).astype(np.float32)
    if ot.name == "multiclass":
        gj, hj = oj.get_gradients_all(jnp.asarray(s))
        gt, ht = ot.get_gradients_all(torch.from_numpy(s))
        pairs = [(gt, gj), (ht, hj)]
    else:
        pairs = []
        for c in range(k):
            gj, hj = oj.get_gradients(jnp.asarray(s[c]), c)
            gt, ht = ot.get_gradients(torch.from_numpy(s[c]), c)
            pairs += [(gt, gj), (ht, hj)]
    for t, j in pairs:
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
        _close(t.numpy(), j)
    for c in range(k):
        np.testing.assert_allclose(ot.boost_from_score(c),
                                   oj.boost_from_score(c), rtol=0,
                                   atol=1e-12)
    raw = rng.randn(64, k) if k > 1 else rng.randn(64)
    np.testing.assert_allclose(ot.convert_output(raw), oj.convert_output(raw),
                               rtol=0, atol=1e-12)
    assert ot.to_string() == oj.to_string()
    assert ot.needs_renew_tree_output == oj.needs_renew_tree_output
    assert ot.num_model_per_iteration == oj.num_model_per_iteration


def test_create_objective_none_and_unknown():
    for name in ("none", "custom"):
        assert tobj.create_objective(
            TConfig.from_params({"objective": name}), CPU) is None
    cfg = TConfig.from_params({})
    cfg.objective = "not_an_objective"
    with pytest.raises(ValueError, match="Unknown objective"):
        tobj.create_objective(cfg, CPU)


def test_multiclass_labels_validated():
    meta = TMetadata(4)
    meta.set_label([0, 1, 3, 1])
    for name in ("multiclass", "multiclassova"):
        obj = tobj.create_objective(TConfig.from_params(
            {"objective": name, "num_class": 3}), CPU)
        with pytest.raises(ValueError, match=r"Label must be in \[0, 3\)"):
            obj.init(meta, 4, 8)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", ["regression_l1", "quantile", "mape"])
def test_percentile_renewal_equals_jax(case, weighted):
    """The same tree, leaf ids, residuals and bag mask through both
    packages' ``renew_tree_output``: every leaf output equal (float64); a
    leaf with no bagged row keeps its value."""
    oj, ot, _, rng = _objective_pair(case, weighted, seed=3)
    leaves = 9
    tj, tt = JTree(leaves), TTree(leaves)
    for t in (tj, tt):
        t.num_leaves = leaves
        t.leaf_value[:leaves] = np.arange(leaves) * 0.25 - 1.0
    leaf_id = rng.randint(0, leaves - 1, N_PAD).astype(np.int64)
    leaf_id[rng.rand(N_PAD) < 0.1] = 4          # leaf 4 has masked rows only
    mask = (rng.rand(N_PAD) < 0.8).astype(np.float32)
    mask[leaf_id == 4] = 0.0
    mask[N:] = 0.0
    score = (rng.randn(N) * 0.7).astype(np.float32)
    oj.renew_tree_output(tj, score, leaf_id, mask)
    ot.renew_tree_output(tt, score, leaf_id, mask)
    assert tt.leaf_value.dtype == np.float64
    np.testing.assert_array_equal(tt.leaf_value, tj.leaf_value)
    assert tt.leaf_value[4] == 0.0 and tt.leaf_value[leaves - 1] == 1.0
    assert not np.array_equal(tt.leaf_value[:4],
                              np.arange(4) * 0.25 - 1.0)


def _tree_fields_equal(bj, bt):
    assert len(bj.gbdt.models) == len(bt.gbdt.models) > 0
    for tj, tt in zip(bj.gbdt.models, bt.gbdt.models):
        nl = tj.num_leaves
        assert nl == tt.num_leaves > 1
        for f in ("split_feature", "threshold_in_bin", "decision_type"):
            np.testing.assert_array_equal(getattr(tt, f)[:nl - 1],
                                          getattr(tj, f)[:nl - 1])
        np.testing.assert_array_equal(tt.leaf_count[:nl], tj.leaf_count[:nl])
        np.testing.assert_allclose(tt.leaf_value[:nl], tj.leaf_value[:nl],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("learner", ["wave", "compact"])
@pytest.mark.parametrize("case", ["regression_l1", "quantile", "reg_sqrt"])
def test_renewing_and_sqrt_objectives_dp_trees_match(case, learner):
    """In dp, L1 (a sign), quantile (alpha or alpha - 1) and L2 with
    reg_sqrt give gradients exact in both packages: with weights and init
    scores the trees, renewed leaf values included, match field for field,
    and the held-out metric per iteration; one renewal read per tree."""
    params = dict(BASE, **TABLE[case], gpu_use_dp=True, tpu_learner=learner)
    params.setdefault("objective", case)
    (bj, ej), (bt, et) = (_train(lj, params, False, 2),
                          _train(lt, dict(params, device_type="cpu"), False,
                                 2))
    _tree_fields_equal(bj, bt)
    assert type(bt.gbdt.learner).__name__ == {
        "wave": "WaveTreeLearner", "compact": "CompactTreeLearner"}[learner]
    renews = bt.gbdt.objective.needs_renew_tree_output
    assert bt.gbdt.renew_reads == (ROUNDS if renews else 0)
    for m in ej["heldout"]:
        np.testing.assert_allclose(et["heldout"][m], ej["heldout"][m],
                                   rtol=1e-6, atol=1e-7, err_msg=m)


def _label_for(case, y):
    if case in ("poisson", "gamma", "tweedie", "mape"):
        return np.exp(0.5 * y) + 0.05
    if case.startswith("cross_entropy"):
        return 1.0 / (1.0 + np.exp(-2.0 * y))
    if case == "multiclassova":
        return np.digitize(y, np.percentile(y, [33, 66])).astype(np.float64)
    return 2.0 * y


@pytest.mark.parametrize("case,weighted", [
    ("huber", True), ("fair", True), ("poisson", True), ("gamma", True),
    ("tweedie", True), ("mape", True), ("cross_entropy", True),
    ("cross_entropy_lambda", False), ("cross_entropy_lambda", True),
    ("multiclassova", True)])
def test_f32_heldout_metrics_match(case, weighted):
    """The other objectives in float32 through the default (wave) learner:
    held-out metric within 1e-4 per iteration.  The weighted
    cross-entropy-lambda gradient is NaN on every zero-weight row, the
    padding rows included, in both packages (ROADMAP.md Queue C), so both
    stop after one constant tree; its unweighted form trains every round."""
    X, z, w, _ = _data(1, False)
    w = w if weighted else None
    y = _label_for(case, z).astype(np.float32)
    params = dict(BASE, **TABLE[case], objective=case, tpu_learner="auto")
    res = []
    for lib, p in ((lj, params), (lt, dict(params, device_type="cpu"))):
        ds = lib.Dataset(X[:2400], label=y[:2400],
                         weight=None if w is None else w[:2400], params=p)
        dv = ds.create_valid(X[2400:], label=y[2400:],
                             weight=None if w is None else w[2400:])
        ev = {}
        bst = lib.train(p, ds, ROUNDS, valid_sets=[dv],
                        valid_names=["heldout"], evals_result=ev,
                        verbose_eval=False)
        res.append((ev["heldout"], len(bst.gbdt.models)))
    (ej, nj), (et, nt) = res
    assert set(ej) == set(et) and ej and nt == nj
    stops = case == "cross_entropy_lambda" and weighted
    assert nt == (1 if stops else ROUNDS * params.get("num_class", 1))
    for m in ej:
        a, b = np.asarray(ej[m]), np.asarray(et[m])
        assert len(a) == len(b) and np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=m)
