"""Port device predictor vs the host trees and lightgbm_tpu's DevicePredictor.

After the JAX package's ``tests/test_predictor.py``: the port's
``DevicePredictor`` (run here on the CPU; the same torch code runs on the
card) traverses every tree in bin space and must equal the host per-tree
walk; a model carried across by model text predicts through a bin schema
rebuilt from the text (``reconstruct_bin_schema``) and must equal the JAX
package's device predictor; prediction early stop must freeze the same rows
as the JAX package's; and ``GBDT.predict_raw`` routes by the JAX package's
rule (rows x trees >= 200,000, or ``pred_early_stop``).  Leaf values and sums
are float64 and summed in tree order on both sides, so the bound is 1e-12.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.predictor import DevicePredictor as JDevicePredictor
from lightgbm_tpu.predictor import \
    reconstruct_bin_schema as j_reconstruct_bin_schema
from lightgbm_tpu.serving.binner import BinnerArrays as JBinnerArrays
from lightgbm_tpu_torch.binner import OOV_BIN, BinnerArrays
from lightgbm_tpu_torch.boosting.gbdt import DEVICE_PREDICT_MIN_WORK
from lightgbm_tpu_torch.predictor import DevicePredictor, \
    reconstruct_bin_schema

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

PARAMS = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
          "min_data_in_leaf": 10, "learning_rate": 0.3}
CPU = {"device_type": "cpu"}
ROUNDS = 20


def _problem(seed, n=3000, f=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[::13, 2] = np.nan
    X[rng.rand(n) < 0.3, 3] = 0.0
    y = (X[:, 0] + X[:, 1] * np.nan_to_num(X[:, 2]) > 0).astype(float)
    return X, y


def _test_rows(seed, n=500, f=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[::17, 2] = np.nan
    X[::5, 3] = 0.0
    X[::29, 4] = np.nan      # NaN where training had none
    return X


def _host_raw(gbdt, X):
    out = np.zeros(X.shape[0])
    for t in gbdt.models:
        out += t.predict(np.ascontiguousarray(X, dtype=np.float64))
    return out


@pytest.fixture(scope="module")
def models():
    """The port's trained booster, and the same model in the JAX package
    through its model text (predicting through the JAX package's own
    ``reconstruct_bin_schema``)."""
    X, y = _problem(0)
    bt = lt.train(dict(PARAMS, **CPU), lt.Dataset(X, label=y), ROUNDS,
                  verbose_eval=False)
    bj = lj.Booster(model_str=bt.model_to_string())
    bj.gbdt.train_data = j_reconstruct_bin_schema(bj.gbdt)
    return X, bt, bj


def test_device_predictor_equals_host_trees(models):
    _, bt, _ = models
    Xt = _test_rows(1)
    dp = DevicePredictor(bt.gbdt, bt.gbdt.train_data)
    np.testing.assert_allclose(dp.predict_raw(Xt), _host_raw(bt.gbdt, Xt),
                               rtol=0, atol=1e-12)


def test_text_model_equals_jax_device_predictor(models):
    _, _, bj = models
    Xt = _test_rows(2, n=12_000)          # 12,000 x 20 trees: device path
    want = JDevicePredictor(bj.gbdt, bj.gbdt.train_data).predict_raw(Xt)
    bl = lt.Booster(params=CPU, model_str=bj.model_to_string())
    got = bl.predict(Xt, raw_score=True)
    assert bl.gbdt.device_predictions == 1
    assert bl.gbdt._pred_schema[0] is not None
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, _host_raw(bl.gbdt, Xt), rtol=0,
                               atol=1e-12)


def test_pred_early_stop_freezes_the_rows_jax_freezes(models):
    X, _, bj = models
    es = dict(pred_early_stop=True, pred_early_stop_freq=5,
              pred_early_stop_margin=1.5)
    j_on = JDevicePredictor(bj.gbdt, bj.gbdt.train_data, **es).predict_raw(X)
    j_off = JDevicePredictor(bj.gbdt, bj.gbdt.train_data).predict_raw(X)
    bl = lt.Booster(params=CPU, model_str=bj.model_to_string())
    schema = reconstruct_bin_schema(bl.gbdt)
    t_on = DevicePredictor(bl.gbdt, schema, **es).predict_raw(X)
    t_off = DevicePredictor(bl.gbdt, schema).predict_raw(X)
    frozen = j_on != j_off
    assert 0 < frozen.sum() < len(X)
    np.testing.assert_array_equal(t_on != t_off, frozen)
    np.testing.assert_allclose(t_on, j_on, rtol=0, atol=1e-12)
    # through the booster: pred_early_stop takes the device path at any size
    bl_es = lt.Booster(params=dict(CPU, **es), model_str=bj.model_to_string())
    np.testing.assert_allclose(bl_es.predict(X[:10], raw_score=True),
                               j_on[:10], rtol=0, atol=1e-12)
    assert bl_es.gbdt.device_predictions == 1


def test_routing_rule_at_the_threshold(models):
    _, bt, _ = models
    assert len(bt.gbdt.models) == ROUNDS
    n = DEVICE_PREDICT_MIN_WORK // ROUNDS
    Xt = _test_rows(3, n=n)
    before = bt.gbdt.device_predictions
    small = bt.predict(Xt[:n - 1], raw_score=True)      # 199,980 -> host
    assert bt.gbdt.device_predictions == before
    big = bt.predict(Xt, raw_score=True)                # 200,000 -> device
    assert bt.gbdt.device_predictions == before + 1
    np.testing.assert_allclose(big[:n - 1], small, rtol=0, atol=1e-12)
    # a cut by num_iteration changes the work: 10 trees fall below it
    bt.predict(Xt, raw_score=True, num_iteration=ROUNDS // 2)
    assert bt.gbdt.device_predictions == before + 1


def test_failed_schema_warns_and_predicts_on_the_host(models, monkeypatch):
    _, _, bj = models
    import lightgbm_tpu_torch.predictor as pred

    def broken(gbdt):
        raise ValueError("unexpected model text")
    monkeypatch.setattr(pred, "reconstruct_bin_schema", broken)
    bl = lt.Booster(params=CPU, model_str=bj.model_to_string())
    Xt = _test_rows(4, n=12_000)
    with pytest.warns(UserWarning, match="bin schema"):
        got = bl.predict(Xt, raw_score=True)
    assert bl.gbdt.device_predictions == 0
    np.testing.assert_allclose(got, _host_raw(bl.gbdt, Xt), rtol=0,
                               atol=1e-12)


#: a model text with a categorical split (categories 0, 2 and 5 left; NaN
#: missing, so NaN goes right) and numerical splits with and without NaN
#: missing: the port trains no categorical model, but loads and predicts one
CAT_MODEL_TEXT = """tree
version=v2
num_class=1
num_tree_per_iteration=1
label_index=0
max_feature_idx=2
objective=binary sigmoid:1
feature_names=Column_0 Column_1 Column_2
feature_infos=0:1:2:3:4:5:6:7:8:9 [-3:3] [-3:3]
tree_sizes=0 0

Tree=0
num_leaves=3
num_cat=1
split_feature=0 1
split_gain=10 5
threshold=0 0.5
decision_type=9 2
left_child=-1 -2
right_child=1 -3
leaf_value=0.5 -0.25 0.125
leaf_count=10 10 10
internal_value=0 0
internal_count=30 20
cat_boundaries=0 1
cat_threshold=37
shrinkage=1


Tree=1
num_leaves=3
num_cat=0
split_feature=2 1
split_gain=10 5
threshold=-0.25 1.5
decision_type=2 10
left_child=1 -1
right_child=-2 -3
leaf_value=0.03125 -0.0625 0.25
leaf_count=10 10 10
internal_value=0 0
internal_count=30 20
shrinkage=1


end of trees

feature importances:
Column_0=1

pandas_categorical:null
"""


def test_categorical_text_model_equals_jax_and_host():
    rng = np.random.RandomState(7)
    n = DEVICE_PREDICT_MIN_WORK // 2          # x 2 trees: the device path
    Xt = np.column_stack([rng.randint(-2, 12, n).astype(float),
                          rng.randn(n) * 2, rng.randn(n)])
    Xt[::17, 0] = np.nan                     # unseen, negative, NaN categories
    Xt[::13, 1] = np.nan
    Xt[::7, 1] = 0.0
    bj = lj.Booster(model_str=CAT_MODEL_TEXT)
    want = JDevicePredictor(bj.gbdt, j_reconstruct_bin_schema(bj.gbdt)) \
        .predict_raw(Xt)
    bl = lt.Booster(params=CPU, model_str=CAT_MODEL_TEXT)
    got = bl.predict(Xt, raw_score=True)
    assert bl.gbdt.device_predictions == 1
    assert len(np.unique(got)) == 8          # every leaf pair is reached
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, _host_raw(bl.gbdt, Xt), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("max_bin", [63, 1023])
def test_binner_bit_identical_to_jax_and_mappers(max_bin):
    X, y = _problem(5, n=4000)
    p = {"max_bin": max_bin, "verbosity": -1}
    dj = lj.Dataset(X, label=y, params=p).construct().constructed
    dt = lt.Dataset(X, label=y, params=dict(p, **CPU)).construct().constructed
    Xt = _test_rows(6, n=700)
    Xt[::31, 0] = np.inf
    got = BinnerArrays.for_data(dt).bin_host(Xt)
    np.testing.assert_array_equal(got, JBinnerArrays.for_data(dj)
                                  .bin_host(Xt))
    for k, m in enumerate(dt.bin_mappers):
        j = int(dt.used_feature_map[k])
        np.testing.assert_array_equal(
            got[k], m.values_to_bins_predict(Xt[:, j], OOV_BIN))
    assert got.max() > 255 if max_bin > 255 else got.max() <= 255
