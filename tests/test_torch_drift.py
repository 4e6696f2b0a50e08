"""The port's drift monitor against lightgbm_tpu's, on the CPU.

``lightgbm_tpu_torch.observability.drift`` is host numpy like the JAX
module, so its numbers must equal the JAX package's exactly: PSI and KS of
the same seeded counts and samples, and ``DriftMonitor.section()`` /
``gauges()`` of the same model text over the same baseline and windows (a
binary model with a categorical column; numerical, categorical, NaN and
unseen-category traffic, a window with feature 0 shifted by +6 and one
with the categorical column remapped).  A baseline file saved by either
package restores in the other and judges the next window identically.
"""

import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
from lightgbm_tpu.observability import drift as jdrift
from lightgbm_tpu.observability.metrics_export import \
    prometheus_snapshot as jprometheus_snapshot
from lightgbm_tpu.serving.batcher import ServingStats as JStats
from lightgbm_tpu.serving.registry import ServingModel as JModel

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.observability import drift
from lightgbm_tpu_torch.observability.metrics_export import \
    prometheus_snapshot
from lightgbm_tpu_torch.serving.batcher import ServingStats
from lightgbm_tpu_torch.serving.registry import ServingModel

torch.set_num_threads(1)

CPU = {"device_type": "cpu"}


def _rows(rng, n):
    X = np.column_stack([
        rng.randn(n),
        rng.randint(0, 12, n).astype(float),          # categorical
        rng.randn(n) * 10,
        np.where(rng.rand(n) < 0.4, 0.0, rng.randn(n)),
    ])
    X[::13, 0] = np.nan
    X[::7, 1] = np.nan
    return X


def _traffic(rng, n):
    """Served rows: the training distribution with unseen and negative
    categories mixed in."""
    X = _rows(rng, n)
    X[::9, 1] = rng.randint(-3, 25, len(X[::9, 1]))
    return X


@pytest.fixture(scope="module")
def models():
    """(JAX ServingModel, port ServingModel) of one model text."""
    rng = np.random.RandomState(5)
    X = _rows(rng, 2000)
    y = (np.nan_to_num(X[:, 0]) + (X[:, 1] % 3 == 1) > 0.5).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "min_data_in_leaf": 10, **CPU}
    bst = lt.train(p, lt.Dataset(X, label=y, categorical_feature=[1]), 8,
                   verbose_eval=False)
    text = bst.model_to_string()
    jm = JModel(lj.Booster(model_str=text), JStats())
    pm = ServingModel(lt.Booster(model_str=text, params=dict(CPU)),
                      ServingStats())
    return jm, pm


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_psi_and_ks_equal_jax(seed):
    """The three statistics on seeded count histograms and samples (empty
    bins, a zero histogram, ties) equal the JAX package's bit for bit."""
    rng = np.random.RandomState(seed)
    p = rng.randint(0, 50, 40)
    q = rng.randint(0, 50, 40)
    p[::5] = 0
    for a, b in ((p, q), (p, p), (p, np.zeros_like(p)), (q[:10], p[:10])):
        assert drift.psi_from_counts(a, b) == jdrift.psi_from_counts(a, b)
        assert drift.ks_from_counts(a, b) == jdrift.ks_from_counts(a, b)
        assert drift.psi_from_counts(*drift._psi_groups(a, b)) == \
            jdrift.psi_from_counts(*jdrift._psi_groups(a, b))
    a = np.round(rng.randn(300), 1)
    b = np.round(rng.randn(200) + 0.3, 1)
    assert drift.ks_2samp(a, b) == jdrift.ks_2samp(a, b)
    assert drift.ks_2samp(a, []) == jdrift.ks_2samp(a, []) == (0.0, 1.0)


def test_sections_equal_jax(models):
    """Baseline, a clean window, a window with feature 0 shifted by +6 and
    one with the categorical column remapped: every section and the gauges
    equal JAX's exactly, the shift is named, the clean window is not."""
    jm, pm = models
    rng = np.random.RandomState(11)
    base = _traffic(rng, 400)
    clean = _traffic(rng, 300)
    shifted = _traffic(rng, 300)
    shifted[:, 0] = np.nan_to_num(shifted[:, 0]) + 6.0
    remapped = _traffic(rng, 300)
    remapped[:, 1] = np.where(np.isnan(remapped[:, 1]), 7.0,
                              remapped[:, 1] % 2)
    jmon = jdrift.DriftMonitor(min_rows=32)
    pmon = drift.DriftMonitor(min_rows=32)
    assert pmon.check(pm, clean) is None is jmon.check(jm, clean)
    assert pmon.capture(pm, base[:16]) is False       # under min_rows
    assert jmon.capture(jm, base) and pmon.capture(pm, base)
    verdicts = []
    for X in (clean, shifted, remapped, clean[:10]):
        want, got = jmon.check(jm, X), pmon.check(pm, X)
        assert got == want
        assert pmon.section() == jmon.section()
        assert pmon.gauges() == jmon.gauges()
        verdicts.append(None if got is None else got["drifted"])
    assert verdicts == [False, True, True, None]
    last = pmon.section()
    assert last["checks"] == 3 and last["alerts"] == 2
    shifted_sec = drift.DriftMonitor(min_rows=32)
    shifted_sec.capture(pm, base)
    sec = shifted_sec.check(pm, shifted)
    assert sec["top_features"][0] == "Column_0"


def test_drift_prometheus_lines_equal_jax(models):
    """The ``lgbt_serving_drift_*`` lines of a monitor on a metrics page
    equal the JAX package's."""
    jm, pm = models
    rng = np.random.RandomState(12)
    base, win = _traffic(rng, 200), _traffic(rng, 200)
    win[:, 0] += 6.0
    jmon, pmon = jdrift.DriftMonitor(), drift.DriftMonitor()
    jmon.capture(jm, base), pmon.capture(pm, base)
    jmon.check(jm, win), pmon.check(pm, win)

    def drift_lines(text):
        return [ln for ln in text.splitlines()
                if "lgbt_serving_drift_" in ln]

    want = drift_lines(jprometheus_snapshot(JStats(), drift=jmon))
    got = drift_lines(prometheus_snapshot(ServingStats(), drift=pmon))
    assert got == want and any("lgbt_serving_drift_drifted 1" == ln
                               for ln in got)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_baseline_file_restores_in_the_other_package(models, tmp_path,
                                                     writer):
    """A baseline saved by one package restores in the other; the restored
    monitor's check of the next window equals the writer's."""
    jm, pm = models
    rng = np.random.RandomState(13)
    base, win = _traffic(rng, 256), _traffic(rng, 128)
    win[:, 2] *= 3.0
    path = str(tmp_path / "baselines.json")
    mods = {"port": (drift.DriftMonitor, pm), "jax": (jdrift.DriftMonitor,
                                                       jm)}
    reader = "jax" if writer == "port" else "port"
    wcls, wmodel = mods[writer]
    rcls, rmodel = mods[reader]
    wmon = wcls(min_rows=32)
    assert wmon.capture(wmodel, base) and wmon.save(path) == 1
    assert set(json.load(open(path))["drift_baselines"]) == {"default"}
    rmon = rcls(min_rows=32)
    assert rmon.restore(path) == 1 and rmon.has_baseline("default")
    assert rmon.restore(path) == 0           # in-memory baselines win
    assert rmon.check(rmodel, win) == wmon.check(wmodel, win)
    assert rcls().restore(str(tmp_path / "missing.json")) == 0
