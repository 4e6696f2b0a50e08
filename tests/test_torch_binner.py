"""Predict-time binning: the port's three binners against lightgbm_tpu's.

``BinnerArrays.bin_host`` (numpy), ``bin_plain`` (torch, the CPU side of
``bin_predict``, whose CUDA kernel ``csrc/bin_predict.cu`` the card tests
hold against it) and the JAX package's jitted ``_bin_device`` and host
``bin_host`` must give the same codes, bit for bit, over mappers fitted on
the same data: numerical features with and without a NaN bin, a
zero-as-missing feature, categorical features with and without NaN, at 63,
255 and 1,023 bins.  The rows hold the adversarial values: NaN, +-inf, -0.0,
values exactly on a bin bound and one ulp either side, 1e30; categories
unseen, negative, fractional (-0.5 is category 0), past the table and NaN.
The suite runs JAX with x64, so the JAX binner searches float64 bounds as
the port does.  Then a model loaded from its text predicts through the
port's device path on a CPU device within 1e-12 of the JAX
``Booster.predict`` of the same text.

The kernel's side that the CPU reaches is held here too: ``bin_plan``'s
layout (every feature in one group, every row in one tile, every block
within the card's shared memory, the bound's bytes those of
``chip_smoke.py:_bin_bytes``) and ``device_arrays``' power-of-two ``+inf``
padding and Eytzinger rows, whose fixed-step descent gives the codes.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.dataset import _ConstructedDataset as JConstructed
from lightgbm_tpu.serving.binner import BinnerArrays as JBinnerArrays
from lightgbm_tpu.serving.binner import _bin_device as jax_bin_device
from lightgbm_tpu_torch.binner import (OOV_BIN, SMEM_LIMIT, BinnerArrays,
                                       DeviceArrays, bin_plain, bin_plan,
                                       bin_predict, tree_width)
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.dataset import _ConstructedDataset

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

#: columns: 0-1 numerical, 2 numerical with NaN (a NaN bin), 3 numerical
#: zero as missing, 4 categorical (20 levels), 5 categorical with NaN
CATEGORICAL = [4, 5]


def _train_matrix(rng, n=4000):
    X = np.empty((n, 6))
    X[:, 0] = rng.randn(n)
    X[:, 1] = rng.exponential(3.0, n).round(1)        # many ties
    X[:, 2] = rng.randn(n)
    X[::7, 2] = np.nan
    X[:, 3] = np.where(rng.rand(n) < 0.4, 0.0, rng.randn(n))
    X[:, 4] = rng.randint(0, 20, n)
    X[:, 5] = rng.randint(3, 12, n)
    X[::9, 5] = np.nan
    return X


def _adversarial(rng, mappers, used, n=3000):
    """Rows holding every hard value in each column (consecutive blocks),
    the rest random; at least ``n`` rows."""
    hard_num = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e30, -1e30, 1e-40]
    hard_cat = [np.nan, -1.0, -0.5, -0.0, 0.5, 2.7, 19.99, 20.0, 25.0,
                1e10, 1e30, np.inf, -np.inf, -3.5, 2.0 ** 31 + 5]
    cols = []
    for k, j in enumerate(used):
        if j in CATEGORICAL:
            cols.append((j, np.asarray(hard_cat)))
        else:
            b = np.asarray(mappers[k].bin_upper_bound, dtype=np.float64)
            b = b[np.isfinite(b)]
            cols.append((j, np.concatenate([hard_num, b,
                                            np.nextafter(b, np.inf),
                                            np.nextafter(b, -np.inf)])))
    X = _train_matrix(rng, max(n, sum(len(v) for _, v in cols) + 100))
    r = 0
    for j, vals in cols:
        X[r:r + len(vals), j] = vals
        r += len(vals)
    return X


def _datasets(max_bin, seed=0):
    rng = np.random.RandomState(seed)
    X = _train_matrix(rng)
    params = {"max_bin": max_bin, "min_data_in_bin": 1, "verbosity": -1}
    import lightgbm_tpu.config as jconfig

    t = _ConstructedDataset.from_matrix(X, Config.from_params(params),
                                        categorical=CATEGORICAL)
    j = JConstructed.from_matrix(X, jconfig.Config.from_params(params),
                                 categorical=CATEGORICAL)
    return rng, t, j


@pytest.mark.parametrize("max_bin", [63, 255, 1023])
def test_bin_plain_equals_bin_host_and_jax(max_bin):
    rng, t, j = _datasets(max_bin)
    # str: the NaN bin's bound is NaN, which == would not match
    assert str([m.to_dict() for m in t.bin_mappers]) \
        == str([m.to_dict() for m in j.bin_mappers])
    Xp = _adversarial(rng, t.bin_mappers, t.used_feature_map)
    arrs = BinnerArrays.for_data(t)
    host = arrs.bin_host(Xp)
    plain = bin_plain(torch.from_numpy(Xp), arrs.device_arrays("cpu"))
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), host)
    jarr = JBinnerArrays.for_data(j)
    np.testing.assert_array_equal(jarr.bin_host(Xp), host)
    jdev = np.asarray(jarr.bin_device(jarr.select_used(Xp)))
    np.testing.assert_array_equal(jdev, host)
    # the hard values landed where the rules say
    k_cat = list(t.used_feature_map).index(4)
    col = Xp[:, 4]
    oov = ~(np.trunc(np.nan_to_num(col)) >= 0) \
        | (np.trunc(np.nan_to_num(col)) > arrs.cat_max[k_cat])
    assert (host[k_cat][oov] == OOV_BIN).all() and oov.sum() > 5
    assert host[k_cat][col == -0.5][0] == host[k_cat][col == -0.0][0]
    k_nan = list(t.used_feature_map).index(2)
    assert (host[k_nan][np.isnan(Xp[:, 2])] == arrs.nan_bin[k_nan]).all()


def test_bin_predict_on_cpu_is_the_plain_version_and_counts_nothing():
    rng, t, _ = _datasets(255, seed=3)
    arrs = BinnerArrays.for_data(t)
    Xp = _adversarial(rng, t.bin_mappers, t.used_feature_map)
    before = bin_predict.launches
    got = arrs.bin_device(Xp, "cpu")
    assert bin_predict.launches == before
    np.testing.assert_array_equal(got.numpy(), arrs.bin_host(Xp))
    assert arrs.device_arrays("cpu") is arrs.device_arrays("cpu")


def test_padding_rows_and_empty_input():
    rng, t, _ = _datasets(63, seed=4)
    arrs = BinnerArrays.for_data(t)
    assert arrs.f_pad == t.bins.shape[0] > t.num_used_features
    Xp = _adversarial(rng, t.bin_mappers, t.used_feature_map)
    got = bin_plain(torch.from_numpy(Xp), arrs.device_arrays("cpu"))
    assert got.shape == (arrs.f_pad, len(Xp))
    assert int(got[t.num_used_features:].abs().sum()) == 0
    empty = bin_plain(torch.zeros((0, 6), dtype=torch.float64),
                      arrs.device_arrays("cpu"))
    assert empty.shape == (arrs.f_pad, 0)


def test_device_path_bins_on_the_device_not_the_host():
    """A model carried by its text into both packages (categorical splits
    included) predicts through the port's device path on a CPU device:
    binned by ``bin_device`` (never ``bin_host``) over a bin schema rebuilt
    from the text, within 1e-12 of the JAX ``Booster.predict``."""
    rng = np.random.RandomState(8)
    X = _train_matrix(rng, 3000)
    y = (np.nan_to_num(X[:, 0]) + (X[:, 4] > 9) > 0.5).astype(float)
    params = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
              "min_data_in_leaf": 10, "max_bin": 63, "device_type": "cpu"}
    text = lt.train(params, lt.Dataset(X, label=y, params=params,
                                       categorical_feature=CATEGORICAL),
                    4, verbose_eval=False).model_to_string()
    bj = lj.Booster(model_str=text)
    assert any(t.num_cat > 0 for t in bj.gbdt.models)
    Xp = _adversarial(rng, [], [], n=50_000)
    bl = lt.Booster(params={"device_type": "cpu"}, model_str=text)
    host_calls = BinnerArrays.host_calls
    got = bl.predict(Xp, raw_score=True)           # 50,000 x 4 trees
    assert bl.gbdt.device_predictions == 1
    assert BinnerArrays.host_calls == host_calls
    np.testing.assert_allclose(got, bj.predict(Xp, raw_score=True), rtol=0,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# the kernel's layout (bin_plan) and search rows (device_arrays)

#: (used features, bounds a row, columns, used columns, category entries):
#: the bench width at 255 and 1,023 bins, MS LTR's width, a row too wide to
#: stage, and a wide matrix of which the model reads every fiftieth column
PLAN_CASES = {"28x255": (28, 254, 28, None, 1),
              "28x1023": (28, 1022, 28, None, 1),
              "137x255": (137, 254, 137, None, 61),
              "4x9999": (4, 9999, 4, None, 1),
              "4_of_200": (4, 254, 200, tuple(range(3, 200, 50)), 1)}


def _fake_arrays(fu, b, ncat, cols):
    rows = max(fu, 1)
    return DeviceArrays(torch.zeros((rows, 5), dtype=torch.int32),
                        torch.zeros((rows, tree_width(b)),
                                    dtype=torch.float64),
                        torch.zeros((rows, tree_width(b)),
                                    dtype=torch.float64),
                        torch.zeros((rows, ncat), dtype=torch.int32), fu,
                        -(-rows // 8) * 8, max(cols) + 1, cols, b)


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_bin_plan_covers_every_feature_and_row_once(case):
    import chip_smoke as cs

    fu, b, ldx, cols, ncat = PLAN_CASES[case]
    cols = cols or tuple(range(fu))
    a = _fake_arrays(fu, b, ncat, cols)
    kw = dict(f_pad=a.f_pad, ncat=ncat, cols=cols)
    tile = bin_plan(fu, b, ldx, 11_000_000, **kw).tile_rows
    for n in (1, 37, tile, tile + 1, 11_000_000):
        p = bin_plan(fu, b, ldx, n, **kw)
        assert p.staged == (tree_width(b) <= 8192)
        # a matrix off a 16-byte boundary is read strided, all else equal
        q = bin_plan(fu, b, ldx, n, aligned=False, **kw)
        assert not q.rows and q.bound_bytes == p.bound_bytes
        # whole rows for a long matrix read whole; a request of a few tiles
        # a block reads its columns
        if n == 11_000_000:     # 137 columns: a task's 128 rows too wide
            assert p.rows == (case not in ("4_of_200", "137x255"))
        elif n != 37:
            assert not p.rows
        # every feature (used and padding) in exactly one group
        feats = [k for g in range(p.groups) for k in p.features(g)]
        assert sorted(feats) == list(range(a.f_pad))
        assert all(len(p.features(g)) for g in range(p.groups))
        # every block within the card's shared memory: its tile ring and
        # its group's bounds rows and metadata
        assert p.smem + 128 <= 232_448 and p.smem <= SMEM_LIMIT
        for g in range(p.groups):
            used = len([k for k in p.features(g) if k < fu])
            assert used <= p.group
            assert p.stages * p.stage_doubles * 8 \
                + used * ((tree_width(b) * 8 if p.staged else 0) + 20) \
                <= p.smem
        if p.rows:
            # whole tiles of 128-row tasks: each tile starts on the
            # matrix's 16-byte alignment, and its buffer is 16-byte sized
            assert 1 <= p.stages <= 8 and p.tile_rows % 128 == 0
            assert p.stage_doubles >= p.tile_rows * ldx
            assert p.stage_doubles % 2 == 0
        # the tiles cover [0, n) once, each in one stripe
        tiles = sorted(t for s in range(p.stripes)
                       for t in p.stripe_tiles(s))
        assert tiles == list(range(p.tiles))
        spans = [p.tile(t) for t in tiles]
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(spans[i][1] == spans[i + 1][0]
                   for i in range(len(spans) - 1))
        assert all(r0 < r1 for r0, r1 in spans)
        assert p.grid == p.groups * p.stripes and p.stripes <= p.tiles
        assert p.grid <= max(132, p.groups)
        # the bound's bytes: the used columns, the tables at their own
        # width (not the search rows' +inf padding), the codes
        assert p.bound_bytes == n * fu * 8 + max(fu, 1) * (
            20 + b * 8 + ncat * 4) + a.f_pad * n * 4
        assert p.bound_bytes == cs._bin_bytes(a, n)
        assert p.moved_bytes >= a.f_pad * n * 4
    # a small request spreads its features over the card
    small = bin_plan(fu, b, ldx, 37, **kw)
    assert small.group == -(-fu // min(fu, 132 // small.tiles))


def test_bin_plan_reads_strided_columns_where_rows_move_more():
    cols = tuple(range(3, 200, 50))
    p = bin_plan(4, 254, 200, 100_000, f_pad=8, ncat=1, cols=cols)
    assert not p.rows and p.stages == 0
    # whole rows would be 1,600 bytes a row; the four columns' sectors 128
    assert p.moved_bytes == 100_000 * (4 * 32 + 8 * 4) + p.stripes * 4 * (
        256 * 8 + 20) + 4 * 4
    assert p.moved_bytes < 100_000 * 200 * 8
    # 28 of 41 columns, unused ones between: the rows cost no more than
    # the used columns' sectors, so a long matrix is read whole (its odd
    # last tile of 41 doubles ends in a double the bulk copy cannot take)
    used = tuple(c for c in range(41) if c % 10 not in (3, 7, 9))[:28]
    q = bin_plan(28, 254, 41, 400_001, f_pad=32, ncat=1, cols=used)
    assert q.rows and q.tile_rows * q.tiles == 400_001 + 127
    assert q.moved_bytes < 1.1 * (400_001 * 41 * 8 + 32 * 400_001 * 4)
    # far fewer rows: the ring's first copy would not pay, so strided
    assert not bin_plan(28, 254, 41, 50_000, f_pad=32, ncat=1,
                        cols=used).rows
    with pytest.raises(ValueError, match="bad shape"):
        bin_plan(4, 254, 4, 10, f_pad=2, ncat=1)


def _descend(tree: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The kernel's fixed-step Eytzinger descent, row by row."""
    w = tree.shape[1]
    i = np.ones(v.shape, dtype=np.int64)
    for _ in range(w.bit_length() - 1):
        i = 2 * i + (np.take_along_axis(tree, i, 1) < v)
    return i - w


@pytest.mark.parametrize("tag,max_bin,rows", [
    ("higgs_255", 255, 2000), ("expo_categorical", 255, 2000),
    ("higgs_1023", 1023, 4000), ("global_bounds_10000", 10000, 32000),
    ("ms_ltr_137", 255, 2000), ("ms_ltr_137_cat", 255, 2000)])
def test_padded_device_arrays_bin_as_jax(tag, max_bin, rows):
    """``device_arrays`` pads each bounds row with ``+inf`` to a power of
    two and lays the same row out in Eytzinger order.  ``bin_plain`` over
    the padded arrays, ``bin_host`` and the JAX
    ``_bin_device`` over the same padded arrays give equal codes on
    ``chip_smoke.py``'s cases (the hard values: NaN, +-inf, -0.0, 1e30,
    every bound and its ulp neighbours, bad categories), and the kernel's
    descent of the Eytzinger rows gives the numerical codes."""
    import chip_smoke as cs

    data, Xp, _ = cs.bin_predict_case(tag, max_bin, rows=rows)
    arrs = BinnerArrays.for_data(data)
    a = arrs.device_arrays("cpu")
    b = arrs.bounds.shape[1]
    w = a.bounds.shape[1]
    assert w == tree_width(b) and w & (w - 1) == 0 and w - 1 >= b
    assert a.num_bounds == b
    assert torch.equal(a.bounds[:, :b], torch.from_numpy(arrs.bounds))
    assert bool(torch.isinf(a.bounds[:, b:]).all())
    # the kernel reads every array row-major
    assert all(t.is_contiguous() for t in a[:4])
    tree = a.tree.numpy()
    assert tree.shape == (max(a.fu, 1), w) and tree.dtype == np.float64
    np.testing.assert_array_equal(np.sort(tree[:, 1:], axis=1),
                                  a.bounds.numpy()[:, :-1])
    assert a.cols == tuple(int(c) for c in data.used_feature_map)
    x = torch.from_numpy(Xp)
    plain = bin_plain(x, a)
    host = arrs.bin_host(Xp)
    np.testing.assert_array_equal(plain.numpy(), host)
    jdev = np.asarray(jax_bin_device(
        np.ascontiguousarray(Xp[:, arrs.used_feature_map]),
        a.bounds.numpy(), arrs.missing, arrs.nan_bin, arrs.is_cat,
        arrs.cat_lut, arrs.cat_max, f_pad=arrs.f_pad))
    np.testing.assert_array_equal(jdev, host)
    # the kernel's search over its rows, NaN probing as 0.0, gives the
    # numerical codes wherever the NaN rule does not
    raw = Xp[:, list(a.cols)].T
    v = np.where(np.isnan(raw), 0.0, raw)
    num = ~arrs.is_cat[:a.fu]
    got = _descend(tree[:a.fu][num], v[num])
    want = np.stack([np.searchsorted(a.bounds.numpy()[k], v[k], side="left")
                     for k in np.flatnonzero(num)])
    np.testing.assert_array_equal(got, want)
    nan_rule = np.isnan(raw[num]) & (arrs.missing[:a.fu][num] == 2)[:, None]
    np.testing.assert_array_equal(np.where(nan_rule, host[:a.fu][num], got),
                                  host[:a.fu][num])
