"""Port binning vs lightgbm_tpu: bin mappers, binned matrices, EFB bundles.

The port keeps its own copy of the numpy binning code; these tests hold its
output bit-identical to the JAX package's on the same float32-representable
inputs, including NaN and zero-heavy columns and validation sets binned
against the training mappers.
"""

import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.interop import dataset_from_jax_arrays

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)


def _matrix(seed, n=2000, f=12):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    X[rng.rand(n) < 0.15, 1] = np.nan                     # NaN column
    X[rng.rand(n) < 0.7, 2] = 0.0                        # zero-heavy
    X[:, 3] = np.where(rng.rand(n) < 0.5, 0.0, np.nan)   # zero/NaN only
    X[:, 4] = rng.randint(0, 5, n)                       # few distinct
    X[:, 5] = 1.0                                        # trivial
    X[rng.rand(n) < 0.05, 6] = np.nan
    X[:, 6] = np.where(rng.rand(n) < 0.4, 0.0, X[:, 6])  # zeros and NaN
    y = (X[:, 0] > 0).astype(np.float32)
    return X, y


def _construct(lib, X, y, params, Xv=None):
    ds = lib.Dataset(X, label=y, params=params)
    ds.construct()
    dv = None
    if Xv is not None:
        dv = ds.create_valid(Xv, label=np.zeros(len(Xv), np.float32))
        dv.construct()
    return ds, dv


def _assert_same_data(cj, ct):
    # json keeps every float's exact repr and spells NaN bounds alike
    assert [json.dumps(m.to_dict(), sort_keys=True) for m in cj.bin_mappers] \
        == [json.dumps(m.to_dict(), sort_keys=True) for m in ct.bin_mappers]
    np.testing.assert_array_equal(cj.used_feature_map, ct.used_feature_map)
    assert cj.bins.dtype == ct.bins.dtype
    np.testing.assert_array_equal(cj.bins, ct.bins)
    assert (cj.num_data, cj.num_data_padded, cj.max_num_bin) == \
        (ct.num_data, ct.num_data_padded, ct.max_num_bin)


@pytest.mark.parametrize("params", [
    {"max_bin": 63},
    {"max_bin": 15, "min_data_in_bin": 1},
    {"max_bin": 63, "zero_as_missing": True},
    {"max_bin": 31, "use_missing": False},
    {"max_bin": 63, "bin_construct_sample_cnt": 500, "data_random_seed": 3},
    {"max_bin": 63, "tpu_row_block": 512},
    {"max_bin": 1023},                  # past 256 bins: uint16 codes
])
def test_bins_bit_identical(params, seed=0):
    X, y = _matrix(seed)
    params = dict(params, enable_bundle=False)
    (dj, vj), (dt, vt) = (_construct(lib, X[:1500], y[:1500], params,
                                     X[1500:]) for lib in (lj, lt))
    _assert_same_data(dj.constructed, dt.constructed)
    np.testing.assert_array_equal(vj.constructed.bins, vt.constructed.bins)
    if params["max_bin"] > 255:
        assert dt.constructed.max_num_bin > 256
        assert dt.constructed.bins.dtype == np.uint16
        assert dt.constructed.device_bins("cpu").dtype == torch.uint16


def test_efb_bundles_bit_identical():
    rng = np.random.RandomState(1)
    n = 3000
    X = np.zeros((n, 8), np.float32)
    X[:, :2] = rng.randn(n, 2)
    owner = rng.randint(2, 8, n)          # one active sparse column per row
    X[np.arange(n), owner] = rng.rand(n) + 0.5
    X[rng.rand(n) < 0.5, 2:] = 0.0        # and many all-default rows
    y = (X[:, 0] > 0).astype(np.float32)
    params = {"max_bin": 31}
    (dj, _), (dt, _) = (_construct(lib, X, y, params) for lib in (lj, lt))
    cj, ct = dj.constructed, dt.constructed
    _assert_same_data(cj, ct)
    assert cj.bundle is not None and ct.bundle is not None
    assert cj.bundle.groups == ct.bundle.groups
    assert any(len(g) > 1 for g in ct.bundle.groups)
    np.testing.assert_array_equal(cj.bundle.encode(cj), ct.bundle.encode(ct))


def test_dataset_from_jax_arrays_bitwise():
    X, y = _matrix(2)
    dj, _ = _construct(lj, X, y, {"max_bin": 63})
    cj = dj.constructed
    ds = dataset_from_jax_arrays(
        cj.bins, [m.to_dict() for m in cj.bin_mappers], cj.used_feature_map,
        cj.metadata.label, cj.num_data, device="cpu",
        num_total_features=cj.num_total_features)
    _assert_same_data(cj, ds.constructed)
    np.testing.assert_array_equal(cj.metadata.label,
                                  ds.constructed.metadata.label)
    assert ds.constructed.device_bins("cpu").numpy().tobytes() == \
        cj.bins.tobytes()
