"""Port operators vs lightgbm_tpu: packing, histograms, split search.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX packed histogram runs in Pallas interpret mode, as ``tests/test_ops.py``
runs it on the CPU; the port's histogram here is its plain torch version
(the CUDA kernel is held against the same plain version on the card, in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.hist_pallas import build_histogram_packed as jx_packed
from lightgbm_tpu.ops.hist_pallas import pack_bin_words as jx_pack
from lightgbm_tpu.ops.hist_pallas import unpack_bin_words as jx_unpack
from lightgbm_tpu.ops.histogram import build_histogram_onehot as jx_onehot
from lightgbm_tpu.ops.histogram import fix_histogram as jx_fix
from lightgbm_tpu.ops.split import find_best_splits as jx_find
from lightgbm_tpu_torch.ops.hist_packed import (
    build_histogram_packed, build_histogram_packed_plain, pack_bin_words,
    unpack_bin_words)
from lightgbm_tpu_torch.ops.histogram import build_histogram_onehot
from lightgbm_tpu_torch.ops.histogram import fix_histogram
from lightgbm_tpu_torch.ops.split import find_best_splits

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)


def _packed_inputs(seed, f, n, b, dyadic=False):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, b, size=(f, n)).astype(np.uint8)
    bag = (rng.rand(n) < 0.7).astype(np.float32)
    if dyadic:
        g = (rng.randint(-16, 17, n) / 16.0).astype(np.float32)
        h = (rng.randint(0, 17, n) / 16.0).astype(np.float32)
    else:
        g = rng.randn(n).astype(np.float32)
        h = rng.rand(n).astype(np.float32)
    w = np.stack([g * bag, h * bag, bag]).astype(np.float32)
    return bins, w


@pytest.mark.parametrize("f,n,high", [(4, 64, 256), (8, 1024, 256),
                                      (16, 333, 128)])
def test_pack_unpack_bitwise(f, n, high):
    rng = np.random.RandomState(f + n)
    bins = rng.randint(0, high, size=(f, n)).astype(np.uint8)
    bins[3::4, :4] = [200, 128, 255, 129]     # byte 3 >= 128: negative words
    words_t = pack_bin_words(torch.from_numpy(bins))
    words_j = np.asarray(jx_pack(jnp.asarray(bins)))
    assert words_t.dtype == torch.int32
    np.testing.assert_array_equal(words_t.numpy(), words_j)
    assert (words_j < 0).any()
    np.testing.assert_array_equal(
        unpack_bin_words(words_t, f).numpy(),
        np.asarray(jx_unpack(jnp.asarray(words_j), f)))
    np.testing.assert_array_equal(unpack_bin_words(words_t, f).numpy(), bins)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_packed_matches_jax_highest(seed):
    """nterms=0 is full float32 on the TPU path too; the sums differ only in
    order: rtol=1e-5, atol=1e-4 (tests/test_ops.py's bound)."""
    bins, w = _packed_inputs(seed, 8, 2048, 64)
    words = np.array(jx_pack(jnp.asarray(bins)))  # writable copy
    want = np.asarray(jx_packed(jnp.asarray(words), jnp.asarray(w),
                                num_bins=64, nterms=0, interpret=True))
    got = build_histogram_packed_plain(torch.from_numpy(words),
                                       torch.from_numpy(w), num_bins=64)
    assert got.dtype == torch.float32 and got.shape == (8, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_plain_packed_matches_jax_bf16x3():
    """bf16x3 terms carry ~24 weight mantissa bits on the TPU path: the
    looser bound of tests/test_ops.py (rtol=3e-4, atol=3e-3)."""
    bins, w = _packed_inputs(3, 8, 2048, 64)
    words = np.array(jx_pack(jnp.asarray(bins)))  # writable copy
    want = np.asarray(jx_packed(jnp.asarray(words), jnp.asarray(w),
                                num_bins=64, nterms=3, interpret=True))
    got = build_histogram_packed(torch.from_numpy(words),
                                 torch.from_numpy(w), num_bins=64)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-3)


@pytest.mark.parametrize("b", [32, 64])
def test_plain_packed_dyadic_equals_jax_exactly(b):
    """Multiples of 1/16 sum exactly in any order: bitwise equal."""
    bins, w = _packed_inputs(4, 8, 2048, b, dyadic=True)
    words = np.array(jx_pack(jnp.asarray(bins)))  # writable copy
    want = np.asarray(jx_packed(jnp.asarray(words), jnp.asarray(w),
                                num_bins=b, nterms=0, interpret=True))
    got = build_histogram_packed_plain(torch.from_numpy(words),
                                       torch.from_numpy(w), num_bins=b)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_packed_window_view_and_dropped_codes():
    """A strided window view is read in place; codes past num_bins are
    dropped, as the one-hot matches no bin for them."""
    bins, w = _packed_inputs(5, 8, 4096, 64)
    bins[:, ::7] = 200
    words = torch.from_numpy(np.array(jx_pack(jnp.asarray(bins))))
    wt = torch.from_numpy(w)
    view = build_histogram_packed(words[:, 1024:3072], wt[:, 1024:3072],
                                  num_bins=64)
    want = np.asarray(jx_onehot(jnp.asarray(bins[:, 1024:3072]),
                                jnp.asarray(w[:, 1024:3072]), num_bins=64))
    np.testing.assert_allclose(view.numpy(), want, rtol=1e-5, atol=1e-4)


def test_plain_dp_histogram_matches_jax_onehot_dp():
    """float64 sums of float32 weights: exact at this size in any order."""
    bins, w = _packed_inputs(6, 8, 2048, 63)
    got = build_histogram_onehot(torch.from_numpy(bins).to(torch.int32),
                                 torch.from_numpy(w), num_bins=63, dp=True)
    want = np.asarray(jx_onehot(jnp.asarray(bins), jnp.asarray(w),
                                num_bins=63, dp=True))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def test_fix_histogram_matches_jax():
    rng = np.random.RandomState(7)
    hist = rng.randn(6, 16, 3)
    db = rng.randint(0, 16, 6).astype(np.int32)
    tot = [rng.randn(6) for _ in range(3)]
    got = fix_histogram(torch.from_numpy(hist), torch.from_numpy(db),
                        *[torch.from_numpy(t) for t in tot])
    want = jx_fix(jnp.asarray(hist), jnp.asarray(db),
                  *[jnp.asarray(t) for t in tot])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


def _cube(seed, f=9, b=32, dtype=np.float32, rows=600):
    """A (F, B, 3) histogram cube built from simulated rows, so every
    feature carries the leaf's totals and counts are integers.  Features
    cycle through the missing types None/Zero/NaN; some have 2 bins."""
    rng = np.random.RandomState(seed)
    num_bin = rng.randint(2, b + 1, f).astype(np.int32)
    num_bin[:3] = [2, 3, b]
    missing = (np.arange(f) % 3).astype(np.int32)
    default_bin = np.array([rng.randint(0, nb) for nb in num_bin], np.int32)
    g = rng.randn(rows)
    h = rng.rand(rows) + 0.05
    hist = np.zeros((f, b, 3))
    for k in range(f):
        # skewed codes so some bins hold most rows
        codes = np.minimum(rng.geometric(0.15, rows) - 1, num_bin[k] - 1)
        np.add.at(hist[k], codes, np.stack([g, h, np.ones(rows)], -1))
    tot = np.array([g.sum(), h.sum(), float(rows)])
    return hist.astype(dtype), tot.astype(dtype), num_bin, missing, \
        default_bin


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kw", [
    {},
    {"lambda_l1": 0.5, "lambda_l2": 2.0, "min_data_in_leaf": 5},
    {"max_delta_step": 0.3, "min_sum_hessian_in_leaf": 1.0,
     "min_gain_to_split": 0.1},
])
def test_find_best_splits_matches_jax(seed, kw):
    hist, tot, nb, mt, db = _cube(seed)
    fmask = np.ones(len(nb), bool)
    fmask[-1] = False
    want = jx_find(jnp.asarray(hist), jnp.asarray(tot[0]),
                   jnp.asarray(tot[1]), jnp.asarray(tot[2]), jnp.asarray(nb),
                   jnp.asarray(mt), jnp.asarray(db), jnp.asarray(fmask), **kw)
    T = torch.from_numpy
    got = find_best_splits(T(hist), T(tot[:1])[0], T(tot[1:2])[0],
                           T(tot[2:3])[0], T(nb), T(mt), T(db), T(fmask),
                           **kw)
    for name in ("threshold", "default_left", "left_cnt", "right_cnt"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    finite = np.isfinite(np.asarray(want.gain))
    assert finite.any()
    np.testing.assert_array_equal(np.isfinite(got.gain.numpy()), finite)
    np.testing.assert_allclose(got.gain.numpy()[finite],
                               np.asarray(want.gain)[finite], rtol=1e-6)
    for name in ("left_sum_g", "left_sum_h", "left_output", "right_output"):
        np.testing.assert_allclose(getattr(got, name).numpy()[finite],
                                   np.asarray(getattr(want, name))[finite],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_find_best_splits_batched_and_missing_skip():
    """A leading leaf axis gives each leaf's own answer; with all features
    MISSING_NONE the missing-right scan may be skipped exactly."""
    hists, tots = [], []
    for seed in (10, 11):
        hist, tot, nb, _, db = _cube(seed, dtype=np.float64)
        hists.append(hist)
        tots.append(tot)
    mt = np.zeros(len(nb), np.int32)
    fmask = np.ones(len(nb), bool)
    T = torch.from_numpy
    tot = np.stack(tots)
    args = (T(np.stack(hists)), T(tot[:, 0]), T(tot[:, 1]), T(tot[:, 2]),
            T(nb), T(mt), T(db), T(fmask))
    both = find_best_splits(*args)
    skip = find_best_splits(*args, skip_missing_scan=True)
    for a, b in zip(both, skip):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for k in range(2):
        one = jx_find(jnp.asarray(hists[k]), *[jnp.asarray(tot[k, i])
                                               for i in range(3)],
                      jnp.asarray(nb), jnp.asarray(mt), jnp.asarray(db),
                      jnp.asarray(fmask))
        np.testing.assert_array_equal(both.threshold[k].numpy(),
                                      np.asarray(one.threshold))
        np.testing.assert_allclose(both.gain[k].numpy(), np.asarray(one.gain),
                                   rtol=1e-12)
