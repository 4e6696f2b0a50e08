"""Port multislot histograms vs lightgbm_tpu's Pallas multislot kernel.

The level-wise opening builds the smaller-child histograms of all members
of a level in one pass over every row, a slot per row.  The same numpy
words, weights and slots go through
``lightgbm_tpu.ops.hist_pallas.build_histogram_multislot`` (Pallas
interpret mode, as ``tests/test_wave.py`` runs it) and the port's
``ops/hist_multislot.py`` (its plain version on CPU tensors).  With
``nterms=0`` (float32 accumulation) random weights agree within the JAX
test's own limits, rtol 1e-5 and atol 1e-3; dyadic weights and the quant
mode sum exact values, so they are bitwise equal.  Rows whose slot lies
outside [0, K) contribute nowhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.hist_pallas import (build_histogram_multislot as
                                          jax_multislot, pack_bin_words)
from lightgbm_tpu_torch.ops.hist_multislot import (
    LANES_PER_BLOCK, STAGE_ROWS, build_histogram_multislot,
    build_histogram_multislot_plain, multislot_plan)
from lightgbm_tpu_torch.ops.hist_packed import pack_bin_words as tpack

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

N, F, B, K = 4096, 8, 64, 4


def _inputs(kind, seed=37):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (F, N)).astype(np.uint8)
    bag = (rng.rand(N) < 0.7).astype(np.float32)
    if kind == "random":
        g, h = rng.randn(2, N).astype(np.float32)
    elif kind == "dyadic":
        g, h = (rng.randint(-64, 65, (2, N)) / 16.0).astype(np.float32)
    else:                                   # quant: integer grids x 2**-k
        g = rng.randint(-7, 8, N).astype(np.float32) * 2.0 ** -4
        h = rng.randint(0, 16, N).astype(np.float32) * 2.0 ** -6
    w = np.stack([g * bag, h * bag, bag]).astype(np.float32)
    # interleaved slots in root order, slot K and -1 rows dropped
    slot = rng.randint(-1, K + 1, N).astype(np.int32)
    return bins, w, slot


def _jax(bins, w, slot, quant=False):
    return np.asarray(jax_multislot(
        pack_bin_words(jnp.asarray(bins)), jnp.asarray(w),
        jnp.asarray(slot), num_bins=B, n_slots=K, row_block=512, nterms=0,
        quant=quant, interpret=True))


def _port(bins, w, slot, fn=build_histogram_multislot, **kw):
    return fn(tpack(torch.from_numpy(bins)), torch.from_numpy(w),
              torch.from_numpy(slot), num_bins=B, n_slots=K, **kw).numpy()


@pytest.mark.parametrize("kind", ["random", "dyadic", "quant"])
def test_plain_multislot_equals_jax_kernel(kind):
    bins, w, slot = _inputs(kind)
    quant = kind == "quant"
    want = _jax(bins, w, slot, quant)
    got = _port(bins, w, slot, quant=quant)
    assert got.shape == want.shape == (K, F, B, 3)
    if kind == "random":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(got[..., 2], want[..., 2])
    else:
        np.testing.assert_array_equal(got, want)
    if quant:
        np.testing.assert_array_equal(got[..., 2], got[..., 1])


def test_slots_see_only_their_rows():
    bins, w, slot = _inputs("dyadic", seed=5)
    got = _port(bins, w, slot)
    for k in range(K):
        rows = np.flatnonzero(slot == k)
        for f in range(F):
            for ch in range(3):
                ref = np.bincount(bins[f, rows], weights=w[ch, rows],
                                  minlength=B)
                np.testing.assert_array_equal(got[k, f, :, ch],
                                              ref.astype(np.float32))
    # every row routed outside [0, K): nothing anywhere
    none = _port(bins, w, np.full(N, K, np.int32))
    assert not none.any()


def test_dp_and_wrapper_route():
    bins, w, slot = _inputs("random", seed=9)
    wrapped = _port(bins, w, slot)
    plain = _port(bins, w, slot, fn=build_histogram_multislot_plain)
    np.testing.assert_array_equal(wrapped, plain)
    dp = _port(bins, w, slot, fn=build_histogram_multislot_plain, dp=True)
    assert dp.dtype == np.float64
    np.testing.assert_allclose(dp, plain, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("fw,k,n", [(8, 1, 1_000_448), (8, 16, 1_000_448),
                                    (8, 64, 1_000_448), (1, 3, 1024),
                                    (2, 17, 5000), (3, 2, 40_000),
                                    (9, 4, 123_457)])
def test_multislot_geometry_covers_every_row(fw, k, n):
    """The kernel's plan (``multislot_plan``): the chunks tile the rows and
    the lane groups the word lanes, each once, and every slot gets the same
    blocks, so each (row, word lane, slot) is binned by one block."""
    p = multislot_plan(fw, k, n, 255)
    assert p.chunk % STAGE_ROWS == 0 and p.chunk >= STAGE_ROWS
    assert p.nchunks * p.chunk >= n > (p.nchunks - 1) * p.chunk
    assert 1 <= p.lanes <= LANES_PER_BLOCK
    assert p.groups * p.lanes >= fw > (p.groups - 1) * p.lanes
    rows = np.zeros(n, np.int64)
    for c in range(p.nchunks):
        rows[c * p.chunk:(c + 1) * p.chunk] += 1
    assert (rows == 1).all()
    lanes = np.zeros(fw, np.int64)
    for g in range(p.groups):
        lanes[g * p.lanes:(g + 1) * p.lanes] += 1
    assert (lanes == 1).all()
