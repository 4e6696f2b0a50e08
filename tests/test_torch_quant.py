"""Port quantized-gradient primitives and quant-mode histograms vs
lightgbm_tpu.

``lightgbm_tpu_torch/ops/quant.py`` must reproduce
``lightgbm_tpu/ops/quant.py`` BIT FOR BIT on the same float32 inputs: the
power-of-two scales, the stateless hash behind the stochastic rounding and
the dequantized lanes, on zeros, negatives, unbagged rows and power-of-two
edges.  The quant modes of the packed and the segment histograms (channel
2 sums the hessian lane) sum integer multiples of a power-of-two scale, so
their plain versions equal the JAX Pallas kernels (interpret mode,
``quant=True``) bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import quant as Q
from lightgbm_tpu.ops.hist_pallas import (build_histogram_packed as
                                          jax_packed,
                                          build_histogram_segments as
                                          jax_segments, pack_bin_words)
from lightgbm_tpu_torch.ops import quant as TQ
from lightgbm_tpu_torch.ops.hist_packed import (build_histogram_packed,
                                                pack_bin_words as tpack)
from lightgbm_tpu_torch.ops.hist_segments import build_histogram_segments

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def test_constants_equal_jax():
    assert (TQ.GMAX, TQ.HMAX, TQ.F32_EXACT_ROWS) == \
        (Q.GMAX, Q.HMAX, Q.F32_EXACT_ROWS)
    assert (TQ._G_SALT, TQ._H_SALT) == (Q._G_SALT, Q._H_SALT)


def test_pow2_ceil_scale_bitwise():
    tiny = np.finfo(np.float32).tiny
    t = np.array([0.0, -0.0, -1.0, -3.5, tiny, tiny / 4, 1e-30, 0.25, 0.5,
                  1.0, 1.0000001, 0.99999994, 3.0, 4.0, 7.0 / 7, 1.75 / 7,
                  0.5 / 15, 1e20, 3e38, np.inf], np.float32)
    want = np.asarray(Q.pow2_ceil_scale(jnp.asarray(t)))
    got = TQ.pow2_ceil_scale(torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("salt", [Q._G_SALT, Q._H_SALT])
def test_hash_and_stochastic_round_bitwise(salt):
    rng = np.random.RandomState(3)
    n = 4096
    idx = np.concatenate([np.arange(n - 8), [0, 1, 2 ** 20, 2 ** 31 - 1,
                                             123456789, 7, 8, 9]]) \
        .astype(np.int32)
    x = (rng.randn(n) * 5).astype(np.float32)
    x[:6] = [0.0, -0.0, 1.0, -1.0, 7.0, 1e-40]
    u_j = np.asarray(Q._hash_uniform(jnp.asarray(idx), jnp.asarray(x), salt))
    u_t = TQ._hash_uniform(torch.from_numpy(idx), torch.from_numpy(x),
                           salt).numpy()
    np.testing.assert_array_equal(_bits(u_t), _bits(u_j))
    assert ((u_t >= 0) & (u_t < 1)).all()
    r_j = np.asarray(Q.stochastic_round(jnp.asarray(x), jnp.asarray(idx),
                                        salt))
    r_t = TQ.stochastic_round(torch.from_numpy(x), torch.from_numpy(idx),
                              salt).numpy()
    np.testing.assert_array_equal(_bits(r_t), _bits(r_j))


@pytest.mark.parametrize("case", ["random", "pow2_edges", "zeros"])
def test_quantize_gradients_bitwise(case):
    rng = np.random.RandomState(11)
    n = 4096
    bag = (rng.rand(n) < 0.8).astype(np.float32)
    g = (rng.randn(n) * 0.3).astype(np.float32)
    h = rng.rand(n).astype(np.float32) * 0.25
    if case == "pow2_edges":
        # the maxima land exactly on GMAX and HMAX times a power of two
        g[5], bag[5] = -7.0 * 2.0 ** -4, 1.0
        h[6], bag[6] = 15.0 * 2.0 ** -6, 1.0
        g = np.clip(g, -7.0 * 2.0 ** -4, 7.0 * 2.0 ** -4)
        h = np.minimum(h, 15.0 * 2.0 ** -6)
    elif case == "zeros":
        g[:] = 0.0
        h[:] = 0.0
    gb, hb = (g * bag).astype(np.float32), (h * bag).astype(np.float32)
    mg, mh = np.abs(gb).max(), hb.max()
    want = Q.quantize_gradients(jnp.asarray(gb), jnp.asarray(hb),
                                jnp.asarray(bag), jnp.asarray(0, jnp.int32),
                                jnp.float32(mg), jnp.float32(mh))
    got = TQ.quantize_gradients(torch.from_numpy(gb), torch.from_numpy(hb),
                                torch.from_numpy(bag), 0,
                                torch.tensor(mg), torch.tensor(mh))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    gd, hd, sg, sh = (a.numpy() for a in got)
    # unbagged rows are exact zeros; the lanes lie on the integer grids
    assert not np.any(gd[bag == 0]) and not np.any(hd[bag == 0])
    assert np.all(np.abs(gd / sg) <= TQ.GMAX)
    assert np.all((hd / sh >= 0) & (hd / sh <= TQ.HMAX))
    np.testing.assert_array_equal(gd / sg, np.rint(gd / sg))


def test_quant_ineligible_reason_equal_jax():
    for n_pad, dp in ((4096, False), (4096, True), (Q.F32_EXACT_ROWS, False),
                      (Q.F32_EXACT_ROWS - 1, False)):
        assert TQ.quant_ineligible_reason(n_pad, dp) == \
            Q.quant_ineligible_reason(n_pad, dp)


# ---------------------------------------------------------------------------
# Quant-mode histograms: bitwise against the Pallas kernels' quant mode.
# ---------------------------------------------------------------------------

N, F, B = 4096, 8, 64


def _quant_inputs(seed):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (F, N)).astype(np.uint8)
    bag = (rng.rand(N) < 0.8).astype(np.float32)
    gq = rng.randint(-TQ.GMAX, TQ.GMAX + 1, N).astype(np.float32)
    hq = rng.randint(0, TQ.HMAX + 1, N).astype(np.float32)
    w = np.stack([gq * 2.0 ** -5 * bag, hq * 2.0 ** -7 * bag, bag]) \
        .astype(np.float32)
    return bins, w


def test_packed_quant_mode_bitwise():
    bins, w = _quant_inputs(4)
    want = np.asarray(jax_packed(pack_bin_words(jnp.asarray(bins)),
                                 jnp.asarray(w), num_bins=B, quant=True,
                                 interpret=True))
    words = tpack(torch.from_numpy(bins))
    got = build_histogram_packed(words, torch.from_numpy(w), num_bins=B,
                                 quant=True).numpy()
    assert got.shape == want.shape == (F, B, 3)
    np.testing.assert_array_equal(got, want)
    # channel 2 is the hessian lane, not the bag
    np.testing.assert_array_equal(got[..., 2], got[..., 1])


def test_segments_quant_mode_bitwise():
    bins, w = _quant_inputs(5)
    rb = 512
    members = [(100, 1500, 3), (2000, 1100, 4), (3300, 796, 7)]
    lid = np.zeros(N, np.int32)
    for s, c, leaf in members:
        lid[s:s + c] = leaf
    slot_t, block_t, leaf_t = [], [], []
    for k, (s, c, leaf) in enumerate(members):
        for blk in range(s // rb, (s + c - 1) // rb + 1):
            slot_t += [k]
            block_t += [blk]
            leaf_t += [leaf]
    while len(slot_t) < N // rb + 2 * len(members):
        slot_t += [len(members)]
        block_t += [0]
        leaf_t += [-1]
    want = np.asarray(jax_segments(
        pack_bin_words(jnp.asarray(bins)), jnp.asarray(w), jnp.asarray(lid),
        jnp.asarray(slot_t, jnp.int32), jnp.asarray(block_t, jnp.int32),
        jnp.asarray(leaf_t, jnp.int32), num_bins=B, n_slots=len(members),
        row_block=rb, quant=True, interpret=True))
    s, c, leaf = (torch.tensor([m[i] for m in members]) for i in range(3))
    got = build_histogram_segments(
        tpack(torch.from_numpy(bins)), torch.from_numpy(w),
        torch.from_numpy(lid), s, c, leaf, num_bins=B,
        rows_bound=int(c.sum()), quant=True).numpy()
    np.testing.assert_array_equal(got, want)
