"""Port fused child scans vs lightgbm_tpu's Pallas fused kernel.

``ops/fused_scan.py:fused_child_scans`` on CPU tensors (its plain version:
subtraction, selection, pool writes, ``fix_histogram`` and
``find_best_splits``) against
``lightgbm_tpu.ops.scan_pallas.fused_child_scans(..., interpret=True)``.
The histograms are dyadic, as quantized ones are, so every sum is exact:
threshold, default_left, the child sums, the outputs and both raw children
(the pool writes) must be exactly equal, and the gain within 1 ulp (jax
0.9's interpret scan is 1 ulp off ``find_best_splits``: ROADMAP.md Queue
C).  The fixture mixes missing types, default bins that FixHistogram
rebuilds, and both selections of the smaller child.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO
from lightgbm_tpu.ops.scan_pallas import fused_child_scans as jax_fused
from lightgbm_tpu_torch.ops.fused_scan import (fused_child_scans,
                                               fused_child_scans_plain)
from lightgbm_tpu_torch.ops.split import (find_best_splits, fix_histogram,
                                          pairwise_bin_sum)

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

FIELDS = ("threshold", "default_left", "left_sum_g", "left_sum_h",
          "left_cnt", "right_sum_g", "right_sum_h", "right_cnt",
          "left_output", "right_output")
K, F, B, H = 4, 9, 32, 11


def _case(seed):
    """Smaller-child and parent histograms on quant-like grids, the pool
    slots (parents in ph, fresh right slots in rh) and the child totals."""
    rng = np.random.RandomState(seed)
    num_bin = rng.randint(3, B + 1, F).astype(np.int32)
    missing = rng.choice([MISSING_NONE, MISSING_ZERO, MISSING_NAN],
                         F).astype(np.int32)
    default_bin = (rng.randint(0, 100, F) % num_bin).astype(np.int32)
    bm = (np.arange(B)[None, :] < num_bin[:, None])[None, :, :, None]

    def hist():
        g = rng.randint(-7 * 40, 7 * 40 + 1, (K, F, B)) * 2.0 ** -6
        h = rng.randint(0, 15 * 40 + 1, (K, F, B)) * 2.0 ** -8
        c = h * 4.0                                # the rescaled count
        return (np.stack([g, h, c], -1) * bm).astype(np.float32)

    h_small, h_other = hist(), hist()
    left_small = rng.rand(K) < 0.5
    hl = np.where(left_small[:, None, None, None], h_small, h_other)
    hr = np.where(left_small[:, None, None, None], h_other, h_small)
    # the children's totals: the sums over feature 0's bins, so the
    # default-bin rebuilds are consistent for that feature and plain
    # arithmetic for the others
    tot = np.stack([hl[:, 0].sum(1), hr[:, 0].sum(1)], 1).reshape(2 * K, 3)
    pool = rng.randn(H, F, B, 3).astype(np.float32)
    ph = np.array([2, 7, 0, 5], np.int64)
    rh = np.array([8, 9, 10, 1], np.int64)
    pool[ph] = h_small + h_other
    return (h_small, pool, ph, rh, left_small, tot, num_bin, missing,
            default_bin)


KW = dict(lambda_l1=0.0, lambda_l2=0.5, max_delta_step=0.0,
          min_data_in_leaf=3, min_sum_hessian_in_leaf=1e-3,
          min_gain_to_split=0.0)


def _run(seed, fmask=None):
    (h_small, pool, ph, rh, left_small, tot, nb, mt, db) = _case(seed)
    fmask = np.ones(F, bool) if fmask is None else fmask
    want, jhl, jhr = jax_fused(
        jnp.asarray(h_small), jnp.asarray(pool[ph]), jnp.asarray(left_small),
        *(jnp.asarray(tot[:, i]) for i in range(3)), jnp.asarray(nb),
        jnp.asarray(mt), jnp.asarray(db), jnp.asarray(fmask),
        interpret=True, **KW)
    tpool = torch.from_numpy(pool.copy())
    got = fused_child_scans(
        torch.from_numpy(h_small), tpool, torch.from_numpy(ph),
        torch.from_numpy(rh), torch.from_numpy(left_small),
        *(torch.from_numpy(np.ascontiguousarray(tot[:, i]))
          for i in range(3)),
        *(torch.from_numpy(a) for a in (nb, mt, db)),
        torch.from_numpy(fmask), **KW)
    return want, np.asarray(jhl), np.asarray(jhr), got, tpool.numpy(), pool


@pytest.mark.parametrize("seed", [3, 4])
def test_fused_plain_equals_jax_kernel(seed):
    want, jhl, jhr, got, tpool, pool = _run(seed)
    for fld in FIELDS:
        np.testing.assert_array_equal(getattr(got, fld).numpy(),
                                      np.asarray(getattr(want, fld)), fld)
    gw, gg = np.asarray(want.gain), got.gain.numpy()
    assert np.array_equal(np.isneginf(gw), np.isneginf(gg))
    fin = ~np.isneginf(gw)
    assert fin.sum() > K
    ulp = np.spacing(np.abs(gw[fin]).astype(np.float32))
    assert (np.abs(gg[fin] - gw[fin]) <= ulp).all()
    # the raw children went to the pool: left over the parent, right into
    # the fresh slot; every other slot is untouched
    ph, rh = np.array([2, 7, 0, 5]), np.array([8, 9, 10, 1])
    np.testing.assert_array_equal(tpool[ph], jhl)
    np.testing.assert_array_equal(tpool[rh], jhr)
    rest = np.setdiff1d(np.arange(H), np.concatenate([ph, rh]))
    np.testing.assert_array_equal(tpool[rest], pool[rest])


def test_fused_plain_is_the_unfused_composition():
    """The plain version equals the wave learner's unfused step on the same
    inputs, with a feature mask."""
    (h_small, pool, ph, rh, left_small, tot, nb, mt, db) = _case(5)
    fmask = np.array([True, False] * 4 + [True])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    p1 = t(pool.copy())
    got = fused_child_scans_plain(t(h_small), p1, t(ph), t(rh),
                                  t(left_small), *(t(tot[:, i])
                                                   for i in range(3)),
                                  t(nb), t(mt), t(db), t(fmask), **KW)
    h_par = t(pool[ph])
    lsm = t(left_small).view(K, 1, 1, 1)
    hl = torch.where(lsm, t(h_small), h_par - t(h_small))
    hr = torch.where(lsm, h_par - t(h_small), t(h_small))
    h2 = torch.stack([hl, hr], 1).reshape(2 * K, F, B, 3)
    sums = [t(tot[:, i]) for i in range(3)]
    want = find_best_splits(fix_histogram(h2, *sums, t(db)), *sums, t(nb),
                            t(mt), t(db), t(fmask), **KW)
    for fld in want._fields:
        assert torch.equal(getattr(got, fld), getattr(want, fld)), fld
    assert torch.equal(p1[t(ph)], hl) and torch.equal(p1[t(rh)], hr)
    assert np.isneginf(got.gain.numpy()[:, ~fmask]).all()


def test_pairwise_bin_sum_order():
    """The fixed pairwise order the card's kernel reproduces: equal to a
    plain sum on exact values, and to the explicit tree on any values."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(3, 5, 3).astype(np.float32))
    got = pairwise_bin_sum(x)
    a = torch.cat([x, torch.zeros(3, 3, 3)], 1)            # pad 5 -> 8
    a = a[:, :4] + a[:, 4:]
    a = a[:, :2] + a[:, 2:]
    assert torch.equal(got, a[:, 0] + a[:, 1])
    d = torch.from_numpy(rng.randint(-99, 99, (2, 255, 3)).astype(
        np.float32) / 8)
    assert torch.equal(pairwise_bin_sum(d), d.sum(1))
