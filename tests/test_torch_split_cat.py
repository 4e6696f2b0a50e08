"""Port categorical split search vs lightgbm_tpu's categorical finder.

The same numpy histograms go through the JAX function (one leaf per call)
and through the port's plain version batched over K leaves with per-leaf
totals.  The bitsets and the counts must be equal, the other float fields
within 1e-12 relative in float64 and 1e-6 in float32.  The fixtures are the
seven of ``tests/test_split_cat.py`` (one-hot, sorted-CTR at the defaults,
no group bookkeeping, a tight category cap, an eligibility filter that
bites, a wide histogram) and one column of 2,047 bins (past the 1,024 the
kernel once took), held against that file's numpy port of the reference
loop as well, plus a NaN-typed feature and two bins of equal CTR.
``categorical_candidates`` (the learners' entry point) must write exactly
the plain version's values into the categorical columns and leave the
others alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.split_cat import \
    find_best_splits_categorical as jax_find
from lightgbm_tpu_torch.binning import MISSING_NAN, MISSING_NONE
from lightgbm_tpu_torch.ops.split import find_best_splits
from lightgbm_tpu_torch.ops.split_cat import (bits_from_member,
                                              categorical_candidates,
                                              categorical_candidates_plain,
                                              find_best_splits_categorical)
from test_split_cat import _bits_to_bins, ref_categorical

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

FIELDS = ("gain", "left_sum_g", "left_sum_h", "left_cnt", "right_sum_g",
          "right_sum_h", "right_cnt", "left_output", "right_output")
FIXTURES = [
    (4, {}), (3, {}), (25, {}), (25, {"min_data_per_group": 1}),
    (25, {"max_cat_threshold": 3}), (40, {"cat_smooth": 25.0}),
    (64, {"min_data_in_leaf": 1, "min_data_per_group": 1}),
    (2047, {})]


def _hists(rng, k, b, nbins):
    """k leaves' histograms of one feature, as tests/test_split_cat.py."""
    out = []
    for _ in range(k):
        cnt = rng.randint(0, 120, size=b).astype(np.float64)
        cnt[nbins:] = 0.0
        g = rng.randn(b) * np.sqrt(np.maximum(cnt, 1e-9))
        h = cnt * 0.25 + np.abs(rng.randn(b)) * 0.01 * (cnt > 0)
        out.append(np.stack([g, h, cnt], axis=1))
    return np.stack(out)                                  # (K, B, 3)


def _compare(hist, num_bin, mtype, kw, dtype, rtol):
    """hist (K, F, B, 3) numpy; the JAX function per leaf against the
    port's batched plain version.  Returns the port's result."""
    k = hist.shape[0]
    hist = hist.astype(dtype)
    tg, th, tn = (hist[:, 0, :, c].sum(1) for c in range(3))
    got = find_best_splits_categorical(
        torch.from_numpy(hist), torch.from_numpy(tg), torch.from_numpy(th),
        torch.from_numpy(tn), torch.from_numpy(num_bin),
        torch.from_numpy(mtype), torch.ones(hist.shape[1], dtype=torch.bool),
        **kw)
    for i in range(k):
        want = jax_find(jnp.asarray(hist[i]), jnp.asarray(tg[i]),
                        jnp.asarray(th[i]), jnp.asarray(tn[i]),
                        jnp.asarray(num_bin), jnp.asarray(mtype),
                        jnp.ones(hist.shape[1], dtype=bool), **kw)
        np.testing.assert_array_equal(
            got.bits[i].numpy(), np.asarray(want.bits).view(np.int32))
        for name in FIELDS:
            a = getattr(got, name)[i].numpy()
            w = np.asarray(getattr(want, name))
            assert a.dtype == w.dtype == dtype, name
            if name.endswith("_cnt"):
                np.testing.assert_array_equal(a, w, err_msg=name)
            else:
                np.testing.assert_allclose(a, w, rtol=rtol, atol=0,
                                           err_msg=name)
    return got


@pytest.mark.parametrize("nbins,kw", FIXTURES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_equals_jax_and_reference(rng, nbins, kw, dtype):
    k, b = 5, max(64, nbins)
    hist = _hists(rng, k, b, nbins)[:, None]              # (K, 1, B, 3)
    kwargs = dict(dict(min_data_in_leaf=5, min_sum_hessian_in_leaf=1e-3),
                  **kw)
    num_bin = np.full(1, nbins, np.int32)
    mtype = np.full(1, MISSING_NONE, np.int32)
    rtol = 1e-12 if dtype == np.float64 else 1e-6
    got = _compare(hist, num_bin, mtype, kwargs, dtype, rtol)
    if dtype != np.float64:
        return
    # the numpy port of the reference loop (`feature_histogram.hpp`)
    for i in range(k):
        want = ref_categorical(
            hist[i, 0], hist[i, 0, :, 0].sum(), hist[i, 0, :, 1].sum(),
            hist[i, 0, :, 2].sum(), nbins, MISSING_NONE,
            min_data=kwargs["min_data_in_leaf"],
            min_hess=kwargs["min_sum_hessian_in_leaf"],
            **{k_: v for k_, v in kw.items()
               if k_ not in ("min_data_in_leaf", "min_data_per_group")},
            min_data_per_group=kw.get("min_data_per_group", 100))
        gain = float(got.gain[i, 0])
        if want is None:
            assert np.isneginf(gain)
            continue
        np.testing.assert_allclose(gain, want["gain"], rtol=1e-4)
        assert _bits_to_bins(got.bits[i, 0].numpy().view(np.uint32)) \
            == sorted(int(x) for x in want["bins"])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_nan_feature_and_ctr_tie(dtype):
    """Several features per leaf: a NaN-typed one (its last bin, the NaN
    bin, is never in a bitset), one whose bins 3 and 7 have the same CTR
    (the stable order keeps bin 3 first), a one-hot one and a masked one."""
    rng = np.random.RandomState(3)
    k, b = 4, 48
    hist = np.stack([_hists(rng, k, b, n) for n in (30, 30, 4, 20)], 1)
    # feature 0 is NaN-typed with a heavy NaN bin
    hist[:, 0, 29] = [5.0, 40.0, 150.0]
    # feature 1: bins 3 and 7 share g / (h + 10) = 0.5 and hold many rows
    hist[:, 1, 3] = [15.0, 20.0, 80.0]
    hist[:, 1, 7] = [25.0, 40.0, 90.0]
    num_bin = np.array([30, 30, 4, 20], np.int32)
    mtype = np.array([MISSING_NAN, MISSING_NONE, MISSING_NONE, MISSING_NONE],
                     np.int32)
    kw = dict(min_data_in_leaf=5, min_data_per_group=20)
    rtol = 1e-12 if dtype == np.float64 else 1e-6
    got = _compare(hist, num_bin, mtype, kw, dtype, rtol)
    nan_bit = got.bits[:, 0, 29 // 32] >> (29 % 32) & 1
    assert not nan_bit.any()
    assert torch.isfinite(got.gain[:, 1]).all()
    # the tie: bins 3 and 7 sort next to each other, 3 first
    h = torch.from_numpy(hist[:, 1].astype(dtype))
    ctr = h[..., 0] / (h[..., 1] + 10.0)
    assert bool((ctr[:, 3] == ctr[:, 7]).all())
    # a feature mask drops a feature: -inf and no bits
    masked = find_best_splits_categorical(
        torch.from_numpy(hist.astype(dtype)),
        *(torch.from_numpy(hist[:, 0, :, c].sum(1).astype(dtype))
          for c in range(3)),
        torch.from_numpy(num_bin), torch.from_numpy(mtype),
        torch.tensor([True, False, True, True]), **kw)
    assert torch.isneginf(masked.gain[:, 1]).all()
    assert not masked.bits[:, 1].any()


def test_bits_from_member_words():
    member = torch.zeros(2, 70, dtype=torch.bool)
    member[0, [0, 31, 32, 69]] = True
    member[1, 31] = True
    bits = bits_from_member(member)
    assert bits.dtype == torch.int32 and bits.shape == (2, 3)
    words = bits.numpy().view(np.uint32)
    assert list(words[0]) == [1 | (1 << 31), 1, 1 << 5]
    assert list(words[1]) == [1 << 31, 0, 0]


def test_candidates_write_only_the_categorical_columns():
    """``categorical_candidates`` on CPU tensors: the numerical scan's
    fields stay in the numerical columns, the categorical columns take the
    plain version's values (threshold 0, default_left False, bits)."""
    rng = np.random.RandomState(5)
    k, f, b = 3, 5, 32
    hist = np.stack([_hists(rng, k, b, 20) for _ in range(f)], 1) \
        .astype(np.float32)
    num_bin = np.full(f, 20, np.int32)
    mtype = np.zeros(f, np.int32)
    args = [torch.from_numpy(a) for a in
            (hist, hist[:, 0, :, 0].sum(1), hist[:, 0, :, 1].sum(1),
             hist[:, 0, :, 2].sum(1))]
    meta = [torch.from_numpy(a) for a in (num_bin, mtype)]
    fm = torch.ones(f, dtype=torch.bool)
    cols = torch.tensor([1, 3], dtype=torch.int32)
    kw = dict(min_data_in_leaf=5, min_data_per_group=10)
    num = find_best_splits(*args, meta[0], meta[1],
                           torch.zeros(f, dtype=torch.int32), fm,
                           min_data_in_leaf=5)
    before = [t.clone() for t in num]
    bits = torch.zeros((k, f, 1), dtype=torch.int32)
    categorical_candidates(num, bits, *args, *meta, fm, cols, **kw)
    cat = find_best_splits_categorical(
        args[0][:, [1, 3]], *args[1:], meta[0][[1, 3]], meta[1][[1, 3]],
        fm[[1, 3]], **kw)
    keep = [0, 2, 4]
    for name, old in zip(num._fields, before):
        new = getattr(num, name)
        assert torch.equal(new[:, keep], old[:, keep]), name
        if name == "threshold":
            assert not new[:, [1, 3]].any()
        elif name == "default_left":
            assert not new[:, [1, 3]].any()
        else:
            assert torch.equal(new[:, [1, 3]], getattr(cat, name)), name
    assert torch.equal(bits[:, [1, 3]], cat.bits)
    assert not bits[:, keep].any()
    # the plain entry point writes the same
    num2 = find_best_splits(*args, meta[0], meta[1],
                            torch.zeros(f, dtype=torch.int32), fm,
                            min_data_in_leaf=5)
    bits2 = torch.zeros_like(bits)
    categorical_candidates_plain(num2, bits2, *args, *meta, fm, cols, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(num, num2))
    assert torch.equal(bits, bits2)


@pytest.mark.parametrize("b", [4, 256, 1024, 2047, 1 << 16])
def test_kernel_plan_takes_every_uint16_width(b):
    """The wrapper's launch plan (``split_cat_plan``, its only width check)
    takes every width of the masked learner's uint16 codes at the default
    max_cat_threshold, its shared memory within the card's."""
    from lightgbm_tpu_torch.ops.split_cat import (_SMEM_LIMIT, SORT_CAP,
                                                  split_cat_plan)

    plan = split_cat_plan(b, 32)
    assert 64 <= plan.threads <= 512 and plan.smem <= _SMEM_LIMIT
    assert plan.cap >= min(b, SORT_CAP) and plan.tcap == min(32, (b + 1) // 2)
    with pytest.raises(ValueError):
        split_cat_plan((1 << 16) + 1, 32)
