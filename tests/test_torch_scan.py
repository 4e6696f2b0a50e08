"""Port batched split scan vs lightgbm_tpu's Pallas scan kernel.

``ops/scan.py:find_best_splits_batched`` on CPU tensors (its plain version,
``find_best_splits`` over the batch axis) against
``lightgbm_tpu.ops.scan_pallas.find_best_splits_batched(..., interpret=True)``
on the fixture of ``tests/test_partition.py``: mixed missing types, bins past
each feature's count zeroed.  On dyadic histograms every sum is exact, so
threshold, default_left, the child sums and the outputs must be exactly
equal and the gain within 1 ulp (jax 0.9's interpret kernel is 1 ulp off
``find_best_splits`` on this fixture: ROADMAP.md Queue C).  On random
float32 the two sum in different orders: the same choices, values within
rtol=2e-5 as the JAX package's own test holds them.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.binning import MISSING_NAN, MISSING_NONE, MISSING_ZERO
from lightgbm_tpu.ops.scan_pallas import (find_best_splits_batched as
                                          jax_scan)
from lightgbm_tpu_torch.ops.scan import find_best_splits_batched
from lightgbm_tpu_torch.ops.split import find_best_splits

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

FIELDS = ("threshold", "default_left", "left_sum_g", "left_sum_h",
          "left_cnt", "right_sum_g", "right_sum_h", "right_cnt",
          "left_output", "right_output")


def _dyadic(rng, shape, scale=64.0):
    return (rng.randint(-(1 << 12), 1 << 12, size=shape) / scale) \
        .astype(np.float32)


def _scan_case(rng, k=6, f=9, b=32, dyadic=True):
    gen = (lambda s: _dyadic(rng, s)) if dyadic else \
        (lambda s: rng.randn(*s).astype(np.float32))
    hg = gen((k, f, b))
    hh = np.abs(gen((k, f, b))) + 0.25
    hc = rng.randint(0, 50, size=(k, f, b)).astype(np.float32)
    hist = np.stack([hg, hh, hc], axis=-1)
    num_bin = rng.randint(2, b + 1, size=f).astype(np.int32)
    missing = rng.choice([MISSING_NONE, MISSING_ZERO, MISSING_NAN],
                         size=f).astype(np.int32)
    default_bin = (rng.randint(0, 100, size=f) % num_bin).astype(np.int32)
    bm = np.arange(b)[None, :] < num_bin[:, None]
    hist *= bm[None, :, :, None]
    sum_g = hist[..., 0].sum(axis=(1, 2)) / f
    sum_h = np.abs(hist[..., 1]).sum(axis=(1, 2)) / f
    cnt = hist[..., 2].sum(axis=(1, 2)) / f
    return hist, sum_g, sum_h, cnt, num_bin, missing, default_bin


def _both(dyadic, seed, fmask=None):
    rng = np.random.RandomState(seed)
    case = _scan_case(rng, dyadic=dyadic)
    f = case[0].shape[1]
    fmask = np.ones(f, bool) if fmask is None else fmask
    kw = dict(lambda_l1=0.1 if not dyadic else 0.0, lambda_l2=0.5,
              max_delta_step=0.0, min_data_in_leaf=3,
              min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0)
    want = jax_scan(*[jnp.asarray(a) for a in case], jnp.asarray(fmask),
                    interpret=True, **kw)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in case]
    got = find_best_splits_batched(*args, torch.from_numpy(fmask), **kw)
    return want, got, args, kw


@pytest.mark.parametrize("seed", [17, 18])
def test_dyadic_fields_exact_gain_within_one_ulp(seed):
    want, got, _, _ = _both(True, seed)
    for fld in FIELDS:
        np.testing.assert_array_equal(getattr(got, fld).numpy(),
                                      np.asarray(getattr(want, fld)), fld)
    gw = np.asarray(want.gain)
    gg = got.gain.numpy()
    assert np.array_equal(np.isneginf(gw), np.isneginf(gg))
    fin = ~np.isneginf(gw)
    ulp = np.spacing(np.abs(gw[fin]).astype(np.float32))
    assert (np.abs(gg[fin] - gw[fin]) <= ulp).all()


def test_random_same_choices_values_close():
    want, got, _, _ = _both(False, 23)
    for fld in ("threshold", "default_left"):
        np.testing.assert_array_equal(getattr(got, fld).numpy(),
                                      np.asarray(getattr(want, fld)))
    gw, gg = np.asarray(want.gain), got.gain.numpy()
    assert np.array_equal(np.isneginf(gw), np.isneginf(gg))
    fin = ~np.isneginf(gw)
    np.testing.assert_allclose(gg[fin], gw[fin], rtol=2e-5, atol=2e-5)
    for fld in FIELDS[2:]:
        a = getattr(got, fld).numpy()[fin]
        b = np.asarray(getattr(want, fld))[fin]
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)


def test_feature_mask_and_plain_route():
    fmask = np.array([True, False] * 4 + [True])
    want, got, args, kw = _both(True, 19, fmask)
    assert np.isneginf(got.gain.numpy()[:, ~fmask]).all()
    np.testing.assert_array_equal(got.threshold.numpy(),
                                  np.asarray(want.threshold))
    plain = find_best_splits(*args, torch.from_numpy(fmask),
                                           **kw)
    for fld in got._fields:
        assert torch.equal(getattr(got, fld), getattr(plain, fld)), fld


def test_both_scans_equal_the_missing_skip_path_on_missing_none():
    """All-MISSING_NONE data: the learner's compact path skips the
    missing-right scan; the batched scan runs both and must choose the
    same (the missing-right scan finds nothing feasible)."""
    rng = np.random.RandomState(3)
    hist, sg, sh, cn, nb, _, db = _scan_case(rng)
    mt = np.full_like(nb, MISSING_NONE)
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (hist, sg, sh, cn, nb, mt, db)]
    fm = torch.ones(nb.shape[0], dtype=torch.bool)
    a = find_best_splits_batched(*args, fm, min_data_in_leaf=3)
    b = find_best_splits(*args, fm, min_data_in_leaf=3,
                         skip_missing_scan=True)
    for fld in a._fields:
        assert torch.equal(getattr(a, fld), getattr(b, fld)), fld


def _threshold_gains():
    """chip_smoke.py's per-threshold gains, which its scan phase uses to
    tell a clear best threshold from a near tie."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.threshold_gains


def test_threshold_gains_hold_the_chosen_gain():
    """The chosen gain is the best of both directions' threshold gains less
    the leaf's gain shift, one shift per leaf."""
    threshold_gains = _threshold_gains()
    _, got, args, kw = _both(True, 17)
    tg = threshold_gains(*args, **kw)                      # (K, F, 2B)
    assert tg.shape[-1] == 2 * args[0].shape[2]
    best = tg.max(dim=-1).values
    fin = torch.isfinite(got.gain)
    for k in range(best.shape[0]):
        shift = (best[k] - got.gain[k])[fin[k]]
        assert shift.numel() > 0
        # float32 rounding of (best - (best - shift)): a few ulps of best
        ulps = 4 * torch.finfo(torch.float32).eps * best[k][fin[k]].abs()
        assert bool(((shift - shift[0]).abs() <= ulps).all())
