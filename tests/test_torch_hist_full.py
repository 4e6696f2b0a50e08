"""The port's full-pass histogram vs lightgbm_tpu's ``build_histogram_onehot``.

``build_histogram_pallas`` (the TPU kernel ``csrc/hist_full.cu`` replaces)
has no interpret flag, so the JAX package's reference for the masked
learner's histogram is its XLA one-hot contraction.  On the CPU the port's
dispatcher ``build_histogram`` and the kernel wrapper
``build_histogram_full`` run the plain ``build_histogram_onehot``; these
tests hold it against the JAX package on the same numpy inputs: uint8 and
uint16 codes, bitwise on dyadic weights (every float32 sum exact in any
order), within rtol 1e-5 and an atol of 1e-5 times each bin's own sum of |w|
on random float32 (the two packages sum in other orders), codes at or past
``num_bins`` dropped, and ``dp`` in float64.  The kernel itself runs only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.histogram import build_histogram_onehot as j_onehot
from lightgbm_tpu_torch.ops.hist_full import build_histogram_full
from lightgbm_tpu_torch.ops.histogram import (build_histogram,
                                              build_histogram_onehot,
                                              read_codes)

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

N, F = 4096, 8


def _inputs(dtype, num_bins, seed, dyadic, code_max=None):
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, code_max or num_bins, size=(F, N)).astype(dtype)
    bag = (rng.rand(N) < 0.9).astype(np.float32)
    if dyadic:
        g = rng.randint(-16, 17, N) / 16.0
        h = rng.randint(1, 17, N) / 16.0
    else:
        g, h = rng.randn(N), rng.rand(N)
    w = np.stack([g * bag, h * bag, bag]).astype(np.float32)
    return codes, w


def _jax(codes, w, num_bins, dp=False):
    return np.asarray(j_onehot(jnp.asarray(codes), jnp.asarray(w),
                               num_bins=num_bins, dp=dp))


CASES = [(np.uint8, 255, None), (np.uint16, 1023, None),
         (np.uint8, 63, 256),            # codes >= num_bins dropped
         (np.uint16, 511, 700)]


@pytest.mark.parametrize("dtype,num_bins,code_max", CASES)
def test_dyadic_bitwise_against_jax(dtype, num_bins, code_max):
    codes, w = _inputs(dtype, num_bins, num_bins, True, code_max)
    want = _jax(codes, w, num_bins)
    b, wt = torch.from_numpy(codes), torch.from_numpy(w)
    before = build_histogram_full.launches
    for fn in (build_histogram_onehot, build_histogram,
               build_histogram_full):
        got = fn(b, wt, num_bins=num_bins)
        assert got.dtype == torch.float32
        assert tuple(got.shape) == (F, num_bins, 3)
        np.testing.assert_array_equal(got.numpy(), want)
    # CPU tensors take the plain version: no kernel launch is counted
    assert build_histogram_full.launches == before


@pytest.mark.parametrize("dtype,num_bins,code_max", CASES[:2])
def test_random_float32_within_tolerance(dtype, num_bins, code_max):
    codes, w = _inputs(dtype, num_bins, 7 + num_bins, False, code_max)
    want = _jax(codes, w, num_bins)
    mass = _jax(codes, np.abs(w), num_bins)
    got = build_histogram(torch.from_numpy(codes), torch.from_numpy(w),
                          num_bins=num_bins).numpy()
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-5 * mass)


@pytest.mark.parametrize("dtype,num_bins", [(np.uint8, 255),
                                            (np.uint16, 1023)])
def test_dp_float64_against_jax(dtype, num_bins):
    codes, w = _inputs(dtype, num_bins, 11, False)
    want = _jax(codes, w, num_bins, dp=True)
    mass = _jax(codes, np.abs(w), num_bins, dp=True)
    got = build_histogram(torch.from_numpy(codes), torch.from_numpy(w),
                          num_bins=num_bins, dp=True)
    assert got.dtype == torch.float64
    # float64 sums of float32 values in two orders
    assert np.all(np.abs(got.numpy() - want) <= 1e-12 * mass)


def test_read_codes_widens_uint16_exactly():
    codes = np.array([[0, 1, 255, 256, 32767, 32768, 65535]], np.uint16)
    t = torch.from_numpy(codes)
    np.testing.assert_array_equal(read_codes(t).numpy(),
                                  codes.astype(np.int64))
    idx = torch.tensor([6, 0, 5])
    np.testing.assert_array_equal(read_codes(t, (0, idx)).numpy(),
                                  codes[0, [6, 0, 5]].astype(np.int64))
    u8 = torch.from_numpy(np.array([[3, 200]], np.uint8))
    assert read_codes(u8).tolist() == [[3, 200]]
