"""Port stable row partition vs lightgbm_tpu's Pallas partition kernel.

The same numpy lanes and split windows go through
``lightgbm_tpu.ops.partition_pallas.apply_partition`` (Pallas interpret mode,
as the JAX package's own tests run it on the CPU) and the port's
``ops/partition.py`` (its plain version on CPU tensors).  A partition is a
permutation, so every lane must be bitwise equal, weights compared as bits.
The cases are those of ``tests/test_partition.py``: windows, the whole
array, adjacent odd windows, a tiny window, no window, all rows on one side.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.partition_pallas import (apply_partition as
                                               jax_apply_partition,
                                               exclusive_cumsum_i32)
from lightgbm_tpu_torch.ops.partition import (apply_partition,
                                              apply_partition_plain,
                                              exclusive_cumsum)

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)


def _case(n, windows, seed, left_bias=None):
    """Random lanes, split flags inside the windows, and the destinations
    the wave learner computes (child window start + rank on its side)."""
    rng = np.random.RandomState(seed)
    w_slots = 8
    bins = rng.randint(-2**31, 2**31 - 1, size=(2, n)).astype(np.int64) \
        .astype(np.int32)
    w_p = rng.randn(3, n).astype(np.float32)
    w_p[0, rng.rand(n) < 0.05] = np.nan
    w_p[1, rng.rand(n) < 0.05] = -0.0
    rid = np.arange(n, dtype=np.int32)
    lid = rng.randint(0, 1000, size=n).astype(np.int32)
    go_left = rng.rand(n) < (rng.rand() if left_bias is None else left_bias)
    ps = np.zeros(w_slots, np.int32)
    cw = np.zeros(w_slots, np.int32)
    lc = np.zeros(w_slots, np.int32)
    active = np.zeros(w_slots, bool)
    slots = rng.permutation(w_slots)[:len(windows)]
    gl = np.zeros(n, bool)
    gr = np.zeros(n, bool)
    for slot, (s, c) in zip(slots, windows):
        ps[slot], cw[slot], active[slot] = s, c, True
        gl[s:s + c] = go_left[s:s + c]
        gr[s:s + c] = ~go_left[s:s + c]
        lc[slot] = gl[s:s + c].sum()
    cum = exclusive_cumsum(torch.from_numpy(np.stack([gl, gr]))).numpy()
    cl, cr = cum[0], cum[1]
    dest = np.arange(n, dtype=np.int32)
    for slot, (s, c) in zip(slots, windows):
        seg = slice(s, s + c)
        dest[seg] = np.where(gl[seg], s - cl[s] + cl[seg],
                             s + lc[slot] - cr[s] + cr[seg])
    return dict(bins=bins, w=w_p, rid=rid, lid=lid, dest=dest, gl=gl, gr=gr,
                ps=ps, lc=lc, cw=cw, active=active, cl=cl, cr=cr)


CASES = {
    "windows": (2048, [(0, 700), (900, 1000)], 1, None),
    "whole_array": (1024, [(0, 1024)], 2, None),
    "odd_adjacent": (4096, [(1, 1023), (1024, 2048), (3500, 596)], 3, None),
    "tiny_window": (1024, [(100, 3)], 4, None),
    "empty": (1024, [], 5, None),
    "all_left": (1024, [(128, 512)], 6, 1.1),
    "all_right": (1024, [(128, 512)], 7, -0.1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_partition_equals_jax_kernel(name):
    c = _case(*CASES[name])
    mvd = (c["gl"] | c["gr"]).astype(np.int32)
    want = jax_apply_partition(
        jnp.asarray(c["bins"]), jnp.asarray(c["w"]), jnp.asarray(c["rid"]),
        jnp.asarray(c["lid"]), jnp.asarray(c["dest"]), jnp.asarray(mvd),
        jnp.asarray(c["ps"]), jnp.asarray(c["lc"]), jnp.asarray(c["cw"]),
        jnp.asarray(c["active"]), jnp.asarray(c["cl"]), jnp.asarray(c["cr"]),
        jnp.asarray(c["cl"][c["ps"]]), jnp.asarray(c["cr"][c["ps"]]),
        interpret=True)
    got = apply_partition(
        torch.from_numpy(c["bins"]), torch.from_numpy(c["w"]),
        torch.from_numpy(c["rid"].astype(np.int64)),
        torch.from_numpy(c["lid"]), torch.from_numpy(c["dest"]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy().view(np.int32),
                                  np.asarray(want[1]).view(np.int32))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_exclusive_cumsum_equals_jax():
    rng = np.random.RandomState(0)
    for n in (512, 2048, 3072):
        f = (rng.rand(2, n) < 0.3).astype(np.int32)
        want = np.asarray(exclusive_cumsum_i32(jnp.asarray(f)))
        got = exclusive_cumsum(torch.from_numpy(f))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_out_buffers_are_written_and_inputs_kept():
    c = _case(*CASES["odd_adjacent"])
    lanes = (torch.from_numpy(c["bins"]), torch.from_numpy(c["w"]),
             torch.from_numpy(c["rid"].astype(np.int64)),
             torch.from_numpy(c["lid"]))
    before = [t.clone() for t in lanes]
    out = tuple(torch.empty_like(t) for t in lanes)
    dest = torch.from_numpy(c["dest"])
    got = apply_partition(*lanes, dest, out=out)
    assert all(a is b for a, b in zip(got, out))
    assert all(torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)
               for a, b in zip(lanes, before))
    fresh = apply_partition_plain(*lanes, dest)
    for a, b in zip(got, fresh):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)
    with pytest.raises(ValueError):
        apply_partition(*lanes, dest, out=out[:3] + (out[2],))
