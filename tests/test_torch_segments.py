"""Port segment histograms vs lightgbm_tpu's Pallas segment kernel.

The same numpy words, weights, leaf ids and member windows go through
``lightgbm_tpu.ops.hist_pallas.build_histogram_segments`` (``nterms=0``,
Pallas interpret mode, set up as ``tests/test_wave.py`` does: one chunk per
row block a member's window touches) and the port's
``ops/hist_segments.py`` (its plain version on CPU tensors).  On dyadic
weights every float32 sum is exact whatever its order, so the two must be
bitwise equal; on random float32 weights they agree within rtol=1e-5 and
an atol of 1e-5 times each bin's own sum of |w| (the two sum in different
orders).  Members start at
unaligned rows and two pairs share a frozen span, told apart by leaf id.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.hist_pallas import (build_histogram_segments as
                                          jax_segments, pack_bin_words)
from lightgbm_tpu_torch.ops.hist_segments import (
    TILE_ROWS, build_histogram_segments, build_histogram_segments_plain,
    segment_grid, segment_tile_plan)

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

N, F, B, RB = 4096, 8, 64, 512
# (start, count, leaf): disjoint windows at unaligned starts, then two
# frozen spans each shared by two members
MEMBERS = [(100, 700, 5), (1000, 900, 9), (2500, 1000, 11),
           (3500, 300, 20), (3500, 300, 21), (3800, 296, 30),
           (3800, 296, 31)]


def _inputs(dyadic: bool, seed: int = 31):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (F, N)).astype(np.uint8)
    if dyadic:
        w = (rng.randint(-64, 65, (3, N)) / 16.0).astype(np.float32)
    else:
        w = rng.randn(3, N).astype(np.float32)
    lid = np.zeros(N, np.int32)
    for s, c, leaf in MEMBERS:
        if leaf in (20, 30):         # the frozen spans: two leaves mixed
            lid[s:s + c] = np.where(rng.rand(c) < 0.5, leaf, leaf + 1)
        elif leaf not in (21, 31):
            lid[s:s + c] = leaf
    return bins, w, lid


def _jax(bins, w, lid):
    slot_t, block_t, leaf_t = [], [], []
    for k, (s, c, leaf) in enumerate(MEMBERS):
        for blk in range(s // RB, (s + c - 1) // RB + 1):
            slot_t.append(k)
            block_t.append(blk)
            leaf_t.append(leaf)
    k = len(MEMBERS)
    while len(slot_t) < N // RB + 2 * k:
        slot_t.append(k)
        block_t.append(0)
        leaf_t.append(-1)
    out = jax_segments(
        pack_bin_words(jnp.asarray(bins)), jnp.asarray(w), jnp.asarray(lid),
        jnp.asarray(slot_t, dtype=jnp.int32),
        jnp.asarray(block_t, dtype=jnp.int32),
        jnp.asarray(leaf_t, dtype=jnp.int32),
        num_bins=B, n_slots=k, row_block=RB, nterms=0, interpret=True)
    return np.asarray(out)


def _port(bins, w, lid, fn=build_histogram_segments, **kw):
    from lightgbm_tpu_torch.ops.hist_packed import pack_bin_words as pack

    s, c, leaf = (torch.tensor([m[i] for m in MEMBERS]) for i in range(3))
    return fn(pack(torch.from_numpy(bins)), torch.from_numpy(w),
              torch.from_numpy(lid), s, c, leaf, num_bins=B,
              rows_bound=int(c.sum()), **kw)


@pytest.mark.parametrize("dyadic", [True, False])
def test_plain_segments_equal_jax_kernel(dyadic):
    bins, w, lid = _inputs(dyadic)
    want = _jax(bins, w, lid)
    got = _port(bins, w, lid).numpy()
    assert got.shape == want.shape == (len(MEMBERS), F, B, 3)
    if dyadic:
        np.testing.assert_array_equal(got, want)
    else:
        # each bin's rounding error is bounded by the bin's own |w| mass
        mass = _port(bins, np.abs(w), lid).numpy()
        assert (np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-5 * mass).all()


def test_members_see_only_their_rows():
    """Each member's histogram is the bincount of its own rows: the frozen
    pairs split their span by leaf id, rows past a count are not read."""
    bins, w, lid = _inputs(True, seed=5)
    got = _port(bins, w, lid).numpy()
    for k, (s, c, leaf) in enumerate(MEMBERS):
        rows = np.arange(s, s + c)[lid[s:s + c] == leaf]
        for f in range(F):
            for ch in range(3):
                ref = np.bincount(bins[f, rows], weights=w[ch, rows],
                                  minlength=B)
                np.testing.assert_array_equal(got[k, f, :, ch],
                                              ref.astype(np.float32))


def test_dp_and_wrapper_route():
    bins, w, lid = _inputs(False, seed=9)
    wrapped = _port(bins, w, lid)
    plain = _port(bins, w, lid, fn=build_histogram_segments_plain)
    assert torch.equal(wrapped, plain)
    dp = _port(bins, w, lid, fn=build_histogram_segments_plain, dp=True)
    assert dp.dtype == torch.float64
    np.testing.assert_allclose(dp.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-4)


# (start, cnt) member windows for the tile plan: cnt = 0 members, one
# member over many tiles, frozen pairs sharing a span, K = 1, a wave of
# many small members
PLAN_CASES = {
    "zero_counts": ([0, 10, 500, 900], [0, 300, 0, 1000]),
    "many_tiles": ([7], [1_000_448 - 7]),
    "frozen_pairs": ([0, 5000, 5000, 9000, 9000], [4000, 2000, 2000, 129,
                                                    129]),
    "k1_small": ([12_345], [77]),
    "wave_of_64": (list(range(0, 64 * 3000, 3000)),
                   [(37 * m) % 2900 + 1 for m in range(64)]),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
@pytest.mark.parametrize("grid", [1, 7, 264])
def test_tile_plan_covers_every_row_once(case, grid):
    """Every row of every member lies in exactly one of the member's tiles,
    each block takes consecutive tiles (at most q), and the partial slots
    of different (block, member) pairs never collide."""
    start, cnt = (torch.tensor(a) for a in PLAN_CASES[case])
    plan = segment_tile_plan(start, cnt, grid)
    q = plan["q"]
    for m, (s, c) in enumerate(zip(start.tolist(), cnt.tolist())):
        sel = plan["member"] == m
        rows = torch.cat([torch.arange(r, r + n) for r, n in zip(
            plan["row0"][sel].tolist(), plan["rows"][sel].tolist())]
            + [torch.zeros(0, dtype=torch.int64)])
        assert torch.equal(rows, torch.arange(s, s + c)), m
        assert bool((plan["rows"][sel] > 0).all())
        assert bool((plan["rows"][sel] <= TILE_ROWS).all())
        blocks = plan["block"][sel].unique()
        if c > 0:
            assert bool(plan["direct"][sel].all()) == (blocks.numel() == 1)
    blk = plan["block"]
    assert bool((blk[1:] >= blk[:-1]).all()) and int(blk.max()) < grid
    assert int(torch.bincount(blk).max()) <= q
    seg = torch.stack([blk, plan["member"]], 1).unique(dim=0)
    assert seg[:, 0].add(seg[:, 1]).unique().numel() == seg.shape[0]
    assert int(plan["slot"].max()) < grid + start.numel()


def _kernel_plan_in_torch(bins, w, lid, grid):
    """The kernel's two passes on the tile plan, in float32 torch: each
    block's tiles in order into its members' histograms, flushed to the
    output or to the partial slot block + member, then each member's
    partials summed in block order."""
    from lightgbm_tpu_torch.ops.hist_packed import (
        build_histogram_packed_plain, pack_bin_words as pack)

    words = pack(torch.from_numpy(bins))
    s, c, leaf = (torch.tensor([m[i] for m in MEMBERS]) for i in range(3))
    plan = segment_tile_plan(s, c, grid)
    k = len(MEMBERS)
    out = torch.zeros((k, F, B, 3))
    partial = {}
    wt, lt = torch.from_numpy(w), torch.from_numpy(lid)
    for t in range(plan["member"].numel()):
        m, r0, n = (int(plan[x][t]) for x in ("member", "row0", "rows"))
        sl = slice(r0, r0 + n)
        h = build_histogram_packed_plain(
            words[:, sl], wt[:, sl] * (lt[sl] == int(leaf[m])), num_bins=B)
        if bool(plan["direct"][t]):
            out[m] += h
        else:
            key = int(plan["slot"][t])
            partial[key] = partial.get(key, 0) + h
    for m in range(k):
        sel = plan["member"] == m
        if sel.any() and not bool(plan["direct"][sel][0]):
            acc = torch.zeros((F, B, 3))
            for b in plan["block"][sel].unique().tolist():
                acc = acc + partial[b + m]
            out[m] = acc
    return out


@pytest.mark.parametrize("grid", [1, 3, 40])
def test_kernel_plan_equals_plain_on_dyadic_inputs(grid):
    """On dyadic weights every order sums exactly: the plan's tiles,
    partial slots and block-order reduction give the plain histograms."""
    bins, w, lid = _inputs(True, seed=17)
    want = _port(bins, w, lid, fn=build_histogram_segments_plain)
    assert torch.equal(_kernel_plan_in_torch(bins, w, lid, grid), want)


def test_segment_grid_is_sized_by_rows():
    assert segment_grid(1, 132) == 1
    assert segment_grid(256 * 10, 132) == 10
    assert segment_grid(256 * 10 + 1, 132) == 11
    assert segment_grid(1_000_448, 132) == 264
    assert segment_grid(0, 132) == 1


def test_pack_bin_words_chunked_equal_jax(monkeypatch):
    """Packing a few rows at a time gives the JAX package's words, the
    bytes past 127 (negative words) included."""
    from lightgbm_tpu_torch.ops import hist_packed

    monkeypatch.setattr(hist_packed, "PACK_CHUNK_ROWS", 5)
    bins = np.random.RandomState(4).randint(0, 256, (8, 37)).astype(np.uint8)
    got = hist_packed.pack_bin_words(torch.from_numpy(bins)).numpy()
    want = np.asarray(pack_bin_words(jnp.asarray(bins)))
    assert got.dtype == np.int32 and (got < 0).any()
    np.testing.assert_array_equal(got, want)
