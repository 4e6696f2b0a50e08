"""The launch plans of the full-pass and multislot histogram kernels, on the
CPU.

``csrc/hist_full.cu``, ``csrc/hist_packed.cu`` and ``csrc/hist_multislot.cu``
take their geometry from ``ops/hist_full.py:full_plan``,
``ops/hist_packed.py:packed_plan`` and ``ops/hist_multislot.py:
multislot_plan``: a block per (row chunk, feature group[, bin tile][,
slot]).  These tests check that
the blocks cover every row, feature and bin exactly once for odd shapes,
that the grid stays within one wave of the card, and, replaying the plan
with the plain histogram, that the kernels' second pass (partials written
only where a bin was touched, summed over chunks in kParts runs) gives the
plain version's bits on dyadic inputs.  The kernels themselves run only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import hist_full as hf
from lightgbm_tpu_torch.ops import hist_multislot as hm
from lightgbm_tpu_torch.ops import hist_packed as hp
from lightgbm_tpu_torch.ops.histogram import build_histogram_onehot

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

KPARTS = 8  # csrc/hist_common.cuh: kParts


def _per_sm_full(tile):
    smem = hf.full_smem_bytes(tile)
    return max(1, min(8, hf.SMEM_PER_SM // (smem + hf.SMEM_RESERVED)))


def _full_blocks(f, s, num_bins):
    """Every block of hist_full's grid: (rows, features, bins) ranges."""
    p = hf.full_plan(f, s, num_bins)
    for c in range(p.nchunks):
        for g in range(p.groups):
            for t in range(p.ntiles):
                yield (range(c * p.chunk, min(s, (c + 1) * p.chunk)),
                       range(g * hf.FEATURES_PER_BLOCK,
                             min(f, (g + 1) * hf.FEATURES_PER_BLOCK)),
                       range(t * p.tile, min(num_bins, (t + 1) * p.tile)))


@pytest.mark.parametrize("f", [1, 3, 7, 29])
@pytest.mark.parametrize("s,num_bins", [
    (1, 2), (255, 255), (4097, 1023), (100_001, 1025), (1_000_448, 1023),
    (9_999, 2047), (513, 65_536)])
def test_full_plan_covers_every_row_feature_and_bin_once(f, s, num_bins):
    p = hf.full_plan(f, s, num_bins)
    assert p.chunk % hf.STAGE_ROWS == 0 and p.chunk > 0
    assert (p.nchunks - 1) * p.chunk < s <= p.nchunks * p.chunk
    assert 1 <= p.tile <= hf.TILE_BINS
    # one wave of the card, or a single chunk
    blocks = p.nchunks * p.groups * p.ntiles
    assert p.nchunks == 1 or blocks <= hf.SMS * _per_sm_full(p.tile)
    seen = np.zeros((f, num_bins), np.int64)
    rows = np.zeros((f, num_bins), np.int64)
    for r, fs, bs in _full_blocks(f, s, num_bins):
        assert len(r) > 0 and len(fs) > 0 and len(bs) > 0
        seen[fs.start:fs.stop, bs.start:bs.stop] += 1
        rows[fs.start:fs.stop, bs.start:bs.stop] += len(r)
    # every (feature, bin) cell belongs to one block per chunk, and the
    # chunks of a cell hold every row once
    assert (seen == p.nchunks).all()
    assert (rows == s).all()


def test_full_plan_fills_the_card_at_the_bench_width():
    """F = 28, 1,000,448 rows, 1,023 bins: three blocks per SM, one wave
    with no tail, chunks of whole stages."""
    p = hf.full_plan(28, 1_000_448, 1023)
    assert _per_sm_full(p.tile) == 3
    assert p.groups == 7 and p.ntiles == 1
    assert p.nchunks * p.groups <= hf.SMS * 3
    assert p.nchunks * p.groups > hf.SMS * 3 - p.groups


@pytest.mark.parametrize("fw", [1, 2, 3, 5, 8, 9, 17])
@pytest.mark.parametrize("s,num_bins", [
    (1024, 2), (3072, 63), (65_536, 255), (100_352, 256), (1_000_448, 255),
    (777, 17)])
def test_packed_plan_covers_every_row_and_lane_once(fw, s, num_bins):
    p = hp.packed_plan(fw, s, num_bins)
    assert 1 <= p.lanes <= hp.LANES_PER_BLOCK
    smem = hp.packed_smem_bytes(p.lanes, num_bins)
    per_sm = min(2048 // (128 * p.lanes),
                 hp.SMEM_PER_SM // (smem + hp.SMEM_RESERVED))
    assert p.groups * p.lanes >= fw > (p.groups - 1) * p.lanes
    assert p.chunk % hp.STAGE_ROWS == 0
    assert (p.nchunks - 1) * p.chunk < s <= p.nchunks * p.chunk
    assert p.nchunks == 1 or p.chunk >= min(hp.SMALL_CHUNK_ROWS,
                                            hp.LARGE_CHUNK_ROWS)
    assert p.nchunks == 1 or p.nchunks * p.groups <= hp.SMS * per_sm
    cover = np.zeros((fw, s), np.int64)
    for c in range(p.nchunks):
        for g in range(p.groups):
            lanes = range(g * p.lanes, min(fw, (g + 1) * p.lanes))
            cover[lanes.start:lanes.stop,
                  c * p.chunk:min(s, (c + 1) * p.chunk)] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("s,lanes,nchunks", [
    (4096, 1, 16), (8192, 1, 32), (65_536, 1, 64), (131_072, 4, 128),
    (1_000_448, 4, 196)])
def test_packed_plan_at_the_bench_width(s, lanes, nchunks):
    """Fw = 8 at 255 bins: a window under 131,072 rows takes one word lane
    a block (eight lane groups) and up to 64 chunks of 256 rows and more;
    a larger one four lanes a block (16 warps, three blocks an SM) and
    1,024-row chunks and more, one wave of the card at the full window."""
    p = hp.packed_plan(8, s, 255)
    assert p.lanes == lanes and p.groups == 8 // lanes
    assert hp.packed_smem_bytes(4, 255) + hp.SMEM_RESERVED \
        <= hp.SMEM_PER_SM // 3
    assert p.nchunks == nchunks


def _replay_reduce(partials, touched):
    """The second pass: the chunks cut into KPARTS consecutive runs, each
    run summed in chunk order over the touched partials, then the runs in
    order (csrc/hist_common.cuh: hist_reduce)."""
    n = len(partials)
    run = -(-n // KPARTS)
    out = torch.zeros_like(partials[0])
    for q in range(KPARTS):
        acc = torch.zeros_like(partials[0])
        for c in range(q * run, min(n, (q + 1) * run)):
            acc = torch.where(touched[c], acc + partials[c], acc)
        out = out + acc if q else acc
    return out


def _replay_full(bins, w, num_bins):
    """hist_full's plan replayed with the plain histogram: each block's
    histogram over its rows, features and tile; with more than one chunk,
    partials kept only where a bin's sums are not all zero, then the
    second pass."""
    f, s = bins.shape
    p = hf.full_plan(f, s, num_bins)
    parts = [torch.zeros(f, num_bins, 3) for _ in range(p.nchunks)]
    for r, fs, bs in _full_blocks(f, s, num_bins):
        c = r.start // p.chunk
        codes = bins[fs.start:fs.stop, r.start:r.stop].to(torch.int64)
        codes = codes - bs.start
        codes = torch.where((codes >= 0) & (codes < len(bs)), codes,
                            torch.full_like(codes, len(bs)))
        h = build_histogram_onehot(codes, w[:, r.start:r.stop],
                                   num_bins=len(bs))
        parts[c][fs.start:fs.stop, bs.start:bs.stop] = h
    if p.nchunks == 1:
        return parts[0]
    touched = [(t != 0).any(dim=-1, keepdim=True) for t in parts]
    return _replay_reduce(parts, touched)


def _dyadic(rng, n, share):
    keep = rng.rand(n) < share
    g = rng.randint(-16, 17, n) / 16.0 * keep
    h = rng.randint(0, 17, n) / 16.0 * keep
    return torch.from_numpy(np.stack([g, h, keep]).astype(np.float32))


@pytest.mark.parametrize("f,s,num_bins,share", [
    (3, 70_001, 255, 1.0), (5, 40_000, 1023, 0.05), (2, 20_480, 2047, 0.002),
    (7, 9_000, 63, 0.0)])
def test_full_plan_replay_is_bitwise_the_plain_version(f, s, num_bins,
                                                       share):
    rng = np.random.RandomState(s)
    bins = torch.from_numpy(rng.randint(0, num_bins + 40, (f, s))
                            .astype(np.int32))
    w = _dyadic(rng, s, share)
    got = _replay_full(bins, w, num_bins)
    assert torch.equal(got, build_histogram_onehot(bins, w,
                                                   num_bins=num_bins))


def test_packed_plan_replay_is_bitwise_the_plain_version():
    """hist_packed's plan at a 65,536-row window over 5 word lanes: the
    chunk partials of every feature, reduced as the kernel does."""
    fw, s, nb = 5, 65_536, 255
    rng = np.random.RandomState(4)
    codes = torch.from_numpy(rng.randint(0, 256, (4 * fw, s))
                             .astype(np.uint8))
    words = hp.pack_bin_words(codes)
    w = _dyadic(rng, s, 0.7)
    p = hp.packed_plan(fw, s, nb)
    assert p.nchunks > 1
    parts = [hp.build_histogram_packed_plain(
        words[:, c * p.chunk:(c + 1) * p.chunk],
        w[:, c * p.chunk:(c + 1) * p.chunk], num_bins=nb)
        for c in range(p.nchunks)]
    touched = [(t != 0).any(dim=-1, keepdim=True) for t in parts]
    got = _replay_reduce(parts, touched)
    assert torch.equal(got, hp.build_histogram_packed_plain(words, w,
                                                            num_bins=nb))


def _per_sm_multislot(lanes, num_bins):
    smem = hm.multislot_smem_bytes(lanes, num_bins)
    return min(2048 // (128 * lanes),
               hf.SMEM_PER_SM // (smem + hf.SMEM_RESERVED))


@pytest.mark.parametrize("fw", [1, 2, 3, 5, 8, 9])
@pytest.mark.parametrize("k,s,num_bins", [
    (1, 1_000_448, 255), (2, 1_000_448, 255), (4, 1_000_448, 255),
    (16, 1_000_448, 255), (17, 5000, 63), (64, 1_000_448, 256), (3, 1024, 2),
    (1, 777, 17), (300, 70_000, 255)])
def test_multislot_plan_covers_every_row_lane_and_slot_once(fw, k, s,
                                                            num_bins):
    """Block (j, g, c) bins slot j's rows of chunk c over lane group g:
    with the chunks tiling the rows and the groups the lanes, every (row,
    word lane, slot) has one block; the grid stays within one wave of the
    card unless it is a single chunk."""
    p = hm.multislot_plan(fw, k, s, num_bins)
    assert 1 <= p.lanes <= hm.LANES_PER_BLOCK
    assert p.chunk % hm.STAGE_ROWS == 0
    assert (p.nchunks - 1) * p.chunk < s <= p.nchunks * p.chunk
    assert p.nchunks == 1 or p.chunk >= hm.MIN_CHUNK_ROWS
    assert p.nchunks == 1 or k * p.groups * p.nchunks \
        <= hf.SMS * _per_sm_multislot(p.lanes, num_bins)
    assert k * 4 * fw <= 65_535 or p.nchunks == 1
    cover = np.zeros((fw, s), np.int8)
    for c in range(p.nchunks):
        for g in range(p.groups):
            cover[g * p.lanes:min(fw, (g + 1) * p.lanes),
                  c * p.chunk:min(s, (c + 1) * p.chunk)] += 1
    assert (cover == 1).all()   # ... and the same blocks for every slot


@pytest.mark.parametrize("k,nchunks", [(1, 131), (2, 66), (4, 33), (8, 16),
                                       (16, 8), (64, 2)])
def test_multislot_plan_at_the_bench_width(k, nchunks):
    """Fw = 8 at 255 bins over 1,000,448 rows: four word lanes a block (16
    warps, two blocks an SM), two lane groups, and as many chunks as fill
    one wave of the 132 SMs at every opening level's K."""
    p = hm.multislot_plan(8, k, 1_000_448, 255)
    assert p.lanes == 4 and p.groups == 2
    assert _per_sm_multislot(4, 255) == 2
    assert p.nchunks == nchunks


def _slots(rng, n, k, kind):
    """Root-order slots: ``spread`` (slots 0..K-1, K and -1 dropped),
    ``half`` (about half the rows in slot 0 of K = 1, as an opening's first
    level), ``empty`` (slot 1 of K = 3 holds no row)."""
    if kind == "half":
        return np.where(rng.rand(n) < 0.5, 0, 1).astype(np.int32)
    slot = rng.randint(-1, k + 1, n).astype(np.int32)
    if kind == "empty":
        slot[slot == 1] = 0
    return slot


@pytest.mark.parametrize("fw,k,s,kind", [
    (2, 3, 40_000, "spread"), (3, 1, 70_001, "half"), (1, 3, 20_000, "empty"),
    (5, 17, 9_000, "spread")])
def test_multislot_plan_replay_is_bitwise_the_plain_version(fw, k, s, kind):
    """multislot_plan replayed with the plain version: each chunk's slot
    histograms, partials kept only where a bin's sums are not all zero,
    then the second pass over the K * 4*Fw features; dyadic weights give
    the plain version's bits, the quant mode too."""
    rng = np.random.RandomState(s)
    codes = torch.from_numpy(rng.randint(0, 256, (4 * fw, s))
                             .astype(np.uint8))
    words = hp.pack_bin_words(codes)
    w = _dyadic(rng, s, 0.8)
    slot = torch.from_numpy(_slots(rng, s, k, kind))
    p = hm.multislot_plan(fw, k, s, 255)
    assert p.nchunks > 1 or s < 2 * hm.MIN_CHUNK_ROWS
    for quant in (False, True):
        parts = [hm.build_histogram_multislot_plain(
            words[:, c * p.chunk:(c + 1) * p.chunk],
            w[:, c * p.chunk:(c + 1) * p.chunk],
            slot[c * p.chunk:(c + 1) * p.chunk], num_bins=255, n_slots=k,
            quant=quant) for c in range(p.nchunks)]
        if p.nchunks > 1:
            touched = [(t != 0).any(dim=-1, keepdim=True) for t in parts]
            got = _replay_reduce(parts, touched)
        else:
            got = parts[0]
        want = hm.build_histogram_multislot_plain(
            words, w, slot, num_bins=255, n_slots=k, quant=quant)
        assert torch.equal(got, want)
    if kind == "empty":
        assert not want[1].any()
