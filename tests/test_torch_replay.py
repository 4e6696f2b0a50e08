"""The wave learner's replay pass (``ops/replay.py``) against a heap oracle.

``replay_pass_plain`` is the plain torch version the replay kernel
(``csrc/replay.cu``) is held against on the card.  Here it runs against a
direct ``heapq`` simulation of the reference's pop order, the host replay
the wave learner ran before the replay moved to the device: pop the
available slot with the largest gain, the lowest leaf index on exact ties
(`serial_tree_learner.cpp:185-218`, `:505-520`), stall at a slot the growth
never split.  The node tables are random forests whose gains come from a
small set of values, so exact ties are frequent, among available slots and
against children a pop reveals.  After each stall both sides apply the same
correction (the members get children with random gains) and the next pass
resumes from the carried state; every pass's pops, leaf indices, available
set, flag, members and counters must be equal.
"""

import heapq

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops.replay import (CTL_EXTRAS, CTL_FLAG, CTL_PASSES,
                                           CTL_POPS, CTL_STALL_EVENTS,
                                           CTL_STALL_SPLITS, FLAG_DONE,
                                           FLAG_STALL, NUM_CTL, replay_pass,
                                           replay_pass_plain)

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

GAINS = np.array([-1.0, 0.0, 0.25, 0.5, 0.5, 1.0, 1.0, 1.5, 2.0, 3.0])


class Oracle:
    """The host replay: a heap over the available slots per pass."""

    def __init__(self, m, budget, kb, extras_cap, vec_cap):
        self.refidx = np.full(m, -1, np.int64)
        self.refidx[0] = 0
        self.avail = {0}
        self.pops = []
        self.extras = 0
        self.done = False
        self.args = (budget, kb, extras_cap, vec_cap)

    def run(self, gains, split, child0, width):
        """One pass: returns (flag, members)."""
        budget, kb, extras_cap, vec_cap = self.args
        refidx = self.refidx
        heap = [(-gains[s], refidx[s], s) for s in self.avail]
        heapq.heapify(heap)
        top = -1
        while heap and len(self.pops) < budget:
            ng, ref, s = heap[0]
            if not -ng > 0.0:
                break
            if not split[s]:
                top = s
                break
            heapq.heappop(heap)
            c0 = int(child0[s])
            right = len(self.pops) + 1
            self.pops.append((s, int(ref)))
            refidx[c0], refidx[c0 + 1] = ref, right
            self.avail.discard(s)
            self.avail.update((c0, c0 + 1))
            heapq.heappush(heap, (-gains[c0], ref, c0))
            heapq.heappush(heap, (-gains[c0 + 1], right, c0 + 1))
        if top < 0:
            self.done = True
            return FLAG_DONE, []
        if kb == 1:
            return FLAG_STALL, [top]
        cands = sorted((s for s in self.avail
                        if not split[s] and gains[s] > 0.0),
                       key=lambda s: (-gains[s], refidx[s], s))[:kb]
        members = [cands[0]] + [
            s for i, s in enumerate(cands[1:], 1)
            if self.extras + i - 1 < extras_cap and width[s] <= vec_cap]
        self.extras += len(members) - 1
        return FLAG_STALL, members


def _forest(rng, m, grown):
    """A random grown forest in M slots: ``grown`` splits of random
    unsplit nodes (children at the next free pair), gains from GAINS."""
    gains = np.full(m, -np.inf)
    split = np.zeros(m, bool)
    child0 = np.zeros(m, np.int64)
    width = np.zeros(m, np.int64)
    gains[0] = rng.choice(GAINS[2:])
    width[0] = 4096
    nn = 1
    for _ in range(grown):
        open_ = np.flatnonzero(~split[:nn] & (gains[:nn] > 0))
        if open_.size == 0:
            break
        s = int(rng.choice(open_))
        split[s] = True
        child0[s] = nn
        gains[nn:nn + 2] = rng.choice(GAINS, 2)
        lw = int(rng.randint(0, width[s] + 1))
        width[nn:nn + 2] = (lw, width[s] - lw)
        nn += 2
    return gains, split, child0, width, nn


def _state(m, budget, kb):
    avail = torch.zeros(m, dtype=torch.uint8)
    avail[0] = 1
    refidx = torch.full((m,), -1, dtype=torch.int32)
    refidx[0] = 0
    return (avail, refidx, torch.zeros((budget, 2), dtype=torch.int32),
            torch.zeros(NUM_CTL, dtype=torch.int32),
            torch.zeros(kb, dtype=torch.int64),
            torch.zeros(kb, dtype=torch.bool))


def _run(seed, budget, kb, extras_cap, vec_cap, grown, dtype=torch.float64):
    rng = np.random.RandomState(seed)
    reserve = budget + extras_cap
    m = 1 + 2 * (grown + reserve)
    gains, split, child0, width, nn = _forest(rng, m, grown)
    oracle = Oracle(m, budget, kb, extras_cap, vec_cap)
    st = _state(m, budget, kb)
    avail, refidx, poprec, ctl, members, mvalid = st
    kw = dict(budget=budget, stall_batch=kb, extras_cap=extras_cap,
              vec_cap=vec_cap, pad_slot=m)
    passes = stalls = splits = 0
    while True:
        g = torch.from_numpy(gains).to(dtype)
        replay_pass_plain(g, torch.from_numpy(split),
                          torch.from_numpy(child0), torch.from_numpy(width),
                          *st, **kw)
        flag, want = oracle.run(gains.astype(dtype_np(dtype)), split, child0,
                                width)
        passes += 1
        stalls += flag == FLAG_STALL
        splits += len(want)
        pops = int(ctl[CTL_POPS])
        assert int(ctl[CTL_FLAG]) == flag
        assert pops == len(oracle.pops)
        assert [tuple(r) for r in poprec[:pops].tolist()] == oracle.pops
        assert np.array_equal(refidx.numpy(), oracle.refidx)
        assert set(torch.nonzero(avail).flatten().tolist()) == oracle.avail
        assert int(ctl[CTL_EXTRAS]) == oracle.extras
        assert int(ctl[CTL_PASSES]) == passes
        assert int(ctl[CTL_STALL_EVENTS]) == stalls
        assert int(ctl[CTL_STALL_SPLITS]) == splits
        nv = int(mvalid.sum())
        assert members[:nv].tolist() == want
        assert bool(mvalid[:nv].all()) and members[nv:].eq(m).all()
        if flag == FLAG_DONE:
            break
        # the correction: every member gets children
        for s in want:
            assert not split[s] and nn + 2 <= m
            split[s] = True
            child0[s] = nn
            gains[nn:nn + 2] = rng.choice(GAINS, 2)
            lw = int(rng.randint(0, width[s] + 1))
            width[nn:nn + 2] = (lw, width[s] - lw)
            nn += 2
    # a pass after the end changes nothing
    before = [t.clone() for t in st]
    replay_pass_plain(torch.from_numpy(gains), torch.from_numpy(split),
                      torch.from_numpy(child0), torch.from_numpy(width),
                      *st, **kw)
    assert all(torch.equal(a, b) for a, b in zip(before, st))
    return passes, stalls, len(oracle.pops), oracle.extras


def dtype_np(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kb", [1, 4])
def test_random_tables_with_ties_and_resumed_passes(seed, kb):
    """Forests grown to about half the budget: the replay stalls and
    resumes many times; the budget binds in some, positive gains run out
    in others."""
    budget = 30 if seed % 2 else 62
    passes, stalls, pops, _ = _run(seed, budget, kb, min(budget - 1, 64),
                                   1 << 17, grown=budget // 2)
    assert stalls > 0 and passes == stalls + 1
    assert pops > 0


@pytest.mark.parametrize("seed", range(3))
def test_extras_cap_binds(seed):
    """A cap of two extras over the replay: later stalls split the top
    alone."""
    _, stalls, _, extras = _run(100 + seed, 62, 4, 2, 1 << 17, grown=8)
    assert stalls > 3 and extras == 2


@pytest.mark.parametrize("seed", range(3))
def test_vec_cap_binds(seed):
    """Extras wider than the vector cap stay out of the batch."""
    _run(200 + seed, 62, 4, 64, 600, grown=10)


def test_float32_gains_and_a_fully_grown_forest():
    """Float32 gains (the learner's f32 node table) and a forest grown
    past the budget: no stall, the budget ends the replay."""
    passes, stalls, pops, _ = _run(7, 30, 4, 29, 1 << 17, grown=90,
                                   dtype=torch.float32)
    assert pops <= 30 and passes == stalls + 1


def test_cpu_tensors_take_the_plain_version():
    m, budget, kb = 9, 4, 2
    gains = torch.tensor([2.0, 1.0, 1.0, -1.0, 0.5, 0, 0, 0, 0])
    split = torch.tensor([1, 1, 0, 0, 0, 0, 0, 0, 0], dtype=torch.bool)
    child0 = torch.tensor([1, 3, 0, 0, 0, 0, 0, 0, 0])
    width = torch.full((m,), 10, dtype=torch.int64)
    st = _state(m, budget, kb)
    n0 = replay_pass.launches
    replay_pass(gains, split, child0, width, *st, budget=budget,
                stall_batch=kb, extras_cap=1, vec_cap=100, pad_slot=m)
    assert replay_pass.launches == n0
    avail, refidx, poprec, ctl, members, mvalid = st
    # root pops (leaf 0), then the tie 1.0 / 1.0 goes to leaf 0 (slot 1,
    # split) before leaf 1 (slot 2); slot 1's children gain -1 and 0.5;
    # slot 2 (gain 1.0, unsplit) stalls; slot 4 (0.5) is the extra
    assert poprec[:2].tolist() == [[0, 0], [1, 0]]
    assert int(ctl[CTL_FLAG]) == FLAG_STALL
    assert members.tolist() == [2, 4] and mvalid.tolist() == [True, True]
    assert refidx[:5].tolist() == [0, 0, 1, 0, 2]


def test_large_table_resumed_passes_against_the_oracle():
    """A table at the sizing of num_leaves=4095 (budget 4,094, M = 16,505)
    grown best-first to most of the budget, gains with exact ties: the
    first passes and their corrections agree with the heap oracle."""
    import chip_smoke as cs

    kb, extras_cap, vec_cap = 4, 64, 1 << 17
    m, budget = cs.replay_dims(4095)
    assert (m, budget) == (16_505, 4094)
    rng = np.random.RandomState(4095)
    tab, nn = cs.replay_ordered_forest(rng, m, 4000, 0.002, vals=GAINS)
    gains, split, child0, width = (t.numpy() for t in tab)
    oracle = Oracle(m, budget, kb, extras_cap, vec_cap)
    st = _state(m, budget, kb)
    avail, refidx, poprec, ctl, members, mvalid = st
    kw = dict(budget=budget, stall_batch=kb, extras_cap=extras_cap,
              vec_cap=vec_cap, pad_slot=m)
    for _ in range(4):
        replay_pass_plain(*tab, *st, **kw)
        flag, want = oracle.run(gains, split, child0, width)
        pops = int(ctl[CTL_POPS])
        assert int(ctl[CTL_FLAG]) == flag
        assert [tuple(r) for r in poprec[:pops].tolist()] == oracle.pops
        assert np.array_equal(refidx.numpy(), oracle.refidx)
        assert set(torch.nonzero(avail).flatten().tolist()) == oracle.avail
        nv = int(mvalid.sum())
        assert members[:nv].tolist() == want
        if flag == FLAG_DONE:
            break
        for s in want:
            split[s] = True
            child0[s] = nn
            gains[nn:nn + 2] = rng.choice(GAINS, 2)
            width[nn:nn + 2] = (1, width[s] - 1)
            nn += 2
    assert int(ctl[CTL_POPS]) > 500 and int(ctl[CTL_STALL_EVENTS]) >= 3


@pytest.mark.parametrize("num_leaves", [255, 2200, 4095, 4097, 131_072])
def test_launch_plan_takes_every_learner_size(num_leaves):
    """The kernel's launch plan (``replay_plan``) for the node slots and
    budget the wave learner sizes: no size refused, shared memory within
    the card's, what does not fit in the global scratch."""
    from lightgbm_tpu_torch import Config
    from lightgbm_tpu_torch.learner_wave import WaveTreeLearner
    from lightgbm_tpu_torch.ops.replay import _SMEM_LIMIT, replay_plan

    import chip_smoke as cs

    ln = WaveTreeLearner.__new__(WaveTreeLearner)
    ln.num_leaves, ln.n_pad, ln.hist_dp = num_leaves, 1 << 20, False
    cfg = Config.from_params({"num_leaves": num_leaves})
    ln._sort_cutoff = int(cfg.tpu_sort_cutoff)
    ln._init_wave_dims(cfg)
    plan = replay_plan(ln.M, ln.budget)
    assert plan.cap >= ln.budget + 1 and plan.cap & (plan.cap - 1) == 0
    assert plan.smem <= _SMEM_LIMIT
    assert plan.scratch + plan.smem == 32 * plan.cap + 13 * ln.M
    want_smem = {255: (True, True), 2200: (True, False),
                 4095: (True, False), 4097: (False, True),
                 131_072: (False, False)}[num_leaves]
    assert (plan.list_smem, plan.tab_smem) == want_smem
    if num_leaves == 255:
        assert ln.M == 1145 and plan.scratch == 0
    if num_leaves == 4095:
        assert ln.M == 16_505
    if num_leaves in cs.REPLAY_LARGE:
        # the sizing chip_smoke.py's large replay checks take
        assert (ln.M, ln.budget) == cs.replay_dims(num_leaves)
