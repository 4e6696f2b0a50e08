"""One pass of the wave learner's exact greedy replay (CUDA kernel + plain).

Port of the XLA loop ``lightgbm_tpu/learner_wave.py:_replay`` (a
``lax.while_loop``, not a Pallas kernel).  The wave learner grows a forest
of speculative splits; the replay re-derives the reference's best-first pop
order over it (`serial_tree_learner.cpp:185-218`): pop the available leaf
with the largest gain, the lowest leaf index on exact ties
(`serial_tree_learner.cpp:505-520`); the left child keeps the leaf index,
the right child gets ``pops + 1``; stop after ``budget`` pops or when no
available gain is positive.  A pass ends early ("stall", flag 1) at a leaf
the growth never split, and writes the correction's members; the learner
splits them and runs the next pass, which carries on from the state in
``avail``, ``refidx``, ``poprec`` and ``ctl``.  Flag 2 ("done") ends the
replay, and a pass that finds it returns at once.

The state is device tensors updated in place, so a pass reads nothing back
to the host:

    avail  (M,) uint8      available (frontier) node slots
    refidx (M,) int32      leaf index of every revealed slot (-1 = none)
    poprec (budget, 2) int32   (slot, leaf index) of each pop, in order
    ctl    (NUM_CTL,) int32    the CTL_* counters and the flag
    members (stall_batch,) int64, mvalid (stall_batch,) bool

On a stall with ``stall_batch == 1`` the member is the stalled top; with a
larger batch the members are the top ``stall_batch`` unsplit positive-gain
available slots by (gain desc, leaf index asc), the top first, each extra
past the first counted against ``extras_cap`` over the whole replay and
kept only with a window width ``<= vec_cap`` (``learner_wave.py:1752-1786``
in the JAX package); members are compacted and padded with ``pad_slot``.

On a CUDA tensor ``replay_pass`` is one launch of the hand-written Hopper
kernel ``csrc/replay.cu`` (design and bound in its header), bitwise equal
to ``replay_pass_plain``: the pass only compares and copies.  The kernel
pops whole runs of the list of available slots per block-wide step; where
its buffers live (shared memory or a global scratch buffer) is
``replay_plan``'s choice, so every M and budget the wave learner sizes
runs.  On a CPU tensor it runs ``replay_pass_plain``, the same pass in
plain torch, one argmax over the available slots per pop.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import native

(CTL_POPS, CTL_EXTRAS, CTL_FLAG, CTL_PASSES, CTL_STALL_EVENTS,
 CTL_STALL_SPLITS, CTL_ERROR) = range(7)
NUM_CTL = 7
FLAG_RUN, FLAG_STALL, FLAG_DONE = 0, 1, 2


def replay_pass_plain(gain: torch.Tensor, split: torch.Tensor,
                      child0: torch.Tensor, width: torch.Tensor,
                      avail: torch.Tensor, refidx: torch.Tensor,
                      poprec: torch.Tensor, ctl: torch.Tensor,
                      members: torch.Tensor, mvalid: torch.Tensor, *,
                      budget: int, stall_batch: int, extras_cap: int,
                      vec_cap: int, pad_slot: int) -> None:
    """Plain torch version (see the module docstring); reads the carried
    state to the host, so it is the CPU's path."""
    if int(ctl[CTL_FLAG]) == FLAG_DONE:
        return
    m = avail.shape[0]
    g = gain[:m].to(torch.float64)
    key = torch.where(g > 0.0, g, torch.zeros_like(g))    # NaN -> 0
    av = avail.to(torch.bool)
    sp = split[:m].to(torch.bool)
    ref64 = refidx.to(torch.int64)
    big = torch.iinfo(torch.int64).max
    pops, extras = int(ctl[CTL_POPS]), int(ctl[CTL_EXTRAS])
    flag, top = FLAG_DONE, -1
    while pops < budget:
        kv = torch.where(av, key, -1.0)
        kmax = kv.max()
        if not bool(kmax > 0.0):
            break
        s = int(torch.where(av & (kv == kmax), ref64, big).argmin())
        if not bool(sp[s]):
            flag, top = FLAG_STALL, s
            break
        c0, ref = int(child0[s]), int(ref64[s])
        poprec[pops, 0], poprec[pops, 1] = s, ref
        ref64[c0], ref64[c0 + 1] = ref, pops + 1
        av[s], av[c0], av[c0 + 1] = False, True, True
        pops += 1
    mem = []
    if flag == FLAG_STALL:
        if stall_batch == 1:
            mem = [top]
        else:
            cand = torch.nonzero(av & ~sp & (key > 0.0)).flatten()
            o = torch.sort(ref64[cand], stable=True).indices
            o = o[torch.sort(key[cand][o], descending=True,
                             stable=True).indices]
            cands = cand[o][:stall_batch].tolist()
            mem = [cands[0]] + [
                s for i, s in enumerate(cands[1:], 1)
                if extras + i - 1 < extras_cap and int(width[s]) <= vec_cap]
            extras += len(mem) - 1
    members.fill_(pad_slot)
    mvalid.zero_()
    if mem:
        members[:len(mem)] = torch.tensor(mem, dtype=members.dtype)
        mvalid[:len(mem)] = True
    avail.copy_(av.to(avail.dtype))
    refidx.copy_(ref64.to(refidx.dtype))
    ctl[CTL_POPS], ctl[CTL_EXTRAS], ctl[CTL_FLAG] = pops, extras, flag
    ctl[CTL_PASSES] += 1
    ctl[CTL_STALL_EVENTS] += int(flag == FLAG_STALL)
    ctl[CTL_STALL_SPLITS] += len(mem)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = native.load("replay")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lgbt_replay.argtypes = [P, L, I, P, P, P, L, I, P, P, P, P, P, P,
                                    I, I, I, L, L, I, I, I, L, P, P]
        lib.lgbt_replay.restype = ctypes.c_int
        _LIB = lib
    return _LIB


#: dynamic shared memory the block may take on the card: Hopper's 227 KB
#: less 4 KB for the kernel's static shared memory
_SMEM_LIMIT = 232_448 - 4_096


class ReplayPlan(NamedTuple):
    """The kernel's buffers for M slots and a budget: the list capacity
    (a power of two >= budget + 1), whether the two list buffers and the
    compact table are in shared memory, the dynamic shared memory and the
    global scratch bytes."""
    cap: int
    list_smem: bool
    tab_smem: bool
    smem: int
    scratch: int


def replay_plan(m: int, budget: int) -> ReplayPlan:
    """Place the kernel's buffers: the two list buffers (16 bytes an entry
    each) in shared memory where they fit, then the table (13 bytes a slot)
    where it still fits, the rest in the global scratch buffer.  Raises
    only for sizes past the kernel's 32-bit indices."""
    if m < 1 or budget < 0 or m >= 1 << 31 or budget + 1 >= 1 << 31:
        raise ValueError(f"{m} node slots and budget {budget} are past the "
                         f"replay kernel's 32-bit slot and leaf indices")
    cap = 1 << budget.bit_length()
    smem = scratch = 0
    list_bytes, tab_bytes = 32 * cap, 13 * m
    list_smem = list_bytes <= _SMEM_LIMIT
    if list_smem:
        smem += list_bytes
    else:
        scratch += list_bytes
    tab_smem = smem + tab_bytes <= _SMEM_LIMIT
    if tab_smem:
        smem += tab_bytes
    else:
        scratch += tab_bytes
    return ReplayPlan(cap, list_smem, tab_smem, smem, scratch)


def replay_pass(gain: torch.Tensor, split: torch.Tensor,
                child0: torch.Tensor, width: torch.Tensor,
                avail: torch.Tensor, refidx: torch.Tensor,
                poprec: torch.Tensor, ctl: torch.Tensor,
                members: torch.Tensor, mvalid: torch.Tensor, *, budget: int,
                stall_batch: int, extras_cap: int, vec_cap: int,
                pad_slot: int) -> None:
    """One replay pass over M node slots, the state updated in place.

    gain   : (M,) float32 or float64 (any stride)   split : (M,) bool
    child0 : (M,) int64 (contiguous)    width : (M,) int64 (any stride)
    avail, refidx, poprec, ctl, members, mvalid : the carried state (see
    the module docstring), contiguous.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``replay_pass.launches``) or raise.
    """
    kw = dict(budget=budget, stall_batch=stall_batch, extras_cap=extras_cap,
              vec_cap=vec_cap, pad_slot=pad_slot)
    state = (avail, refidx, poprec, ctl, members, mvalid)
    args = (gain, split, child0, width) + state
    if all(t.device.type == "cpu" for t in args):
        return replay_pass_plain(*args, **kw)
    dev = avail.device
    if dev.type != "cuda" or any(t.device != dev for t in args):
        raise ValueError("the node table and the replay state must all lie "
                         "on one CUDA device")
    m = avail.shape[0]
    want = ((split, torch.bool, (m,)), (child0, torch.int64, (m,)),
            (width, torch.int64, (m,)), (avail, torch.uint8, (m,)),
            (refidx, torch.int32, (m,)), (poprec, torch.int32, (budget, 2)),
            (ctl, torch.int32, (NUM_CTL,)),
            (members, torch.int64, (stall_batch,)),
            (mvalid, torch.bool, (stall_batch,)))
    for t, dt, shape in want:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"expected a {dt} tensor of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if gain.dtype not in (torch.float32, torch.float64) \
            or tuple(gain.shape) != (m,):
        raise ValueError(f"gain must be ({m},) float32 or float64")
    if not all(t.is_contiguous() for t in (split, child0) + state):
        raise ValueError("split, child0 and the replay state must be "
                         "contiguous")
    if not 1 <= stall_batch <= 64:
        raise ValueError(f"stall_batch {stall_batch} out of the kernel's "
                         f"range 1..64")
    plan = replay_plan(m, budget)
    scratch = torch.empty(plan.scratch, dtype=torch.uint8, device=dev) \
        if plan.scratch else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    native.launch("replay", _lib().lgbt_replay, gain, gain.stride(0),
                  int(gain.dtype == torch.float64), split, child0, width,
                  width.stride(0), m, avail, refidx, poprec, ctl, members,
                  mvalid, budget, stall_batch, extras_cap, int(vec_cap),
                  int(pad_slot), plan.cap, int(plan.list_smem),
                  int(plan.tab_smem), plan.smem, scratch, stream)
    native.count(replay_pass)


replay_pass.launches = 0
