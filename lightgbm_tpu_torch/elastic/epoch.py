"""Membership epochs: the agreed live-host set and its generation counter.

Port of ``lightgbm_tpu/elastic/epoch.py`` on the pod's ``TCPStore``.  An
epoch is ``(epoch, members)``: ``members`` is the ordered list of stable
host ids still alive (host ids never renumber; a host's rank in an epoch is
its index in ``members``).  Epoch k+1 is negotiated by epoch k's survivors
over epoch k's store right after a ``RankDeathError``.  The store server
lives in epoch k's global rank 0 process and serves until that process
exits, which is the window the negotiation uses (the window
``DistributedNet._missing_report`` already relies on to name dead ranks).

A host runs ``L`` ranks (``LOCAL_WORLD_SIZE``; one a card), and the host is
the unit of membership, as a JAX host is one process: global rank ``r`` of
epoch k is on host ``members[r // L]``, so one dead rank takes its host out
of epoch k+1.  Each host negotiates through its local rank 0.

Protocol (keys under ``elastic/e<k+1>/``):

  1. every surviving host posts ``ack/h<host>`` = the dead-rank set it
     observed, translated to host ids;
  2. the anchor, the lowest-host-id survivor, waits for every proposed
     member's ack under the deadline; a proposed member that never acks is
     declared dead too (a failure during recovery), then the anchor posts
     the canonical ``record``;
  3. the other survivors wait for ``record``, make their verdict durable
     (the controller's verdict file), and only then post ``got/h<host>``
     through :func:`confirm_record`; the anchor waits for every got before
     it returns, so it cannot exit while a peer still reads the record.

If the anchor or the store's host is among the dead, the reads time out
and negotiation raises ``ConnectionError``: losing the control plane is
terminal, as in the JAX package, whose coordination service lives in
process 0 the way the store lives in global rank 0's process.

The generation stamp is the zombie fence: a late worker of epoch k writes
only under its own proposed generation, and epoch k+1 runs on a store at
another port, so its collectives never interleave with the new epoch's.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from datetime import timedelta
from typing import List, Sequence


@dataclass
class MembershipEpoch:
    """One agreed generation of the pod."""

    epoch: int
    #: ordered STABLE host ids; a host's rank is its index here
    members: List[int]
    #: host ids declared dead in the transition INTO this epoch
    dead_hosts: List[int] = field(default_factory=list)
    coordinator: str = ""

    def rank_of(self, host_id: int) -> int:
        return self.members.index(int(host_id))

    def to_dict(self) -> dict:
        return {"epoch": int(self.epoch),
                "members": [int(m) for m in self.members],
                "dead_hosts": [int(d) for d in self.dead_hosts],
                "coordinator": self.coordinator}

    @classmethod
    def from_dict(cls, d: dict) -> "MembershipEpoch":
        return cls(epoch=int(d["epoch"]),
                   members=[int(m) for m in d["members"]],
                   dead_hosts=[int(x) for x in d.get("dead_hosts", [])],
                   coordinator=str(d.get("coordinator", "")))


def coordinator_for_epoch(host: str, port_base: int, epoch: int) -> str:
    """Epoch k's fresh pod address: ``port_base + k`` on the coordinator
    host.  A new port per generation isolates epoch k+1 from epoch k's
    dying store (and its zombies)."""
    return f"{host}:{int(port_base) + int(epoch)}"


def _store():
    from torch.distributed import PrefixStore

    from ..parallel.multihost import _pod_store
    return PrefixStore("lgbt-elastic", _pod_store())


def _get(store, key: str, deadline_s: float) -> bytes:
    """``key``'s value, waiting at most ``deadline_s`` for it to appear."""
    store.wait([key], timedelta(seconds=max(deadline_s, 0.001)))
    return store.get(key)


def negotiate_next_epoch(current: MembershipEpoch, my_host: int,
                         dead_ranks: Sequence[int],
                         deadline_s: float = 20.0,
                         store=None,
                         ranks_per_host: int = 1) -> MembershipEpoch:
    """Agree epoch k+1's membership among epoch k's survivors (the protocol
    in the module docstring).  ``dead_ranks`` are epoch-k global ranks from
    the ``RankDeathError``, ``ranks_per_host`` the pod's ``L``; returns the
    canonical next epoch.  Raises ``ConnectionError`` when the control
    plane is lost (the anchor dead or the store gone)."""
    if store is None:
        store = _store()
    nxt = int(current.epoch) + 1
    prefix = f"elastic/e{nxt}"
    per = max(int(ranks_per_host), 1)
    dead_hosts = sorted({int(current.members[int(r) // per])
                         for r in dead_ranks
                         if 0 <= int(r) < len(current.members) * per})
    proposed = [h for h in current.members if h not in dead_hosts]

    store.set(f"{prefix}/ack/h{int(my_host)}",
              pickle.dumps({"host": int(my_host), "dead_hosts": dead_hosts}))

    anchor = min(proposed)
    # the anchor, rank 0 of the proposed membership, alone writes the
    # canonical record
    rank = proposed.index(int(my_host)) if int(my_host) in proposed else -1
    if rank == 0:
        confirmed: List[int] = []
        union_dead = set(dead_hosts)
        for h in proposed:
            try:
                ack = pickle.loads(_get(store, f"{prefix}/ack/h{h}",
                                        deadline_s))
                confirmed.append(h)
                union_dead.update(int(x) for x in ack.get("dead_hosts", ()))
            except Exception:
                union_dead.add(int(h))
        members = [h for h in confirmed if h not in union_dead]
        record = MembershipEpoch(
            epoch=nxt, members=members,
            dead_hosts=sorted(union_dead),
            coordinator=current.coordinator)
        store.set(f"{prefix}/record", pickle.dumps(record.to_dict()))
        # hold the store open until every surviving peer has read the
        # record: this process exiting takes the store with it
        for h in members:
            if h == int(my_host):
                continue
            try:
                _get(store, f"{prefix}/got/h{h}", deadline_s)
            except Exception:
                pass  # a peer that died after its ack: epoch k+1's own
                # heartbeat names it within one iteration
        return record
    try:
        raw = _get(store, f"{prefix}/record", deadline_s)
    except Exception as e:
        raise ConnectionError(
            f"membership negotiation for epoch {nxt} lost the control "
            f"plane (anchor host {anchor} dead or the store gone): "
            f"{e}") from None
    return MembershipEpoch.from_dict(pickle.loads(raw))


def confirm_record(record: MembershipEpoch, my_host: int,
                   store=None) -> None:
    """Post this host's ``got`` for the canonical record, called by the
    worker after its verdict file is on disk.  It releases the anchor,
    whose exit takes the store down, so whatever must survive the
    transition has to be written before this call."""
    if store is None:
        store = _store()
    store.set(f"elastic/e{int(record.epoch)}/got/h{int(my_host)}",
              pickle.dumps(True))
