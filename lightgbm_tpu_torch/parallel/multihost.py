"""Multi-host pod training over ``torch.distributed``.

Port of ``lightgbm_tpu/parallel/multihost.py``.  The JAX package joins a
``jax.distributed`` cluster, one process per host driving every local
device, and rides its coordination service's key-value store for the
heartbeat and the loader's collectives.  The port runs one process per card
over one ``torch.distributed`` process group, and the key-value store is a
``torch.distributed.TCPStore``:

  * the rank layout: a host runs ``L = LOCAL_WORLD_SIZE`` ranks (default 1;
    one per card, as ``torchrun --nproc-per-node L`` starts them); global
    rank = ``process_id * L + LOCAL_RANK``, world = ``num_hosts * L``, so
    rank order is host-major;
  * global rank 0 hosts the ``TCPStore`` at ``coordinator_address``; the
    process group is initialized on a ``PrefixStore`` of it, with the
    backend ``sharding.default_backend`` picks from every rank's card
    (NCCL only when no two ranks share a card);
  * :class:`DistributedNet` (the ``io/distributed.py`` seam: ``allgather``
    / ``sync_min`` / ``sync_max``, plus ``barrier`` and the per-iteration
    ``heartbeat``) runs on another ``PrefixStore`` of the same store; a
    group that ``torchrun`` started (``sharding.init_from_env``) reaches
    the same code, its net riding that group's store.

The store has no prefix listing, so the dead-rank scan checks each rank's
key (``store.check``), the lagged key collection deletes each key of the
round before, and the barrier is ``store.add`` plus ``wait``.

Config / environment contract (config keys win; the environment fills the
gaps, so one launch recipe works for every rank)::

    coordinator_address = host:port     # or LGBT_COORDINATOR
    num_hosts           = N             # or LGBT_NUM_HOSTS
    process_id          = h             # or LGBT_PROCESS_ID
    LOCAL_WORLD_SIZE    = L             # ranks on this host (default 1)
    LOCAL_RANK          = l             # this rank's index on its host

What bounds a death.  A rank that dies between heartbeats is named on every
survivor at the next heartbeat, within ``net_collective_deadline_s`` (else
``time_out`` seconds).  A rank that dies inside a histogram collective of
the sharded learners leaves its peers in that gloo or NCCL collective until
the process group's timeout, ``time_out`` minutes (``sharding.py``): the
same hole the JAX package has with XLA collectives.
"""

from __future__ import annotations

import os
import pickle
import time
from datetime import timedelta
from typing import List, Optional, Tuple

import numpy as np

ENV_COORDINATOR = "LGBT_COORDINATOR"
ENV_NUM_HOSTS = "LGBT_NUM_HOSTS"
ENV_PROCESS_ID = "LGBT_PROCESS_ID"

_initialized = False
_store = None
_layout: Optional[Tuple[int, int, int]] = None
_ns_counts: dict = {}


class RankDeathError(ConnectionError):
    """A collective's deadline scan named dead rank(s).

    A ``ConnectionError``, so every caller that handles a lost peer keeps
    working; the elastic controller (``elastic/``) catches this type to
    tell "a peer died, shrink and continue" from "the store itself is
    unreachable" (a plain ``ConnectionError``: the control plane is gone).
    ``dead_ranks`` are global ranks of the current membership epoch
    (``process_id * L + LOCAL_RANK``); ``epoch`` is that epoch's generation
    (0 outside elastic runs)."""

    def __init__(self, message: str, dead_ranks=(), epoch: int = 0):
        super().__init__(message)
        self.dead_ranks = list(dead_ranks)
        self.epoch = int(epoch)


def resolve_multihost(cfg=None) -> Optional[Tuple[str, int, int]]:
    """(coordinator_address, num_hosts, process_id) this run asks for, or
    None for a single-host run.  Config keys win over the LGBT_*
    environment; a partial spec (hosts without a coordinator, a process id
    out of range) is an error, never a silent single-host fallback."""
    coord = str(getattr(cfg, "coordinator_address", "") or
                os.environ.get(ENV_COORDINATOR, "")).strip()
    nproc = int(getattr(cfg, "num_hosts", 1) or 1)
    if nproc <= 1:
        nproc = int(os.environ.get(ENV_NUM_HOSTS, "1") or 1)
    pid = int(getattr(cfg, "process_id", -1) if cfg is not None else -1)
    if pid < 0:
        pid = int(os.environ.get(ENV_PROCESS_ID, "-1") or -1)
    if nproc <= 1 and not coord:
        return None
    if nproc <= 1 or not coord or pid < 0:
        raise ValueError(
            "multi-host run under-specified: need coordinator_address "
            f"({coord!r}), num_hosts ({nproc}), process_id ({pid}) — set "
            "the config keys or LGBT_COORDINATOR/LGBT_NUM_HOSTS/"
            "LGBT_PROCESS_ID")
    if pid >= nproc:
        raise ValueError(f"process_id {pid} out of range for num_hosts "
                         f"{nproc}")
    return coord, nproc, pid


def _local() -> Tuple[int, int]:
    """(LOCAL_WORLD_SIZE, LOCAL_RANK) of this process (1, 0 by default)."""
    size = int(os.environ.get("LOCAL_WORLD_SIZE", "1") or 1)
    rank = int(os.environ.get("LOCAL_RANK", "0") or 0)
    if not 0 <= rank < size:
        raise ValueError(f"LOCAL_RANK {rank} out of range for "
                         f"LOCAL_WORLD_SIZE {size}")
    return size, rank


def is_initialized() -> bool:
    return _initialized


def initialize_from_config(cfg=None, device=None) -> bool:
    """Join the pod this run describes, once; True when this process is part
    of one.  An LGBT_* spec starts the ``TCPStore`` (global rank 0 hosts
    it) and the process group on it; without one, a ``torchrun`` launch of
    more than one rank (``WORLD_SIZE`` in the environment) joins through
    ``sharding.init_from_env``.  Must run before the dataset is built: the
    elastic loader exchanges its shards over the pod's store."""
    global _initialized, _store, _layout
    import torch.distributed as dist

    from . import sharding
    spec = resolve_multihost(cfg)
    if _initialized:
        return True
    device = device if device is not None else "cpu"
    if spec is None:
        if int(os.environ.get("WORLD_SIZE", "1") or 1) <= 1 \
                or dist.is_initialized():
            return False
        sharding.init_from_env(cfg, device)
        _store = dist.distributed_c10d._get_default_store()
        local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                   dist.get_world_size()))
        _layout = (dist.get_world_size() // max(local, 1),
                   int(os.environ.get("GROUP_RANK",
                                      dist.get_rank() // max(local, 1))),
                   local)
        _initialized = True
        return True
    coord, nhosts, pid = spec
    local, lrank = _local()
    rank, world = pid * local + lrank, nhosts * local
    host, _, port = coord.rpartition(":")
    timeout = sharding.group_timeout(cfg)
    store = dist.TCPStore(host or "127.0.0.1", int(port), world, rank == 0,
                          timeout=timeout, wait_for_workers=False)
    sharding.init_group(store, rank, world, device, timeout)
    _store = store
    _layout = (nhosts, pid, local)
    _initialized = True
    return True


def _pod_store():
    if _store is None:
        raise RuntimeError(
            "the pod is not initialized — call "
            "multihost.initialize_from_config(cfg) (or set "
            "coordinator_address/num_hosts/process_id) first")
    return _store


def host_layout() -> Tuple[int, int, int]:
    """(num_hosts, process_id, ranks per host): the host layout string
    recorded beside a pod's measurements."""
    if _layout is not None:
        return _layout
    return 1, 0, max(_local()[0], 1)


def host_rank() -> int:
    """This rank's index on its host (0 outside a pod)."""
    return _local()[1] if _initialized else 0


def mesh_for_config(cfg):
    """The ``sharding.mesh_for_config`` mesh, checked for host alignment:
    each host's ranks must hold contiguous blocks of the row (data) axis, so
    every host's row shard is host-local.  Rank order is host-major, so a
    mesh whose data axis is the leading one is aligned."""
    from .sharding import mesh_for_config as _local_mesh_for_config
    from .sharding import row_axis

    mesh = _local_mesh_for_config(cfg)
    nhosts, _, local = host_layout()
    if nhosts <= 1:
        return mesh
    ax = mesh.axis_names.index(row_axis(mesh))
    grid = np.arange(mesh.size).reshape(mesh.shape)
    by_row = np.moveaxis(grid, ax, 0).reshape(mesh.shape[ax], -1)
    first_host = [int(row.min()) // local for row in by_row]
    if any(first_host[i] > first_host[i + 1]
           for i in range(len(first_host) - 1)):
        import warnings
        warnings.warn(
            f"mesh {dict(zip(mesh.axis_names, mesh.shape))} scatters row "
            f"shards across hosts non-contiguously (row->host "
            f"{first_host}); cross-host transfers will dominate — prefer a "
            f"parallel_mesh whose data axis is host-major, e.g. "
            f"\"{nhosts}x{local}\"")
    return mesh


class DistributedNet:
    """The ``io/distributed.py`` net seam (allgather / sync_min / sync_max)
    over the pod's ``TCPStore``.

    Payloads are pickled to seq-numbered per-rank keys and read back under
    a deadline; a rank that never posts (crashed, partitioned) surfaces as a
    ``RankDeathError`` naming it on every survivor within the deadline.  The
    ``net.crash`` fault point fires at the collective's entry, as in the
    JAX package, so the rank-crash drills drive this path.

    This is the loader and heartbeat side channel only: the histogram and
    split traffic of the sharded learners rides the process group's
    collectives, never the store.
    """

    def __init__(self, cfg=None, rank: Optional[int] = None,
                 num_machines: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 namespace: str = "lgbt", store=None):
        import torch.distributed as dist
        from torch.distributed import PrefixStore

        base = store if store is not None else _pod_store()
        if rank is None or num_machines is None:
            rank = dist.get_rank() if rank is None else rank
            num_machines = dist.get_world_size() if num_machines is None \
                else num_machines
        self.rank = int(rank)
        self.num_machines = int(num_machines)
        if deadline_s is None:
            deadline_s = float(getattr(cfg, "net_collective_deadline_s", 0.0)
                               or 0.0)
            if deadline_s <= 0.0:
                deadline_s = float(getattr(cfg, "time_out", 120) or 120)
        self.deadline_s = float(deadline_s)
        # the membership generation (elastic runs bump it per shrink),
        # stamped into every dead-rank verdict
        self.epoch = int(getattr(cfg, "elastic_epoch", 0) or 0)
        # a key prefix per net instance: every rank builds its nets in the
        # same order, so the counter agrees pod-wide, and a later net never
        # meets an earlier one's last round of keys
        n = _ns_counts.get(namespace, 0)
        _ns_counts[namespace] = n + 1
        self._ns = f"{namespace}.{n}" if n else namespace
        self._seq = 0
        self._store = PrefixStore("lgbt-net", base)

    def _wait(self, keys: List[str], seconds: float) -> None:
        self._store.wait(keys, timedelta(seconds=max(seconds, 0.001)))

    # -- the three seam calls (``io/distributed.py:LoopbackCluster``) -------

    def allgather(self, obj) -> List:
        from ..reliability import faults

        self._seq += 1
        seq = self._seq
        prefix = f"{self._ns}/ag{seq}/"
        if faults.fire("net.crash", rank=self.rank) is not None:
            # a hard exit at the collective's entry: the rank-death drill;
            # the survivors' deadline scan below must name this rank
            os._exit(17)
        self._store.set(prefix + f"r{self.rank}", pickle.dumps(obj))
        until = time.monotonic() + self.deadline_s
        out: List = [None] * self.num_machines
        for r in range(self.num_machines):
            key = prefix + f"r{r}"
            try:
                self._wait([key], until - time.monotonic())
                out[r] = pickle.loads(self._store.get(key))
            except Exception as e:
                from ..reliability.metrics import rel_inc
                missing, report = self._missing_report(prefix)
                rel_inc("net.multihost_collective_timeouts")
                rel_inc("net.multihost_peers_dead", max(len(missing), 1))
                msg = (f"multihost collective #{seq} timed out after "
                       f"{self.deadline_s:.1f}s on rank {self.rank} "
                       f"(membership epoch {self.epoch}): {report} "
                       f"(store error: {e})")
                if missing:
                    # a named dead peer is the recoverable verdict; none
                    # named means the store itself is suspect
                    raise RankDeathError(msg, dead_ranks=missing,
                                         epoch=self.epoch) from None
                raise ConnectionError(msg) from None
        # lagged collection: every rank posting round N proves it returned
        # from round N-1, so round N-1's keys are dead only now
        if self.rank == 0 and seq > 1:
            old = f"{self._ns}/ag{seq - 1}/"
            for r in range(self.num_machines):
                try:
                    self._store.delete_key(old + f"r{r}")
                except Exception:
                    pass
        return out

    def sync_min(self, v: int) -> int:
        return min(self.allgather(int(v)))

    def sync_max(self, v: int) -> int:
        return max(self.allgather(int(v)))

    # -- liveness ------------------------------------------------------------

    def heartbeat(self, tag: int = 0, payload=None) -> List:
        """One small allgather: every live rank agrees everyone is still
        here, and a dead rank is named within the deadline.  The boosting
        loop runs it before each iteration (``engine.py``), so a host crash
        surfaces as a named ``RankDeathError`` instead of a hang in the
        next collective.  ``payload`` rides the same allgather (the
        engine's last step time: straggler detection at no extra
        collective); the ``("hb", rank, tag, payload)`` tuples come back."""
        return self.allgather(("hb", int(self.rank), int(tag), payload))

    def _missing_report(self, prefix: str):
        """(missing ranks, message): the ranks whose key for ``prefix`` is
        not in the store, one ``check`` each (the store lists no prefix)."""
        try:
            missing = [r for r in range(self.num_machines)
                       if not self._store.check([prefix + f"r{r}"])]
            if missing:
                return missing, (
                    "rank(s) " + ", ".join(map(str, missing)) +
                    " never posted — process(es) dead or partitioned")
            return [], "all ranks posted late (store stall?)"
        except Exception as e:
            return [], f"missing-rank scan failed: {e}"

    def barrier(self, name: str) -> None:
        """Every rank arrives at ``name`` before any leaves, within the
        deadline: a count by ``store.add``, the last arrival posting the
        release key."""
        key = f"{self._ns}/barrier/{name}"
        if self._store.add(key, 1) == self.num_machines:
            self._store.set(key + "/go", b"1")
        try:
            self._wait([key + "/go"], self.deadline_s)
        except Exception as e:
            arrived = self._store.add(key, 0)
            raise ConnectionError(
                f"barrier {name!r} timed out after {self.deadline_s:.1f}s "
                f"on rank {self.rank}: {arrived} of {self.num_machines} "
                f"rank(s) arrived ({e})") from None

    def close(self) -> None:
        """Leader-last leave: every rank posts that it is done with this
        net, and rank 0, whose process hosts the store, waits (within the
        deadline) until all have, so it never exits while a peer still
        reads a key of the last round."""
        key = f"{self._ns}/closed/"
        self._store.set(key + f"r{self.rank}", b"1")
        if self.rank == 0:
            try:
                self._wait([key + f"r{r}" for r in range(self.num_machines)],
                           self.deadline_s)
            except Exception:
                pass    # a peer gone by now has nothing left to read


def net_for_run(cfg) -> Optional[DistributedNet]:
    """The loader and heartbeat net of this run: a ``DistributedNet`` when
    the pod is initialized, else None.  A failed pod is an error, never a
    ``SocketNet`` in its place."""
    if not _initialized:
        return None
    return DistributedNet(cfg)
