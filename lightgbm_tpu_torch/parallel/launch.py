"""Starting ranks on one host: a pool of spawned processes, one per rank.

``torchrun --nproc-per-node N`` is the user's launcher for a sharded run
(every rank runs the same script; ``engine.train`` initializes the process
group from the environment ``torchrun`` sets).  ``RankPool`` is the
in-process one the tests and ``chip_smoke.py`` use: N processes started
with ``spawn`` (never ``fork``: a parent with JAX or CUDA loaded cannot be
forked safely), each joined to a ``torch.distributed`` group over
a ``TCPStore`` on ``localhost:<free port>`` (rank 0 hosts it) with a
timeout, each running the tasks the parent sends it in turn.  A task is a
module-level function and its arguments; ``run`` returns every rank's
return value.

No rank failure is swallowed: a rank that raises sends its traceback and
exits non-zero, and a rank that dies is seen by its exit code; either way
``run`` kills every rank and raises ``RankFailure`` naming the rank, and
the pool is closed.  The group's timeout bounds how long the surviving
ranks wait in a collective for a dead peer.  Without a ``backend`` the
ranks choose one from their cards (``sharding.default_backend``: NCCL when
each has a card of its own).
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional


class RankFailure(RuntimeError):
    """A rank of a ``RankPool`` raised or died."""


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def init_group(rank: int, world: int, port: int, backend: Optional[str],
               timeout_s: float, device=None) -> str:
    """Join rank ``rank`` of a ``world``-rank group at localhost:``port``
    (rank 0 hosts the store); ``backend`` None lets the world choose from
    the ranks' cards (``sharding.init_group``, ``device`` this rank's).
    Returns the backend."""
    import torch.distributed as dist

    from .sharding import init_group as init_on_store
    timeout = timedelta(seconds=timeout_s)
    store = dist.TCPStore("localhost", port, world, rank == 0,
                          timeout=timeout, wait_for_workers=False)
    if backend is None:
        return init_on_store(store, rank, world, device or "cpu", timeout)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout)
    return backend


def _rank_device(rank: int):
    """The card a pool rank trains on (``config.resolve_device``'s rule for
    local rank ``rank``), or the CPU without one."""
    import torch
    if not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _worker(rank: int, world: int, port: int, backend: Optional[str],
            timeout_s: float, threads: int, tasks, results) -> None:
    import torch
    import torch.distributed as dist
    if threads > 0:
        torch.set_num_threads(threads)
    # every rank of the pool is local: ``config.resolve_device`` picks card
    # LOCAL_RANK % cards, as under ``torchrun``
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        chosen = init_group(rank, world, port, backend, timeout_s,
                            _rank_device(rank))
        results.put((rank, "ready", chosen))
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            results.put((rank, "ok", fn(*args)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        # flush the queue's feeder thread before leaving without cleanup
        results.close()
        results.join_thread()
        os._exit(1)
    dist.destroy_process_group()


class RankPool:
    """``world`` spawned ranks in one process group (see the module
    docstring).  ``timeout_s`` is the group's collective timeout."""

    def __init__(self, world: int, backend: Optional[str] = None,
                 timeout_s: float = 60.0, threads: int = 1,
                 start_timeout_s: float = 120.0):
        import torch.multiprocessing as mp

        self.world = int(world)
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        port = free_port()
        self._procs = [ctx.Process(
            target=_worker, args=(r, self.world, port, backend,
                                  float(timeout_s), int(threads),
                                  self._tasks[r], self._results),
            daemon=True) for r in range(self.world)]
        for p in self._procs:
            p.start()
        self.closed = False
        #: the group's backend: ``backend``, or the one the ranks' cards
        #: chose (``sharding.default_backend``)
        self.backend = self._collect(start_timeout_s)[0]

    def _fail(self, msg: str) -> None:
        self.close(kill=True)
        raise RankFailure(msg)

    def _collect(self, timeout_s: float) -> List[Any]:
        got = {}
        deadline = time.monotonic() + timeout_s
        while len(got) < self.world:
            try:
                rank, kind, val = self._results.get(timeout=0.1)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if p.exitcode is not None]
                if dead:
                    # a failing rank's traceback may still be queued
                    try:
                        rank, kind, val = self._results.get(timeout=1.0)
                    except queue.Empty:
                        rank = kind = None
                    if kind is None:
                        self._fail(f"rank {dead[0]} exited with code "
                                   f"{self._procs[dead[0]].exitcode}")
                elif time.monotonic() > deadline:
                    late = sorted(set(range(self.world)) - set(got))
                    self._fail(f"ranks {late} did not answer within "
                               f"{timeout_s:.0f} s")
                else:
                    continue
            if kind == "error":
                self._fail(f"rank {rank} raised:\n{val}")
            got[rank] = val
        return [got[r] for r in range(self.world)]

    def run(self, fn: Callable, *args, timeout_s: float = 600.0
            ) -> List[Any]:
        """Run ``fn(*args)`` on every rank; the ranks' return values in rank
        order.  Raises ``RankFailure`` (and closes the pool) if a rank
        raises, dies or does not answer within ``timeout_s``."""
        if self.closed:
            raise RankFailure("the rank pool is closed")
        for q in self._tasks:
            q.put((fn, args))
        return self._collect(timeout_s)

    def close(self, kill: bool = False) -> None:
        """Stop every rank (at once with ``kill``)."""
        if self.closed:
            return
        self.closed = True
        if not kill:
            for q in self._tasks:
                q.put(None)
            for p in self._procs:
                p.join(timeout=10)
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close(kill=exc[0] is not None)

