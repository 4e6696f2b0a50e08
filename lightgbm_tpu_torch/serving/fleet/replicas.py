"""Replica fleet: one registry + batcher stack per replica, least-loaded
dispatch.

Port of ``lightgbm_tpu/serving/fleet/replicas.py``.  A ``Replica`` is the
unit the fleet scales and fails by: its own ``ModelRegistry`` pinned to one
``torch.device`` (on a card: its own CUDA stream, bucket graphs and graph
memory pool per model), its own ``MicroBatcher`` worker threads and its own
health state.  ``ReplicaSet`` owns N of them, round-robin over the given
devices (default: every card, ``torch.cuda.device_count()``; with one H100
``replicas=2`` puts two replicas on ``cuda:0``), and routes each admitted
request to the healthy replica with the fewest requests in flight.

Health and ejection: the injected ``serving.replica_fault`` (matched by
``rank`` = replica index, `reliability/faults.py`) degrades that batch to
the host traversal (no rider fails) and ejects the replica for
``recovery_s`` seconds.  A real device error of a CUDA replica also ejects
it, and fails its batch: ``ServingModel.host_fallback`` re-raises it, the
model records it in ``device_error`` and the gateway's ``health`` reports
it.  While ejected, the dispatcher skips the replica and traffic moves to
the survivors; after the cooldown the next dispatch re-admits it (the
recovery probe); a still-faulty replica re-ejects.  A CUDA error is sticky
to the process's context on that card, so re-admission cannot clear one:
every replica on the card keeps failing.  With every replica ejected the
set dispatches least-loaded anyway: serving degraded beats refusing.

Fleet lifecycle: ``prepare_all`` builds, warms (captures) and verifies a
candidate on every replica off to the side while the live models serve;
``commit_rolling`` swaps one replica at a time (each registry's commit is
atomic and each batcher resolves its model at batch time, so a request in
flight during the roll is served by whichever version its replica holds,
never dropped); ``rollback_all`` re-swaps the retained incumbents.  The
shadow gate in front of the roll lives in
`gateway.FleetServer.promote_rolling`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ...observability.metrics_export import LatencyHistogram
from ...reliability import faults
from ...reliability.metrics import rel_inc
from ..batcher import MicroBatcher, ServingStats, bucket_ladder
from ..registry import ModelRegistry, ServingModel


class _AggRequest:
    """Aggregate handle for an oversize async request chunked across
    several batcher submissions — quacks like ``batcher._Request`` for
    the dispatch callback (``result``/``error``/``trace_id``)."""

    __slots__ = ("result", "error", "trace_id", "_parts", "_left", "_lock")

    def __init__(self, n_parts: int, trace_id: Optional[str]):
        self.result = None
        self.error: Optional[BaseException] = None
        self.trace_id = trace_id
        self._parts: List[Optional[np.ndarray]] = [None] * n_parts
        self._left = n_parts
        self._lock = threading.Lock()

    def part_done(self, i: int, req) -> bool:
        """Record chunk ``i``; True once every chunk has reported."""
        with self._lock:
            if req.error is not None and self.error is None:
                self.error = req.error
            self._parts[i] = req.result
            self._left -= 1
            if self._left:
                return False
            if self.error is None:
                self.result = np.concatenate(self._parts, axis=0)
            return True


class Replica:
    """One servable device stack with health state and load accounting."""

    def __init__(self, index: int, device, stats: ServingStats,
                 warm_buckets: Sequence[int], warmup: bool = True,
                 max_batch_rows: int = 256, deadline_ms: float = 2.0,
                 min_bucket: int = 32, recovery_s: float = 1.0):
        self.index = int(index)
        self.device = device
        self.stats = stats
        self.max_batch_rows = int(max_batch_rows)
        self.deadline_ms = float(deadline_ms)
        self.min_bucket = int(min_bucket)
        self.recovery_s = float(recovery_s)
        self.registry = ModelRegistry(stats=stats,
                                      warm_buckets=list(warm_buckets),
                                      warmup=warmup, device=device)
        # per-replica dispatch→response latency (the fleet view; the
        # shared ServingStats request_hist stays the aggregate).  Lock-leaf
        self.hist = LatencyHistogram()
        self._batchers: Dict[str, MicroBatcher] = {}
        self._batcher_lock = threading.Lock()
        self._lock = threading.Lock()
        self._inflight = 0
        self._dispatched = 0
        self._completed = 0
        self._errors = 0
        self._device_failures = 0
        self._ejections = 0
        self._healthy_flag = True
        self._eject_until = 0.0

    # -- health --------------------------------------------------------------

    def healthy(self) -> bool:
        """Current dispatchability; an elapsed cooldown re-admits the
        replica right here (the recovery probe is the next dispatch)."""
        with self._lock:
            if not self._healthy_flag and \
                    time.monotonic() >= self._eject_until:
                self._healthy_flag = True
                rel_inc("serve.replica_recoveries")
            return self._healthy_flag

    def _record_device_failure(self) -> None:
        with self._lock:
            self._device_failures += 1
            if self._healthy_flag:
                self._healthy_flag = False
                self._ejections += 1
                self._eject_until = time.monotonic() + self.recovery_s
                ejected = True
            else:
                self._eject_until = time.monotonic() + self.recovery_s
                ejected = False
        if ejected:
            rel_inc("serve.replica_ejections")

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    # -- batching ------------------------------------------------------------

    def _batcher(self, name: str) -> MicroBatcher:
        with self._batcher_lock:
            b = self._batchers.get(name)
            if b is None:
                # resolve the model at BATCH time so a rolling commit is
                # picked up atomically at the next batch boundary
                def predict_fn(Xpad, m, _name=name):
                    f = faults.fire("serving.replica_fault", rank=self.index)
                    if f is not None:
                        self._record_device_failure()
                        raise faults.InjectedFault(
                            f"injected serving.replica_fault on replica "
                            f"{self.index}")
                    try:
                        return self.registry.get(_name).predict_padded(
                            Xpad, m)
                    except Exception:
                        self._record_device_failure()
                        raise

                # the injected faults re-score on the host; a real device
                # error of a CUDA model re-raises and fails the batch
                def fallback_fn(Xpad, m, error, _name=name):
                    return self.registry.get(_name).host_fallback(
                        Xpad, m, error)

                b = MicroBatcher(
                    predict_fn,
                    num_features=self.registry.get(name).num_features,
                    max_batch_rows=self.max_batch_rows,
                    deadline_ms=self.deadline_ms,
                    min_bucket=self.min_bucket, stats=self.stats,
                    fallback_fn=fallback_fn).start()
                self._batchers[name] = b
            return b

    def submit_async(self, X: np.ndarray, name: str,
                     callback: Callable[[Any], None],
                     trace_id: Optional[str] = None) -> None:
        """Dispatch one request to this replica's batcher without
        blocking; ``callback(handle)`` runs on the batch worker once
        ``handle.result``/``handle.error`` is set.  Oversize requests are
        chunked to the batch budget and re-aggregated here (the async
        analogue of ``MicroBatcher.submit``'s chunk chain)."""
        X = np.ascontiguousarray(np.atleast_2d(np.asarray(X, np.float64)))
        b = self._batcher(name)
        if X.shape[1] != b.num_features:
            # refused before it counts as in flight: a request that never
            # reaches the batcher must not leave this replica looking busy
            raise ValueError(f"request has {X.shape[1]} features, model "
                             f"expects {b.num_features}")
        with self._lock:
            self._inflight += 1
            self._dispatched += 1
        t0 = time.perf_counter()

        def _finish(handle) -> None:
            with self._lock:
                self._inflight -= 1
                self._completed += 1
                if handle.error is not None:
                    self._errors += 1
            self.hist.record((time.perf_counter() - t0) * 1e3)
            callback(handle)

        if X.shape[0] <= b.max_rows:
            b.submit_async(X, _finish, trace_id=trace_id)
            return
        chunks = [X[i:i + b.max_rows] for i in range(0, X.shape[0],
                                                     b.max_rows)]
        agg = _AggRequest(len(chunks), trace_id)

        def _chunk_cb(i):
            def cb(req):
                if agg.part_done(i, req):
                    _finish(agg)
            return cb

        for i, c in enumerate(chunks):
            b.submit_async(c, _chunk_cb(i), trace_id=trace_id)

    def stop(self) -> None:
        with self._batcher_lock:
            batchers = list(self._batchers.values())
        for b in batchers:
            b.stop()

    # -- observability -------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        # histogram + registry locks are taken BEFORE self._lock so no
        # lock nests inside another
        latency = self.hist.snapshot()
        models = self.registry.versions()
        healthy = self.healthy()
        with self._lock:
            return {"index": self.index,
                    "device": str(self.device),
                    "healthy": healthy,
                    "in_flight": self._inflight,
                    "dispatched": self._dispatched,
                    "completed": self._completed,
                    "errors": self._errors,
                    "device_failures": self._device_failures,
                    "ejections": self._ejections,
                    "models": models,
                    "latency_ms": latency}


class ReplicaSet:
    """N replicas + least-loaded dispatch + fleet-wide lifecycle."""

    def __init__(self, stats: Optional[ServingStats] = None,
                 replicas: int = 0, devices: Optional[Sequence] = None,
                 max_batch_rows: int = 256, deadline_ms: float = 2.0,
                 min_bucket: int = 32, warmup: bool = True,
                 recovery_s: float = 1.0):
        self.stats = stats or ServingStats()
        if devices is not None:
            devs = [torch.device(d) for d in devices]
        else:
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
            if not devs:
                raise RuntimeError(
                    "the serving fleet runs its replicas on CUDA cards, "
                    "but torch.cuda.device_count() is 0; pass devices="
                    "[torch.device('cpu')] * N to serve on the CPU")
        if not devs:
            raise ValueError("devices is empty")
        n = int(replicas) if int(replicas) > 0 else len(devs)
        self.buckets = bucket_ladder(min_bucket, max_batch_rows)
        # replicas round-robin over devices when n > device count (one
        # card holds several replicas, each with its own stream and graphs)
        self.replicas: List[Replica] = [
            Replica(i, devs[i % len(devs)], self.stats, self.buckets,
                    warmup=warmup, max_batch_rows=max_batch_rows,
                    deadline_ms=deadline_ms, min_bucket=min_bucket,
                    recovery_s=recovery_s)
            for i in range(n)]

    def __len__(self) -> int:
        return len(self.replicas)

    # -- dispatch ------------------------------------------------------------

    def pick(self) -> Replica:
        """Least-loaded healthy replica (lowest in-flight count, index
        breaking ties).  With the whole fleet ejected, dispatch
        least-loaded over everyone — degraded service beats refusal,
        and the batcher's host fallback still answers."""
        healthy = [r for r in self.replicas if r.healthy()]
        pool = healthy or self.replicas
        if not healthy:
            rel_inc("serve.dispatch_no_healthy_replica")
        return min(pool, key=lambda r: (r.inflight, r.index))

    def dispatch(self, X: np.ndarray, name: str,
                 callback: Callable[[Any], None],
                 trace_id: Optional[str] = None) -> Replica:
        r = self.pick()
        r.submit_async(X, name, callback, trace_id=trace_id)
        return r

    # -- fleet lifecycle -----------------------------------------------------

    def load(self, name: str = "default", booster=None,
             model_str: Optional[str] = None,
             model_file: Optional[str] = None) -> Dict[int, int]:
        """Initial (non-rolling) load on every replica."""
        return {r.index: r.registry.load(name, booster=booster,
                                         model_str=model_str,
                                         model_file=model_file)
                for r in self.replicas}

    def prepare_all(self, name: str = "default", booster=None,
                    model_str: Optional[str] = None,
                    model_file: Optional[str] = None) -> List[ServingModel]:
        """Build+warm+verify a candidate on EVERY replica, off to the
        side — serving never sees any of them until ``commit_rolling``.
        A failure on any replica propagates with nothing swapped."""
        return [r.registry.prepare(name, booster=booster,
                                   model_str=model_str,
                                   model_file=model_file)
                for r in self.replicas]

    def commit_rolling(self, prepared: Sequence[ServingModel],
                       settle_s: float = 0.0) -> Dict[int, int]:
        """Swap the prepared candidates in one replica at a time.  Each
        registry commit is atomic and batchers resolve their model at
        batch time, so during the roll a request is served by whichever
        version its replica currently holds — old or new, never neither:
        zero requests are dropped.
        ``settle_s`` optionally pauses between replicas so a canary
        failure surfaces before the roll finishes."""
        versions: Dict[int, int] = {}
        for r, model in zip(self.replicas, prepared):
            versions[r.index] = r.registry.commit(model)
            rel_inc("serve.fleet_rolling_commits")
            if settle_s > 0 and r is not self.replicas[-1]:
                time.sleep(settle_s)
        return versions

    def commit_rolling_gated(self, prepared: Sequence[ServingModel],
                             gate: Callable[[int, ServingModel],
                                            Any],
                             settle_s: float = 0.0,
                             name: str = "default") -> Dict[str, Any]:
        """``commit_rolling`` with an admission gate in front of EVERY
        replica's commit (not just replica 0's): ``gate(index, model)``
        returns ``(passed, report)`` and runs immediately before that
        replica would swap.  The first failing gate aborts the roll and
        reverse-rolls the replicas already committed (each registry's
        retained incumbent swaps back, newest-committed first), leaving
        the fleet homogeneous on the old version.  Requests in flight
        during an abort ride whichever version their replica holds at
        batch-resolve time — old or new, never neither."""
        versions: Dict[int, int] = {}
        gates: List[Dict[str, Any]] = []
        committed: List[Replica] = []
        for r, model in zip(self.replicas, prepared):
            passed, report = gate(r.index, model)
            gates.append({"replica": r.index, "passed": bool(passed),
                          "report": report})
            if not passed:
                restored: Dict[int, int] = {}
                for rc in reversed(committed):
                    restored[rc.index] = rc.registry.rollback(name)
                rel_inc("serve.fleet_roll_aborts")
                return {"committed": False, "aborted_replica": r.index,
                        "versions": versions, "gates": gates,
                        "restored": restored}
            versions[r.index] = r.registry.commit(model)
            committed.append(r)
            rel_inc("serve.fleet_rolling_commits")
            if settle_s > 0 and r is not self.replicas[-1]:
                time.sleep(settle_s)
        return {"committed": True, "aborted_replica": None,
                "versions": versions, "gates": gates, "restored": {}}

    def rollback_all(self, name: str = "default") -> Dict[int, int]:
        """Re-swap every replica's retained incumbent (reverse rolling
        order, matching how far a partial roll got)."""
        restored: Dict[int, int] = {}
        for r in reversed(self.replicas):
            restored[r.index] = r.registry.rollback(name)
        return restored

    # -- aggregate views -----------------------------------------------------

    def versions(self) -> Dict[str, int]:
        """Fleet-wide model versions (replica 0's view — the roll makes
        them momentarily heterogeneous; ``section()`` has the per-replica
        truth)."""
        return self.replicas[0].registry.versions()

    def versions_detail(self) -> Dict[str, Dict[str, Optional[int]]]:
        return self.replicas[0].registry.versions_detail()

    def jit_entries(self) -> Optional[int]:
        return self.replicas[0].registry.jit_entries()

    def device_errors(self) -> Dict[int, Dict[str, str]]:
        """Per replica, the live models whose batches met a real device
        error (``ModelRegistry.device_errors``); replicas without one are
        left out."""
        out = {}
        for r in self.replicas:
            errs = r.registry.device_errors()
            if errs:
                out[r.index] = errs
        return out

    def get(self, name: str = "default") -> ServingModel:
        return self.replicas[0].registry.get(name)

    def section(self) -> List[Dict[str, Any]]:
        """``serving.replicas[]`` for the stats report / metrics op."""
        return [r.snapshot() for r in self.replicas]

    def stop(self) -> None:
        for r in self.replicas:
            r.stop()
