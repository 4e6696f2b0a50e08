"""Deadline-based micro-batching queue + serving statistics.

Port of ``lightgbm_tpu/serving/batcher.py``.  Concurrent prediction
requests coalesce into one device dispatch: the worker collects requests
until either the batch deadline elapses or the row budget fills,
concatenates them, pads the row axis up to the nearest power-of-two bucket
and runs the model's bin + traverse pipeline.  On a CUDA device every
bucket of the ladder was captured at warmup as one CUDA graph
(`registry.py:ServingModel.warm`), so a request inside the ladder replays
a graph and never captures one: the counterpart of the JAX package's "the
request path never compiles".

When the device path raises, the batch goes to ``fallback_fn``, which
re-scores it on the host, counted (``fallback_batches``, ``fallback_rows``
and the ``serve.host_fallback_*`` reliability counters) as in the JAX
package, or re-raises the error to fail the batch's requests.  The server's
``fallback_fn`` (``ServingModel.host_fallback``) re-scores on the CPU and,
on a CUDA model, only the injected ``serve.predict.fail``.

Stage accounting (queue -> pad -> bin -> traverse -> unpad) flows through a
``ServingStats`` wrapping the ``Telemetry`` accumulator and surfaces in the
JSON report's ``serving`` section (``observability/schema.json``).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..observability import LatencyHistogram, Telemetry
from ..reliability.metrics import rel_inc

_NULL_CTX = contextlib.nullcontext()


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def bucket_ladder(min_bucket: int, max_rows: int) -> List[int]:
    """The power-of-two row buckets between ``min_bucket`` and
    ``max_rows`` inclusive — the shapes warmed at startup."""
    lo, hi = next_pow2(min_bucket), next_pow2(max_rows)
    out = []
    b = lo
    while b <= hi:
        out.append(b)
        b *= 2
    return out


class TenantStats:
    """Per-model-name ("tenant") serving metrics: an admission→response
    ``LatencyHistogram`` plus request/error/shed counters and the SLO
    view (attainment against a latency target, error-budget burn).

    Lock-leaf like the histogram it wraps: its one lock guards the
    counters only and nothing is called while holding it."""

    __slots__ = ("name", "hist", "_lock", "requests", "errors", "shed",
                 "tenant_shed", "within_slo")

    def __init__(self, name: str):
        self.name = name
        self.hist = LatencyHistogram()
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.shed = 0
        self.tenant_shed = 0    # shed by THIS tenant's own cap
        self.within_slo = 0

    def record(self, ms: float, slo_p99_ms: float,
               error: bool = False) -> None:
        self.hist.record(ms)
        with self._lock:
            self.requests += 1
            if error:
                self.errors += 1
            if ms <= slo_p99_ms:
                self.within_slo += 1

    def record_shed(self) -> None:
        with self._lock:
            self.shed += 1

    def record_cap_shed(self) -> None:
        """A shed caused by this tenant's own admission cap (the global
        gate still had headroom): the fleet gateway's
        ``TenantAdmission``."""
        with self._lock:
            self.tenant_shed += 1

    def record_error(self) -> None:
        """An error without a latency sample: the control-plane path
        (failed swap, unknown op), so the tenant's error rate sees every
        failure, not just predict errors."""
        with self._lock:
            self.errors += 1

    def section(self, slo_p99_ms: float, slo_target: float
                ) -> Dict[str, Any]:
        # histogram snapshot first: its lock stays leaf beside ours
        latency = self.hist.snapshot()
        with self._lock:
            requests, errors = self.requests, self.errors
            shed, within = self.shed, self.within_slo
            tenant_shed = self.tenant_shed
        # a request this tenant's own cap refused was offered work that
        # never met the SLO: tenant-local sheds burn the error budget
        offered = requests + tenant_shed
        attainment = within / offered if offered else 1.0
        budget = max(1.0 - float(slo_target), 1e-9)
        return {"model": self.name,
                "requests": requests,
                "errors": errors,
                "shed": shed,
                "tenant_shed": tenant_shed,
                "latency_ms": latency,
                "slo": {"p99_target_ms": float(slo_p99_ms),
                        "target": float(slo_target),
                        "attainment": attainment,
                        "error_budget_burn": (1.0 - attainment) / budget}}


class ServingStats:
    """Thread-safe serving counters + stage phase timers.

    Stage timers reuse ``Telemetry`` phases (named ``serve_<stage>``), so
    they show up both in the standard ``phases`` section and, summarized,
    under ``serving.stage_ms``.  Per-model-name ``TenantStats`` hang off
    the same object (the threaded server and the fleet gateway record into
    them at dispatch completion), surfacing as the ``serving.tenants[]`` section and the
    ``lgbt_serving_tenant_*`` Prometheus series.
    """

    STAGES = ("queue", "pad", "bin", "traverse", "unpad", "fallback")

    def __init__(self, slo_p99_ms: float = 50.0, slo_target: float = 0.99):
        self.tel = Telemetry(True)
        # per-request end-to-end latency (admission → response), backing
        # the serving section's exact p50/p95/p99 and the Prometheus
        # histogram of the `metrics` op.  Lock-leaf: recorded OUTSIDE
        # self._lock (metrics_export.LatencyHistogram has its own)
        self.request_hist = LatencyHistogram()
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self.requests = 0
        self.rows = 0
        self.batches = 0
        self.batched_rows = 0
        self.bucket_rows = 0
        self.bucket_batches: Dict[int, int] = {}
        self.cache_hits = 0
        self.cache_misses = 0
        self.shed = 0
        self.errors = 0
        self.fallback_batches = 0
        self.fallback_rows = 0
        # per-tenant metrics under their own leaf lock (the request path
        # must never take self._lock just to find its tenant)
        self.slo_p99_ms = float(slo_p99_ms)
        self.slo_target = float(slo_target)
        self._tenants: Dict[str, TenantStats] = {}
        self._tenants_lock = threading.Lock()

    @property
    def tracer(self):
        """The attached span recorder (``None`` when tracing is off)."""
        return self.tel.tracer

    def attach_tracer(self, tracer) -> None:
        """Attach a ``TraceRecorder``: stage timers double as spans and
        the batcher emits per-batch / per-request-queue spans."""
        self.tel.tracer = tracer

    def stage(self, name: str):
        return self.tel.phase(f"serve_{name}")

    def record_request(self, rows: int) -> None:
        with self._lock:
            self.requests += 1
            self.rows += int(rows)

    def record_request_latency(self, ms: float) -> None:
        """End-to-end server-side request latency (admission→response)."""
        self.request_hist.record(ms)

    def record_queue_wait(self, seconds: float,
                          t0: Optional[float] = None) -> None:
        self.tel.add_phase_time("serve_queue", seconds, t0=t0)

    def record_batch(self, bucket: int, rows: int) -> None:
        with self._lock:
            self.batches += 1
            self.batched_rows += int(rows)
            self.bucket_rows += int(bucket)
            self.bucket_batches[int(bucket)] = \
                self.bucket_batches.get(int(bucket), 0) + 1

    def record_compile_cache(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.cache_hits += 1
            else:
                self.cache_misses += 1

    def record_shed(self) -> None:
        with self._lock:
            self.shed += 1

    def record_error(self) -> None:
        """An admitted predict request that answered with an error frame:
        the signal the lifecycle rollback watchdog rates promotions by
        (`lifecycle/controller.py`)."""
        with self._lock:
            self.errors += 1
        rel_inc("serve.request_errors")

    def tenant(self, name: str) -> TenantStats:
        """The (lazily created) per-model-name metrics bundle."""
        with self._tenants_lock:
            t = self._tenants.get(name)
            if t is None:
                t = self._tenants[name] = TenantStats(name)
            return t

    def record_tenant_request(self, name: str, ms: float,
                              error: bool = False) -> None:
        """One completed (admission→response) request for a tenant —
        recorded in the dispatch ``finally`` beside the global
        ``record_request_latency``."""
        self.tenant(name).record(ms, self.slo_p99_ms, error=error)

    def record_tenant_shed(self, name: str) -> None:
        self.tenant(name).record_shed()

    def record_tenant_cap_shed(self, name: str) -> None:
        """A shed by the tenant's own admission cap, not the global one
        (`reliability.degrade.TenantAdmission`)."""
        self.tenant(name).record_cap_shed()

    def record_tenant_error(self, name: str) -> None:
        """Control-plane failure attributed to a tenant (no latency
        sample): failed swaps and malformed ops burn the same error
        budget the rollback watchdog reads."""
        self.tenant(name).record_error()

    def tenants_section(self) -> List[Dict[str, Any]]:
        """``serving.tenants[]``: one section per model name, sorted."""
        with self._tenants_lock:
            tenants = sorted(self._tenants.values(), key=lambda t: t.name)
        return [t.section(self.slo_p99_ms, self.slo_target)
                for t in tenants]

    def record_fallback(self, rows: int) -> None:
        with self._lock:
            self.fallback_batches += 1
            self.fallback_rows += int(rows)
        rel_inc("serve.host_fallback_batches")
        rel_inc("serve.host_fallback_rows", int(rows))

    def serving_section(self, models: Optional[Dict[str, int]] = None,
                        jit_entries: Optional[int] = None) -> Dict[str, Any]:
        # histogram/tenant snapshots BEFORE self._lock: their locks stay
        # leaf (no nested acquisition for the race detector to chew)
        latency = self.request_hist.snapshot()
        tenants = self.tenants_section()
        with self._lock:
            elapsed = max(time.monotonic() - self._t0, 1e-9)
            stage_ms = {}
            for s in self.STAGES:
                st = self.tel._phases.get(f"serve_{s}")
                if st is not None:
                    stage_ms[s] = {"total_ms": st[0] * 1e3, "count": st[1],
                                   "max_ms": st[2] * 1e3}
            return {
                "requests": self.requests,
                "rows": self.rows,
                "batches": self.batches,
                "qps": self.requests / elapsed,
                "rows_per_s": self.rows / elapsed,
                "batch_occupancy": (self.batched_rows / self.bucket_rows
                                    if self.bucket_rows else 0.0),
                "compile_cache": {"hits": self.cache_hits,
                                  "misses": self.cache_misses,
                                  "jit_entries": jit_entries},
                "stage_ms": stage_ms,
                "buckets": {str(b): c
                            for b, c in sorted(self.bucket_batches.items())},
                "models": dict(models or {}),
                "shed": self.shed,
                "errors": self.errors,
                "fallback_batches": self.fallback_batches,
                "fallback_rows": self.fallback_rows,
                "latency_ms": latency,
                "tenants": tenants,
            }

    def report(self, models: Optional[Dict[str, int]] = None,
               jit_entries: Optional[int] = None) -> Dict[str, Any]:
        """Full telemetry report with the ``serving`` section attached —
        validates against the extended ``observability/schema.json``."""
        rep = self.tel.report()
        rep["serving"] = self.serving_section(models, jit_entries)
        return rep


class _Request:
    __slots__ = ("X", "n", "done", "result", "error", "t_enq", "trace_id",
                 "callback")

    def __init__(self, X: np.ndarray, trace_id: Optional[str] = None,
                 callback: Optional[Callable[["_Request"], None]] = None):
        self.X = X
        self.n = X.shape[0]
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        # perf_counter: the clock the trace recorder's epoch is on, so
        # the queue-wait span aligns with the stage spans
        self.t_enq = time.perf_counter()
        self.trace_id = trace_id
        self.callback = callback


class MicroBatcher:
    """Coalesces concurrent requests into padded power-of-two batches.

    ``predict_fn(Xpad, m)`` receives an ``(bucket, num_features)`` float64
    matrix whose first ``m`` rows are real and returns host scores for
    those rows (``(m,)`` or ``(m, K)``).  It runs ONLY on the worker
    thread, so the device is never entered concurrently.

    ``fallback_fn(Xpad, m, error)`` is the graceful-degradation path:
    when ``predict_fn`` raises ``error``, it re-scores the batch (the host
    numpy traversal in practice) and the fallback is counted
    (`reliability/metrics.py`), or it re-raises and every rider gets the
    error.
    """

    def __init__(self, predict_fn: Callable[[np.ndarray, int], np.ndarray],
                 num_features: int, max_batch_rows: int = 1024,
                 deadline_ms: float = 2.0, min_bucket: int = 16,
                 stats: Optional[ServingStats] = None,
                 fallback_fn: Optional[Callable[
                     [np.ndarray, int, Exception], np.ndarray]] = None):
        self.predict_fn = predict_fn
        self.fallback_fn = fallback_fn
        self.num_features = int(num_features)
        self.max_rows = next_pow2(max_batch_rows)
        self.min_bucket = min(next_pow2(min_bucket), self.max_rows)
        self.deadline_s = float(deadline_ms) / 1e3
        self.stats = stats or ServingStats()
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "MicroBatcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._worker, name="lgbt-serve-batcher", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- request side (any thread) ------------------------------------------

    def submit(self, X: np.ndarray, timeout: Optional[float] = None,
               trace_id: Optional[str] = None) -> np.ndarray:
        """Blocking predict; rows of oversized requests are chunked to the
        batch budget and re-concatenated.  ``trace_id`` rides the request
        into the batch worker so its queue-wait and micro-batch spans
        link back to the originating request."""
        X = np.ascontiguousarray(np.atleast_2d(np.asarray(X, np.float64)))
        if X.shape[1] != self.num_features:
            raise ValueError(f"request has {X.shape[1]} features, model "
                             f"expects {self.num_features}")
        if X.shape[0] > self.max_rows:
            parts = [self.submit(X[i:i + self.max_rows], timeout, trace_id)
                     for i in range(0, X.shape[0], self.max_rows)]
            return np.concatenate(parts, axis=0)
        self.stats.record_request(X.shape[0])
        req = _Request(X, trace_id=trace_id)
        self._q.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("prediction request timed out in the "
                               "serving queue")
        if req.error is not None:
            raise req.error
        return req.result

    def submit_async(self, X: np.ndarray, callback: Callable[[_Request], None],
                     trace_id: Optional[str] = None) -> _Request:
        """Non-blocking predict: enqueue and return at once; the batch
        worker calls ``callback(request)`` once ``result`` or ``error`` is
        set.  The fleet gateway's event loop rides this seam and must never
        block on device work (`serving/fleet/gateway.py`), so callbacks run
        on the batch worker thread and must not block themselves.  Rows
        past ``max_rows`` raise here: the dispatcher chunks them
        (`serving/fleet/replicas.py`)."""
        X = np.ascontiguousarray(np.atleast_2d(np.asarray(X, np.float64)))
        if X.shape[1] != self.num_features:
            raise ValueError(f"request has {X.shape[1]} features, model "
                             f"expects {self.num_features}")
        if X.shape[0] > self.max_rows:
            raise ValueError(f"async request of {X.shape[0]} rows exceeds "
                             f"the {self.max_rows}-row batch budget; chunk "
                             f"at the dispatch layer")
        self.stats.record_request(X.shape[0])
        req = _Request(X, trace_id=trace_id, callback=callback)
        self._q.put(req)
        return req

    # -- worker side ---------------------------------------------------------

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            rows = first.n
            deadline = time.monotonic() + self.deadline_s
            while rows < self.max_rows:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                try:
                    r = self._q.get(timeout=rem)
                except queue.Empty:
                    break
                batch.append(r)
                rows += r.n
            # preserve request boundaries while keeping every dispatch
            # inside the row budget
            group: List[_Request] = []
            grows = 0
            for r in batch:
                if group and grows + r.n > self.max_rows:
                    self._run_batch(group)
                    group, grows = [], 0
                group.append(r)
                grows += r.n
            if group:
                self._run_batch(group)

    def _run_batch(self, reqs: List[_Request]) -> None:
        t_start = time.perf_counter()
        tracer = self.stats.tracer
        for r in reqs:
            # one queue-wait span per rider, carrying ITS trace_id
            with (tracer.bind(r.trace_id) if tracer is not None
                  else _NULL_CTX):
                self.stats.record_queue_wait(t_start - r.t_enq, t0=r.t_enq)
        m = sum(r.n for r in reqs)
        bucket = max(self.min_bucket, next_pow2(m))
        # the micro-batch span carries EVERY rider's trace_id, and the
        # bind makes the stage spans recorded inside (pad here,
        # bin/traverse/unpad in ServingModel.predict_padded) inherit the
        # same ids — the request→batch→stage causal link
        ids = [r.trace_id for r in reqs if r.trace_id]
        span = bind = _NULL_CTX
        if tracer is not None:
            span = tracer.span("serve.batch", cat="serving",
                               trace_id=ids or None,
                               args={"bucket": int(bucket), "rows": int(m),
                                     "requests": len(reqs)})
            bind = tracer.bind(ids or None)
        try:
            with span, bind:
                with self.stats.stage("pad"):
                    Xpad = np.zeros((bucket, self.num_features), np.float64)
                    ofs = 0
                    for r in reqs:
                        Xpad[ofs:ofs + r.n] = r.X
                        ofs += r.n
                try:
                    scores = self.predict_fn(Xpad, m)
                except Exception as e:
                    if self.fallback_fn is None:
                        raise
                    with self.stats.stage("fallback"):
                        scores = self.fallback_fn(Xpad, m, e)
                    self.stats.record_fallback(m)
            ofs = 0
            for r in reqs:
                r.result = scores[ofs:ofs + r.n]
                ofs += r.n
                r.done.set()
                if r.callback is not None:
                    self._fire_callback(r)
            self.stats.record_batch(bucket, m)
        except BaseException as e:
            for r in reqs:
                r.error = e
                r.done.set()
                if r.callback is not None:
                    self._fire_callback(r)

    @staticmethod
    def _fire_callback(r: _Request) -> None:
        # a broken callback must not take down the batch worker (or the
        # other riders' callbacks)
        try:
            r.callback(r)
        except Exception:
            pass
