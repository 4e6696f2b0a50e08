"""Supervised train-to-serve lifecycle: refit, shadow, promote, watch.

Port of ``lightgbm_tpu/lifecycle/controller.py``.  ``LifecycleController``
closes the loop between the trainer and the server around one registered
model name:

  * ``refit``: continued training, ``engine.train(init_model=incumbent)``
    on fresh data, on the card unless the params say ``device_type=cpu``,
    with the crash-safe snapshots underneath
    (``snapshot_freq`` + ``resume=True``), so a refit killed mid-run
    relaunches bit-identical;
  * ``shadow``: the candidate is built, warmed and verified off to the side
    in the registry (``prepare``, never swapped) and replayed against the
    traffic recording with the configured gates (`lifecycle/shadow.py`); a
    failing candidate is rejected with the structured report and nothing
    changes on the serving path;
  * ``promote``: the already-prepared candidate commits through the
    registry's atomic swap (the incumbent retained for rollback);
  * ``RollbackWatchdog``: for ``rollback_deadline_s`` after a promotion,
    serving health (request errors, fallback batches, sheds, from
    ``ServingStats``) is sampled every ``watch_interval_s``; a breach rolls
    the registry back to the retained incumbent.

Every decision lands in ``section()``, the ``lifecycle`` section of the
server's report, and, with a tracer, as ``lifecycle.*`` spans.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..reliability.metrics import rel_inc
from .shadow import shadow_validate

_NULL_CTX = contextlib.nullcontext()

_MAX_EVENTS = 256


class CandidateRejected(RuntimeError):
    """Raised by ``run_cycle`` when the shadow gates reject the refit
    candidate.  Carries the structured shadow report."""

    def __init__(self, report: Dict[str, Any]):
        super().__init__("shadow validation rejected the candidate: "
                         + "; ".join(report.get("reasons", [])))
        self.report = report


class RollbackWatchdog:
    """Post-promotion circuit breaker on a daemon thread.

    Samples serving deltas since the promotion; any breach of the error /
    fallback / shed ceilings inside the deadline rolls the registry back
    to the retained incumbent.  ``result`` is ``None`` while watching,
    then ``"healthy"`` or ``"rolled_back"``.
    """

    def __init__(self, controller: "LifecycleController", version: int,
                 deadline_s: float, interval_s: float,
                 error_rate_max: float, shed_rate_max: float,
                 min_requests: int = 1):
        self.controller = controller
        self.version = int(version)
        self.deadline_s = float(deadline_s)
        self.interval_s = max(float(interval_s), 0.01)
        self.error_rate_max = float(error_rate_max)
        self.shed_rate_max = float(shed_rate_max)
        self.min_requests = max(int(min_requests), 1)
        self.result: Optional[str] = None
        self.breach: Optional[str] = None
        self._stop = threading.Event()
        self._done = threading.Event()
        stats = controller.stats
        with stats._lock:
            self._base = {"requests": stats.requests, "errors": stats.errors,
                          "fallback_batches": stats.fallback_batches,
                          "batches": stats.batches, "shed": stats.shed}
        self._t0 = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name="lgbt-lifecycle-watchdog", daemon=True)

    def start(self) -> "RollbackWatchdog":
        self._thread.start()
        return self

    def cancel(self) -> None:
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def _deltas(self) -> Dict[str, int]:
        stats = self.controller.stats
        with stats._lock:
            now = {"requests": stats.requests, "errors": stats.errors,
                   "fallback_batches": stats.fallback_batches,
                   "batches": stats.batches, "shed": stats.shed}
        return {k: now[k] - self._base[k] for k in now}

    def _check(self) -> Optional[str]:
        d = self._deltas()
        if d["requests"] + d["shed"] < self.min_requests:
            return None
        err_rate = d["errors"] / max(d["requests"], 1)
        if err_rate > self.error_rate_max:
            return (f"request error rate {err_rate:.3g} > "
                    f"{self.error_rate_max:g} ({d['errors']} errors / "
                    f"{d['requests']} requests)")
        fb_rate = d["fallback_batches"] / max(d["batches"], 1)
        if fb_rate > self.error_rate_max:
            return (f"device fallback rate {fb_rate:.3g} > "
                    f"{self.error_rate_max:g} ({d['fallback_batches']} "
                    f"fallback batches / {d['batches']} batches)")
        shed_rate = d["shed"] / max(d["requests"] + d["shed"], 1)
        if shed_rate > self.shed_rate_max:
            return (f"shed rate {shed_rate:.3g} > {self.shed_rate_max:g} "
                    f"({d['shed']} shed / {d['requests'] + d['shed']} "
                    f"offered)")
        return None

    def _run(self) -> None:
        try:
            deadline = self._t0 + self.deadline_s
            while not self._stop.wait(self.interval_s):
                breach = self._check()
                if breach is not None:
                    self.breach = breach
                    self.result = "rolled_back"
                    self.controller._auto_rollback(self, breach)
                    return
                if time.monotonic() >= deadline:
                    self.result = "healthy"
                    self.controller._watch_healthy(self)
                    return
            self.result = self.result or "cancelled"
        finally:
            self._done.set()

    def section(self) -> Dict[str, Any]:
        return {"version": self.version,
                "result": self.result or "watching",
                "breach": self.breach,
                "elapsed_s": time.monotonic() - self._t0,
                "deadline_s": self.deadline_s}


class LifecycleController:
    """Drives the continuous train→serve loop for one served model."""

    def __init__(self, server, name: str = "default", *,
                 metric: str = "", metric_floor: float = float("nan"),
                 divergence_max: float = 0.25,
                 latency_max_ratio: float = 4.0, min_shadow_rows: int = 1,
                 rollback_deadline_s: float = 30.0,
                 watch_interval_s: float = 0.5,
                 error_rate_max: float = 0.05, shed_rate_max: float = 0.5,
                 watch_min_requests: int = 1):
        self.server = server
        self.registry = server.registry
        self.stats = server.stats
        self.recorder = server.recorder
        self.name = name
        self.metric = metric
        self.metric_floor = float(metric_floor)
        self.divergence_max = float(divergence_max)
        self.latency_max_ratio = float(latency_max_ratio)
        self.min_shadow_rows = int(min_shadow_rows)
        self.rollback_deadline_s = float(rollback_deadline_s)
        self.watch_interval_s = float(watch_interval_s)
        self.error_rate_max = float(error_rate_max)
        self.shed_rate_max = float(shed_rate_max)
        self.watch_min_requests = int(watch_min_requests)
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._t0 = time.monotonic()
        self._promotions = 0
        self._rollbacks = 0
        self._auto_rollbacks = 0
        self._shadow_last: Optional[Dict[str, Any]] = None
        self.watchdog: Optional[RollbackWatchdog] = None
        # the server's report() attaches section() once a controller is
        # bound (PredictionServer.lifecycle)
        server.lifecycle = self

    @classmethod
    def from_config(cls, server, cfg, name: str = "default"
                    ) -> "LifecycleController":
        """Build from the ``lifecycle_*`` config keys (`config.py`)."""
        return cls(
            server, name,
            metric=cfg.lifecycle_metric,
            metric_floor=cfg.lifecycle_metric_floor,
            divergence_max=cfg.lifecycle_divergence_max,
            latency_max_ratio=cfg.lifecycle_latency_max_ratio,
            min_shadow_rows=cfg.lifecycle_min_shadow_rows,
            rollback_deadline_s=cfg.lifecycle_rollback_deadline_s,
            watch_interval_s=cfg.lifecycle_watch_interval_s,
            error_rate_max=cfg.lifecycle_error_rate_max,
            shed_rate_max=cfg.lifecycle_shed_rate_max)

    # -- bookkeeping ---------------------------------------------------------

    def _event(self, kind: str, **info: Any) -> None:
        ev = {"event": kind,
              "t_ms": (time.monotonic() - self._t0) * 1e3, **info}
        with self._lock:
            self._events.append(ev)
            if len(self._events) > _MAX_EVENTS:
                del self._events[:_MAX_EVENTS // 2]
        tr = self.stats.tracer
        if tr is not None:
            tr.instant(f"lifecycle.{kind}", cat="lifecycle",
                       args={k: v for k, v in info.items()
                             if isinstance(v, (int, float, str, bool))})

    def _span(self, name: str, **args: Any):
        tr = self.stats.tracer
        return tr.span(f"lifecycle.{name}", cat="lifecycle", args=args) \
            if tr is not None else _NULL_CTX

    # -- continued training --------------------------------------------------

    def refit(self, train_set, num_boost_round: int = 10,
              params: Optional[Dict[str, Any]] = None,
              output_model: str = "", snapshot_freq: int = -1,
              resume: bool = False, **train_kw):
        """Continued training off the LIVE incumbent: warm-start
        ``engine.train`` on ``train_set`` for ``num_boost_round`` more
        rounds.  ``output_model`` + ``snapshot_freq`` arm the crash-safe
        snapshots; ``resume=True`` relaunches a killed refit from the
        newest valid snapshot (which wins over the incumbent when newer —
        `engine.train`)."""
        from .. import engine

        incumbent = self.registry.get(self.name).booster
        p = dict(params or {})
        if output_model:
            p.setdefault("output_model", output_model)
        if snapshot_freq > 0:
            p.setdefault("snapshot_freq", snapshot_freq)
        with self._span("refit", rounds=int(num_boost_round)):
            booster = engine.train(p, train_set, num_boost_round,
                                   init_model=incumbent, resume=resume,
                                   verbose_eval=False, **train_kw)
        self._event("refit", rounds=int(num_boost_round),
                    trees=booster.num_trees())
        rel_inc("lifecycle.refits")
        return booster

    # -- shadow validation ---------------------------------------------------

    def shadow(self, candidate, labels: Optional[np.ndarray] = None,
               X: Optional[np.ndarray] = None):
        """Prepare the candidate in the registry (warm + verify, never
        swapped) and run the shadow gates over the traffic recording (or
        an explicit ``X``).  Returns ``(prepared_model_or_None,
        report)`` — the model is ``None`` when any gate failed."""
        if X is None:
            X = self.recorder.snapshot()
        # serve the DEPLOYMENT ARTIFACT, not the trainer handle: a
        # continued-training booster's live bin space is the fresh
        # data's quantization of the incumbent's thresholds (lossy), so
        # its device path would diverge from the exact float-threshold
        # traversal and fail registry verification.  The model text
        # carries the exact thresholds, which the registry reconstructs
        # into an exact bin schema — and it is what a remote `swap`
        # would serve anyway.
        cand_text = candidate if isinstance(candidate, str) \
            else candidate.model_to_string()
        with self._span("shadow", rows=int(np.atleast_2d(X).shape[0])):
            try:
                prepared = self.registry.prepare(self.name,
                                                 model_str=cand_text)
            except Exception as e:
                return None, self.unbuildable(e)
            report = shadow_validate(
                prepared, self.registry.get(self.name), X, labels=labels,
                metric=self.metric, metric_floor=self.metric_floor,
                divergence_max=self.divergence_max,
                latency_max_ratio=self.latency_max_ratio,
                min_rows=self.min_shadow_rows,
                buckets=self.registry.warm_buckets)
        self.record_shadow(report)
        return (prepared if report["passed"] else None), report

    def unbuildable(self, error: Exception) -> Dict[str, Any]:
        """Reject a candidate that cannot even build or verify, with the
        same structured report as a gate failure; returns the report."""
        report = {"rows": 0, "gates": {"verify": {"passed": False}},
                  "reasons": [f"candidate failed registry verification: "
                              f"{error}"],
                  "passed": False}
        rel_inc("lifecycle.shadow_runs")
        rel_inc("lifecycle.shadow_rejections")
        self.record_shadow(report)
        return report

    def record_shadow(self, report: Dict[str, Any]) -> None:
        """Keep ``report`` as the last shadow run (the ``lifecycle``
        section's ``shadow``) and log it as an event."""
        with self._lock:
            self._shadow_last = report
        self._event("shadow", passed=bool(report["passed"]),
                    reasons="; ".join(report.get("reasons", [])))

    # -- promotion / rollback ------------------------------------------------

    def promote(self, prepared, watch: bool = True) -> int:
        """Commit an already-prepared candidate through the registry's
        atomic swap (incumbent retained) and start the rollback
        watchdog."""
        with self._span("promote"):
            version = self.registry.commit(prepared)
        with self._lock:
            self._promotions += 1
        rel_inc("lifecycle.promotions")
        self._event("promote", version=int(version))
        if watch:
            stale = self.watchdog
            if stale is not None:
                # Back-to-back promotions: the previous watchdog's
                # ServingStats base belongs to the OLD candidate's
                # window — left running it would judge the new candidate
                # against stale error/shed deltas and could roll it back
                # spuriously.  The replacement watchdog re-baselines in
                # its own __init__.
                stale.cancel()
                stale.join(timeout=5.0)
            self.watchdog = RollbackWatchdog(
                self, version, self.rollback_deadline_s,
                self.watch_interval_s, self.error_rate_max,
                self.shed_rate_max, self.watch_min_requests).start()
        return version

    def rollback(self, reason: str = "operator") -> int:
        """Manual rollback to the retained previous version."""
        version = self.registry.rollback(self.name)
        with self._lock:
            self._rollbacks += 1
        rel_inc("lifecycle.rollbacks")
        self._event("rollback", version=int(version), reason=reason)
        return version

    def _auto_rollback(self, watchdog: RollbackWatchdog,
                       breach: str) -> None:
        with self._span("rollback", breach=breach):
            try:
                version = self.registry.rollback(self.name)
            except KeyError:
                # no retained incumbent (first-ever load): record the
                # breach, there is nothing to roll back to
                self._event("rollback_failed", reason=breach)
                return
        with self._lock:
            self._rollbacks += 1
            self._auto_rollbacks += 1
        rel_inc("lifecycle.rollbacks")
        rel_inc("lifecycle.auto_rollbacks")
        self._event("auto_rollback", version=int(version), reason=breach,
                    promoted_version=watchdog.version,
                    elapsed_s=time.monotonic() - watchdog._t0)

    def _watch_healthy(self, watchdog: RollbackWatchdog) -> None:
        self._event("promotion_healthy", version=watchdog.version,
                    elapsed_s=time.monotonic() - watchdog._t0)
        rel_inc("lifecycle.promotions_healthy")

    # -- the whole loop ------------------------------------------------------

    def run_cycle(self, train_set, num_boost_round: int = 10,
                  params: Optional[Dict[str, Any]] = None,
                  labels: Optional[np.ndarray] = None,
                  output_model: str = "", snapshot_freq: int = -1,
                  resume: bool = False, watch: bool = True,
                  **train_kw) -> Dict[str, Any]:
        """record → refit → shadow → promote in one call.  Raises
        ``CandidateRejected`` (carrying the shadow report) when the gates
        fail; otherwise returns ``{"version", "shadow", "booster"}``."""
        booster = self.refit(train_set, num_boost_round, params,
                             output_model=output_model,
                             snapshot_freq=snapshot_freq, resume=resume,
                             **train_kw)
        prepared, report = self.shadow(booster, labels=labels)
        if prepared is None:
            raise CandidateRejected(report)
        version = self.promote(prepared, watch=watch)
        return {"version": version, "shadow": report, "booster": booster}

    def stop(self) -> None:
        if self.watchdog is not None:
            self.watchdog.cancel()
            self.watchdog.join(timeout=5.0)

    # -- report --------------------------------------------------------------

    def section(self) -> Dict[str, Any]:
        """The ``lifecycle`` section of the serving telemetry report."""
        with self._lock:
            events = list(self._events)
            out = {"promotions": self._promotions,
                   "rollbacks": self._rollbacks,
                   "auto_rollbacks": self._auto_rollbacks,
                   "shadow": self._shadow_last,
                   "events": events}
        out["recorder"] = self.recorder.section() \
            if self.recorder is not None else None
        out["watchdog"] = self.watchdog.section() \
            if self.watchdog is not None else None
        out["versions"] = self.registry.versions_detail()
        return out
