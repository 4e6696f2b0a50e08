"""Autopilot: drift-triggered refit with budget caps and gated rollout.

Port of ``lightgbm_tpu/lifecycle/autopilot.py``, the same decisions in the
same order.  The ``Autopilot`` is the daemon that composes the lifecycle:

  1. **detect**: poll the fleet's drift verdict over the recorder window;
     only ``consecutive_checks`` consecutive drifted verdicts, each over
     fresh traffic (the monitor's check counter and the recorder's row
     counter both advanced), arm a refit;
  2. **budget**: every armed refit passes ``RefitBudget``; a veto records a
     ``suppressed`` decision with its reason and never queues;
  3. **refit**: continued training from the incumbent over the original
     train source (plus the recorded window when ``label_fn`` labels it),
     through ``LifecycleController.refit``, so on the card the refit trains
     through the wave learner's kernels while the replicas serve;
  4. **validate**: the candidate goes through its model text and is shadow
     validated against the incumbent on the recorded window;
  5. **roll**: a fleet builds the candidate on every replica once and
     upgrades replica by replica through ``promote_rolling``, each
     replica's commit gated by its own shadow run on the window; replica
     0's gate is step 4 (a failure there commits nothing and is a
     rejection), so no replica captures or replays the candidate twice.
     A server without replicas shadows and promotes through the
     controller.

Every decision lands in a bounded ring (the ``autopilot`` report section),
in ``lifecycle.autopilot.*`` counters and as trace instants.  The daemon
thread never runs on the gateway's event loop.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..reliability.metrics import rel_inc
from .budget import RefitBudget
from .controller import CandidateRejected, LifecycleController

__all__ = ["Autopilot"]

_MAX_DECISIONS = 256


class Autopilot:
    """Drift→refit→shadow→roll daemon (see module doc).

    ``train_source`` is a zero-argument callable returning the original
    training data as ``(X, y)`` arrays — called once per refit cycle so
    the source can be re-read from disk.  ``label_fn`` (optional) maps
    recorded request rows to labels; when present, the recorded window
    joins the refit training set and labels the shadow metric gate.
    """

    def __init__(self, server: Any, controller: LifecycleController,
                 train_source: Callable[[], Any], *,
                 label_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 name: str = "default",
                 interval_s: float = 30.0,
                 consecutive_checks: int = 3,
                 budget: Optional[RefitBudget] = None,
                 num_boost_round: int = 10,
                 params: Optional[Dict[str, Any]] = None,
                 output_model: str = "",
                 snapshot_freq: int = -1,
                 settle_s: float = 0.0):
        self.server = server
        self.controller = controller
        self.train_source = train_source
        self.label_fn = label_fn
        self.name = name
        self.interval_s = float(interval_s)
        self.consecutive_checks = max(int(consecutive_checks), 1)
        self.budget = budget if budget is not None else RefitBudget()
        self.num_boost_round = int(num_boost_round)
        self.params = dict(params or {})
        self.output_model = output_model
        self.snapshot_freq = int(snapshot_freq)
        self.settle_s = float(settle_s)
        self.stats = server.stats
        self._lock = threading.Lock()
        self._decisions: List[Dict[str, Any]] = []
        self._counts = {"checks": 0, "triggered": 0, "suppressed": 0,
                        "rejected": 0, "promoted": 0, "rolled_back": 0,
                        "errors": 0}
        self._consecutive = 0
        self._seen_checks = -1
        self._seen_rows = -1
        self._t0 = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        server.autopilot = self

    # -- daemon --------------------------------------------------------

    def start(self) -> "Autopilot":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="lgbt-autopilot")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as exc:  # daemon must survive anything
                self._decide("error", reason=repr(exc))

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)

    # -- one detect→refit→roll step (synchronous; tests call directly) -

    def tick(self) -> Optional[Dict[str, Any]]:
        """Run one check; returns the decision recorded (None when the
        window produced no fresh verdict or drift is still clear)."""
        with self._lock:
            self._counts["checks"] += 1
        verdict = self._fresh_verdict()
        if verdict is None:
            return None
        if not verdict.get("drifted"):
            with self._lock:
                self._consecutive = 0
            return None
        with self._lock:
            self._consecutive += 1
            consecutive = self._consecutive
        if consecutive < self.consecutive_checks:
            return self._decide("drift_pending", consecutive=consecutive,
                                required=self.consecutive_checks,
                                max_psi=verdict.get("max_psi"),
                                max_ks=verdict.get("max_ks"))
        admitted, reason = self.budget.try_begin()
        if not admitted:
            rel_inc("lifecycle.autopilot.suppressed")
            rel_inc(f"lifecycle.autopilot.suppressed.{reason}")
            return self._decide("suppressed", reason=reason,
                                consecutive=consecutive)
        rel_inc("lifecycle.autopilot.triggered")
        decision = self._decide("triggered", consecutive=consecutive,
                                max_psi=verdict.get("max_psi"),
                                max_ks=verdict.get("max_ks"))
        rolled_back = False
        try:
            outcome = self._refit_cycle()
        except CandidateRejected as exc:
            rel_inc("lifecycle.autopilot.rejected")
            report = getattr(exc, "report", {}) or {}
            return self._decide("rejected",
                                reason=";".join(report.get("reasons", []))
                                or "shadow_gate",
                                shadow=report.get("gates"))
        except Exception as exc:
            rel_inc("lifecycle.autopilot.errors")
            return self._decide("error", reason=repr(exc))
        else:
            rolled_back = bool(outcome.get("rolled_back"))
            if rolled_back:
                rel_inc("lifecycle.autopilot.rolled_back")
                return self._decide(
                    "rolled_back",
                    reason=outcome.get("reason", "gate_failed_mid_roll"),
                    aborted_replica=outcome.get("aborted_replica"))
            rel_inc("lifecycle.autopilot.promoted")
            with self._lock:
                self._consecutive = 0
            return self._decide("promoted",
                                versions=outcome.get("versions"),
                                replicas=outcome.get("replicas"))
        finally:
            self.budget.end(rolled_back=rolled_back)
            _ = decision

    # -- detection -----------------------------------------------------

    def _fresh_verdict(self) -> Optional[Dict[str, Any]]:
        """The fleet's current drift section, only when it reflects a
        check the autopilot has not counted yet over new traffic."""
        check = getattr(self.server, "check_drift", None)
        recorder = getattr(self.server, "recorder", None)
        if check is None or recorder is None or not recorder.enabled:
            return None
        rows = recorder.total_rows
        section = check(self.name)
        if not section or "drifted" not in section:
            return None
        checks = int(section.get("checks", 0))
        with self._lock:
            if checks <= self._seen_checks or rows <= self._seen_rows:
                return None   # stale: no new comparison or no new traffic
            self._seen_checks = checks
            self._seen_rows = rows
        return section

    # -- the refit cycle ----------------------------------------------

    def _refit_cycle(self) -> Dict[str, Any]:
        """Refit → round-trip → shadow → gated roll.  Raises
        ``CandidateRejected`` when the candidate fails shadow; returns
        an outcome dict otherwise."""
        from ..dataset import Dataset

        ctl = self.controller
        window = self.server.recorder.snapshot()
        if window.size == 0:
            raise CandidateRejected({"passed": False,
                                     "reasons": ["empty_window"]})
        X0, y0 = self.train_source()
        X0 = np.asarray(X0, dtype=np.float64)
        y0 = np.asarray(y0, dtype=np.float64).reshape(-1)
        labels = None
        if self.label_fn is not None:
            labels = np.asarray(self.label_fn(window),
                                dtype=np.float64).reshape(-1)
            Xt = np.vstack([X0, np.asarray(window, dtype=np.float64)])
            yt = np.concatenate([y0, labels])
        else:
            Xt, yt = X0, y0
        train_set = Dataset(Xt, label=yt, params=dict(self.params))
        booster = ctl.refit(
            train_set, num_boost_round=self.num_boost_round,
            params=dict(self.params), output_model=self.output_model,
            snapshot_freq=self.snapshot_freq,
            resume=bool(self.output_model))
        cand_text = booster.model_to_string()  # promote what serializes
        promote_rolling = getattr(self.server, "promote_rolling", None)
        if promote_rolling is None:
            prepared, report = ctl.shadow(cand_text, labels=labels,
                                          X=window)
            if prepared is None:
                raise CandidateRejected(report)
            version = ctl.promote(prepared, watch=True)
            return {"versions": {self.name: version}, "replicas": 1}
        # a fleet: the candidate is built on every replica once, and
        # replica 0's gate before its commit is the cycle's shadow run
        # (the window, its labels and the metric floor), so no replica
        # captures or replays the candidate twice
        try:
            prepared = self.server.replicas.prepare_all(
                self.name, model_str=cand_text)
        except Exception as e:
            raise CandidateRejected(ctl.unbuildable(e))
        out = promote_rolling(
            self.name, settle_s=self.settle_s,
            divergence_max=ctl.divergence_max,
            latency_max_ratio=ctl.latency_max_ratio,
            shadow_min_rows=ctl.min_shadow_rows, prepared=prepared,
            X=window, labels=labels, metric=ctl.metric,
            metric_floor=ctl.metric_floor)
        ctl.record_shadow(out["shadow"])
        if not out.get("committed"):
            if not out.get("restored"):
                raise CandidateRejected(out["shadow"])
            return {"rolled_back": True,
                    "aborted_replica": out.get("aborted_replica"),
                    "reason": "replica_gate_failed",
                    "gates": out.get("gates")}
        return {"versions": out.get("versions"),
                "replicas": out.get("replicas")}

    # -- bookkeeping ---------------------------------------------------

    def _decide(self, decision: str, **info: Any) -> Dict[str, Any]:
        ev: Dict[str, Any] = {
            "decision": decision,
            "t_ms": round((time.monotonic() - self._t0) * 1e3, 3)}
        ev.update({k: v for k, v in info.items() if v is not None})
        key = "errors" if decision == "error" else decision
        with self._lock:
            if key in self._counts:
                self._counts[key] += 1
            self._decisions.append(ev)
            if len(self._decisions) > _MAX_DECISIONS:
                del self._decisions[:_MAX_DECISIONS // 2]
        tr = self.stats.tracer
        if tr is not None:
            tr.instant(f"autopilot.{decision}",
                       args={k: str(v) for k, v in ev.items()})
        return ev

    def section(self) -> Dict[str, Any]:
        """The ``autopilot`` report section."""
        with self._lock:
            counts = dict(self._counts)
            decisions = list(self._decisions)
            consecutive = self._consecutive
        return {
            "enabled": True,
            "model": self.name,
            "interval_s": self.interval_s,
            "consecutive_required": self.consecutive_checks,
            "drift_consecutive": consecutive,
            "checks": counts["checks"],
            "triggered": counts["triggered"],
            "suppressed": counts["suppressed"],
            "rejected": counts["rejected"],
            "promoted": counts["promoted"],
            "rolled_back": counts["rolled_back"],
            "errors": counts["errors"],
            "budget": self.budget.section(),
            "decisions": decisions,
        }

    @classmethod
    def from_config(cls, server: Any, controller: LifecycleController,
                    train_source: Callable[[], Any], cfg: Any,
                    **kw: Any) -> "Autopilot":
        """Map ``autopilot_*`` config keys (see ``config.py``)."""
        budget = RefitBudget(
            max_refits_per_window=cfg.autopilot_max_refits,
            window_s=cfg.autopilot_window_s,
            min_spacing_s=cfg.autopilot_min_spacing_s,
            cooldown_s=cfg.autopilot_cooldown_s)
        return cls(server, controller, train_source,
                   interval_s=cfg.autopilot_interval_s,
                   consecutive_checks=cfg.autopilot_consecutive_checks,
                   num_boost_round=cfg.autopilot_num_boost_round,
                   budget=budget, **kw)
