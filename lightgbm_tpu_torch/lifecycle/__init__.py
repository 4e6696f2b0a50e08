"""Continuous train-to-serve lifecycle.

Port of ``lightgbm_tpu/lifecycle/``.  A refreshed model is trained
incrementally off the live incumbent (``engine.train(init_model=...)`` with
the crash-safe snapshots), judged against recorded live traffic (shadow
replay with divergence, metric and latency gates) and promoted through the
serving registry with the incumbent retained; a watchdog after the
promotion rolls back when serving health regresses.

  * ``recorder``   — bounded ring capture of served feature rows
  * ``shadow``     — gated candidate-vs-incumbent replay
  * ``controller`` — ``LifecycleController``: refit, shadow, promote,
    watch, every decision in the ``lifecycle`` report section
  * ``budget``     — ``RefitBudget``: rate caps for autonomous refits
  * ``autopilot``  — ``Autopilot``: sustained drift triggers a budgeted
    refit and a per-replica shadow-gated rolling upgrade (the
    ``autopilot`` report section)

On the card the refit trains through the wave learner's kernels and the
shadow replays the bucket graphs of both models, while the fleet serves.
"""

from .autopilot import Autopilot
from .budget import RefitBudget
from .controller import (CandidateRejected, LifecycleController,
                         RollbackWatchdog)
from .recorder import TrafficRecorder
from .shadow import shadow_validate

__all__ = ["LifecycleController", "RollbackWatchdog", "CandidateRejected",
           "TrafficRecorder", "shadow_validate", "Autopilot",
           "RefitBudget"]
