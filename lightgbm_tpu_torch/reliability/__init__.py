"""Reliability for the port's serving path.

Port of the serving half of ``lightgbm_tpu/reliability/``:

  * ``faults``  — deterministic named injection points armed via
    ``LGBT_FAULTS`` / ``fault_spec``, so chaos tests drive the real
    serving failure paths (never mocks);
  * ``degrade`` — the serving layer's bounded admission and load shedding
    (`serving/server.py`);
  * ``metrics`` — the process-wide counter table every shed, fallback,
    rollback and injected fault reports into, surfaced as the
    ``reliability`` section of the telemetry report
    (`observability/schema.json`).

Crash-safe training resume (the JAX ``resume``) is not ported: ROADMAP.md
Queue A, "reliability and training observability".
"""

from . import faults
from .degrade import AdmissionController
from .metrics import (rel_counters, rel_get, rel_inc, rel_reset,
                      reliability_section)

__all__ = ["faults", "AdmissionController",
           "rel_inc", "rel_get", "rel_counters", "rel_reset",
           "reliability_section"]
