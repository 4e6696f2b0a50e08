"""Reliability for the port's training and serving paths.

Port of ``lightgbm_tpu/reliability/``:

  * ``faults``  — deterministic named injection points armed via
    ``LGBT_FAULTS`` / ``fault_spec``, so chaos tests drive the real
    failure paths (never mocks): the serving ones and ``train.crash``;
  * ``resume``  — crash-safe training snapshots (``snapshot_freq``) and
    their validation, retention and bit-identical resume (``resume``);
  * ``degrade`` — the serving layer's bounded admission and load shedding
    (`serving/server.py`) and the fleet gateway's per-tenant caps
    (`serving/fleet/gateway.py`);
  * ``metrics`` — the process-wide counter table every shed, fallback,
    rollback and injected fault reports into, surfaced as the
    ``reliability`` section of the telemetry report
    (`observability/schema.json`).
"""

from . import faults
from .degrade import AdmissionController, TenantAdmission
from .metrics import (rel_counters, rel_get, rel_inc, rel_reset,
                      reliability_section)
from .resume import (config_fingerprint, find_resume_snapshot,
                     list_snapshots, prune_snapshots, save_snapshot,
                     validate_snapshot)

__all__ = ["faults", "AdmissionController", "TenantAdmission",
           "rel_inc", "rel_get", "rel_counters", "rel_reset",
           "reliability_section", "config_fingerprint",
           "find_resume_snapshot", "list_snapshots", "prune_snapshots",
           "save_snapshot", "validate_snapshot"]
