"""Collective-communication accounting of the sharded learners.

Port of ``lightgbm_tpu/observability/collectives.py``.  The sharded
learners (``parallel/``) issue every collective from a handful of seams
(``_reduce_hist`` / ``_reduce_hist_batch`` / ``_sync_counts*`` /
``_global_scalar`` / ``_global_max`` / the best-split all-gathers); each
seam records its call site here as (op, payload bytes, phase, cadence).

The JAX package records a site when its tree program is traced, once per
site; the port's learners run eagerly, so a site is recorded when it is
called, and the ledger keeps the set of distinct sites (what
``collectives.sites`` reports) apart from the calls and bytes it counted
(what ``per_tree_estimate`` reports, measured rather than estimated).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List


def _nbytes(x: Any) -> int:
    """Payload bytes of a tensor, or an explicit byte count."""
    if isinstance(x, (int, float)):
        return int(x)
    try:
        return int(x.numel()) * int(x.element_size())
    except AttributeError:
        return 0


class CollectiveLedger:
    """Per-learner registry of collective call sites and their traffic."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._sites: List[Dict[str, Any]] = []
        self._keys = set()
        #: collectives issued and their payload bytes, over all trees
        self.calls = 0
        self.bytes = 0

    def record(self, op: str, payload: Any, phase: str,
               cadence: str) -> None:
        """Count one collective and register its site.  ``payload`` is the
        operand (its bytes read from its shape) or a byte count."""
        if not self.enabled:
            return
        b = _nbytes(payload)
        self.calls += 1
        self.bytes += b
        key = (op, phase, cadence, b)
        if key in self._keys:
            return
        self._keys.add(key)
        self._sites.append({"op": op, "phase": phase, "cadence": cadence,
                            "bytes_per_call": b})

    def sites(self) -> Iterable[Dict[str, Any]]:
        return list(self._sites)
