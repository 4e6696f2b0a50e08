"""Program-invariant static analysis of the port, ``lightgbm_tpu_torch``.

Port of ``lightgbm_tpu/analysis/``: a gate that runs on the CPU over the
port's own tree,

    python -m lightgbm_tpu_torch.analysis [--json report.json]

with six passes and an always-on allowlist-staleness check:

  * ``lint``      — repo AST rules LGB001-LGB006 (socket deadlines, atomic
    writes, seeded RNGs, no swallowed BaseException, no wall clock in code
    a CUDA graph capture runs, report keys against the schema);
  * ``races``     — the lock-acquisition graph over the serving, fleet,
    lifecycle, elastic and ``native.py`` locks: cycles and fields mutated
    both inside and outside a lock, plus a runtime lock-order monitor;
  * ``resources`` — threads joined, fds closed, subprocesses and spawned
    processes reaped (LGB011-LGB013);
  * ``spmd``      — rank-divergent control flow around collectives
    (LGB008) and blocking calls on the fleet gateway's selector thread
    (LGB010);
  * ``programs``  — each sharded learner run for one tree on a gloo rank
    pool, its ordered collectives held to ``budgets.json`` and
    ``sequences.json``, ``data`` at 2 and 4 ranks held to one order;
  * ``recompile`` — capture counters fingerprinted after warm-up: a warmed
    training step or serving bucket never captures a CUDA graph again
    (skipped on the CPU, where nothing is captured).

The JAX package's ``donation`` (``donate_argnums`` and XLA's input/output
aliasing) and ``costmodel`` (XLA's cost analysis) passes check XLA
mechanisms the port does not have; they are not ported.  The report
validates against ``schema.json``, byte for byte the JAX package's.

This module stays import-light: the AST passes need nothing but the
standard library and the port's own report validator.
"""

from .common import (Finding, apply_allowlist, build_report, is_allowed,
                     load_allowlist, load_budgets, load_schema,
                     load_sequences, stale_allowlist_findings,
                     validate_findings_report)

__all__ = ["Finding", "apply_allowlist", "build_report", "is_allowed",
           "load_allowlist", "load_budgets", "load_schema",
           "load_sequences", "stale_allowlist_findings",
           "validate_findings_report"]
