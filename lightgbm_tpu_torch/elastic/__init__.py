"""Elastic pod training: shrink and continue without an operator.

Port of ``lightgbm_tpu/elastic/``.  It composes three pieces of the port
into a supervised recovery state machine:

  * the per-iteration heartbeat that names a dead rank within the
    collective deadline (``parallel/multihost.py``), a typed
    :class:`~lightgbm_tpu_torch.parallel.multihost.RankDeathError`;
  * crash-safe snapshots and exact resume (``reliability/resume.py``),
    with the world-shape keys kept out of the config fingerprint, so a
    resume after a shrink is accepted (``allow_topology_change``);
  * the placement rules (``parallel/sharding.py``), which lay the same
    learners over whatever ranks the surviving membership has.

A process group cannot shrink in place: after a rank dies, a collective
over the old world fails against the dead peer.  So each membership epoch
is a fresh process group in a fresh worker subprocess, supervised by a
per-host controller (``controller.py``) that never touches a device:

  1. epoch k's workers train; a death surfaces as ``RankDeathError``;
  2. the survivors negotiate epoch k+1's membership over epoch k's store,
     still served by its rank 0 (``epoch.py``), write a verdict file and
     exit with ``EXIT_RESHAPE``;
  3. each controller reads its worker's verdict, enforces the
     ``elastic_max_recoveries`` / ``elastic_min_ranks`` budget, and starts
     a worker for epoch k+1: a new store (port = base + epoch, hosted by
     the new rank 0), the rows re-dealt over the survivors by the
     ``two_round`` loader (``redeal.py``), training resumed from the last
     snapshot to the original round target.

A zombie worker of epoch k cannot poison epoch k+1: the new epoch's store
is at another port, and every verdict and key is generation-stamped.  This
slice runs one rank per host: ``elastic=true`` with ``LOCAL_WORLD_SIZE >
1`` raises (ROADMAP.md Queue A).
"""

from .controller import (EXIT_CONTROL_LOST, EXIT_DECLARED_DEAD,
                         EXIT_RESHAPE, ElasticHostDead, ElasticResult,
                         ElasticTerminalError, run_host)
from .epoch import MembershipEpoch, negotiate_next_epoch

__all__ = ["run_host", "ElasticResult", "ElasticTerminalError",
           "ElasticHostDead", "EXIT_RESHAPE", "EXIT_DECLARED_DEAD",
           "EXIT_CONTROL_LOST", "MembershipEpoch", "negotiate_next_epoch"]
