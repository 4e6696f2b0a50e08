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
is a fresh process group in fresh worker subprocesses, ``L =
LOCAL_WORLD_SIZE`` a host (one a card), supervised by a per-host
controller (``controller.py``) that never touches a device:

  1. epoch k's workers train; a death surfaces as ``RankDeathError``
     naming global ranks, each on host ``members[rank // L]``;
  2. the surviving hosts negotiate epoch k+1's membership over epoch k's
     store, still served by its global rank 0 (``epoch.py``), each through
     its local rank 0, which writes a verdict file; every worker exits
     with ``EXIT_RESHAPE``;
  3. each controller reads its host's verdict, enforces the
     ``elastic_max_recoveries`` / ``elastic_min_ranks`` budget, and starts
     the host's workers for epoch k+1: a new store (port = base + epoch,
     hosted by the new global rank 0), the rows re-dealt over the
     survivors' ``num_hosts * L`` ranks by the ``two_round`` loader
     (``redeal.py``), training resumed from the host's last snapshot to the
     original round target.

The host is the unit of membership, of failure and of re-deal, as a JAX
host is one process: a worker that dies takes its host's other workers
down with it, and a death on host ``members[0]``, whose local rank 0
holds the store, is terminal.  A zombie worker of epoch k cannot poison
epoch k+1: the new epoch's store is at another port, and every verdict
and key is generation-stamped.
"""

from .controller import (EXIT_CONTROL_LOST, EXIT_DECLARED_DEAD,
                         EXIT_RESHAPE, ElasticHostDead, ElasticResult,
                         ElasticTerminalError, run_host)
from .epoch import MembershipEpoch, negotiate_next_epoch

__all__ = ["run_host", "ElasticResult", "ElasticTerminalError",
           "ElasticHostDead", "EXIT_RESHAPE", "EXIT_DECLARED_DEAD",
           "EXIT_CONTROL_LOST", "MembershipEpoch", "negotiate_next_epoch"]
