"""One membership epoch's training process, one a card.

Port of ``lightgbm_tpu/elastic/worker.py``:
``python -m lightgbm_tpu_torch.elastic.worker <spec.json>``, launched by
the per-host controller once per epoch and local rank: ``L`` processes a
host (the spec's ``local_world_size``, ``LOCAL_RANK`` from the
environment), and one fresh process group, per epoch, because a group with
a dead peer cannot shrink in place.

The worker derives its epoch's world from the membership record: a fresh
store (``port_base + epoch``, hosted by the epoch's global rank 0, which
is host ``members[0]``'s local rank 0), ``num_hosts`` = the survivor
count, ``process_id`` = this host's index in the member list, global rank
``process_id * L + LOCAL_RANK``.  It trains to the original round target
with ``resume=true`` (the snapshot directory is the host's, stable across
epochs: the host's local rank 0 writes it and every local rank resumes
from it) and exits:

  * 0 — trained to the target; local rank 0 wrote the model and the
    host's result JSON, every other local rank a result file of its own;
  * ``EXIT_RESHAPE`` — a peer died (``RankDeathError``): the host's local
    rank 0 negotiated the next epoch's membership over the old store and
    wrote it to the verdict file for the controller; the host's other
    ranks leave without a verdict of their own;
  * ``EXIT_DECLARED_DEAD`` — the negotiation declared this host dead (it
    stalled past the ack deadline);
  * ``EXIT_CONTROL_LOST`` — the anchor or the store is gone, or the dead
    rank was on host ``members[0]``, whose local rank 0 holds the store;
    terminal.

The single-writer work of a host (the model, the result and the verdict
files, the record's confirmation) is its local rank 0's: ``L`` writers of
one file race.  After a death the worker never tears its process group
down (with NCCL, ``destroy_process_group`` over a dead peer can hang): it
writes its verdict, confirms, and leaves through ``os._exit``.  The card
is ``LOCAL_RANK % cards`` (``config.resolve_device``), as for every rank.
"""

from __future__ import annotations

import json
import os
import sys
import time

from .controller import (EXIT_CONTROL_LOST, EXIT_DECLARED_DEAD,
                         EXIT_RESHAPE, result_file, write_json)
from .epoch import MembershipEpoch, confirm_record, negotiate_next_epoch


def _quiesce(epoch: MembershipEpoch, host: int, local_rank: int,
             per_host: int, spec: dict) -> None:
    """Leader-last exit on success: the epoch's store lives in global rank
    0's process (host ``members[0]``'s local rank 0), so that process
    lingers until every other rank's result file is on disk (bounded: on a
    pod with per-host workdirs this is a grace period)."""
    if epoch.rank_of(host) != 0 or local_rank != 0:
        return
    edir = os.path.dirname(os.path.abspath(spec["result_path"]))
    hosts_root = os.path.dirname(os.path.dirname(edir))
    peers = [result_file(os.path.join(hosts_root, f"h{int(h)}",
                                      os.path.basename(edir)), lr)
             for h in epoch.members for lr in range(per_host)
             if (int(h), lr) != (int(host), 0)]
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if all(os.path.exists(p) for p in peers):
            break
        time.sleep(0.05)


def _control_lost(spec: dict, epoch: MembershipEpoch, error: str) -> None:
    write_json(spec["verdict_path"], {
        "kind": "control_plane_lost", "failed_epoch": epoch.epoch,
        "error": error})
    os._exit(EXIT_CONTROL_LOST)


def _recover(spec: dict, epoch: MembershipEpoch, host: int, per_host: int,
             err) -> None:
    """Negotiate the next membership over the dying epoch's store, write
    the verdict for the controller, and exit (the host's local rank 0)."""
    t0 = time.monotonic()
    anchor = int(epoch.members[0])
    if any(int(r) // per_host == 0 for r in err.dead_ranks):
        # the store's host is dead by the host rule: its local rank 0, which
        # holds the store, goes down with its siblings, as the JAX
        # package's process 0 takes its coordination service with it
        _control_lost(spec, epoch, f"dead rank(s) {list(err.dead_ranks)} "
                      f"on host {anchor}, which holds epoch {epoch.epoch}'s "
                      f"store: {err}")
    try:
        record = negotiate_next_epoch(
            epoch, host, err.dead_ranks,
            deadline_s=float(spec.get("negotiate_deadline_s", 20.0)),
            ranks_per_host=per_host)
    except ConnectionError as e:
        _control_lost(spec, epoch, str(e))
    write_json(spec["verdict_path"], {
        "kind": "reshape", "failed_epoch": epoch.epoch,
        "dead_ranks": [int(r) for r in err.dead_ranks],
        "error": str(err), "next": record.to_dict(),
        "negotiate_s": time.monotonic() - t0})
    # the verdict is durable: now release the anchor, whose exit takes the
    # store down, so nothing below this line may matter
    if epoch.rank_of(host) != 0:
        try:
            confirm_record(record, host)
        except Exception:
            pass
    if int(host) not in record.members:
        os._exit(EXIT_DECLARED_DEAD)
    os._exit(EXIT_RESHAPE)


def main(argv) -> None:
    with open(argv[1]) as fh:
        spec = json.load(fh)
    epoch = MembershipEpoch.from_dict(spec["membership"])
    host = int(spec["host_id"])
    rank = epoch.rank_of(host)
    per_host = int(spec.get("local_world_size", 1))
    local_rank = int(os.environ.get("LOCAL_RANK", "0") or 0)

    import lightgbm_tpu_torch as lt
    from ..parallel.multihost import RankDeathError

    params = dict(spec["params"])
    params.update({
        "coordinator_address": epoch.coordinator,
        "num_hosts": len(epoch.members),
        "process_id": rank,
        "elastic": True,
        "elastic_epoch": int(epoch.epoch),
        "two_round": True,
        "resume": True,
        "output_model": spec["output_model"],
    })
    params.setdefault("snapshot_freq", 1)
    edir = os.path.dirname(os.path.abspath(spec["result_path"]))
    if local_rank != 0:
        # the host's report is its local rank 0's; another rank keeps its
        # own in the epoch directory (every rank still sets the key, which
        # decides whether the pod runs the clock handshake)
        if params.get("telemetry_out"):
            params["telemetry_out"] = os.path.join(
                edir, f"telemetry.l{local_rank}.json")
        params.pop("telemetry_prom_out", None)
    try:
        dtrain = lt.Dataset(spec["data"], params=params)
        bst = lt.train(params, dtrain,
                       num_boost_round=int(spec["num_boost_round"]),
                       verbose_eval=False)
        result = {"ok": True, "epoch": int(epoch.epoch), "rank": rank,
                  "local_rank": local_rank,
                  "members": list(epoch.members),
                  "iterations": int(bst.current_iteration),
                  "model": spec["output_model"]}
        import torch.distributed as dist
        if dist.is_initialized():
            result.update(global_rank=dist.get_rank(),
                          backend=dist.get_backend())
        if params.get("telemetry"):
            result["report"] = bst.get_telemetry()
        if local_rank == 0:
            bst.save_model(spec["output_model"])
        write_json(result_file(edir, local_rank), result)
        _quiesce(epoch, host, local_rank, per_host, spec)
    except RankDeathError as e:
        if local_rank != 0:
            os._exit(EXIT_RESHAPE)
        _recover(spec, epoch, host, per_host, e)  # never returns
    except ConnectionError as e:
        # the store is unreachable: global rank 0's process is gone
        if local_rank != 0:
            os._exit(EXIT_CONTROL_LOST)
        _control_lost(spec, epoch, str(e))
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv)
