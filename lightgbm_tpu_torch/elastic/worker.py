"""One membership epoch's training process.

Port of ``lightgbm_tpu/elastic/worker.py``:
``python -m lightgbm_tpu_torch.elastic.worker <spec.json>``, launched by
the per-host controller once per epoch: one fresh process, and one fresh
process group, per epoch, because a group with a dead peer cannot shrink in
place.

The worker derives its epoch's world from the membership record: a fresh
store (``port_base + epoch``, hosted by the epoch's rank 0),
``num_hosts`` = the survivor count, ``process_id`` = this host's index in
the member list.  It trains to the original round target with
``resume=true`` (the snapshot directory is the host's, stable across
epochs) and exits:

  * 0 — trained to the target; the model and the result JSON written;
  * ``EXIT_RESHAPE`` — a peer died (``RankDeathError``): the next epoch's
    membership was negotiated over the old store and written to the
    verdict file for the controller;
  * ``EXIT_DECLARED_DEAD`` — the negotiation declared this host dead (it
    stalled past the ack deadline);
  * ``EXIT_CONTROL_LOST`` — the anchor or the store is gone; terminal.

After a death the worker never tears its process group down (with NCCL,
``destroy_process_group`` over a dead peer can hang): it writes its
verdict, confirms, and leaves through ``os._exit``.  The card is
``LOCAL_RANK % cards`` (``config.resolve_device``), as for every rank.
"""

from __future__ import annotations

import json
import os
import sys
import time

from .controller import (EXIT_CONTROL_LOST, EXIT_DECLARED_DEAD,
                         EXIT_RESHAPE, write_json)
from .epoch import MembershipEpoch, confirm_record, negotiate_next_epoch


def _quiesce(epoch: MembershipEpoch, host: int, spec: dict) -> None:
    """Leader-last exit on success: the epoch's store lives in rank 0's
    process, so rank 0 lingers until every peer's result file is on disk
    (bounded: on a pod with per-host workdirs this is a grace period)."""
    if epoch.rank_of(host) != 0:
        return
    edir = os.path.dirname(os.path.abspath(spec["result_path"]))
    hosts_root = os.path.dirname(os.path.dirname(edir))
    peers = [os.path.join(hosts_root, f"h{int(h)}", os.path.basename(edir),
                          "result.json")
             for h in epoch.members if int(h) != int(host)]
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if all(os.path.exists(p) for p in peers):
            break
        time.sleep(0.05)


def _recover(spec: dict, epoch: MembershipEpoch, host: int, err) -> None:
    """Negotiate the next membership over the dying epoch's store, write
    the verdict for the controller, and exit."""
    t0 = time.monotonic()
    try:
        record = negotiate_next_epoch(
            epoch, host, err.dead_ranks,
            deadline_s=float(spec.get("negotiate_deadline_s", 20.0)))
    except ConnectionError as e:
        write_json(spec["verdict_path"], {
            "kind": "control_plane_lost", "failed_epoch": epoch.epoch,
            "error": str(e)})
        os._exit(EXIT_CONTROL_LOST)
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
    try:
        dtrain = lt.Dataset(spec["data"], params=params)
        bst = lt.train(params, dtrain,
                       num_boost_round=int(spec["num_boost_round"]),
                       verbose_eval=False)
        bst.save_model(spec["output_model"])
        result = {"ok": True, "epoch": int(epoch.epoch), "rank": rank,
                  "members": list(epoch.members),
                  "iterations": int(bst.current_iteration),
                  "model": spec["output_model"]}
        if params.get("telemetry"):
            result["report"] = bst.get_telemetry()
        write_json(spec["result_path"], result)
        _quiesce(epoch, host, spec)
    except RankDeathError as e:
        _recover(spec, epoch, host, e)  # never returns
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv)
