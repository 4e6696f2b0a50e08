"""Per-host elastic agent: one worker subprocess per membership epoch.

Port of ``lightgbm_tpu/elastic/controller.py``.  The controller is the only
long-lived process on a host, and it never touches a device or a process
group (it never initializes CUDA): that lets it outlive a pod whose store
went down with a dead peer.  It runs the epoch state machine of the
package docstring: launch a worker for the current membership, read its
exit, enforce the recovery budget, and launch again for the next epoch
until a worker trains to the original round target.

Structured failures carry the whole epoch history (every membership the
run agreed on, in order), so a post-mortem reads the shrink trajectory
from the exception alone.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .epoch import MembershipEpoch, coordinator_for_epoch

#: the directory that holds the package, for the workers' PYTHONPATH
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: worker exit codes (os._exit — see worker.py)
EXIT_RESHAPE = 43
EXIT_DECLARED_DEAD = 44
EXIT_CONTROL_LOST = 45


class ElasticTerminalError(RuntimeError):
    """Recovery is over: below ``elastic_min_ranks``, past
    ``elastic_max_recoveries``, or the control plane is gone.  ``history``
    is the ordered list of membership-epoch dicts this run lived
    through."""

    def __init__(self, message: str, history: List[Dict[str, Any]]):
        super().__init__(message)
        self.history = list(history)


class ElasticHostDead(RuntimeError):
    """THIS host's worker died (or was declared dead by the survivors) —
    the local controller has nothing left to supervise."""

    def __init__(self, message: str, rc: Optional[int] = None):
        super().__init__(message)
        self.rc = rc


@dataclass
class ElasticResult:
    """A finished elastic run on this host."""

    model_path: str
    history: List[Dict[str, Any]]
    recoveries: int
    ranks_lost: int
    recovery_wall_s: float
    result: Dict[str, Any] = field(default_factory=dict)
    report: Optional[Dict[str, Any]] = None


def write_json(path: str, obj: Any) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
    os.replace(tmp, path)


def _parse_base(params: Dict[str, Any], host_id: int) -> "tuple":
    """(coordinator_host, port_base) from the params: ``elastic_port_base``
    wins, else the port in ``coordinator_address``."""
    addr = str(params.get("coordinator_address", "") or "127.0.0.1:12421")
    host, _, port = addr.rpartition(":")
    base = int(params.get("elastic_port_base", 0) or 0)
    if base <= 0:
        base = int(port)
    return (host or "127.0.0.1"), base


def run_host(params: Dict[str, Any], data: str, num_boost_round: int,
             host_id: int, num_hosts: int, workdir: str,
             worker_env: Optional[Dict[str, str]] = None,
             negotiate_deadline_s: float = 20.0,
             worker_timeout_s: float = 600.0) -> ElasticResult:
    """Supervise this host through every membership epoch until training
    reaches ``num_boost_round`` (the ORIGINAL target — epochs resume, they
    do not extend).  ``data`` must be a file path (the ``from_stream``
    loader is what makes re-dealing possible).  Raises
    :class:`ElasticTerminalError` / :class:`ElasticHostDead` with the
    epoch history on unrecoverable failure."""
    from ..config import not_ported
    from ..observability.trace import TraceRecorder
    from ..parallel.multihost import ELASTIC_LOCAL
    from ..reliability.metrics import rel_inc

    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1") or 1)
    if local > 1:
        raise not_ported(f"elastic=true with LOCAL_WORLD_SIZE={local}",
                         ELASTIC_LOCAL)
    params = dict(params)
    host_id = int(host_id)
    max_recoveries = int(params.get("elastic_max_recoveries", 3))
    min_ranks = int(params.get("elastic_min_ranks", 1))
    coord_host, port_base = _parse_base(params, host_id)
    params["elastic_port_base"] = port_base

    hostdir = os.path.join(workdir, f"h{host_id}")
    os.makedirs(hostdir, exist_ok=True)
    output_model = os.path.join(hostdir, "model.txt")

    epoch = MembershipEpoch(
        epoch=0, members=list(range(int(num_hosts))),
        coordinator=coordinator_for_epoch(coord_host, port_base, 0))
    history: List[Dict[str, Any]] = [epoch.to_dict()]
    recoveries = 0
    ranks_lost = 0
    recovery_wall_s = 0.0
    tracer = TraceRecorder(True, capacity=4096)
    tracer.set_metadata(elastic_host=host_id)

    while True:
        edir = os.path.join(hostdir, f"e{epoch.epoch}")
        os.makedirs(edir, exist_ok=True)
        spec = {
            "params": params, "data": data,
            "num_boost_round": int(num_boost_round),
            "membership": epoch.to_dict(), "host_id": host_id,
            "output_model": output_model,
            "verdict_path": os.path.join(edir, "verdict.json"),
            "result_path": os.path.join(edir, "result.json"),
            "negotiate_deadline_s": float(negotiate_deadline_s),
        }
        spec_path = os.path.join(edir, "spec.json")
        write_json(spec_path, spec)
        env = dict(os.environ)
        env.update(worker_env or {})
        # the worker imports this package however this process found it
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
        log_path = os.path.join(edir, "worker.log")
        with tracer.span("elastic.epoch", cat="elastic",
                         args={"epoch": epoch.epoch,
                               "members": list(epoch.members)}):
            with open(log_path, "w") as log:
                proc = subprocess.Popen(
                    [sys.executable, "-m",
                     "lightgbm_tpu_torch.elastic.worker", spec_path],
                    env=env, stdout=log, stderr=subprocess.STDOUT)
                try:
                    rc = proc.wait(timeout=float(worker_timeout_s))
                except subprocess.TimeoutExpired:
                    rc = None
                finally:
                    # reap-on-epoch-teardown: a timed-out (or any
                    # still-running) worker is killed AND waited here, so
                    # no epoch leaves a zombie behind for the next one
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()

        def _tail(n: int = 2000) -> str:
            try:
                with open(log_path) as fh:
                    return fh.read()[-n:]
            except OSError:
                return ""

        if rc == 0:
            with open(spec["result_path"]) as fh:
                result = json.load(fh)
            res = ElasticResult(
                model_path=output_model, history=history,
                recoveries=recoveries, ranks_lost=ranks_lost,
                recovery_wall_s=recovery_wall_s, result=result,
                report=result.get("report"))
            _finalize_observability(params, host_id, res, tracer)
            return res

        # the verdict file outranks the exit code: the worker makes its
        # verdict durable before it releases the epoch's anchor, whose exit
        # takes the store down under any peer still winding down, so a
        # dirty rc with a readable verdict is a normal transition
        try:
            with open(spec["verdict_path"]) as fh:
                verdict = json.load(fh)
        except (OSError, ValueError) as e:
            verdict = None
            if rc == EXIT_RESHAPE:
                raise ElasticHostDead(
                    f"host {host_id}: epoch {epoch.epoch} worker exited "
                    f"EXIT_RESHAPE but left no readable verdict ({e}); "
                    f"log tail: {_tail()}", rc=rc)

        if verdict is not None and verdict.get("kind") == "reshape":
            t0 = time.monotonic()
            nxt = MembershipEpoch.from_dict(verdict["next"])
            nxt.coordinator = coordinator_for_epoch(coord_host, port_base,
                                                    nxt.epoch)
            lost = len(epoch.members) - len(nxt.members)
            recoveries += 1
            ranks_lost += lost
            rel_inc("elastic.recoveries")
            rel_inc("elastic.ranks_lost", max(lost, 0))
            history.append(nxt.to_dict())
            negotiate_s = float(verdict.get("negotiate_s", 0.0))
            recovery_wall_s += negotiate_s + (time.monotonic() - t0)
            tracer.add_complete(
                "elastic.recovery", time.perf_counter() - negotiate_s,
                negotiate_s + (time.monotonic() - t0), cat="elastic",
                args={"failed_epoch": epoch.epoch,
                      "dead_hosts": nxt.dead_hosts,
                      "next_members": list(nxt.members)})
            if len(nxt.members) < min_ranks:
                raise ElasticTerminalError(
                    f"host {host_id}: epoch {nxt.epoch} has "
                    f"{len(nxt.members)} rank(s), below elastic_min_ranks="
                    f"{min_ranks} — terminal. Epoch history: "
                    f"{json.dumps(history)}", history)
            if recoveries > max_recoveries:
                raise ElasticTerminalError(
                    f"host {host_id}: recovery #{recoveries} exceeds "
                    f"elastic_max_recoveries={max_recoveries} — terminal. "
                    f"Epoch history: {json.dumps(history)}", history)
            if host_id not in nxt.members:
                raise ElasticHostDead(
                    f"host {host_id} is not in epoch {nxt.epoch}'s "
                    f"membership {nxt.members} — declared dead", rc=rc)
            epoch = nxt
            continue

        if rc not in (EXIT_DECLARED_DEAD, EXIT_CONTROL_LOST, None):
            # a dirty exit after finishing (the store lives in rank 0's
            # worker, and a teardown while peers disconnect can kill a
            # process after its work is on disk): the controller reads
            # results, not exits, and a complete ok-result is a success
            try:
                with open(spec["result_path"]) as fh:
                    result = json.load(fh)
            except (OSError, ValueError):
                result = None
            if result and result.get("ok"):
                rel_inc("elastic.dirty_exits")
                res = ElasticResult(
                    model_path=output_model, history=history,
                    recoveries=recoveries, ranks_lost=ranks_lost,
                    recovery_wall_s=recovery_wall_s, result=result,
                    report=result.get("report"))
                _finalize_observability(params, host_id, res, tracer)
                return res

        if rc == EXIT_DECLARED_DEAD:
            raise ElasticHostDead(
                f"host {host_id} was declared dead during the epoch "
                f"{epoch.epoch} -> {epoch.epoch + 1} negotiation (stalled "
                f"past the ack deadline). Epoch history: "
                f"{json.dumps(history)}", rc=rc)
        if rc == EXIT_CONTROL_LOST or (
                verdict is not None
                and verdict.get("kind") == "control_plane_lost"):
            raise ElasticTerminalError(
                f"host {host_id}: control plane lost during epoch "
                f"{epoch.epoch} recovery (anchor or its store "
                f"dead). Epoch history: {json.dumps(history)}", history)
        raise ElasticHostDead(
            f"host {host_id}: epoch {epoch.epoch} worker "
            f"{'timed out' if rc is None else f'died (rc={rc})'}; "
            f"log tail: {_tail()}", rc=rc)


def _finalize_observability(params: Dict[str, Any], host_id: int,
                            res: ElasticResult, tracer) -> None:
    """Inject the ``elastic`` section into the worker's telemetry report
    and export the controller's recovery spans — both opt-in via the same
    config keys the engine honors (``telemetry_out`` / ``trace_out``)."""
    final = res.history[-1]
    section = {
        "epochs": len(res.history),
        "epoch": int(final["epoch"]),
        "members": list(final["members"]),
        "recoveries": int(res.recoveries),
        "ranks_lost": int(res.ranks_lost),
        "recovery_wall_s": float(res.recovery_wall_s),
    }
    if res.report is not None:
        counters = (res.report.get("reliability", {}) or {}) \
            .get("counters", {})
        section["redeal_rows"] = int(
            counters.get("elastic.redeal_rows", 0))
        res.report["elastic"] = section
        out = params.get("telemetry_out")
        if out:
            write_json(str(out), res.report)
    res.result["elastic"] = section
    trace_out = params.get("trace_out")
    if trace_out:
        try:
            tracer.save(f"{trace_out}.elastic_h{host_id}")
        except OSError:
            pass
