"""Crash-safe training resume: snapshot discovery, validation, retention.

Port of ``lightgbm_tpu/reliability/resume.py``.  ``snapshot_freq > 0``
makes ``engine.train`` checkpoint the model text to
``<output_model>.snapshot_iter_<k>`` (atomically: ``save_model_to_file``
writes a temporary file and renames it) with two sidecars: a JSON one
recording the iteration and fingerprints of the training-semantics config
and of the world shape, and a state one holding exactly what the next
iteration reads besides the trees: the training and validation score
tensors in their own dtype, copied from the device, and the state of
every random stream the boosting loop carries from one iteration to the
next (``RNG_ATTRS``: numpy ``RandomState``s; GOSS seeds a
``torch.Generator`` afresh every iteration, so none is carried).  A
killed run relaunched with ``resume=true`` (``--resume``) finds the newest
snapshot that parses as a complete model and fingerprints to the same
config, continues from it and trains only the remaining iterations: the
model text equals an uninterrupted run's of the same loop
(``tests/test_torch_resume.py``).

Validation is deliberately paranoid: a truncated file, a stale snapshot
from a different config, or a missing trailer falls through to the
next-newest candidate (with a warning) instead of resuming into a subtly
wrong model.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import pickle
import re
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch

from .metrics import rel_inc

_SNAP_RE = re.compile(r"\.snapshot_iter_(\d+)$")
META_SUFFIX = ".meta.json"
STATE_SUFFIX = ".state.pkl"

#: config fields that describe the world shape, not the training semantics;
#: hashed apart (``topology_fingerprint``) as in the JAX package
_TOPOLOGY_KEYS = frozenset({
    "coordinator_address", "num_hosts", "process_id", "num_machines",
    "parallel_mesh", "tree_learner",
})

#: config fields with no bearing on what the trained trees look like;
#: everything else (objective, rates, bin config, learner knobs, seeds,
#: the device) is in the fingerprint
_VOLATILE_KEYS = frozenset({
    "task", "output_model", "output_result", "input_model", "convert_model",
    "convert_model_language", "resume", "snapshot_freq", "snapshot_keep",
    "verbosity", "metric_freq", "telemetry", "telemetry_out",
    "telemetry_sync_every", "telemetry_prom_out",
    "profile_trace_dir", "fault_spec", "num_iterations", "num_threads",
    "time_out", "machine_list_filename", "machines", "local_listen_port",
    "net_max_frame_mb", "net_collective_deadline_s",
    "serve_host", "serve_port", "serve_max_batch_rows", "serve_deadline_ms",
    "serve_min_bucket", "serve_warmup", "serve_max_inflight",
    "serve_stats_out", "serve_stats_interval", "serve_replicas",
    "serve_recovery_s",
    "trace_out", "trace_capacity",
    "lifecycle_record_rows", "lifecycle_metric", "lifecycle_metric_floor",
    "lifecycle_divergence_max", "lifecycle_latency_max_ratio",
    "lifecycle_min_shadow_rows", "lifecycle_rollback_deadline_s",
    "lifecycle_watch_interval_s", "lifecycle_error_rate_max",
    "lifecycle_shed_rate_max",
    "is_parallel", "is_parallel_find_bin", "_FIELD_TYPES",
    "elastic", "elastic_max_recoveries", "elastic_min_ranks",
    "elastic_epoch", "elastic_port_base",
})

#: the boosting loop's random streams (``GBDT`` attributes; DART's drops)
RNG_ATTRS = ("_bag_rng", "_feat_rng", "_drop_rng")


def _hash(d: Dict[str, Any]) -> str:
    blob = json.dumps(d, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def config_fingerprint(cfg) -> str:
    """Hash of the training-semantics subset of a ``Config``
    (``num_iterations`` is out, so a resumed run may extend the rounds)."""
    d = {k: v for k, v in cfg.to_dict().items()
         if k not in _VOLATILE_KEYS and k not in _TOPOLOGY_KEYS}
    return _hash(d)


def topology_fingerprint(cfg) -> str:
    """Hash of the world-shape subset of a ``Config``; a mismatch refuses
    the snapshot, but for an elastic resume."""
    d = {k: getattr(cfg, k, None) for k in sorted(_TOPOLOGY_KEYS)}
    return _hash(d)


def snapshot_path(output_model: str, iteration: int) -> str:
    return f"{output_model}.snapshot_iter_{int(iteration)}"


def list_snapshots(output_model: str) -> List[Tuple[int, str]]:
    """All ``<output_model>.snapshot_iter_*`` files as (iteration, path),
    by iteration ascending."""
    out: List[Tuple[int, str]] = []
    for p in glob.glob(glob.escape(output_model) + ".snapshot_iter_*"):
        m = _SNAP_RE.search(p)
        if m:
            out.append((int(m.group(1)), p))
    out.sort()
    return out


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, path)


def write_snapshot_meta(path: str, iteration: int, cfg) -> None:
    meta = {"iteration": int(iteration),
            "config_fingerprint": config_fingerprint(cfg),
            "topology_fingerprint": topology_fingerprint(cfg)}
    _atomic_write(path + META_SUFFIX, json.dumps(meta).encode())


def snapshot_state(gbdt) -> Dict[str, Any]:
    """The exact-continuation sidecar's content: the score tensors as numpy
    arrays of their own dtype (the training score gathered from every
    rank's rows under a parallel mode: a collective every rank makes) and
    the random streams' states."""
    return {
        "iter": int(gbdt.iter_),
        "score": gbdt._global(gbdt.train_score.score, "score").cpu().numpy(),
        "valid_scores": [vs.score.cpu().numpy()
                         for vs in gbdt.valid_scores],
        "rngs": {a: getattr(gbdt, a).get_state() for a in RNG_ATTRS
                 if getattr(gbdt, a, None) is not None},
    }


def write_snapshot_state(path: str, gbdt, state=None) -> None:
    """The exact-continuation sidecar (``snapshot_state``).  The model text
    alone resumes too, but replaying scores by traversal adds in another
    order and moves a float32 score by an ulp; the live scores make the
    resumed model text equal an uninterrupted run's."""
    if state is None:
        state = snapshot_state(gbdt)
    _atomic_write(path + STATE_SUFFIX,
                  pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL))


def load_snapshot_state(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path + STATE_SUFFIX, "rb") as fh:
            return pickle.load(fh)
    except (OSError, pickle.UnpicklingError, EOFError, ValueError):
        return None


def restore_training_state(gbdt, state: Dict[str, Any]) -> bool:
    """Overwrite the replayed scores and the random streams with the
    snapshot's.  Returns False, leaving the replayed scores, when a score's
    shape differs (a resume against other data)."""
    cur = gbdt.train_score.score
    score = state.get("score")
    # the whole score under a parallel mode, of which a rank keeps its rows
    shape = (cur.shape[0], gbdt.train_data.num_data_padded)
    if score is not None and tuple(score.shape) != shape:
        warnings.warn(f"snapshot score state shape {score.shape} != "
                      f"{tuple(cur.shape)}; resuming from the replayed "
                      f"score instead")
        return False
    if score is not None:
        cur.copy_(gbdt._local(torch.from_numpy(score), "score"))
    valid = state.get("valid_scores") or []
    if len(valid) == len(gbdt.valid_scores) and all(
            tuple(v.shape) == tuple(vs.score.shape)
            for v, vs in zip(valid, gbdt.valid_scores)):
        for v, vs in zip(valid, gbdt.valid_scores):
            vs.score.copy_(torch.from_numpy(v))
    for attr, saved in (state.get("rngs") or {}).items():
        rng = getattr(gbdt, attr, None)
        if rng is not None:
            rng.set_state(saved)
    return True


def _validate(path: str, fingerprint: Optional[str] = None,
              topology: Optional[str] = None,
              allow_topology_change: bool = False
              ) -> Tuple[bool, str, str]:
    """(ok, kind, reason); ``kind`` is the rejection class the reliability
    counters key on (``unreadable``, ``truncated``, ``sidecar_unreadable``,
    ``fingerprint_mismatch``, ``topology_mismatch``).  With
    ``allow_topology_change`` (an elastic resume) a world-shape mismatch is
    accepted as ``kind == "topology_changed"``, for the caller to warn and
    count."""
    try:
        with open(path) as fh:
            text = fh.read()
    except OSError as e:
        return False, "unreadable", f"unreadable: {e}"
    if "end of trees" not in text:
        return False, "truncated", \
            "truncated model text (no 'end of trees' trailer)"
    meta_path = path + META_SUFFIX
    if fingerprint is not None:
        if not os.path.exists(meta_path):
            warnings.warn(f"snapshot {path} has no metadata sidecar; "
                          f"resuming without a config-fingerprint check")
            return True, "ok", "ok"
        try:
            with open(meta_path) as fh:
                meta = json.load(fh)
        except (OSError, ValueError) as e:
            return False, "sidecar_unreadable", f"unreadable sidecar: {e}"
        got = meta.get("config_fingerprint")
        if got != fingerprint:
            return False, "fingerprint_mismatch", \
                (f"config fingerprint mismatch (snapshot {got}, current "
                 f"{fingerprint})")
        got_topo = meta.get("topology_fingerprint")
        if topology is not None and got_topo is not None \
                and got_topo != topology:
            if not allow_topology_change:
                return False, "topology_mismatch", \
                    (f"world-shape fingerprint mismatch (snapshot "
                     f"{got_topo}, current {topology}) — this is not an "
                     f"elastic run; refusing to resume a model trained "
                     f"under a different topology")
            return True, "topology_changed", \
                (f"topology changed (snapshot {got_topo}, current "
                 f"{topology}) — accepted for elastic resume")
    return True, "ok", "ok"


def validate_snapshot(path: str,
                      fingerprint: Optional[str] = None) -> Tuple[bool, str]:
    """(ok, reason): the model text is complete (its ``end of trees``
    trailer) and, given a ``fingerprint`` and a sidecar, the sidecar's
    fingerprint matches.  A missing sidecar is accepted with a warning."""
    ok, _kind, reason = _validate(path, fingerprint)
    return ok, reason


def find_resume_snapshot(output_model: str,
                         cfg=None) -> Optional[Tuple[int, str]]:
    """The newest valid snapshot of ``output_model`` as (iteration, path),
    or None.  Invalid ones are skipped newest first with a warning naming
    the reason, each rejection counted in the reliability counters
    (``snapshots_rejected.<kind>``).  An ``elastic`` config accepts a
    snapshot of another world shape (JAX `resume.py:188-270`), with a
    warning and ``snapshots_resumed_after_shrink``."""
    if not output_model:
        return None
    fp = config_fingerprint(cfg) if cfg is not None else None
    topo = topology_fingerprint(cfg) if cfg is not None else None
    elastic = bool(getattr(cfg, "elastic", False))
    for iteration, path in reversed(list_snapshots(output_model)):
        ok, kind, reason = _validate(path, fp, topology=topo,
                                     allow_topology_change=elastic)
        if ok:
            if kind == "topology_changed":
                warnings.warn(f"elastic resume from {path}: {reason}")
                rel_inc("snapshots_resumed_after_shrink")
            return iteration, path
        warnings.warn(f"skipping snapshot {path}: {reason}")
        rel_inc("snapshots_rejected")
        rel_inc(f"snapshots_rejected.{kind}")
    return None


def prune_snapshots(output_model: str, keep: int) -> List[str]:
    """Delete all but the newest ``keep`` snapshots and their sidecars
    (``keep <= 0`` keeps everything); returns the removed paths."""
    if keep <= 0:
        return []
    removed: List[str] = []
    snaps = list_snapshots(output_model)
    for _it, path in snaps[:max(len(snaps) - keep, 0)]:
        for p in (path, path + META_SUFFIX, path + STATE_SUFFIX):
            try:
                os.unlink(p)
                if p == path:
                    removed.append(p)
            except OSError:
                pass
    if removed:
        rel_inc("snapshots_pruned", len(removed))
    return removed


def save_snapshot(gbdt, output_model: str, iteration: int, cfg) -> str:
    """Flush the pipelined loop's queued trees (else the text would miss
    trees the score holds), then write the snapshot, its sidecars and the
    retention in one call."""
    from ..parallel import multihost
    from ..parallel.sharding import is_primary
    gbdt._flush_pending()
    path = snapshot_path(output_model, iteration)
    state = snapshot_state(gbdt)
    # every rank gathers the score; rank 0 writes, and in a pod the first
    # rank of every host, so each host resumes from its own disk
    writer = multihost.host_rank() == 0 if multihost.is_initialized() \
        else is_primary()
    if not writer:
        return path
    gbdt.save_model_to_file(path)
    write_snapshot_meta(path, iteration, cfg)
    write_snapshot_state(path, gbdt, state)
    rel_inc("snapshots_written")
    prune_snapshots(output_model, int(getattr(cfg, "snapshot_keep", 0)))
    return path
