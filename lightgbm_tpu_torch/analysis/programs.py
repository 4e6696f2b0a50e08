"""The sharded programs, run once per gate run: collective budgets, pinned
orders, and the same order across mesh factorizations.

Port of the program set and budgets of ``lightgbm_tpu/analysis/
jaxpr_lint.py`` and of the sequence checks of ``analysis/spmd.py``.  The
JAX package traces each sharded learner's tree step to a jaxpr once per
gate run and walks its collectives; the port's learners are eager Python
over a ``torch.distributed`` group, so the port *runs* each program once
per gate run, one tree at the fixture size on a ``parallel/launch.py``
rank pool (gloo, on the CPU), with ``Mesh.log`` set: every ``Mesh``
collective recorded in the order it ran as (op, axis, dtype, payload
bytes, issuing site).  Every check shares that one record:

  * **budgets** — per program and op, the calls of the tree, the distinct
    issuing sites and the payload bytes may not exceed ``budgets.json``
    (``collective-budget`` / ``collective-sites`` / ``collective-payload``);
    a new collective must raise the pin in the same commit;
  * **sequences** — rank 0's ordered list of (op, axis, dtype, bytes) must
    equal ``sequences.json`` (``collective-order``): a collective that
    moves with the count unchanged is invisible to budgets and still hangs
    a pod when only some ranks take the new path;
  * **rank agreement** — every rank issued the same (op, axis, dtype)
    order (``collective-order-ranks``);
  * **cross-factorization** — ``data`` at 2 and at 4 ranks issues the same
    (op, axis) order (``collective-order-factorization``);
  * **quantized exchange** — the quantized ``data`` program's
    ``psum_scatter`` bytes are at most half the float32 program's
    (``quant-exchange-payload``: the int16 wire tier engaged).

The pins are the port's own: a record is the order calls ran, where a
jaxpr holds a loop body once, so the JAX package's numbers do not carry
over (``tests/test_torch_parallel.py::test_collective_sites_equal_jax_report``
holds the data learner's site set equal to the JAX report's).  The JAX
pass's float64-leak, host-callback and baked-constant rules read jaxpr
primitives and have no eager counterpart; they are not ported.
``--dump-budgets`` / ``--dump-sequences`` re-derive both files
byte-identically from the record.
"""

from __future__ import annotations

import fnmatch
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .common import (BUDGETS_PATH, SEQUENCES_PATH, Finding, dump_json,
                     load_budgets, load_sequences)

#: program -> (tree_learner mode, learner class, mesh shape, extra params)
PROGRAMS: Dict[str, Tuple[str, str, Tuple[int, ...], Dict[str, Any]]] = {
    "wave_sharded_data": ("data", "ShardedWaveLearner", (2,), {}),
    "wave_sharded_data_quant": ("data", "ShardedWaveLearner", (2,),
                                {"tpu_quantized_grad": "on"}),
    "wave_sharded_voting": ("voting", "ShardedVotingWaveLearner", (2,), {}),
    "wave_feature": ("feature", "FeatureShardedWaveLearner", (2,), {}),
    "wave_sharded_data_4": ("data", "ShardedWaveLearner", (4,), {}),
    "wave_sharded_2d": ("data_feature", "ShardedWave2DLearner", (2, 2), {}),
}

_MODULES = {"ShardedWaveLearner": "wave_sharded",
            "ShardedVotingWaveLearner": "wave_sharded",
            "FeatureShardedWaveLearner": "feature_sharded",
            "ShardedWave2DLearner": "wave2d_sharded"}

#: program -> the source file a finding anchors to (and whose change
#: selects the program under ``--changed-only``)
PROGRAM_FILES = {
    name: "lightgbm_tpu_torch/parallel/%s.py" % _MODULES[cls]
    for name, (_, cls, _, _) in PROGRAMS.items()}
PROGRAM_FILES["wave_sharded_data_quant"] = \
    "lightgbm_tpu_torch/parallel/compact_sharded.py"

#: mode -> the programs that are the SAME learner at different mesh
#: factorizations; their (op, axis) order must be identical
FACTORIZATION_GROUPS = {"data": ("wave_sharded_data", "wave_sharded_data_4")}

#: the toy problem: the JAX gate's (``jaxpr_lint._toy_dataset(2048, 8)``)
ROWS, FEATURES = 2048, 8
BASE_PARAMS = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
               "verbosity": -1, "enable_bundle": False, "device_type": "cpu"}

#: the entry fields a sequence pins (the site is counted, never pinned:
#: it moves with every edit above it)
SEQ_FIELDS = ("op", "axis", "dtype", "bytes")


def _problem():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((ROWS, FEATURES))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    return X, y


def _grads(y: np.ndarray, n_pad: int):
    """Binary-logloss-shaped gradients on a 1/64 grid (|g| <= 1, h in
    [1/64, 1/4]): every float32 sum of 2,048 of them is exact, so the tree,
    and with it the collective schedule, is the same at any
    factorization."""
    rng = np.random.default_rng(1)
    n = len(y)
    grad = np.zeros(n_pad, np.float32)
    hess = np.zeros(n_pad, np.float32)
    bag = np.zeros(n_pad, np.float32)
    grad[:n] = (0.5 - y) * rng.integers(32, 65, n) / 32.0
    hess[:n] = rng.integers(1, 17, n) / 64.0
    bag[:n] = 1.0
    return grad, hess, bag


def record_program(name: str) -> Dict[str, Any]:
    """One rank's run of program ``name`` (a ``RankPool`` task): one tree
    grown with the mesh's log on; the ordered record and the seconds."""
    import importlib

    import torch

    import lightgbm_tpu_torch as lt
    from ..config import Config
    from ..parallel.sharding import make_mesh, rules_for_mode

    mode, cls_name, shape, extra = PROGRAMS[name]
    params = dict(BASE_PARAMS, tree_learner=mode, **extra)
    X, y = _problem()
    data = lt.Dataset(X, label=y, params=params).construct().constructed
    cfg = Config.from_params(params)
    mesh = make_mesh(shape=shape) if len(shape) > 1 else make_mesh(shape[0])
    cls = getattr(importlib.import_module(
        "lightgbm_tpu_torch.parallel." + _MODULES[cls_name]), cls_name)
    dev = torch.device("cpu")
    learner = cls(cfg, data, mesh, dev)
    rules = rules_for_mode(learner._placement_mode, mesh)
    g, h, b = (rules.place("grad", torch.from_numpy(a))
               for a in _grads(y, int(data.num_data_padded)))
    mesh.log = []
    t0 = time.perf_counter()
    learner.grow(g, h, b)
    seconds = time.perf_counter() - t0
    log, mesh.log = mesh.log, None
    return {"log": log, "seconds": seconds}


class ProgramRecords:
    """One run of the program set, shared by every check of a gate run:
    ``logs`` maps program -> every rank's ordered record, ``seconds`` the
    run's wall time, ``skipped`` programs not run -> reason."""

    def __init__(self) -> None:
        self.logs: Dict[str, List[List[Dict[str, Any]]]] = {}
        self.seconds: Dict[str, float] = {}
        self.skipped: Dict[str, str] = {}


def run_programs(glob: Optional[str] = None, only: Optional[set] = None,
                 timeout_s: float = 300.0) -> ProgramRecords:
    """Run the selected programs once, each rank count on one pool
    (``--programs GLOB`` narrows the set; ``only``, a set of names, is
    the ``--changed-only`` narrowing, the rest skipped with a reason)."""
    from ..parallel.launch import RankPool

    recs = ProgramRecords()
    by_world: Dict[int, List[str]] = {}
    for name in sorted(PROGRAMS):
        if glob and not fnmatch.fnmatch(name, glob):
            recs.skipped[name] = f"not selected by --programs {glob!r}"
        elif only is not None and name not in only:
            recs.skipped[name] = "source file unchanged under --changed-only"
        else:
            world = int(np.prod(PROGRAMS[name][2]))
            by_world.setdefault(world, []).append(name)
    for world, names in sorted(by_world.items()):
        with RankPool(world, "gloo", timeout_s=timeout_s) as pool:
            for name in names:
                t0 = time.perf_counter()
                outs = pool.run(record_program, name, timeout_s=timeout_s)
                recs.seconds[name] = time.perf_counter() - t0
                recs.logs[name] = [o["log"] for o in outs]
    return recs


# -- the record's views -------------------------------------------------------

def sequence(log: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The pinned view of one rank's record: (op, axis, dtype, bytes)."""
    return [{k: e[k] for k in SEQ_FIELDS} for e in log]


def order_signature(log: Sequence[Dict[str, Any]]
                    ) -> List[Tuple[str, str]]:
    """The factorization-invariant view: (op, axis) in order."""
    return [(e["op"], e["axis"]) for e in log]


def stats(log: Sequence[Dict[str, Any]]) -> Dict[str, Dict[str, int]]:
    """Per op: the calls, the distinct issuing sites, the payload bytes."""
    calls: Dict[str, int] = {}
    sites: Dict[str, set] = {}
    nbytes: Dict[str, int] = {}
    for e in log:
        calls[e["op"]] = calls.get(e["op"], 0) + 1
        sites.setdefault(e["op"], set()).add(e["site"])
        nbytes[e["op"]] = nbytes.get(e["op"], 0) + int(e["bytes"])
    return {"calls": dict(sorted(calls.items())),
            "sites": {k: len(v) for k, v in sorted(sites.items())},
            "bytes": dict(sorted(nbytes.items()))}


def budgets_from(recs: ProgramRecords) -> Dict[str, Any]:
    """The ``budgets.json`` payload pinning the current record."""
    return {
        "_comment": "Per-program collective budgets of one tree, from the "
                    "recorded runs (rank 0): calls, distinct issuing sites "
                    "and payload bytes per op. A learner change that adds "
                    "a collective MUST raise its budget here (python -m "
                    "lightgbm_tpu_torch.analysis --dump-budgets), in the "
                    "same commit, with the why in the commit message.",
        "programs": {name: stats(logs[0])
                     for name, logs in sorted(recs.logs.items())},
    }


def sequences_from(recs: ProgramRecords) -> Dict[str, Any]:
    """The ``sequences.json`` payload pinning the current order."""
    return {
        "_comment": "Per-program ordered collectives of one tree (op, mesh "
                    "axis, operand dtype, payload bytes), in the order rank "
                    "0 issued them. Every rank must issue these in exactly "
                    "this order; a change that moves or reshapes a "
                    "collective MUST regenerate this file (python -m "
                    "lightgbm_tpu_torch.analysis --dump-sequences) in the "
                    "same commit, with the why in the commit message.",
        "programs": {name: sequence(logs[0])
                     for name, logs in sorted(recs.logs.items())},
    }


def dump_budgets(recs: ProgramRecords, path: str = BUDGETS_PATH) -> None:
    dump_json(budgets_from(recs), path)


def dump_sequences(recs: ProgramRecords, path: str = SEQUENCES_PATH) -> None:
    dump_json(sequences_from(recs), path)


# -- the checks ---------------------------------------------------------------

def check_budgets(recs: ProgramRecords,
                  budgets: Optional[Dict[str, Any]] = None) -> List[Finding]:
    if budgets is None:
        budgets = load_budgets()
    pinned = budgets.get("programs", {})
    out: List[Finding] = []
    rules = (("calls", "collective-budget", "call(s)"),
             ("sites", "collective-sites", "issuing site(s)"),
             ("bytes", "collective-payload", "payload bytes"))
    for name, logs in sorted(recs.logs.items()):
        file = PROGRAM_FILES[name]
        if name not in pinned:
            out.append(Finding(
                "programs", "collective-budget", file,
                f"program {name!r} has no budget in analysis/budgets.json "
                f"— run --dump-budgets and commit the diff", symbol=name))
            continue
        got = stats(logs[0])
        for key, rule, what in rules:
            caps = pinned[name].get(key, {})
            for op, n in sorted(got[key].items()):
                cap = int(caps.get(op, 0))
                if n > cap:
                    out.append(Finding(
                        "programs", rule, file,
                        f"program {name!r} issues {n} {op} {what} in one "
                        f"tree, budget allows {cap} — a new collective "
                        f"must raise analysis/budgets.json explicitly",
                        symbol=name))
    return out


def _first_divergence(want: Sequence[Dict[str, Any]],
                      got: Sequence[Dict[str, Any]]) -> str:
    for i, (w, g) in enumerate(zip(want, got)):
        if w != g:
            return (f"collective {i}: pinned {_fmt(w)}, ran {_fmt(g)}")
    return f"pinned {len(want)} collective(s), ran {len(got)}"


def _fmt(e: Dict[str, Any]) -> str:
    return "%s@%s %s %dB" % (e["op"], e["axis"], e["dtype"], e["bytes"])


def check_sequences(recs: ProgramRecords,
                    sequences: Optional[Dict[str, Any]] = None
                    ) -> List[Finding]:
    """Rank 0's order against ``sequences.json`` (``collective-order``),
    and every rank's (op, axis, dtype) order against rank 0's
    (``collective-order-ranks``)."""
    if sequences is None:
        sequences = load_sequences()
    pinned = sequences.get("programs", {})
    out: List[Finding] = []
    for name, logs in sorted(recs.logs.items()):
        file = PROGRAM_FILES[name]
        got = sequence(logs[0])
        want = pinned.get(name)
        if want is None:
            out.append(Finding(
                "programs", "collective-order", file,
                f"program {name!r} has no pinned sequence in "
                f"analysis/sequences.json — run --dump-sequences and "
                f"commit the diff", symbol=name))
        elif got != want:
            out.append(Finding(
                "programs", "collective-order", file,
                f"program {name!r} collective order diverges from "
                f"analysis/sequences.json ({_first_divergence(want, got)})"
                f" — every rank must issue the same collectives in the "
                f"same order; a reviewed change must regenerate "
                f"sequences.json in the same commit", symbol=name))
        ref = [(e["op"], e["axis"], e["dtype"]) for e in logs[0]]
        for r, log in enumerate(logs[1:], 1):
            if [(e["op"], e["axis"], e["dtype"]) for e in log] != ref:
                out.append(Finding(
                    "programs", "collective-order-ranks", file,
                    f"program {name!r}: rank {r} issued another collective "
                    f"order than rank 0 ({len(log)} vs {len(ref)} calls) — "
                    f"a rank that enters a collective its peers never "
                    f"reach hangs the group", symbol=name))
    return out


def cross_factorization_findings(recs: ProgramRecords,
                                 groups: Optional[Dict[str, Tuple[str, ...]]]
                                 = None) -> List[Finding]:
    """Within each mode, every factorization run issues the identical
    (op, axis) order; shard widths (bytes) may differ."""
    if groups is None:
        groups = FACTORIZATION_GROUPS
    out: List[Finding] = []
    for mode, names in sorted(groups.items()):
        have = [(n, order_signature(recs.logs[n][0]))
                for n in names if n in recs.logs]
        if len(have) < 2:
            continue
        ref_name, ref = have[0]
        for name, sig in have[1:]:
            if sig == ref:
                continue
            detail = "differing length" if len(sig) != len(ref) else next(
                f"collective {i}: {a} vs {b}"
                for i, (a, b) in enumerate(zip(ref, sig)) if a != b)
            out.append(Finding(
                "programs", "collective-order-factorization",
                PROGRAM_FILES.get(name, "lightgbm_tpu_torch"),
                f"mode {mode!r}: programs {ref_name!r} and {name!r} are the "
                f"same learner at different mesh factorizations but issue "
                f"different collective orders ({detail}) — the schedule "
                f"must be mesh-shape-invariant", symbol=name))
    return out


def quant_payload_findings(recs: ProgramRecords) -> List[Finding]:
    """The quantized data program's histogram exchange moves at most half
    the float32 program's ``psum_scatter`` bytes."""
    if "wave_sharded_data_quant" not in recs.logs or \
            "wave_sharded_data" not in recs.logs:
        return []
    qb = stats(recs.logs["wave_sharded_data_quant"][0])["bytes"] \
        .get("psum_scatter", 0)
    fb = stats(recs.logs["wave_sharded_data"][0])["bytes"] \
        .get("psum_scatter", 0)
    if fb and 2 * qb <= fb:
        return []
    return [Finding(
        "programs", "quant-exchange-payload",
        PROGRAM_FILES["wave_sharded_data_quant"],
        f"the quantized data program's histogram exchange moves {qb} "
        f"psum_scatter bytes, more than half the float32 program's {fb} — "
        f"the int16 wire tier is not engaging",
        symbol="wave_sharded_data_quant")]


def run(recs: ProgramRecords,
        budgets: Optional[Dict[str, Any]] = None,
        sequences: Optional[Dict[str, Any]] = None) -> List[Finding]:
    """Every check over one record (no allowlist: a program's budget is
    its pin)."""
    return check_budgets(recs, budgets) + check_sequences(recs, sequences) \
        + cross_factorization_findings(recs) + quant_payload_findings(recs)
