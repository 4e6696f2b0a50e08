"""Recompile sentinel: fingerprint CUDA graph captures, fail on a recapture.

Port of ``lightgbm_tpu/analysis/recompile.py``.  The JAX package
fingerprints jit caches; the port's counterpart of a compiled program is a
captured CUDA graph, and its invariant is the same: a warmed serving
bucket or training step never captures again (a capture synchronizes the
card and costs milliseconds; a capture on every request or tree is the
silent regression this pass catches).  The sentinel reads capture
counters instead of cache sizes:

  * ``register(name, reader)`` a zero-argument callable returning the
    counter (an int), or None where that counter cannot move (a CPU
    learner or model captures nothing);
  * ``arm()`` after warmup snapshots every counter — the fingerprint;
  * ``check()`` after the steady-state path: any counter that GREW is a
    recapture and yields a finding.

``run()`` is the gate pass, mirroring the JAX pass: a tiny wave booster
(two warm-up iterations, arm, two more), the same with quantized
gradients, the compact learner's graphed step, a ``ServingModel`` warmed
at buckets (32, 64) then asked for 1, b/2 and b rows in each bucket, and
the process-wide ``native.captures``; each learner's ``graph_captures``,
the model's ``jit_entries()`` (its bucket graphs) and ``eager_batches``
(an in-bucket request that missed its graph) are registered.  A 2-D leg
(``tree_learner=data_feature`` on a 2x2 mesh) runs only where at least four
CUDA devices exist, as the JAX leg needs four devices.  On the CPU nothing
is captured, so ``run()`` returns a skip reason rather than a green result
that checked nothing.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from .common import Finding


def counter_value(reader: Callable[[], Optional[int]]) -> Optional[int]:
    """The counter ``reader`` reads, or None where it cannot move."""
    try:
        v = reader()
    except Exception:
        return None
    return None if v is None else int(v)


class RecompileSentinel:
    """Snapshot-and-compare over named capture counters."""

    def __init__(self) -> None:
        self._readers: Dict[str, Tuple[Callable[[], Optional[int]], str]] = {}
        self._snap: Dict[str, Optional[int]] = {}

    def register(self, name: str, reader: Callable[[], Optional[int]],
                 file: str = "lightgbm_tpu_torch") -> None:
        self._readers[name] = (reader, file)

    def arm(self) -> Dict[str, Optional[int]]:
        """Fingerprint every registered counter (call after warmup)."""
        self._snap = {name: counter_value(r)
                      for name, (r, _) in self._readers.items()}
        return dict(self._snap)

    def deltas(self) -> Dict[str, Tuple[Optional[int], Optional[int]]]:
        return {name: (self._snap.get(name), counter_value(r))
                for name, (r, _) in self._readers.items()}

    def check(self) -> List[Finding]:
        """Findings for every counter that grew since ``arm()``."""
        out: List[Finding] = []
        for name, (r, file) in self._readers.items():
            before = self._snap.get(name)
            after = counter_value(r)
            if before is None or after is None:
                continue
            if after > before:
                out.append(Finding(
                    "recompile", "recapture", file,
                    f"warmed program {name!r} captured again: its counter "
                    f"grew {before} -> {after} after warmup",
                    symbol=name))
        return out

    def supported(self) -> bool:
        return any(counter_value(r) is not None
                   for r, _ in self._readers.values())


# -- the gate pass -----------------------------------------------------------

def _problem(n: int, f: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    return X, y


def _tiny_booster(device: str, n: int = 256, f: int = 4, iters: int = 2,
                  extra: Optional[Dict[str, Any]] = None):
    import lightgbm_tpu_torch as lt

    X, y = _problem(n, f, 0)
    params = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
              "verbosity": -1, "device_type": device}
    params.update(extra or {})
    bst = lt.Booster(params, lt.Dataset(X, label=y, params=params))
    for _ in range(iters):
        bst.update()
    return bst


def _captures(learner) -> Callable[[], Optional[int]]:
    """A learner's capture counter, None where it replays no graph."""
    return lambda: learner.graph_captures \
        if getattr(learner, "use_graphs", False) else None


def _leg_2d(rounds: int, device: str = "cuda") -> Tuple[int, int, str]:
    """One rank of the 2-D leg (a ``RankPool`` task): the learner's graph
    captures after two iterations and after ``rounds``, and its class."""
    bst = _tiny_booster(device, n=2048, f=8, extra={
        "tree_learner": "data_feature", "parallel_mesh": "2x2",
        "enable_bundle": False})
    learner = bst.gbdt.learner
    before = int(learner.graph_captures)
    for _ in range(rounds - 2):
        bst.update()
    bst.gbdt.models                          # flush the pipelined trees
    return before, int(learner.graph_captures), type(learner).__name__


def run(device: Optional[str] = None
        ) -> Tuple[List[Finding], Dict[str, Any], Optional[str]]:
    """Gate pass: ``(findings, detail, skip_reason)``.  ``detail`` records
    each counter's (before, after) and the armed fingerprint."""
    import numpy as np
    import torch

    from .. import native
    from ..serving.registry import ServingModel

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    sentinel = RecompileSentinel()

    # -- training steps: two warm-up iterations, then two steady-state ones
    bst = _tiny_booster(device)
    sentinel.register("train_step_wave", _captures(bst.gbdt.learner),
                      "lightgbm_tpu_torch/learner_wave.py")
    # quantized gradients: the per-tree scales ride the captured passes'
    # buffers; a value baked at capture would recapture every round
    bstq = _tiny_booster(device, extra={"tpu_quantized_grad": "on"})
    if getattr(bstq.gbdt.learner, "_quant", False):
        sentinel.register("quant_train_step_wave",
                          _captures(bstq.gbdt.learner),
                          "lightgbm_tpu_torch/ops/quant.py")
    else:
        bstq = None
    bstc = _tiny_booster(device, extra={"tpu_learner": "compact"})
    sentinel.register("train_step_compact", _captures(bstc.gbdt.learner),
                      "lightgbm_tpu_torch/learner_compact.py")

    # -- serving: warm two buckets, fingerprint, replay in-bucket sizes
    model = ServingModel(_tiny_booster(device))
    buckets = (32, 64)
    model.warm(buckets)
    sentinel.register("serving_graphs",
                      lambda: model.jit_entries() if model.cuda else None,
                      "lightgbm_tpu_torch/serving/registry.py")
    sentinel.register("serving_eager",
                      lambda: model.eager_batches if model.cuda else None,
                      "lightgbm_tpu_torch/serving/registry.py")
    sentinel.register("native_capture",
                      lambda: native.captures if device != "cpu" else None,
                      "lightgbm_tpu_torch/native.py")
    if not sentinel.supported():
        return [], {}, ("no CUDA device: nothing is captured on the CPU "
                        "(CUDA graphs are the card's), so no capture "
                        "counter can move")

    snap = sentinel.arm()
    for b in (bst, bstq, bstc):
        if b is not None:
            for _ in range(2):
                b.update()                   # same shapes: must not capture
            b.gbdt.models                    # flush the pipelined trees
    for bucket in buckets:
        for m in (1, bucket // 2, bucket):   # distinct in-bucket row counts
            model.predict_padded(np.zeros((bucket, model.num_features)), m)

    findings = sentinel.check()
    detail: Dict[str, Any] = {name: {"before": b, "after": a}
                              for name, (b, a) in sentinel.deltas().items()}

    # -- the 2-D step (tree_learner=data_feature, 2x2): four ranks, a card
    # each; each rank's counters come back from its process
    if device != "cpu" and torch.cuda.device_count() >= 4:
        from ..parallel.launch import RankPool

        with RankPool(4, timeout_s=300) as pool:
            got = pool.run(_leg_2d, 4)
        for r, (b, a, cls) in enumerate(got):
            name = f"2d_train_step_rank{r}"
            detail[name] = {"before": b, "after": a}
            if cls != "ShardedWave2DLearner":
                findings.append(Finding(
                    "recompile", "recapture",
                    "lightgbm_tpu_torch/parallel/wave2d_sharded.py",
                    f"the 2-D leg trained through {cls}, not the 2-D "
                    f"learner: nothing of it was fingerprinted",
                    symbol=name))
            elif a > b:
                findings.append(Finding(
                    "recompile", "recapture",
                    "lightgbm_tpu_torch/parallel/wave2d_sharded.py",
                    f"warmed program {name!r} captured again: its counter "
                    f"grew {b} -> {a} after warmup", symbol=name))
    detail["armed"] = {k: v for k, v in snap.items() if v is not None}
    return findings, detail, None
