"""Versioned model registry with atomic hot-swap.

Port of ``lightgbm_tpu/serving/registry.py``.  A ``ServingModel`` binds one
booster to the device pipeline: the predict binner (``binner.py``: the
``bin_predict`` kernel on a CUDA device, ``bin_plain`` on the CPU), the
traversal (``predictor.DevicePredictor.predict_binned``) and the bucket
bookkeeping.  Boosters with training data serve in their training bin
space; text-loaded boosters through the schema rebuilt from the model text
(``predictor.reconstruct_bin_schema``).

Where the JAX package jits one bin + traverse program per bucket, the port
captures one CUDA graph per bucket of the ladder (``ServingModel.warm``):
after warmup a batch inside the ladder copies its rows into the bucket's
static input and replays the graph.  On the CPU the same path runs
eagerly.

``ModelRegistry.prepare`` builds, warms and verifies a candidate (its
scores against the host traversal on a fuzz sample) off to the side;
``commit`` swaps it in under the registry lock while retaining the
displaced incumbent, so ``rollback`` can re-swap it; ``load`` is prepare +
commit.  A failed prepare raises and changes nothing: a failed build or
launch of ``bin_predict`` at warmup or verification raises there, and the
swap does not happen.
"""

from __future__ import annotations

import contextlib
import copy
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import native
from ..binner import BinnerArrays, bin_predict
from ..reliability import faults
from ..reliability.metrics import rel_inc
from .batcher import ServingStats, next_pow2

_NULL_CTX = contextlib.nullcontext()


class BucketGraph(NamedTuple):
    """One bucket's captured bin + traverse: the graph, its static
    (bucket, num_features) float64 input on the device, the pinned host
    buffer a batch is staged in, the graph's (K, bucket) float64 score
    output, the pinned host buffer the scores are read into, and the
    wrapper launches one replay makes (``native.capture``'s tally)."""
    graph: "torch.cuda.CUDAGraph"
    x: torch.Tensor
    staging: torch.Tensor
    score: torch.Tensor
    host: torch.Tensor
    launches: Dict


class ServingModel:
    """One immutable servable model version (swap = replace the object)."""

    def __init__(self, booster, stats: Optional[ServingStats] = None,
                 name: str = "default", version: int = 1, device=None):
        from ..predictor import DevicePredictor

        self.booster = booster
        self.name = name
        self.version = int(version)
        self.stats = stats or ServingStats()
        gbdt = booster.gbdt
        if not gbdt.models:
            raise ValueError("model has no trees to serve")
        data = gbdt.train_data
        if data is None:
            data = gbdt._prediction_schema()
            if data is None:
                raise ValueError("could not rebuild a bin schema from the "
                                 "model text; it cannot be served")
        if any(getattr(t, "needs_rebind", False) for t in gbdt.models):
            raise ValueError("the model's trees are not bound to a bin "
                             "space (a refit booster): save and reload it "
                             "to serve it")
        #: every device op of this model runs here: the booster's device
        #: unless the registry asks for another
        self.device = torch.device(device) if device is not None \
            else gbdt.device
        if self.device != gbdt.device:
            gbdt = copy.copy(gbdt)
            gbdt.device = self.device
        self.predictor = DevicePredictor(gbdt, data)
        self.arrays = BinnerArrays.for_data(data)
        self.dev_arrays = self.arrays.device_arrays(self.device)
        self.num_features = int(gbdt.max_feature_idx) + 1
        self.K = self.predictor.K
        self.objective = gbdt.objective
        self.cuda = self.device.type == "cuda"
        self._warmed: set = set()          # buckets run at least once
        self._graphs: Dict[int, BucketGraph] = {}
        self._pool = None
        self._stream = torch.cuda.Stream(self.device) if self.cuda else None
        # the bucket graphs' static buffers admit one batch at a time: the
        # batch worker's, and a shadow replay's of the live incumbent
        # (`lifecycle/shadow.py`) from the promoting thread
        self._lock = threading.Lock()
        #: graph replays and eager device batches so far
        self.replays = 0
        self.eager_batches = 0
        #: the first real device error a batch of this model raised (the
        #: server's ``health`` reports the model not ready), else None
        self.device_error: Optional[str] = None

    # -- the batch path (batcher worker thread only) -------------------------

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        """(K, n) float64 raw scores of the (n, num_features) float64
        device matrix ``x``: ``bin_predict`` and the traversal."""
        return self.predictor.predict_binned(bin_predict(x, self.dev_arrays))

    def predict_padded(self, Xpad: np.ndarray, m: int) -> np.ndarray:
        """Raw scores of the first ``m`` rows of a padded ``(bucket,
        num_features)`` matrix, (m,) or (m, K); stages timed into
        ``stats``.

        On a CUDA device a warmed bucket replays its graph.  ``bin`` times
        the rows' copy into the pinned staging buffer, the copy to the
        graph's static input and the replay, all enqueued without a wait;
        ``traverse`` the copy of the bucket's scores to pinned host memory
        and the wait for it, so it holds the device time of the replay;
        ``unpad`` the host slice to ``m`` rows.  A bucket with no graph
        (``warmup=False``, or outside the ladder) runs eagerly: ``bin`` the
        upload and ``bin_predict``, ``traverse`` the traversal and the read
        of its scores.  On the CPU ``bin`` is ``bin_plain``, ``traverse``
        the traversal.  One batch of a model runs at a time (the model's
        lock): a shadow replay of the live model waits for the batch worker's
        and the reverse."""
        f = faults.fire("serve.predict.delay")
        if f is not None:
            time.sleep(float(f.get("seconds", 0.1)))
        if faults.fire("serve.predict.fail") is not None:
            raise faults.InjectedFault("injected fault serve.predict.fail "
                                       "(device predict path)")
        with self._lock:
            bucket = Xpad.shape[0]
            self.stats.record_compile_cache(hit=bucket in self._warmed)
            self._warmed.add(bucket)
            g = self._graphs.get(bucket)
            if g is not None:
                with torch.cuda.stream(self._stream):
                    with self.stats.stage("bin"):
                        g.staging.numpy()[:] = Xpad
                        g.x.copy_(g.staging, non_blocking=True)
                        g.graph.replay()
                        self.replays += 1
                        native.credit(g.launches)
                    with self.stats.stage("traverse"):
                        g.host.copy_(g.score, non_blocking=True)
                        self._stream.synchronize()
                    with self.stats.stage("unpad"):
                        s = g.host.numpy()[:, :m].copy()
            elif self.cuda:
                from ..dataset import upload

                self.eager_batches += 1
                with torch.cuda.stream(self._stream):
                    with self.stats.stage("bin"):
                        bins = bin_predict(upload(Xpad, self.device),
                                           self.dev_arrays)
                    with self.stats.stage("traverse"):
                        score = self.predictor.predict_binned(
                            bins)[:, :m].cpu()
                    with self.stats.stage("unpad"):
                        s = score.numpy()
            else:
                with self.stats.stage("bin"):
                    bins = bin_predict(torch.from_numpy(Xpad),
                                       self.dev_arrays)
                with self.stats.stage("traverse"):
                    score = self.predictor.predict_binned(bins)
                with self.stats.stage("unpad"):
                    s = score[:, :m].numpy()
        return s[0] if self.K == 1 else s.T

    def convert_output(self, raw: np.ndarray,
                       raw_score: bool = False) -> np.ndarray:
        if raw_score or self.objective is None:
            return raw
        return self.objective.convert_output(raw)

    # -- warmup: one CUDA graph per bucket -----------------------------------

    def _capture(self, bucket: int) -> BucketGraph:
        """Capture ``bin_predict`` + the traversal over a static (bucket,
        num_features) input as one CUDA graph in the model's memory pool,
        after one eager run that builds the kernel's library and raises its
        shared-memory limit.  A pass that cannot be captured raises."""
        x = torch.zeros((bucket, self.num_features), dtype=torch.float64,
                        device=self.device)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            self._run(x)
        self._stream.synchronize()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        score, launches = native.capture(graph, lambda: self._run(x),
                                         self._pool, "thread_local",
                                         self.device)
        return BucketGraph(
            graph, x, torch.zeros_like(x, device="cpu").pin_memory(), score,
            torch.zeros_like(score, device="cpu").pin_memory(), launches)

    def warm(self, buckets: Sequence[int]) -> List[int]:
        """Capture every bucket's graph (on a CUDA device) and run each
        bucket once, so requests inside the ladder never capture."""
        warmed = []
        for b in buckets:
            b = int(b)
            if self.cuda and b not in self._graphs:
                self._graphs[b] = self._capture(b)
            self.predict_padded(np.zeros((b, self.num_features)), 1)
            warmed.append(b)
        return warmed

    def jit_entries(self) -> int:
        """The bucket programs this model holds: its captured graphs on a
        CUDA device, the buckets it ran on the CPU (where nothing is
        captured).  The counterpart of the JAX package's jit cache size,
        which never grows on the request path after warmup."""
        return len(self._graphs) if self.cuda else len(self._warmed)

    def host_fallback(self, Xpad: np.ndarray, m: int,
                      error: Exception) -> np.ndarray:
        """Degraded-mode scoring for a padded batch whose ``predict_padded``
        raised ``error`` (the batcher's ``fallback_fn``): the host numpy
        traversal over the real rows, same output convention.  A CUDA model
        re-scores only a batch that the injected ``serve.predict.fail``
        failed: a real device error (a failed ``bin_predict`` build or
        launch, a kernel fault at the wait) is kept in ``device_error``,
        counted in ``serve.device_errors`` and re-raised, so the batch's
        requests fail and ``health`` reports the model not ready."""
        if self.cuda and not isinstance(error, faults.InjectedFault):
            if self.device_error is None:
                self.device_error = f"{type(error).__name__}: {error}"
            rel_inc("serve.device_errors")
            raise error
        return self.host_raw(Xpad[:m])

    def host_raw(self, X: np.ndarray) -> np.ndarray:
        """Reference host traversal (per-tree numpy), the verify oracle."""
        gbdt = self.booster.gbdt
        X = np.ascontiguousarray(X, dtype=np.float64)
        k = max(gbdt.num_tree_per_iteration, 1)
        out = np.zeros((X.shape[0], k))
        for i, t in enumerate(gbdt.models):
            out[:, i % k] += t.predict(X)
        return out[:, 0] if k == 1 else out


class ModelRegistry:
    """Name -> current ``ServingModel``; swaps are atomic and verified."""

    def __init__(self, stats: Optional[ServingStats] = None,
                 warm_buckets: Sequence[int] = (), warmup: bool = True,
                 verify_rows: int = 64, verify_tol: float = 1e-5,
                 device=None):
        self.stats = stats or ServingStats()
        self.warm_buckets = [int(b) for b in warm_buckets]
        self.warmup = bool(warmup)
        self.verify_rows = int(verify_rows)
        self.verify_tol = float(verify_tol)
        #: every model of this registry serves on this device: ``device``
        #: (a fleet replica's card), else the device of the first booster
        #: loaded
        self.device = torch.device(device) if device is not None else None
        self._lock = threading.Lock()
        self._models: Dict[str, ServingModel] = {}
        # the version each commit displaced, retained per name so
        # rollback() can re-swap it
        self._previous: Dict[str, ServingModel] = {}

    # -- prepare / commit (load = both) --------------------------------------

    def _booster(self, model_str: Optional[str], model_file: Optional[str]):
        """A booster from model text, built on the registry's device (a CPU
        server's swap stays on the CPU)."""
        from ..engine import Booster

        params = {}
        if self.device is not None:
            params["device_type"] = "cpu" if self.device.type == "cpu" \
                else "cuda"
        if model_str is not None:
            return Booster(model_str=model_str, params=params)
        return Booster(model_file=model_file, params=params)

    def prepare(self, name: str = "default", booster=None,
                model_str: Optional[str] = None,
                model_file: Optional[str] = None) -> ServingModel:
        """Build, warm and verify a candidate WITHOUT swapping it in — the
        serving path never sees it.  On any failure the exception
        propagates and nothing changed."""
        if booster is None:
            booster = self._booster(model_str, model_file)
        with self._lock:
            version = self._models[name].version + 1 \
                if name in self._models else 1
            if self.device is None:
                self.device = booster.gbdt.device
        tr = self.stats.tracer
        model = ServingModel(booster, self.stats, name, version,
                             device=self.device)
        if self.warmup and self.warm_buckets:
            with (tr.span("serve.warm", cat="serving",
                          args={"buckets": list(self.warm_buckets)})
                  if tr is not None else _NULL_CTX):
                model.warm(self.warm_buckets)
        with (tr.span("serve.verify", cat="serving")
              if tr is not None else _NULL_CTX):
            self._verify(model)
        return model

    def commit(self, model: ServingModel) -> int:
        """Atomically swap a prepared candidate in, retaining the
        displaced incumbent for ``rollback``."""
        tr = self.stats.tracer
        with (tr.span("serve.swap", cat="serving",
                      args={"model": model.name, "version": model.version})
              if tr is not None else _NULL_CTX):
            with self._lock:
                old = self._models.get(model.name)
                # re-number against the live version (another commit may
                # have landed since prepare)
                model.version = old.version + 1 if old is not None else \
                    max(model.version, 1)
                if old is not None:
                    self._previous[model.name] = old
                self._models[model.name] = model
        return model.version

    def load(self, name: str = "default", booster=None,
             model_str: Optional[str] = None,
             model_file: Optional[str] = None) -> int:
        """Build, warm and verify a candidate, then atomically swap it in.
        On any failure the exception propagates and the previous version
        keeps serving untouched."""
        return self.commit(self.prepare(name, booster=booster,
                                        model_str=model_str,
                                        model_file=model_file))

    def rollback(self, name: str = "default") -> int:
        """Re-swap the retained previous version in (the displaced current
        version becomes the new retained one, so a mistaken rollback is
        itself reversible).  Raises ``KeyError`` when no previous version
        is retained."""
        tr = self.stats.tracer
        with self._lock:
            prev = self._previous.get(name)
            if prev is None:
                raise KeyError(f"no previous version retained for "
                               f"model {name!r}")
            cur = self._models[name]
            self._models[name] = prev
            self._previous[name] = cur
            restored = prev.version
        rel_inc("serve.rollbacks")
        if tr is not None:
            tr.instant("serve.rollback", cat="serving",
                       args={"model": name, "restored": restored,
                             "displaced": cur.version})
        return restored

    def _verify(self, model: ServingModel) -> None:
        """Device scores vs the host reference traversal on a fuzz sample
        (NaNs and negative/unseen categorical codes included)."""
        rng = np.random.RandomState(7)
        rows = self.verify_rows
        X = rng.randn(rows, model.num_features) * 3.0
        X[::7] = np.abs(np.floor(X[::7] * 4))   # int-ish rows for cat LUTs
        X[::11, :] = np.where(rng.rand(model.num_features) < 0.3,
                              np.nan, X[::11, :])
        bucket = next_pow2(rows)
        if self.warm_buckets:
            fits = [b for b in self.warm_buckets if b >= rows]
            bucket = min(fits) if fits else max(self.warm_buckets)
        Xpad = np.zeros((bucket, model.num_features))
        m = min(rows, bucket)
        Xpad[:m] = X[:m]
        got = model.predict_padded(Xpad, m)
        want = model.host_raw(X[:m])
        if not np.allclose(got, want, rtol=self.verify_tol,
                           atol=self.verify_tol):
            worst = float(np.max(np.abs(np.asarray(got) - want)))
            raise ValueError(
                f"model verification failed: device scores diverge from the "
                f"host traversal (max abs err {worst:g}); swap aborted")

    # -- lookup --------------------------------------------------------------

    def get(self, name: str = "default") -> ServingModel:
        with self._lock:
            if name not in self._models:
                raise KeyError(f"no model named {name!r} is registered")
            return self._models[name]

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def versions(self) -> Dict[str, int]:
        with self._lock:
            return {n: m.version for n, m in self._models.items()}

    def versions_detail(self) -> Dict[str, Dict[str, Optional[int]]]:
        """Per-name serving + retained-previous versions (the ``health``
        op's operator view)."""
        with self._lock:
            return {n: {"version": m.version,
                        "previous": (self._previous[n].version
                                     if n in self._previous else None)}
                    for n, m in self._models.items()}

    def device_errors(self) -> Dict[str, str]:
        """The live models whose batches met a real device error, with
        the first error (``ServingModel.device_error``)."""
        with self._lock:
            return {n: m.device_error for n, m in self._models.items()
                    if m.device_error is not None}

    def jit_entries(self) -> Optional[int]:
        """The bucket programs the live models hold (``ServingModel
        .jit_entries``), None with no model."""
        with self._lock:
            models = list(self._models.values())
        return sum(m.jit_entries() for m in models) if models else None
