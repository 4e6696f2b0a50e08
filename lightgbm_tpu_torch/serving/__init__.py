"""The prediction server, on the H100 by default.

Port of ``lightgbm_tpu/serving/`` (the single-server part):

  * ``binner`` — the predict binner stays ``lightgbm_tpu_torch/binner.py``
    (``BinnerArrays``, the ``bin_predict`` kernel); ``OOV_BIN`` and
    ``BinnerArrays`` are exported here as the JAX package exports them;
  * ``batcher`` — a deadline-based micro-batching queue: concurrent
    requests coalesce into padded power-of-two row buckets;
  * ``registry`` — a versioned multi-model registry with atomic, verified
    hot-swap and rollback; on a CUDA device each model captures one CUDA
    graph per bucket at warmup, so the request path replays graphs and
    never captures one;
  * ``server`` — a threaded socket server + client over the
    length-prefixed pickle framing of ``io/net.py``, exposed as
    ``python -m lightgbm_tpu_torch serve`` and ``Booster.serve()``;
  * ``fleet`` — the binary wire protocol's codecs, which the client's
    protocol negotiation speaks.  The fleet itself is not ported
    (ROADMAP.md Queue A, "serving and lifecycle").

Serving telemetry (QPS, stage latency, batch occupancy, compile-cache hits)
reports through ``observability/`` under the ``serving`` section of
``schema.json``.
"""

from ..binner import OOV_BIN, BinnerArrays

_LAZY = {
    "MicroBatcher": "batcher", "ServingStats": "batcher",
    "ModelRegistry": "registry", "ServingModel": "registry",
    "PredictionServer": "server", "ServingClient": "server",
    "ServerOverloaded": "server", "ServerUnavailable": "server",
    "WireError": "fleet",
}

__all__ = ["OOV_BIN", "BinnerArrays", "MicroBatcher", "ServingStats",
           "ModelRegistry", "ServingModel", "PredictionServer",
           "ServingClient", "ServerOverloaded", "ServerUnavailable",
           "WireError"]


def __getattr__(name):
    # the registry pulls in the predictor and the server the Booster facade:
    # import lazily, as the JAX package does
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
