"""The port's package-level names and its ingest spans, against lightgbm_tpu.

Every name the JAX package exports from ``observability``, ``reliability``
and ``io`` that the port has a counterpart of is importable from the same
place in both packages; a ``two_round`` load of a text file under
``trace_out`` leaves the same ``ingest.*`` span names, chunk for chunk, in
both packages' traces; ``timeit`` is the best of its synced calls.

``observability.BENCH_SERVING_SCHEMA`` is not here: it names the serving
benchmark's report, which the port's own serving benchmark will bring.
"""

import importlib
import json
from collections import Counter

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

EXPORTS = [
    ("observability", "estimate_clock_offset"),
    ("observability", "export_rank_trace"),
    ("observability", "merge_pod_trace"),
    ("observability", "timeit"),
    ("observability", "get_global_tracer"),
    ("observability", "set_global_tracer"),
    ("reliability", "config_fingerprint"),
    ("reliability", "find_resume_snapshot"),
    ("reliability", "list_snapshots"),
    ("reliability", "prune_snapshots"),
    ("reliability", "save_snapshot"),
    ("reliability", "validate_snapshot"),
    ("io", "load_data_file"),
]


@pytest.mark.parametrize("pkg,name", EXPORTS)
def test_package_level_name_in_both(pkg, name):
    """``from <package>.<pkg> import <name>`` works in both packages, and
    the port's name is in its ``__all__`` where the package keeps one."""
    mine = importlib.import_module(f"lightgbm_tpu_torch.{pkg}")
    theirs = importlib.import_module(f"lightgbm_tpu.{pkg}")
    assert callable(getattr(theirs, name))
    assert callable(getattr(mine, name))
    assert name in getattr(mine, "__all__", [name])


def _csv(path, n=600, f=4):
    rng = np.random.RandomState(3)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.3 * rng.randn(n) > 0).astype(float)
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.6f")


def _ingest_spans(trace_path):
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    return Counter(e["name"] for e in events
                   if str(e.get("name", "")).startswith("ingest."))


def test_two_round_ingest_spans_equal_jax(tmp_path):
    """A ``two_round`` text load under ``trace_out``: an
    ``ingest.sample_chunk`` span per chunk of the sampling pass and an
    ``ingest.bin_chunk`` span per chunk of the binning pass, the same names
    and counts as the JAX package's; the global recorder is cleared when
    ``train`` returns."""
    from lightgbm_tpu.observability import get_global_tracer as jax_get
    from lightgbm_tpu_torch.observability import get_global_tracer

    data = tmp_path / "train.csv"
    _csv(data)
    params = {"objective": "binary", "num_leaves": 4, "verbosity": -1,
              "two_round": True, "stream_chunk_rows": 128,
              "header": False, "label_column": 0}
    spans = {}
    for lib, extra in ((lj, {}), (lt, {"device_type": "cpu"})):
        out = tmp_path / f"{lib.__name__}.json"
        p = dict(params, trace_out=str(out), **extra)
        lib.train(p, lib.Dataset(str(data), params=p), 1,
                  verbose_eval=False)
        spans[lib] = _ingest_spans(out)
    assert spans[lt] == spans[lj]
    # 600 rows in chunks of 128: five chunks to each pass of each load
    assert set(spans[lt]) == {"ingest.sample_chunk", "ingest.bin_chunk"}
    assert all(n > 0 and n % 5 == 0 for n in spans[lt].values())
    assert get_global_tracer() is None and jax_get() is None


def test_streaming_without_trace_records_nothing(tmp_path):
    """No ``trace_out``: no recorder is registered and the load records
    nothing (the loader's clock reads are skipped)."""
    from lightgbm_tpu_torch.observability import get_global_tracer
    data = tmp_path / "train.csv"
    _csv(data, n=200)
    p = {"objective": "binary", "num_leaves": 4, "verbosity": -1,
         "two_round": True, "stream_chunk_rows": 64, "device_type": "cpu",
         "label_column": 0}
    lt.train(p, lt.Dataset(str(data), params=p), 1, verbose_eval=False)
    assert get_global_tracer() is None


def test_timeit_is_best_of_synced_calls():
    """``timeit`` runs the warm-up calls untimed and returns the best of
    the timed ones; ``sync`` sees every result."""
    from lightgbm_tpu_torch.observability import timeit
    seen = []
    x = torch.ones(8)
    best = timeit(lambda a: a * 2, x, iters=3, warmup=2, sync=seen.append)
    assert len(seen) == 5 and all(torch.equal(s, x * 2) for s in seen)
    assert 0.0 <= best < 1.0
    assert timeit(lambda: (x, None), iters=1, warmup=0) >= 0.0
