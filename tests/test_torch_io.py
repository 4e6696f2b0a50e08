"""Text files, binary caches, streaming loads and pandas categories: the
port against lightgbm_tpu.

``io/parser.py`` and its host library ``csrc/parse.cpp`` must read CSV, TSV,
whitespace and LibSVM files (a header, ``label_column``, empty fields,
``.weight`` / ``.query`` sidecars) into the JAX package's values bit for
bit; ``two_round`` streaming must give the in-memory dataset's codes and
mappers and the JAX ``from_stream``'s; a binary cache written by either
package must load in the other; training on a DataFrame's ``category``
columns must write the JAX package's model text, ``pandas_categorical`` line
included (L2 and ``gpu_use_dp``, the exact setup of ROADMAP.md "What held
against the reference means"); ``add_features_from`` must join features as
the JAX package does.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import _ConstructedDataset as JConstructed
from lightgbm_tpu.io import parser as jparser
from lightgbm_tpu_torch.dataset import _ConstructedDataset as TConstructed
from lightgbm_tpu_torch.io import parser as tparser

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

CPU = {"device_type": "cpu"}
L2 = {"objective": "regression", "num_leaves": 15, "min_data_in_leaf": 20,
      "max_bin": 63, "verbosity": -1, "gpu_use_dp": True}


def _rows(seed=0, n=600, f=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[::7, 1] = np.nan
    X[:, 3] = rng.randint(0, 6, n)
    y = X[:, 0] + 0.5 * (X[:, 3] == 2) + 0.1 * rng.randn(n)
    return X, y


def _fmt(v, repr_floats):
    if np.isnan(v):
        return ""
    return repr(float(v)) if repr_floats else f"{v:.6g}"


def _write(path, kind, X, y, header=False, label_col=0):
    """The rows as a ``kind`` text file: the label at ``label_col``."""
    with open(path, "w") as fh:
        if kind == "libsvm":
            for yi, r in zip(y, X):
                feats = " ".join(f"{j}:{float(v)!r}"
                                 for j, v in enumerate(r)
                                 if v != 0 and not np.isnan(v))
                fh.write(f"{float(yi)!r} {feats}\n")
            return
        delim = {"csv": ",", "tsv": "\t", "space": " "}[kind]
        if header:
            fh.write(delim.join(f"c{j}" for j in range(X.shape[1] + 1))
                     + "\n")
        for i, (yi, r) in enumerate(zip(y, X)):
            vals = [_fmt(v, i % 2 == 0) for v in r]
            if kind == "space":
                vals = [v or "nan" for v in vals]
            vals.insert(label_col, repr(float(yi)))
            line = delim.join(vals)
            if kind == "csv" and i % 5 == 0:
                line += ","                     # a trailing delimiter
            fh.write(line + ("\r\n" if i % 3 == 0 else "\n"))
            if i % 50 == 0:
                fh.write("\n")                  # blank lines are skipped


@pytest.mark.parametrize("kind,header,label_col", [
    ("csv", True, 0), ("tsv", False, 2), ("space", False, 0),
    ("libsvm", False, 0)])
def test_load_data_file_equals_jax(tmp_path, kind, header, label_col):
    X, y = _rows(1)
    path = str(tmp_path / f"data.{kind}")
    _write(path, kind, X, y, header, label_col)
    with open(path + ".weight", "w") as fh:
        fh.write("\n".join(repr(float(w))
                            for w in np.linspace(0.5, 2, len(y))))
    with open(path + ".query", "w") as fh:
        fh.write("\n".join(["100"] * 6))
    params = {"header": header, "label_column": f"column_{label_col}"}
    got = tparser.load_data_file(path, params)
    want = jparser.load_data_file(path, params)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64))
    assert got[0].shape == (600, 5 if kind != "libsvm" else 5)
    # the streaming passes give the same matrix, chunk by chunk
    info = tparser.scan_data_file(path, params)
    chunks = list(tparser.iter_data_chunks(path, params, 128, info=info))
    assert [c[0] for c in chunks] == list(range(0, 600, 128))
    mat = np.concatenate([c[1] for c in chunks])
    np.testing.assert_array_equal(mat.view(np.int64),
                                  got[0].view(np.int64))


def test_parse_dense_bitwise_to_jax(tmp_path):
    from lightgbm_tpu.native import parse_dense as j_parse_dense

    rng = np.random.RandomState(2)
    vals = np.concatenate([rng.randn(3000) * 10.0 ** rng.randint(-30, 30, 3000),
                           [0.1, 1 / 3, 5e-324, 1.7976931348623157e308,
                            -0.0, 2.5e-308]])
    lines = []
    for i in range(0, len(vals) - 6, 6):
        toks = [repr(float(v)) if (i // 6) % 2 else f"{v:.17g}"
                for v in vals[i:i + 6]]
        if i % 30 == 0:
            toks[2] = ""                        # an empty field
        if i % 42 == 12:
            toks = toks[:4]                     # a ragged row: NaN-padded
        if i % 18 == 0:
            toks[1] = " " + toks[1] + " "
        lines.append(",".join(toks))
    lines.append(",".join(repr(float(v)) for v in vals[-6:]))
    path = str(tmp_path / "dense.csv")
    with open(path, "w") as fh:
        fh.write("h0,h1,h2,h3,h4,h5\n" + "\n".join(lines) + "\n")
    got = tparser.parse_dense(path, ",", 1)
    want = j_parse_dense(path, ",", 1)
    assert got.shape == want.shape == (len(lines), 6)
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    assert np.isnan(got).sum() > 10
    # the chunk entry point parses the same lines to the same bits
    chunk = tparser.parse_lines(lines, ",", 6)
    np.testing.assert_array_equal(chunk.view(np.int64), got.view(np.int64))


def _stream_file(tmp_path, n=3000):
    X, y = _rows(3, n=n, f=6)
    path = str(tmp_path / "stream.csv")
    _write(path, "csv", X, y, header=True)
    np.savetxt(path + ".weight", np.linspace(1, 2, n))
    return path


def test_two_round_equals_in_memory_and_jax(tmp_path):
    path = _stream_file(tmp_path)
    params = dict(CPU, header=True, max_bin=63, two_round=True,
                  stream_chunk_rows=700, bin_construct_sample_cnt=1000,
                  categorical_feature="3")
    streamed = lt.Dataset(path, params=params).construct().constructed
    in_mem = lt.Dataset(path, params=dict(params, two_round=False)
                        ).construct().constructed
    jparams = {k: v for k, v in params.items() if k != "device_type"}
    jds = lj.Dataset(path, params=jparams).construct().constructed
    assert isinstance(jds, JConstructed)
    for other in (in_mem, jds):
        np.testing.assert_array_equal(streamed.bins, other.bins)
        assert str([m.to_dict() for m in streamed.bin_mappers]) \
            == str([m.to_dict() for m in other.bin_mappers])
        np.testing.assert_array_equal(streamed.used_feature_map,
                                      other.used_feature_map)
        np.testing.assert_array_equal(streamed.metadata.label,
                                      other.metadata.label)
        np.testing.assert_array_equal(streamed.metadata.weights,
                                      other.metadata.weights)
    assert streamed.bin_mappers[3].bin_type == 1


def test_two_round_across_machines_stays_refused(tmp_path):
    """``num_machines`` does not refuse a ``two_round`` load any more: the
    Dataset takes every row with it, as the JAX package's does (a rank's
    share is ``from_stream(rank=, num_machines=)``'s or the elastic
    re-deal's: ``tests/test_torch_distributed_bin.py``)."""
    path = _stream_file(tmp_path, n=200)
    p = dict(header=True, two_round=True, num_machines=2)
    mine = lt.Dataset(path, params=dict(CPU, **p)).construct().constructed
    theirs = lj.Dataset(path, params=p).construct().constructed
    assert mine.num_data == theirs.num_data == 200
    np.testing.assert_array_equal(mine.bins, theirs.bins)
    assert str([m.to_dict() for m in mine.bin_mappers]) \
        == str([m.to_dict() for m in theirs.bin_mappers])


def test_binary_cache_loads_in_both_directions(tmp_path):
    X, y = _rows(4)
    w = np.linspace(0.5, 1.5, len(y))
    t = lt.Dataset(X, label=y, weight=w, group=[300, 300],
                   params=dict(L2, **CPU))
    j = lj.Dataset(X, label=y, weight=w, group=[300, 300], params=L2)
    t.save_binary(str(tmp_path / "port.bin"))
    j.save_binary(str(tmp_path / "jax.bin"))
    assert TConstructed.is_binary_file(str(tmp_path / "jax.bin"))
    assert not TConstructed.is_binary_file(__file__)
    from_port = JConstructed.load_binary(str(tmp_path / "port.bin"),
                                         JConfig.from_params(L2))
    from_jax = lt.Dataset(str(tmp_path / "jax.bin"),
                          params=dict(L2, **CPU)).construct().constructed
    for a, b in ((from_port, j.constructed), (from_jax, t.constructed)):
        np.testing.assert_array_equal(a.bins, b.bins)
        assert str([m.to_dict() for m in a.bin_mappers]) \
            == str([m.to_dict() for m in b.bin_mappers])
        for fld in ("label", "weights", "query_boundaries"):
            np.testing.assert_array_equal(getattr(a.metadata, fld),
                                          getattr(b.metadata, fld))
        assert a.feature_names == b.feature_names
    # the cache trains the in-memory dataset's model
    p = dict(L2, **CPU)
    cached = lt.train(p, lt.Dataset(str(tmp_path / "port.bin"), params=p), 3,
                      verbose_eval=False)
    fresh = lt.train(p, lt.Dataset(X, label=y, weight=w, params=p), 3,
                     verbose_eval=False)
    assert cached.model_to_string() == fresh.model_to_string()


def test_pandas_category_training_equals_jax():
    pd = pytest.importorskip("pandas")
    from test_categorical import _make_data

    X, y = _make_data()
    cats = [f"k{c:02d}" for c in range(25)]

    def frame(rows, order=None):
        c_big = pd.Categorical([cats[int(v)] for v in rows[:, 2]],
                               categories=order or cats)
        return pd.DataFrame({"small": pd.Categorical(rows[:, 0].astype(int)),
                             "num": rows[:, 1], "big": c_big})

    df = frame(X[:1500])
    # the validation frame lists its categories in another order: the
    # training lists define the codes
    dv = frame(X[1500:], order=list(reversed(cats)))
    # the masked learner: the JAX wave learner's categorical programs take
    # twice as long to compile on the CPU
    p = dict(L2, num_leaves=31, tpu_learner="masked")
    bj = lj.train(p, (ds_j := lj.Dataset(df, label=y[:1500], params=p)), 6,
                  verbose_eval=False)
    ds_t = lt.Dataset(df, label=y[:1500], params=dict(p, **CPU))
    # no validation set in either: both take their pipelined loops
    bt = lt.train(dict(p, **CPU), ds_t, 6, verbose_eval=False)
    vt = ds_t.create_valid(dv, label=y[1500:])
    text = bt.model_to_string()
    assert text == bj.model_to_string()
    assert "pandas_categorical:" in text and "k24" in text
    np.testing.assert_array_equal(vt.constructed.bins,
                                  ds_j.create_valid(dv, label=y[1500:])
                                  .construct().constructed.bins)
    assert any(t.num_cat > 0 for t in bt.gbdt.models)
    np.testing.assert_allclose(bt.predict(dv), bj.predict(dv), rtol=0,
                               atol=1e-12)


def test_add_features_from_equals_jax():
    X, y = _rows(5)
    parts = []
    for pkg, extra in ((lt, CPU), (lj, {})):
        a = pkg.Dataset(X[:, :3], label=y, params=dict(L2, **extra))
        b = pkg.Dataset(X[:, 3:], label=y, params=dict(L2, **extra))
        a.add_features_from(b)
        parts.append(a.constructed)
    t, j = parts
    np.testing.assert_array_equal(t.bins, j.bins)
    np.testing.assert_array_equal(t.used_feature_map, j.used_feature_map)
    assert t.num_total_features == j.num_total_features == 5
    assert t.feature_names == j.feature_names
    assert str([m.to_dict() for m in t.bin_mappers]) \
        == str([m.to_dict() for m in j.bin_mappers])
    whole = lt.Dataset(X, label=y, params=dict(L2, **CPU)).constructed
    np.testing.assert_array_equal(t.bins, whole.bins)
