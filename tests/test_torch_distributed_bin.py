"""Port distributed bin finding and sharded loading vs lightgbm_tpu.

``lightgbm_tpu_torch/io/distributed.py``, ``io/net.py:SocketNet`` and the
rank-owning ``two_round`` loader held against the JAX package's
``tests/test_distributed_bin.py`` and its functions on the same inputs:
mappers equal to single-host binning for 2, 3 and 5 machines and to JAX
``distributed_construct``'s serialized mappers, the row and query dealing,
``load_partitioned_file``, ``SocketNet`` across processes, query-aware
lambdarank, rank-identical EFB bundles and ``net_from_config``.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io import distributed as jdist
from lightgbm_tpu.io.parser import load_data_file as jload
from lightgbm_tpu_torch.binning import BinMapper
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.dataset import _ConstructedDataset
from lightgbm_tpu_torch.io.distributed import (LoopbackCluster,
                                               _feature_ranges,
                                               distributed_construct,
                                               load_partitioned_file,
                                               partition_queries,
                                               partition_rows)
from lightgbm_tpu_torch.io.parser import load_data_file
from lightgbm_tpu_torch.parallel.launch import RankPool, free_port

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_multihost_worker as worker  # noqa: E402
from test_torch_multihost import _clean_env  # noqa: E402

torch.set_num_threads(1)


def _mapper_equal(a, b):
    """dict equality with NaN == NaN (the NaN bin's upper bound)."""
    da, db = a.to_dict(), b.to_dict()
    if set(da) != set(db):
        return False
    for k in da:
        va, vb = da[k], db[k]
        if isinstance(va, list):
            if not np.array_equal(np.asarray(va, np.float64),
                                  np.asarray(vb, np.float64),
                                  equal_nan=True):
                return False
        elif va != vb:
            return False
    return True


def _make_matrix(n=5000, f=11, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[:, 1] = np.round(X[:, 1] * 2)            # few distinct values
    X[rng.rand(n, f) < 0.2] = 0.0              # sparse zeros
    X[rng.rand(n, f) < 0.05] = np.nan          # missing
    X[:, 4] = rng.randint(0, 7, n)             # categorical-ish ints
    return X


def _write_csv(path, X, y):
    with open(path, "w") as fh:
        for i in range(len(X)):
            row = [f"{y[i]:g}"] + [("nan" if np.isnan(v)
                                    else repr(float(v))) for v in X[i]]
            fh.write(",".join(row) + "\n")


@pytest.mark.parametrize("num_machines", [2, 3, 5])
def test_mappers_match_single_host_and_jax(num_machines):
    """Contiguous row shards: every rank's mappers equal single-host
    binning and JAX ``distributed_construct``'s, and each shard's codes
    equal the single-host codes of its rows."""
    X = _make_matrix()
    params = {"max_bin": 63, "min_data_in_bin": 3,
              "bin_construct_sample_cnt": 2000}
    cfg = Config.from_params(params)
    ref = _ConstructedDataset.from_matrix(X, cfg, categorical=[4])
    cuts = np.linspace(0, len(X), num_machines + 1).astype(int)
    shards = [(X[cuts[r]:cuts[r + 1]],) for r in range(num_machines)]
    outs = LoopbackCluster(num_machines).run(
        lambda net, shard: distributed_construct(net, shard, cfg,
                                                 categorical=[4]), shards)
    jcfg = JConfig.from_params(params)
    jouts = jdist.LoopbackCluster(num_machines).run(
        lambda net, shard: jdist.distributed_construct(net, shard, jcfg,
                                                       categorical=[4]),
        shards)
    for ds, jds in zip(outs, jouts):
        assert np.array_equal(ds.used_feature_map, ref.used_feature_map)
        assert np.array_equal(ds.used_feature_map, jds.used_feature_map)
        for a, b, c in zip(ds.bin_mappers, ref.bin_mappers,
                           jds.bin_mappers):
            assert _mapper_equal(a, b)
            assert _mapper_equal(a, BinMapper.from_dict(c.to_dict()))
    for r, (ds, jds) in enumerate(zip(outs, jouts)):
        n_r = cuts[r + 1] - cuts[r]
        assert (ds.num_data, ds.row_offset, ds.num_data_global) \
            == (n_r, cuts[r], len(X)) \
            == (jds.num_data, jds.row_offset, jds.num_data_global)
        ours = ds.bins[:len(ds.bin_mappers), :n_r]
        np.testing.assert_array_equal(
            ours, ref.bins[:len(ref.bin_mappers), cuts[r]:cuts[r + 1]])
        np.testing.assert_array_equal(ours,
                                      jds.bins[:len(jds.bin_mappers), :n_r])


def test_no_host_sees_full_matrix():
    X = _make_matrix(n=3000, f=5)
    cfg = Config.from_params({"max_bin": 15,
                              "bin_construct_sample_cnt": 500})
    cuts = np.linspace(0, len(X), 4).astype(int)
    outs = LoopbackCluster(3).run(
        lambda net, shard: distributed_construct(net, shard, cfg),
        [(X[cuts[r]:cuts[r + 1]],) for r in range(3)])
    assert sum(ds.num_data for ds in outs) == len(X)
    for ds in outs[1:]:
        assert all(_mapper_equal(a, b) for a, b in
                   zip(ds.bin_mappers, outs[0].bin_mappers))


def test_partitions_and_feature_ranges_equal_jax():
    """``partition_rows``, ``partition_queries`` and ``_feature_ranges``
    return the JAX functions' values."""
    for n, k in [(10, 3), (7, 1), (13, 5)]:
        for r in range(k):
            for pre in (False, True):
                np.testing.assert_array_equal(
                    partition_rows(n, r, k, pre),
                    jdist.partition_rows(n, r, k, pre))
    sizes = np.random.RandomState(1).randint(1, 9, 23)
    for k in (1, 2, 3, 5):
        for r in range(k):
            rows, grp = partition_queries(sizes, r, k)
            jrows, jgrp = jdist.partition_queries(sizes, r, k)
            np.testing.assert_array_equal(rows, jrows)
            np.testing.assert_array_equal(grp, jgrp)
    for f in [1, 2, 7, 16, 30]:
        for k in [1, 2, 3, 8]:
            assert _feature_ranges(f, k) == jdist._feature_ranges(f, k)
            start, length = _feature_ranges(f, k)
            flat = [j for s, n in zip(start, length)
                    for j in range(s, s + max(n, 0))]
            assert flat == list(range(f))


def test_load_partitioned_file_equals_jax(tmp_path):
    """Mod-dealt shards of a file with a header and a ``.weight`` sidecar:
    the JAX loader's matrices, labels, weights and global rows, every row
    on exactly one rank."""
    rows = ["%d,%.3f,%.3f" % (i % 3, i * 0.5, i) for i in range(13)]
    p = tmp_path / "hdr.csv"
    p.write_text("label,f0,f1\n" + "\n".join(rows) + "\n")
    (tmp_path / "hdr.csv.weight").write_text(
        "\n".join(str(0.1 * (i + 1)) for i in range(13)) + "\n")
    params = {"header": True, "label_column": 0}
    seen = []
    for r in range(2):
        mine = load_partitioned_file(str(p), params, r, 2)
        theirs = jdist.load_partitioned_file(str(p), params, r, 2)
        for a, b in zip(mine, theirs):
            if a is None or b is None:
                assert a is None and b is None
            else:
                np.testing.assert_array_equal(a, b)
        owned = partition_rows(13, r, 2, False)
        np.testing.assert_array_equal(mine[4], owned)
        np.testing.assert_allclose(mine[2], 0.1 * (owned + 1))
        seen.extend(mine[4].tolist())
    assert sorted(seen) == list(range(13))


def test_mod_partition_and_stream_mappers_match_single_host(tmp_path):
    """Interleaved shards with explicit global rows, and the ``two_round``
    stream with ``rank`` / ``num_machines`` and a net (its FindBin split
    over the ranks' feature ranges), both give the single-host mappers
    and the owned rows' single-host codes."""
    X = _make_matrix(n=4000, f=7)
    params = {"max_bin": 31, "bin_construct_sample_cnt": 1500}
    cfg = Config.from_params(params)
    ref = _ConstructedDataset.from_matrix(X, cfg)
    k = 3
    args = []
    for r in range(k):
        rows = partition_rows(len(X), r, k, pre_partition=False)
        args.append((X[rows], rows))
    outs = LoopbackCluster(k).run(
        lambda net, shard, rows: distributed_construct(
            net, shard, cfg, global_rows=rows), args)
    y = np.arange(len(X)) % 2 * 1.0
    path = str(tmp_path / "s.csv")
    _write_csv(path, X, y)
    streams = LoopbackCluster(k).run(
        lambda net: _ConstructedDataset.from_stream(path, params, cfg,
                                                    net=net), [()] * k)
    ref_s = _ConstructedDataset.from_stream(path, params, cfg)
    for r, (ds, st) in enumerate(zip(outs, streams)):
        rows = partition_rows(len(X), r, k, pre_partition=False)
        for a, b, c in zip(ds.bin_mappers, ref.bin_mappers,
                           st.bin_mappers):
            assert _mapper_equal(a, b) and _mapper_equal(c, b)
        np.testing.assert_array_equal(
            ds.bins[:len(ds.bin_mappers), :len(rows)],
            ref.bins[:len(ref.bin_mappers), rows])
        np.testing.assert_array_equal(st.global_rows, rows)
        np.testing.assert_array_equal(
            st.bins[:len(st.bin_mappers), :len(rows)],
            ref_s.bins[:len(ref_s.bin_mappers), rows])
        np.testing.assert_array_equal(st.metadata.label, y[rows])


@pytest.mark.parametrize("num_machines", [2, 3])
def test_socket_net_multiprocess_mappers_match_single_host(tmp_path,
                                                           num_machines):
    """N processes bin their mod-dealt shards of a file over the TCP
    ``SocketNet``: every one ends with the single-host mapper table of the
    JAX package and of the port, and its rows' codes."""
    X = _make_matrix(n=3000, f=8)
    y = (np.nansum(X[:, :2], axis=1) > 0).astype(float)
    data = str(tmp_path / "train.csv")
    _write_csv(data, X, y)
    port = free_port()
    specs = [dict(job="socket", rank=r, num_machines=num_machines,
                  port=port, data=data, out=str(tmp_path / f"o{r}.pkl"))
             for r in range(num_machines)]
    procs = [subprocess.Popen([sys.executable, worker.__file__,
                               __import__("json").dumps(s)],
                              env=_clean_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for s in specs]
    for p in procs:
        out = p.communicate(timeout=120)[0]
        assert p.returncode == 0, out.decode()[-2000:]
    results = [pickle.load(open(s["out"], "rb")) for s in specs]
    params = {"max_bin": 63, "min_data_in_bin": 3,
              "bin_construct_sample_cnt": 2000, "label_column": "0"}
    mat, _l, _w, _g = load_data_file(data, params)
    ref = _ConstructedDataset.from_matrix(mat, Config.from_params(params),
                                          categorical=[4])
    jmat = jload(data, params)[0]
    from lightgbm_tpu.dataset import _ConstructedDataset as JConstructed
    jref = JConstructed.from_matrix(jmat, JConfig.from_params(params),
                                    categorical=[4])
    for res in results:
        assert np.array_equal(res["used"], ref.used_feature_map)
        assert res["num_data_global"] == len(mat)
        for d, b, j in zip(res["mappers"], ref.bin_mappers,
                           jref.bin_mappers):
            assert _mapper_equal(BinMapper.from_dict(d), b)
            assert _mapper_equal(BinMapper.from_dict(d),
                                 BinMapper.from_dict(j.to_dict()))
        want = ref.bins[:len(ref.bin_mappers), :len(mat)][
            :, res["global_rows"]]
        np.testing.assert_array_equal(res["bins"], want)
    all_rows = np.sort(np.concatenate([r["global_rows"] for r in results]))
    np.testing.assert_array_equal(all_rows, np.arange(len(mat)))


def test_query_aware_mod_partition_distributed_lambdarank(tmp_path):
    """A ``.query`` sidecar deals whole query groups (the JAX dealing), the
    dealt shards bin to the single-host mappers, and ``tree_learner=data``
    over two ranks on the dealt order reproduces the serial NDCG."""
    rng = np.random.RandomState(5)
    nq = 120
    sizes = rng.randint(3, 12, nq)
    n = int(sizes.sum())
    X = rng.randn(n, 6)
    rel = np.clip((X[:, 0] + 0.5 * X[:, 1]
                   + 0.3 * rng.randn(n) > 0.5).astype(int)
                  + (X[:, 2] > 1).astype(int) * 2, 0, 4)
    path = str(tmp_path / "rank.train")
    with open(path, "w") as fh:
        for i in range(n):
            fh.write(",".join([f"{rel[i]:d}"]
                              + [repr(float(v)) for v in X[i]]) + "\n")
    with open(path + ".query", "w") as fh:
        fh.write("\n".join(str(s) for s in sizes) + "\n")
    M = 3
    params = {"max_bin": 63, "min_data_in_bin": 3, "label_column": "0",
              "bin_construct_sample_cnt": 2000}
    cfg = Config.from_params(params)
    shards = [load_partitioned_file(path, params, r, M) for r in range(M)]
    jshards = [jdist.load_partitioned_file(path, params, r, M)
               for r in range(M)]
    starts = np.concatenate([[0], np.cumsum(sizes)])
    for r, ((mat, label, _w, group, rows), js) in enumerate(
            zip(shards, jshards)):
        np.testing.assert_array_equal(rows, js[4])
        np.testing.assert_array_equal(group, js[3])
        np.testing.assert_array_equal(mat, js[0])
        assert int(np.sum(group)) == len(mat) == len(rows)
        for q in range(r, nq, M):
            assert np.all(np.isin(np.arange(starts[q], starts[q + 1]),
                                  rows))
    outs = LoopbackCluster(M).run(
        lambda net, mat, label, group, rows: distributed_construct(
            net, mat, cfg, label=label, group=group, global_rows=rows),
        [(s[0], s[1], s[3], s[4]) for s in shards])
    mat_full = load_data_file(path, params)[0]
    ref = _ConstructedDataset.from_matrix(mat_full, cfg)
    for ds in outs:
        for a, b in zip(ds.bin_mappers, ref.bin_mappers):
            assert _mapper_equal(a, b)
        assert int(ds.metadata.query_boundaries[-1]) == ds.num_data
    tp = {"objective": "lambdarank", "metric": "ndcg", "eval_at": "5",
          "num_leaves": 15, "min_data_in_leaf": 5, "verbosity": -1,
          "gpu_use_dp": True, "learning_rate": 0.1}
    serial = worker.ndcg_task(dict(tp, tree_learner="serial"), mat_full,
                              rel.astype(float), sizes, 5)
    Xr = np.concatenate([s[0] for s in shards])
    yr = np.concatenate([s[1] for s in shards])
    gr = np.concatenate([s[3] for s in shards])
    with RankPool(2, "gloo", timeout_s=120) as pool:
        data = pool.run(worker.ndcg_task, dict(tp, tree_learner="data"),
                        Xr, yr, gr, 5)
    assert data[0] == data[1]
    for k in serial:
        assert abs(serial[k] - data[0][k]) < 1e-6, (k, serial, data)


@pytest.mark.parametrize("num_machines", [2, 3])
def test_distributed_efb_bundles_rank_identical(num_machines):
    """EFB bundles from the allgathered global sample are the same on
    every rank, for contiguous and for mod-dealt shards, and the JAX
    package's."""
    rng = np.random.RandomState(9)
    n = 4000
    dense = rng.randn(n, 2)
    sparse = np.zeros((n, 6))
    sparse[np.arange(n), rng.randint(0, 6, n)] = rng.rand(n)
    sparse[rng.rand(n) < 0.5, :] = 0.0
    X = np.column_stack([dense, sparse])
    params = {"max_bin": 63, "enable_bundle": True,
              "bin_construct_sample_cnt": 2000}
    cfg = Config.from_params(params)
    cuts = np.linspace(0, n, num_machines + 1).astype(int)
    shards = [(X[cuts[r]:cuts[r + 1]],) for r in range(num_machines)]
    outs = LoopbackCluster(num_machines).run(
        lambda net, shard: distributed_construct(net, shard, cfg), shards)
    jcfg = JConfig.from_params(params)
    jouts = jdist.LoopbackCluster(num_machines).run(
        lambda net, shard: jdist.distributed_construct(net, shard, jcfg),
        shards)
    assert all(o.bundle is not None for o in outs)
    g0 = outs[0].bundle.groups
    assert any(len(g) > 1 for g in g0)
    assert jouts[0].bundle.groups == g0
    for o in outs[1:]:
        assert o.bundle.groups == g0
        np.testing.assert_array_equal(o.bundle.f_gcol,
                                      outs[0].bundle.f_gcol)
        np.testing.assert_array_equal(o.bundle.f_off, outs[0].bundle.f_off)
    outs2 = LoopbackCluster(num_machines).run(
        lambda net, shard, rows: distributed_construct(
            net, shard, cfg, global_rows=rows),
        [(X[r::num_machines], np.arange(r, n, num_machines, dtype=np.int64))
         for r in range(num_machines)])
    for o in outs2:
        assert o.bundle is not None and o.bundle.groups == g0


def test_socket_net_from_config(tmp_path):
    """The reference's config surface (``machine_list_filename``,
    ``local_listen_port``, ``time_out``) builds the construction net, as
    the JAX ``net_from_config`` does."""
    from lightgbm_tpu.io import net as jnet
    from lightgbm_tpu_torch.io.net import net_from_config, parse_machine_list

    ml = tmp_path / "mlist.txt"
    ml.write_text("# master first\n127.0.0.1 45871\n127.0.0.1 45872\n")
    assert parse_machine_list(str(ml)) == jnet.parse_machine_list(str(ml)) \
        == [("127.0.0.1", 45871), ("127.0.0.1", 45872)]
    bad = tmp_path / "bad.txt"
    bad.write_text("127.0.0.1 notaport\n")
    for parse in (parse_machine_list, jnet.parse_machine_list):
        with pytest.raises(ValueError, match="not an integer"):
            parse(str(bad))
    cfg = Config.from_params({"num_machines": 1,
                              "machine_list_filename": str(ml)})
    net = net_from_config(cfg, 0)
    assert net.allgather("x") == ["x"]
    net.close()
    cfg3 = Config.from_params({"num_machines": 3,
                               "machine_list_filename": str(ml)})
    with pytest.raises(ValueError, match="machine list"):
        net_from_config(cfg3, 0)
