"""The command line: the port's ``cli.main`` against lightgbm_tpu's.

A generated conf (L2, ``gpu_use_dp``, a few dozen rows per leaf, a
validation file) trains through both CLIs in this process: the model files
must be equal, and ``task=predict`` outputs of the two agree within 1e-6;
``task=refit`` and ``task=convert_model`` write equal files.  The conf runs
the masked learner, whose JAX programs compile in a few seconds.  The
argument parser takes what the JAX package's takes.  ``task=serve`` with
``serve_replicas=2`` serves through the fleet gateway, ``autopilot=true``
without its inputs raises; the training telemetry and resume keys train,
and so does ``num_machines=2``, to the JAX CLI's model.  One subprocess runs
``python -m lightgbm_tpu_torch`` on the CPU and loads no JAX module.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lightgbm_tpu.cli as jcli
from lightgbm_tpu_torch import cli

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONF = """# generated: L2 regression on a CSV with the label first
task = train
objective = regression
data = train.csv
valid = valid.csv
num_iterations = 6
learning_rate = 0.2
num_leaves = 15
min_data_in_leaf = 30
max_bin = 63
gpu_use_dp = true
tpu_learner = masked
metric = l2
verbosity = -1
"""


def _write_csv(path, X, y):
    with open(path, "w") as fh:
        for yi, r in zip(y, X):
            fh.write(",".join([repr(float(yi))] + ["" if np.isnan(v) else
                                                    repr(float(v))
                                                    for v in r]) + "\n")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    X = rng.randn(2600, 5)
    X[::11, 3] = np.nan
    y = X[:, 0] + 0.5 * np.nan_to_num(X[:, 3]) * X[:, 1] \
        + 0.1 * rng.randn(2600)
    _write_csv(d / "train.csv", X[:1500], y[:1500])
    _write_csv(d / "valid.csv", X[1500:2000], y[1500:2000])
    _write_csv(d / "test.csv", X[2000:2300], y[2000:2300])
    _write_csv(d / "refit.csv", X[2300:], y[2300:] + 0.3)
    (d / "train.conf").write_text(CONF)
    old = os.getcwd()
    os.chdir(d)
    try:
        assert cli.main(["config=train.conf", "output_model=port.txt",
                         "device_type=cpu"]) == 0
        assert jcli.main(["config=train.conf", "output_model=jax.txt"]) == 0
    finally:
        os.chdir(old)
    return d


def _run_both(d, args):
    old = os.getcwd()
    os.chdir(d)
    try:
        assert cli.main([a.replace("{pkg}", "port") for a in args]
                        + ["device_type=cpu"]) == 0
        assert jcli.main([a.replace("{pkg}", "jax") for a in args]) == 0
    finally:
        os.chdir(old)


def test_train_writes_the_jax_model(workdir):
    port = (workdir / "port.txt").read_text()
    assert port == (workdir / "jax.txt").read_text()
    assert port.count("Tree=") == 6


def test_predict_agrees_with_jax(workdir):
    for extra in ([], ["predict_raw_score=true"], ["predict_leaf_index=true"]):
        _run_both(workdir, ["task=predict", "data=test.csv",
                            "input_model={pkg}.txt",
                            "output_result={pkg}_pred.txt"] + extra)
        got = np.loadtxt(workdir / "port_pred.txt")
        want = np.loadtxt(workdir / "jax_pred.txt")
        assert got.shape == want.shape and len(got) == 300
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_refit_and_convert_model_match(workdir):
    _run_both(workdir, ["task=refit", "data=refit.csv",
                        "input_model={pkg}.txt",
                        "output_model={pkg}_refit.txt"])
    refit = (workdir / "port_refit.txt").read_text()
    assert refit == (workdir / "jax_refit.txt").read_text()
    assert refit != (workdir / "port.txt").read_text()
    _run_both(workdir, ["convert_model", "input_model={pkg}.txt",
                        "convert_model={pkg}.cpp"])
    src = (workdir / "port.cpp").read_text()
    assert src == (workdir / "jax.cpp").read_text()
    assert "double Predict(const double* arr)" in src


@pytest.mark.parametrize("argv", [
    ["config=train.conf", "num_leaves=7"],
    ["predict", "--input-model", "m.txt", "--data=test.csv", "--header"],
    ["train", "config=train.conf", "--num-iterations", "3", "num_trees=4"],
])
def test_argument_parsing_equals_jax(workdir, argv):
    old = os.getcwd()
    os.chdir(workdir)
    try:
        assert cli._load_params(argv) == jcli._load_params(argv)
    finally:
        os.chdir(old)


def test_serve_and_telemetry_raise_named_errors(workdir):
    """``task=serve serve_replicas=2`` serves through the fleet gateway (two
    CPU replicas answer Booster.predict's scores, then shut down), and
    ``autopilot=true`` without the train source raises naming ``data=``.
    The telemetry keys train: ``--telemetry-out`` (implying telemetry)
    writes the report, ``--resume`` continues from the newest snapshot;
    ``num_machines=2`` trains the model both CLIs train without it."""
    import socket
    import threading

    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.observability import validate_report
    from lightgbm_tpu_torch.serving import ServingClient

    model = str(workdir / "port.txt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    done = []
    served = threading.Thread(target=lambda: done.append(cli.main(
        ["task=serve", "input_model=" + model, "serve_replicas=2",
         f"serve_port={port}", "serve_min_bucket=64",
         "serve_max_batch_rows=64", "device_type=cpu"])))
    served.start()
    try:
        X = np.random.RandomState(1).randn(20, 5)
        with ServingClient("127.0.0.1", port, timeout=60, retries=40,
                           backoff_s=0.25) as c:
            assert c.health()["replicas"] == 2
            np.testing.assert_allclose(
                np.asarray(c.predict(X)),
                lt.Booster(model_file=model,
                           params={"device_type": "cpu"}).predict(X),
                rtol=1e-9, atol=1e-9)
            c.shutdown()
    finally:
        served.join(120)
    assert done == [0]
    with pytest.raises(ValueError, match="data="):
        cli.main(["task=serve", "input_model=" + model, "serve_replicas=2",
                  "serve_port=0", "lifecycle_record_rows=64",
                  "autopilot=true", "device_type=cpu"])
    old = os.getcwd()
    os.chdir(workdir)
    try:
        args = ["config=train.conf", "device_type=cpu", "snapshot_freq=2",
                "output_model=tel.txt"]
        assert cli.main(args + ["--telemetry-out", "t.json"]) == 0
        rep = json.loads((workdir / "t.json").read_text())
        assert validate_report(rep) == [] and rep["enabled"]
        assert rep["iterations"]["count"] == 6
        assert cli.main(args + ["--resume"]) == 0
        assert (workdir / "tel.txt").read_text() \
            == (workdir / "port.txt").read_text()
        # num_machines only deals the rows of a stream across machines
        # (``io/distributed.py``): an in-memory CLI run trains the same
        # model with it, as the JAX CLI does
        plain = ["config=train.conf", "device_type=cpu",
                 "output_model=nm2.txt", "num_machines=2"]
        assert cli.main(plain) == 0
        assert jcli.main(["config=train.conf", "output_model=jnm2.txt",
                          "num_machines=2"]) == 0
        assert (workdir / "nm2.txt").read_text() \
            == (workdir / "jnm2.txt").read_text() \
            == (workdir / "port.txt").read_text()
    finally:
        os.chdir(old)


def test_module_entry_point_loads_no_jax(workdir):
    """``python -m lightgbm_tpu_torch`` trains on the CPU; ``-X importtime``
    lists every module the run imported."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "lightgbm_tpu_torch",
         "config=train.conf", "device_type=cpu", "num_iterations=2",
         "output_model=sub.txt"],
        cwd=workdir, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    mods = [ln.rsplit("|", 1)[-1].strip() for ln in out.stderr.splitlines()
            if ln.startswith("import time:")]
    assert "lightgbm_tpu_torch.cli" in mods
    assert not [m for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", "lightgbm_tpu")]
    assert (workdir / "sub.txt").read_text().count("Tree=") == 2
