"""The PyTorch port's package rules: no JAX, the device rule, loud gaps.

``lightgbm_tpu_torch`` must run where JAX is not installed, so it imports
neither ``jax`` nor anything of ``lightgbm_tpu`` (whose ``__init__`` imports
JAX).  The conftest of this suite has already imported JAX into this
process, so the import check runs in a fresh interpreter.
"""

import json
import os
import re
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config, resolve_device

# every pytest-xdist worker imports every test file and the workers share the
# machine's cores: one intra-op thread per worker keeps them from
# oversubscribing the CPU (torch's default is a thread per core)
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(str(p.relative_to(REPO)) for p in
                    (REPO / "lightgbm_tpu_torch").rglob("*.py")) \
    + ["chip_smoke.py"]
_FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|jaxlib|lightgbm_tpu)\b(?!_torch)"
    r"|from\s+(?:jax|jaxlib|lightgbm_tpu)\b(?!_torch)\S*\s+import)",
    re.MULTILINE)


def _problem(n=600, f=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


def test_import_and_dataset_leave_jax_out():
    """Every module of the port imported, a dataset built, and the CLI's
    ``__main__`` run as ``python -m`` runs it: no JAX module loaded."""
    code = (
        "import json, pkgutil, runpy, sys\n"
        "import numpy as np\n"
        "import lightgbm_tpu_torch as lt\n"
        "for m in pkgutil.walk_packages(lt.__path__, 'lightgbm_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        __import__(m.name)\n"
        "X = np.random.RandomState(0).randn(300, 4)\n"
        "ds = lt.Dataset(X, label=(X[:, 0] > 0).astype(float),\n"
        "                params={'device_type': 'cpu'}).construct()\n"
        "ds.constructed.device_bins('cpu')\n"
        "sys.argv = ['lightgbm_tpu_torch', 'task=train', 'device_type=cpu']\n"
        "try:\n"
        "    runpy.run_module('lightgbm_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 1, e.code   # no data: the CLI quits\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('jax', 'jaxlib', 'lightgbm_tpu'))))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", PORT_FILES)
def test_source_imports_no_jax(path):
    src = (REPO / path).read_text()
    assert not _FORBIDDEN.findall(src), f"{path} imports JAX or lightgbm_tpu"


def test_source_scan_catches_forbidden_imports():
    for bad in ("import jax\n", "  import jax.numpy as jnp\n",
                "from jax import lax\n", "from lightgbm_tpu.tree import T\n",
                "import lightgbm_tpu\n"):
        assert _FORBIDDEN.search(bad), bad
    for fine in ("import lightgbm_tpu_torch\n",
                 "from lightgbm_tpu_torch.ops import split\n",
                 "# lightgbm_tpu/ops/hist_pallas.py\n"):
        assert not _FORBIDDEN.search(fine), fine


@pytest.mark.parametrize("kind", [None, "tpu", "gpu", "cuda"])
def test_device_rule_card_unless_cpu(kind):
    """Unset/tpu/gpu/cuda select the card; without one the entry point
    raises instead of running on the CPU."""
    X, y = _problem()
    params = {"objective": "binary", "verbosity": -1, "num_leaves": 4}
    if kind is not None:
        params["device_type"] = kind
    if torch.cuda.is_available():
        assert resolve_device(Config.from_params(params)).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device_type=cpu"):
            lt.train(params, lt.Dataset(X, label=y), 1, verbose_eval=False)


def test_device_rule_cpu_and_alias():
    for key in ("device_type", "device"):
        cfg = Config.from_params({key: "cpu"})
        assert resolve_device(cfg) == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device(Config.from_params({"device_type": "metal"}))


@pytest.mark.parametrize("extra", [
    {"tree_learner": "feature"},
    {"trace_out": "t.json", "tree_learner": "data"},
    {"tree_learner": "data_feature"},
    {"tree_learner": "data"},
    {"tpu_learner": "masked", "tree_learner": "voting"},
])
def test_parallel_settings_train_serially_in_world_of_one(extra, tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """Without a process group of more than one rank a parallel
    ``tree_learner`` trains the serial model and says so, as the JAX
    package shards only over more than one device (the multi-rank runs:
    ``tests/test_torch_parallel.py``)."""
    monkeypatch.chdir(tmp_path)
    X, y = _problem()
    base = {"objective": "binary", "device_type": "cpu", "num_leaves": 4,
            "verbosity": 1, "tpu_learner": extra.get("tpu_learner", "auto")}

    def text(params):
        bst = lt.train(params, lt.Dataset(X, label=y), 2, verbose_eval=False)
        return [ln for ln in bst.model_to_string().splitlines()
                if not ln.startswith(("[tree_learner", "[trace_out"))]

    serial = text(dict(base, tree_learner="serial"))
    capsys.readouterr()
    assert text(dict(base, **extra)) == serial
    assert "training serially (start one process per card" \
        in capsys.readouterr().out


@pytest.mark.parametrize("extra", [
    {"resume": True, "num_machines": 2},
    {"num_hosts": 2},
    {"elastic": True},
    {"snapshot_freq": 1, "fault_spec": "net.crash:rank=1"},
    {"num_machines": 2},
    {"telemetry_out": "t.jsonl", "fault_spec": "net.send.drop"},
    {"fault_spec": "net.send.truncate:rank=1"},
    {"profile_trace_dir": "prof", "num_hosts": 2},
    {"telemetry": True, "elastic": True},
])
def test_unported_settings_raise(extra, tmp_path, monkeypatch):
    """The multi-host and elastic keys and the ``net.*`` fault points are
    ported: each of these calls does what the JAX package's same call
    does.  ``num_hosts`` without a coordinator is an under-specified pod
    (``ValueError``); ``elastic`` on an in-memory Dataset warns that it
    cannot re-deal and trains; ``num_machines`` and the ``net.*`` points
    (which fire only in a net's collectives) train."""
    import lightgbm_tpu as lj
    from lightgbm_tpu.reliability import faults as jfaults

    from lightgbm_tpu_torch.reliability import faults
    monkeypatch.chdir(tmp_path)
    for k in ("LGBT_COORDINATOR", "LGBT_NUM_HOSTS", "LGBT_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    X, y = _problem()
    params = {"objective": "binary", "verbosity": -1, "num_leaves": 4,
              "output_model": "m.txt", **extra}

    def outcome(pkg, p):
        try:
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                bst = pkg.train(p, pkg.Dataset(X, label=y, params=p), 1,
                                verbose_eval=False)
            return "trained", bst.num_trees(), [
                str(w.message)[:40] for w in got
                if w.category is RuntimeWarning]
        except Exception as e:      # noqa: BLE001 — compared below
            return type(e).__name__, str(e)[:40], []
        finally:
            faults.reset()
            jfaults.reset()

    if "profile_trace_dir" in extra:
        (tmp_path / "prof").mkdir()
    mine = outcome(lt, dict(params, device_type="cpu"))
    theirs = outcome(lj, params)
    assert mine == theirs
    assert mine[0] == ("ValueError" if "num_hosts" in extra else "trained")


def test_serving_fault_point_arms_in_training():
    """``serving.replica_fault`` is a ported point (the fleet's replicas
    fire it): a training run that arms it trains, as in the JAX package."""
    X, y = _problem()
    params = {"objective": "binary", "verbosity": -1, "device_type": "cpu",
              "num_leaves": 4, "fault_spec": "serving.replica_fault:rank=1"}
    try:
        assert lt.train(params, lt.Dataset(X, label=y), 1,
                        verbose_eval=False).num_trees() == 1
    finally:
        from lightgbm_tpu_torch.reliability import faults
        faults.reset()


def test_text_file_input_raises(tmp_path, monkeypatch):
    """A dense text file is parsed by the port's host library; where that
    cannot be built the load raises, naming the build, and never parses in
    Python.  With the library it loads."""
    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.io import parser

    path = tmp_path / "train.csv"
    path.write_text("1,0.5,0.25\n0,0.1,0.2\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(parser, "_LIB", None)
    monkeypatch.setattr(native, "_LOADED", {})
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="csrc/parse.cpp"):
        lt.Dataset(str(path), params={"device_type": "cpu"}).construct()
    monkeypatch.undo()
    ds = lt.Dataset(str(path), params={"device_type": "cpu"}).construct()
    np.testing.assert_array_equal(ds.get_label(), [1.0, 0.0])
    assert ds.num_feature() == 2


@pytest.mark.parametrize("mode", ["auto", "wave", "compact"])
def test_learner_routing_to_compact(mode, capsys):
    """``compact`` selects the compact learner; ``auto`` and ``wave`` the
    frontier-wave learner, which is eligible here, without a message."""
    from lightgbm_tpu_torch.learner_compact import CompactTreeLearner
    from lightgbm_tpu_torch.learner_wave import WaveTreeLearner

    X, y = _problem()
    params = {"objective": "binary", "device_type": "cpu", "num_leaves": 4,
              "tpu_learner": mode, "verbosity": 1}
    bst = lt.train(params, lt.Dataset(X, label=y), 1, verbose_eval=False)
    want = CompactTreeLearner if mode == "compact" else WaveTreeLearner
    assert type(bst.gbdt.learner) is want
    assert "lightgbm_tpu_torch" not in capsys.readouterr().out
