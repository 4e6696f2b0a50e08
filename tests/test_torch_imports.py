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
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "import lightgbm_tpu_torch as lt\n"
        "X = np.random.RandomState(0).randn(300, 4)\n"
        "ds = lt.Dataset(X, label=(X[:, 0] > 0).astype(float),\n"
        "                params={'device_type': 'cpu'}).construct()\n"
        "ds.constructed.device_bins('cpu')\n"
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
    {"trace_out": "t.json"},
    {"resume": True},
    {"tree_learner": "data_feature"},
    {"num_hosts": 2},
    {"two_round": True},
    {"snapshot_freq": 1},
    {"tree_learner": "data"},
    {"tpu_learner": "masked", "tree_learner": "voting"},
    {"num_machines": 2},
    {"telemetry_out": "t.jsonl"},
    {"fault_spec": "grad_nan:nth=1"},
    {"profile_trace_dir": "prof"},
    {"telemetry": True},
])
def test_unported_settings_raise(extra):
    X, y = _problem()
    params = {"objective": "binary", "verbosity": -1, "device_type": "cpu",
              "num_leaves": 4, **extra}
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A"):
        lt.train(params, lt.Dataset(X, label=y), 1, verbose_eval=False)


def test_text_file_input_raises(tmp_path):
    path = tmp_path / "train.csv"
    path.write_text("1,0.5,0.25\n0,0.1,0.2\n")
    with pytest.raises(NotImplementedError, match="text-file"):
        lt.Dataset(str(path), params={"device_type": "cpu"}).construct()


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
