"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

Trains and predicts with the same binning, split math, model text and user
API as the JAX package (``lightgbm_tpu``), which stays the reference: the
``train`` / ``cv`` / ``Booster`` API, the scikit-learn estimators
(``sklearn.py``), the plotting helpers (``plotting.py``) and the CLI
(``python -m lightgbm_tpu_torch``).  Every TPU kernel of the JAX package is a
CUDA kernel written by hand for Hopper (``csrc/*.cu``).  Entry points run on
the CUDA card unless the params say ``device_type=cpu``.  The port imports
torch and numpy, never JAX and nothing of ``lightgbm_tpu``.
"""

from .callback import (early_stopping, print_evaluation, record_evaluation,
                       record_telemetry, reset_parameter)
from .config import Config
from .dataset import Dataset
from .engine import Booster, CVBooster, cv, train
from .plotting import (create_tree_digraph, plot_importance, plot_metric,
                       plot_tree)
from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor

__version__ = "0.1.0"

__all__ = ["Booster", "CVBooster", "Config", "Dataset", "cv",
           "early_stopping", "print_evaluation", "record_evaluation",
           "record_telemetry", "reset_parameter", "train", "LGBMModel", "LGBMRegressor",
           "LGBMClassifier", "LGBMRanker", "plot_importance", "plot_metric",
           "plot_tree", "create_tree_digraph"]
