"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

Trains the compact-learner GBDT path with the same binning, split math, model
text and user API as the JAX package (``lightgbm_tpu``), which stays the
reference.  Its one on-path TPU kernel, the packed-word histogram, is a CUDA
kernel written by hand for Hopper (``csrc/hist_packed.cu``).  Entry points
run on the CUDA card unless the params say ``device_type=cpu``.  The port
imports torch and numpy, never JAX and nothing of ``lightgbm_tpu``.
"""

from .callback import (early_stopping, print_evaluation, record_evaluation,
                       reset_parameter)
from .config import Config
from .dataset import Dataset
from .engine import Booster, CVBooster, cv, train

__version__ = "0.1.0"

__all__ = ["Booster", "CVBooster", "Config", "Dataset", "cv",
           "early_stopping", "print_evaluation", "record_evaluation",
           "reset_parameter", "train"]
