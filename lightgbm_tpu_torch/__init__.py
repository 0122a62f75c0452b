"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

Trains gradient-boosted trees on the segment-resident layout and predicts
through the forest walk; the hot loops are CUDA kernels for Hopper
(``csrc/``, built by ``nvcc`` at first use into ``build/``), each beside a
plain PyTorch version that runs when the tensors lie on the CPU.  Entry
points run on the CUDA card unless the caller passes ``device='cpu'``.
``train`` takes validation sets and callbacks; a Booster writes and reads
LightGBM's model text.
"""

from .boosting.gbdt import Booster
from .callback import EarlyStopException, early_stopping, log_evaluation, record_evaluation
from .dataset import Dataset
from .engine import train

__all__ = ["Booster", "Dataset", "EarlyStopException", "early_stopping", "log_evaluation",
           "record_evaluation", "train"]
