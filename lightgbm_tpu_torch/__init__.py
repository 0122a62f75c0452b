"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

Trains gradient-boosted trees on the segment-resident layout and predicts
through the forest walk; the hot loops are CUDA kernels for Hopper
(``csrc/``, built by ``nvcc`` at first use into ``build/``), each beside a
plain PyTorch version that runs when the tensors lie on the CPU.  Entry
points run on the CUDA card unless the caller passes ``device='cpu'``.
"""

from .boosting.gbdt import Booster
from .dataset import Dataset
from .engine import train

__all__ = ["Booster", "Dataset", "train"]
