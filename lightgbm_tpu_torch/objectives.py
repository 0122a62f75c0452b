"""Objective functions: raw score -> (grad, hess) in float32.

Counterpart of ``lightgbm_tpu/objectives/__init__.py`` for ``RegressionL2``
(:146) and ``BinaryLogloss`` (:424) with their default settings (no weights,
sigmoid 1, no class rebalancing).  The arithmetic follows the JAX
expressions operation for operation, so both packages produce the same f32
gradients up to the last ulp of ``exp``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-15


class RegressionL2:
    """L2 loss (reference RegressionL2loss, regression_objective.hpp:95)."""

    name = "regression"
    need_train = True
    is_constant_hessian = True  # every hessian is 1

    def __init__(self, label: np.ndarray, device: torch.device):
        self._label_np = np.asarray(label, np.float64)
        self.label = torch.as_tensor(self._label_np, dtype=torch.float32, device=device)

    def get_gradients(self, score: torch.Tensor):
        grad = score - self.label
        return grad, torch.ones_like(grad)

    def boost_from_score(self) -> float:
        return float(np.mean(self._label_np))

    def convert_output(self, raw: torch.Tensor) -> torch.Tensor:
        return raw

    def train_loss(self, score: torch.Tensor) -> float:
        """Mean squared error of the raw score (l2 metric)."""
        d = score.double() - self.label.double()
        return float((d * d).mean())


class BinaryLogloss:
    """Binary log-loss (reference BinaryLogloss, binary_objective.hpp:20)."""

    name = "binary"
    sigmoid = 1.0
    is_constant_hessian = False

    def __init__(self, label: np.ndarray, device: torch.device):
        pos = np.asarray(label, np.float64) > 0
        self._pos_np = pos
        pos_t = torch.as_tensor(pos, device=device)
        one = torch.ones((), dtype=torch.float32, device=device)
        self._y = torch.where(pos_t, one, -one)  # label in {-1, +1}
        self.need_train = bool(pos.any() and (~pos).any())

    def get_gradients(self, score: torch.Tensor):
        if not self.need_train:
            z = torch.zeros_like(score)
            return z, z
        sig = self.sigmoid
        response = -self._y * sig / (1.0 + torch.exp(self._y * sig * score))
        abs_resp = torch.abs(response)
        # label weights are 1 (no is_unbalance / scale_pos_weight)
        return response, abs_resp * (sig - abs_resp)

    def boost_from_score(self) -> float:
        pavg = float(self._pos_np.mean())
        pavg = min(max(pavg, _EPS), 1.0 - _EPS)
        return math.log(pavg / (1.0 - pavg)) / self.sigmoid

    def convert_output(self, raw: torch.Tensor) -> torch.Tensor:
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * raw))

    def train_loss(self, score: torch.Tensor) -> float:
        """Binary log-loss of the raw score, in float64."""
        p = torch.sigmoid(score.double()).clamp(_EPS, 1.0 - _EPS)
        y = (self._y > 0).double()
        return float(-(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p)).mean())


def create_objective(name: str, label: np.ndarray, device: torch.device):
    if name == "binary":
        return BinaryLogloss(label, device)
    if name == "regression":
        return RegressionL2(label, device)
    raise ValueError(f"objective {name!r} not yet ported to lightgbm_tpu_torch")


def objective_for_output(name: str, device: torch.device):
    """An objective that only converts raw scores (for boosters rebuilt from
    exported trees, which carry no training labels)."""
    return create_objective(name, np.zeros(0), device)
