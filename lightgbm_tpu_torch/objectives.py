"""Objective functions: raw score -> (grad, hess) in float32.

Counterpart of ``lightgbm_tpu/objectives/__init__.py`` for ``RegressionL2``
(:146) and ``BinaryLogloss`` (:424) with their default settings (sigmoid 1,
no class rebalancing), with row weights: gradients and hessians are
multiplied by the f32 weight (``_apply_weight`` :106-109), and
``boost_from_score`` takes the weighted mean label (regression) or the
weighted share of positives (binary).  The arithmetic follows the JAX
expressions operation for operation, so both packages produce the same f32
gradients up to the last ulp of ``exp``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

_EPS = 1e-15


class _Objective:
    """Row weights (f32 on the device, f64 on the host) of an objective."""

    def __init__(self, weight: Optional[np.ndarray], device: torch.device):
        self._weight_np = None if weight is None else np.asarray(weight, np.float64)
        self.weight = (None if weight is None else
                       torch.as_tensor(self._weight_np, dtype=torch.float32, device=device))

    def _apply_weight(self, grad, hess):
        if self.weight is None:
            return grad, hess
        return grad * self.weight, hess * self.weight

    def _mean(self, pt: torch.Tensor) -> float:
        """Mean of a per-row f64 loss, weighted when the rows are."""
        if self.weight is None:
            return float(pt.mean())
        w = self.weight.double()
        return float((pt * w).sum() / w.sum())

    def to_string(self) -> str:
        return self.name


class RegressionL2(_Objective):
    """L2 loss (reference RegressionL2loss, regression_objective.hpp:95)."""

    name = "regression"
    need_train = True

    def __init__(self, label: np.ndarray, device: torch.device,
                 weight: Optional[np.ndarray] = None):
        super().__init__(weight, device)
        self._label_np = np.asarray(label, np.float64)
        self.label = torch.as_tensor(self._label_np, dtype=torch.float32, device=device)
        self.is_constant_hessian = weight is None  # every hessian is 1

    def get_gradients(self, score: torch.Tensor):
        grad = score - self.label
        return self._apply_weight(grad, torch.ones_like(grad))

    def boost_from_score(self) -> float:
        if self._weight_np is None:
            return float(np.mean(self._label_np))
        return float(np.average(self._label_np, weights=self._weight_np))

    def convert_output(self, raw: torch.Tensor) -> torch.Tensor:
        return raw

    def train_loss(self, score: torch.Tensor) -> float:
        """Mean squared error of the raw score (l2 metric), weighted."""
        d = score.double() - self.label.double()
        return self._mean(d * d)


class BinaryLogloss(_Objective):
    """Binary log-loss (reference BinaryLogloss, binary_objective.hpp:20)."""

    name = "binary"
    sigmoid = 1.0
    is_constant_hessian = False

    def __init__(self, label: np.ndarray, device: torch.device,
                 weight: Optional[np.ndarray] = None):
        super().__init__(weight, device)
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
        return self._apply_weight(response, abs_resp * (sig - abs_resp))

    def boost_from_score(self) -> float:
        if self._weight_np is None:
            pavg = float(self._pos_np.mean())
        else:
            pavg = float(np.average(self._pos_np.astype(np.float64), weights=self._weight_np))
        pavg = min(max(pavg, _EPS), 1.0 - _EPS)
        return math.log(pavg / (1.0 - pavg)) / self.sigmoid

    def convert_output(self, raw: torch.Tensor) -> torch.Tensor:
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * raw))

    def train_loss(self, score: torch.Tensor) -> float:
        """Binary log-loss of the raw score, in float64, weighted."""
        p = torch.sigmoid(score.double()).clamp(_EPS, 1.0 - _EPS)
        y = (self._y > 0).double()
        return self._mean(-(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p)))

    def to_string(self) -> str:
        return f"{self.name} sigmoid:{self.sigmoid:g}"


def create_objective(name: str, label: np.ndarray, device: torch.device,
                     weight: Optional[np.ndarray] = None):
    if name == "binary":
        return BinaryLogloss(label, device, weight)
    if name == "regression":
        return RegressionL2(label, device, weight)
    raise ValueError(f"objective {name!r} not yet ported to lightgbm_tpu_torch")


def objective_for_output(name: str, device: torch.device):
    """An objective that only converts raw scores (for boosters rebuilt from
    exported trees, which carry no training labels)."""
    return create_objective(name, np.zeros(0), device)
