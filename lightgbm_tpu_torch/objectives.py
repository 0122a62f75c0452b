"""Objective functions: raw score -> (grad, hess) in float32.

Counterpart of ``lightgbm_tpu/objectives/__init__.py`` for ``RegressionL2``
(:146) and ``BinaryLogloss`` (:424) with their default settings (sigmoid 1,
no class rebalancing), with row weights: gradients and hessians are
multiplied by the f32 weight (``_apply_weight`` :106-109), and
``boost_from_score`` takes the weighted mean label (regression) or the
weighted share of positives (binary).  The arithmetic follows the JAX
expressions operation for operation, and the binary gradients take their
``exp`` from ``xla_exp``, the f32 ``exp`` that XLA compiles on the CPU, so
both packages produce the same f32 gradients bit for bit (``torch.exp``
differs from it in the last ulp on about 9% of inputs, which flips near-tie
splits).  The card runs the same function, so the gradients do not depend
on the device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

_EPS = 1e-15

# Cephes' expf as XLA:CPU emits it for f32: the polynomial's coefficients
# p0 .. p5, ln 2 split in two, and the input's clamp
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
          1.6666665459e-1, 5.0000001201e-1)
_LOG2E = 1.44269504088896341
_LN2_HI, _LN2_LO = 0.693359375, -2.12194440e-4
_EXP_LO, _EXP_HI = -87.8, 88.8
_F32_MIN_NORMAL = 2.0**-126


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add: the product
    of two f32 values is exact in f64, the sum's error comes from TwoSum,
    and a sum that is not exact is rounded to odd (its last f64 bit set by
    one step toward the error), so that its one rounding to f32 is the
    correct rounding of the exact value."""
    a, b, c = torch.broadcast_tensors(*(torch.as_tensor(v, dtype=torch.float32, device=a.device)
                                        for v in (a, b, c)))
    p, c64 = a.double() * b.double(), c.double()
    s = p + c64
    bp = s - p
    err = (p - (s - bp)) + (c64 - bp)
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.full_like(s, math.inf)
    s = torch.where((err != 0) & even, torch.nextafter(s, torch.where(err > 0, inf, -inf)), s)
    return s.float()


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """f32 ``exp`` equal bit for bit to XLA:CPU's (``jax.jit(jnp.exp)`` on
    the CPU; held against it by tests/test_torch_exp.py): the input clamped
    to [-87.8, 88.8], n = floor(x log2(e) + 1/2) clamped to [-127, 127],
    r = x - n ln 2 in two fused steps, Cephes' degree-5 polynomial in r by
    fused multiply-adds, then 2^n exactly, with XLA's flush of results
    below the least normal f32 to zero."""
    x = torch.clamp(x.to(torch.float32), _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma_f32(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma_f32(n, -_LN2_HI, x)
    r = fma_f32(n, -_LN2_LO, r)
    y = torch.full_like(r, _EXP_P[0])
    for p in _EXP_P[1:]:
        y = fma_f32(y, r, p)
    y = fma_f32(y, r * r, r) + 1.0
    v = y.double() * ((n.to(torch.int64) + 1023) << 52).view(torch.float64)  # y * 2^n, exact
    return torch.where(v < _F32_MIN_NORMAL, torch.zeros_like(y), v.float())


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
        response = -self._y * sig / (1.0 + xla_exp(self._y * sig * score))
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
