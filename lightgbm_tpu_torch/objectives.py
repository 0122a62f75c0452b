"""Objective functions: raw score -> (grad, hess) in float32.

Counterpart of ``lightgbm_tpu/objectives/__init__.py:33-680`` (ranking,
:682-938, is not ported): ``_weighted_percentile`` (:33-67); L2 with
``reg_sqrt`` (:146), L1 (:184), Huber (:229), Fair (:253), Poisson (:282),
Quantile (:318), MAPE (:361), Gamma (:391), Tweedie (:404); binary log-loss
(:424, sigmoid from the params, no class rebalancing); softmax and
one-vs-all multiclass (:497, :553); cross-entropy and its lambda form
(:598, :633); and the factory's names (:945-962).

Each objective takes a ``[k, N]`` score (or an ``[N]`` one, for the
objectives with one model an iteration) and gives ``(grad, hess)`` of the
same shape, with ``boost_from_score(class_id)``, ``class_need_train``,
``convert_output``, ``renew_tree_output`` (the host-side leaf renewal of
L1, Quantile and MAPE, in f64 with numpy, exactly as the JAX package) and
``to_string``.  Row weights multiply the gradients and hessians as f32
(``_apply_weight`` :106-109).

The gradients equal the JAX package's bit for bit on the CPU, as the JAX
Booster evaluates them (operation by operation with XLA:CPU; under one
``jax.jit`` XLA folds the label and weight constants together and fuses
multiply-adds, which the Booster never does), and on the card: the arithmetic follows
the JAX expressions operation for operation in f32, and every function
whose XLA:CPU form torch's own does not match is written in that form, one
function on both devices:

* ``xla_exp``: Cephes' expf with fused multiply-adds (``jnp.exp``; torch's
  differs in the last ulp on about 9% of inputs);
* ``xla_log`` / ``xla_log1p``: XLA:CPU's Cephes logf (its polynomial split
  in three Horner chains, fused multiply-adds) and its log1p (a rational
  function of x below sqrt(2) - 1, else log(1 + x)); torch's differ on 10%
  and 20% of inputs;
* ``xla_sigmoid``: ``jax.nn.sigmoid`` is 1 / (1 + exp(-x));
* ``xla_softmax``: ``jax.nn.softmax`` over the class axis: max, exp(x -
  max), the sum in class order, a division;
* ``ftz``: XLA:CPU runs with subnormal results flushed to zero, so every
  operation whose result can be subnormal is flushed.

A division is always of two tensors of the same shape: PyTorch computes
``tensor / python_scalar`` on the card, and ``python_scalar / tensor`` on
both devices, through a reciprocal, which is not the correctly rounded
quotient.
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
# Cephes' logf as XLA:CPU emits it (all f32): sqrt(1/2), the polynomial's
# coefficients p0 .. p8, and ln 2 split in two
_LOG_SQRTHF = 0.7071067690849304
_LOG_P = (0.07037683576345444, -0.11514610052108765, 0.11676998436450958,
          -0.12420140951871872, 0.14249323308467865, -0.16668057441711426,
          0.2000071406364441, -0.24999994039535522, 0.3333333134651184)
_LOG_Q1, _LOG_Q2 = -0.00021219444170128554, 0.693359375
# XLA:CPU's log1p below sqrt(2) - 1: numerator and denominator, highest
# power first, each started from 0 * x (Horner in f32)
_LOG1P_NUM = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
              29.91191864013672, 60.949668884277344, 57.11296463012695,
              20.039552688598633)
_LOG1P_DEN = (1.0, 15.062909126281738, 83.04756927490234, 221.7624053955078,
              309.0987243652344, 216.42788696289062, 60.11865997314453)
_LOG1P_SMALL = 0.4142135679721832


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


def ftz(v: torch.Tensor) -> torch.Tensor:
    """Subnormal f32 values flushed to a zero of their sign, as XLA:CPU's
    arithmetic leaves them."""
    return torch.where(v.abs() < _F32_MIN_NORMAL, v * 0.0, v)


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


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """f32 ``log`` equal bit for bit to XLA:CPU's (``jax.jit(jnp.log)``):
    frexp of the input (clamped up to the least normal), the mantissa
    shifted to [sqrt(1/2), sqrt(2)) - 1, Cephes' degree-8 polynomial as
    three interleaved Horner chains in x^3 by fused multiply-adds, then the
    exponent times ln 2 in two parts; 0 (and a subnormal, read as 0) gives
    -inf, +inf gives +inf, a negative input or NaN a NaN."""
    x = ftz(x.to(torch.float32))
    xc = torch.where(x > _F32_MIN_NORMAL, x, torch.full_like(x, _F32_MIN_NORMAL))
    bits = xc.view(torch.int32)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 127).float() + 1.0
    small = m < _LOG_SQRTHF
    e = e - small.float()
    t = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    z = t * t
    t3 = z * t
    p = _LOG_P
    a = fma_f32(fma_f32(t, p[0], p[1]), t, p[2])
    b = fma_f32(fma_f32(t, p[3], p[4]), t, p[5])
    c = fma_f32(fma_f32(t, p[6], p[7]), t, p[8])
    y = fma_f32(fma_f32(fma_f32(a, t3, b), t3, c), t3, e * _LOG_Q1)
    out = fma_f32(e, _LOG_Q2, fma_f32(z, -0.5, t) + y)
    out = torch.where(x == 0, torch.full_like(out, -math.inf), out)
    out = torch.where(x == math.inf, torch.full_like(out, math.inf), out)
    return torch.where((x < 0) | torch.isnan(x), torch.full_like(out, math.nan), out)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """f32 ``log1p`` equal bit for bit to XLA:CPU's (``jax.jit(jnp.log1p)``):
    below sqrt(2) - 1 in magnitude x + (-x^2 / 2 + x^3 * N(x) / D(x)) with
    the rational function of Cephes' log1p (Horner by fused multiply-adds),
    else ``xla_log(1 + x)``; a subnormal input reads as 0."""
    x = ftz(x.to(torch.float32))
    x2 = x * x
    num = fma_f32(x, 0.0, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = fma_f32(num, x, c)
    den = fma_f32(x, 0.0, _LOG1P_DEN[0])
    for c in _LOG1P_DEN[1:]:
        den = fma_f32(den, x, c)
    small = x + fma_f32(x2, -0.5, ftz((x * x2) * (num / den)))
    return torch.where(x.abs() < _LOG1P_SMALL, small, xla_log(x + 1.0))


def _div(a, b: torch.Tensor) -> torch.Tensor:
    """f32 a / b rounded once (``a`` a tensor or a number), flushed."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    return ftz(a / b)


def xla_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA:CPU computes it: 1 / (1 + exp(-x))."""
    return _div(1.0, xla_exp(-x) + 1.0)


def xla_softmax(score: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax(score, axis=0)`` of a [k, N] score as XLA:CPU
    computes it: exp(x - max) over each column, summed in class order."""
    e = xla_exp(score - score.max(dim=0, keepdim=True).values)
    total = e[0]
    for c in range(1, e.shape[0]):
        total = total + e[c]
    return _div(e, total.expand_as(e).contiguous())


def _weighted_percentile(values: np.ndarray, weights: Optional[np.ndarray], alpha: float) -> float:
    """Percentile of l1 / quantile / mape boost-from-score and leaf renewal
    (reference PercentileFun / WeightedPercentileFun,
    regression_objective.hpp:18-88; lightgbm_tpu/objectives/__init__.py:33-67):
    linear interpolation between the two order statistics around the alpha
    position, in f64."""
    values = np.asarray(values, dtype=np.float64)
    cnt = len(values)
    if cnt == 0:
        return 0.0
    if cnt == 1:
        return float(values[0])
    if weights is None:
        sorted_v = np.sort(values)
        float_pos = (cnt - 1) * alpha
        pos = int(float_pos)
        bias = float_pos - pos
        if pos + 1 < cnt:
            return float(sorted_v[pos] * (1 - bias) + sorted_v[pos + 1] * bias)
        return float(sorted_v[pos])
    order = np.argsort(values, kind="stable")
    sv = values[order]
    sw = np.asarray(weights, dtype=np.float64)[order]
    cdf = np.cumsum(sw)
    threshold = cdf[-1] * alpha
    pos = int(np.searchsorted(cdf, threshold, side="right"))
    pos = min(pos, cnt - 1)
    if pos == 0 or pos == cnt - 1:
        return float(sv[pos])
    v1, v2 = sv[pos - 1], sv[pos]
    if pos + 1 < cnt and cdf[pos + 1] - cdf[pos] >= 1.0:
        return float((threshold - cdf[pos]) / (cdf[pos + 1] - cdf[pos]) * (v2 - v1) + v1)
    return float(v2)


def _f32(v: float) -> float:
    """A Python float rounded to f32, as JAX's weak-typed constants are."""
    return float(np.float32(v))


class _Objective:
    """Labels and row weights (f32 on the device, f64 on the host) of an
    objective with one model an iteration; ``get_gradients`` takes an [N]
    or a [1, N] score and gives the same shape."""

    name = "custom"
    num_class = 1
    is_constant_hessian = False
    is_renew_tree_output = False

    def __init__(self, config, label: np.ndarray, weight: Optional[np.ndarray], device):
        self.device = torch.device(device)
        self._label_np = np.asarray(label, np.float64)
        self._weight_np = None if weight is None else np.asarray(weight, np.float64)
        self.label = torch.as_tensor(self._label_np, dtype=torch.float32, device=self.device)
        self.weight = (None if weight is None else
                       torch.as_tensor(self._weight_np, dtype=torch.float32, device=self.device))
        self.need_train = True

    def get_gradients(self, score: torch.Tensor):
        if score.dim() == 2:
            g, h = self._gradients(score[0])
            return g[None], h[None]
        return self._gradients(score)

    def _gradients(self, s: torch.Tensor):
        raise NotImplementedError

    def _apply_weight(self, grad, hess):
        if self.weight is None:
            return grad, hess
        return ftz(grad * self.weight), ftz(hess * self.weight)

    def _mean(self, pt: torch.Tensor) -> float:
        """Mean of a per-row f64 loss, weighted when the rows are."""
        if self.weight is None:
            return float(pt.mean())
        w = self.weight.double()
        return float((pt * w).sum() / w.sum())

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def class_need_train(self, class_id: int) -> bool:
        return True

    def convert_output(self, raw: torch.Tensor) -> torch.Tensor:
        return raw

    def renew_tree_output(self, score: np.ndarray, leaf_id: np.ndarray,
                          leaf_values: np.ndarray, mask: Optional[np.ndarray]) -> np.ndarray:
        return leaf_values

    def to_string(self) -> str:
        return self.name


# ============================================================ regression family
class RegressionL2(_Objective):
    """L2 loss (reference RegressionL2loss, regression_objective.hpp:95),
    on sign(y) sqrt(|y|) with ``reg_sqrt``."""

    name = "regression"

    def __init__(self, config, label, weight, device):
        self.sqrt = bool(getattr(config, "reg_sqrt", False))
        if self.sqrt:
            label = np.asarray(label, np.float64)
            label = np.sign(label) * np.sqrt(np.abs(label))
        super().__init__(config, label, weight, device)
        self.is_constant_hessian = weight is None  # every hessian is 1

    def _gradients(self, s):
        grad = ftz(s - self.label)
        return self._apply_weight(grad, torch.ones_like(grad))

    def boost_from_score(self, class_id: int = 0) -> float:
        if self._weight_np is None:
            return float(np.mean(self._label_np))
        return float(np.average(self._label_np, weights=self._weight_np))

    def convert_output(self, raw):
        return torch.sign(raw) * raw * raw if self.sqrt else raw

    def train_loss(self, score: torch.Tensor) -> float:
        """Mean squared error of the raw score (l2 metric), weighted."""
        d = score.double() - self.label.double()
        return self._mean(d * d)

    def to_string(self):
        return f"{self.name} sqrt" if self.sqrt else self.name


class _Renewing(_Objective):
    """Leaf renewal (regression_objective.hpp:252): each leaf's output is
    the weighted ``alpha`` percentile of the residuals of its in-bag rows,
    taken in row order (the JAX package's ``leaf_id == leaf`` selection):
    the in-bag rows are grouped by leaf with one stable sort, not one pass
    over all rows a leaf."""

    is_renew_tree_output = True
    _alpha = 0.5

    def _renew_weights(self) -> Optional[np.ndarray]:
        return self._weight_np

    def renew_tree_output(self, score, leaf_id, leaf_values, mask):
        out = np.array(leaf_values, dtype=np.float64)
        w = self._renew_weights()
        rows = np.arange(len(score)) if mask is None else np.flatnonzero(mask > 0)
        leaf = np.asarray(leaf_id)[rows]
        rows = rows[np.argsort(leaf, kind="stable")]
        residual = self._label_np[rows] - np.asarray(score, np.float64)[rows]
        wr = None if w is None else w[rows]
        ends = np.cumsum(np.bincount(leaf, minlength=len(out))[: len(out)])
        for j in range(len(out)):
            lo, hi = (ends[j - 1] if j else 0), ends[j]
            if hi > lo:
                out[j] = _weighted_percentile(
                    residual[lo:hi], None if wr is None else wr[lo:hi], self._alpha)
        return out


class RegressionL1(_Renewing):
    """L1 loss (reference RegressionL1loss, regression_objective.hpp:205)."""

    name = "regression_l1"

    def __init__(self, config, label, weight, device):
        super().__init__(config, label, weight, device)
        self.is_constant_hessian = weight is None

    def _gradients(self, s):
        grad = torch.sign(ftz(s - self.label))
        return self._apply_weight(grad, torch.ones_like(grad))

    def boost_from_score(self, class_id: int = 0) -> float:
        return _weighted_percentile(self._label_np, self._weight_np, 0.5)


class RegressionHuber(_Objective):
    """Huber loss (reference RegressionHuberLoss, regression_objective.hpp:292)."""

    name = "huber"

    def __init__(self, config, label, weight, device):
        super().__init__(config, label, weight, device)
        self.alpha = float(config.alpha)
        self.is_constant_hessian = weight is None

    def _gradients(self, s):
        a = _f32(self.alpha)
        grad = torch.clamp(ftz(s - self.label), -a, a)
        return self._apply_weight(grad, torch.ones_like(grad))

    boost_from_score = RegressionL2.boost_from_score


class RegressionFair(_Objective):
    """Fair loss (reference RegressionFairLoss, regression_objective.hpp:351)."""

    name = "fair"

    def __init__(self, config, label, weight, device):
        super().__init__(config, label, weight, device)
        self.c = float(config.fair_c)

    def _gradients(self, s):
        x = ftz(s - self.label)
        denom = x.abs() + _f32(self.c)
        grad = _div(ftz(x * _f32(self.c)), denom)
        hess = _div(_f32(self.c * self.c), ftz(denom * denom))
        return self._apply_weight(grad, hess)

    boost_from_score = RegressionL2.boost_from_score


class RegressionPoisson(_Objective):
    """Poisson loss (reference RegressionPoissonLoss, regression_objective.hpp:398)."""

    name = "poisson"

    def __init__(self, config, label, weight, device):
        super().__init__(config, label, weight, device)
        self.max_delta_step = float(config.poisson_max_delta_step)
        if np.min(self._label_np, initial=0.0) < 0:
            raise ValueError(f"[{self.name}]: at least one target label is negative")
        if len(self._label_np) and np.sum(self._label_np) == 0:
            raise ValueError(f"[{self.name}]: sum of labels is zero")

    def _gradients(self, s):
        exp_score = xla_exp(s)
        grad = ftz(exp_score - self.label)
        hess = ftz(exp_score * _f32(math.exp(self.max_delta_step)))
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        mean = RegressionL2.boost_from_score(self)
        return math.log(max(mean, 1e-300))

    def convert_output(self, raw):
        return torch.exp(raw)


class RegressionQuantile(_Renewing):
    """Quantile loss (reference RegressionQuantileloss, regression_objective.hpp:478)."""

    name = "quantile"

    def __init__(self, config, label, weight, device):
        super().__init__(config, label, weight, device)
        self.alpha = float(config.alpha)
        if not 0.0 < self.alpha < 1.0:
            raise ValueError("alpha must be in (0, 1) for quantile objective")
        self._alpha = self.alpha

    def _gradients(self, s):
        delta = ftz(s - self.label)
        grad = torch.where(delta >= 0, torch.full_like(delta, _f32(1.0 - self.alpha)),
                           torch.full_like(delta, _f32(-self.alpha)))
        return self._apply_weight(grad, torch.ones_like(grad))

    def boost_from_score(self, class_id: int = 0) -> float:
        return _weighted_percentile(self._label_np, self._weight_np, self.alpha)

    def to_string(self):
        return f"{self.name} alpha:{self.alpha:g}"


class RegressionMAPE(RegressionL1):
    """MAPE loss (reference RegressionMAPELOSS, regression_objective.hpp:578):
    the L1 gradient times 1 / max(1, |label|) (times the weight)."""

    name = "mape"

    def __init__(self, config, label, weight, device):
        super().__init__(config, label, weight, device)
        lw = 1.0 / np.maximum(1.0, np.abs(self._label_np))
        if self._weight_np is not None:
            lw = lw * self._weight_np
        self._label_weight_np = lw
        self._label_weight = torch.as_tensor(lw, dtype=torch.float32, device=self.device)
        self.is_constant_hessian = True

    def _gradients(self, s):
        grad = ftz(torch.sign(ftz(s - self.label)) * self._label_weight)
        hess = torch.ones_like(grad) if self.weight is None else self.weight.clone()
        return grad, hess

    def boost_from_score(self, class_id: int = 0) -> float:
        return _weighted_percentile(self._label_np, self._label_weight_np, 0.5)

    def _renew_weights(self):
        return self._label_weight_np


class RegressionGamma(RegressionPoisson):
    """Gamma loss (reference RegressionGammaLoss, regression_objective.hpp:682)."""

    name = "gamma"

    def _gradients(self, s):
        exp_neg = xla_exp(-s)
        le = ftz(self.label * exp_neg)
        return self._apply_weight(ftz(1.0 - le), le)


class RegressionTweedie(RegressionPoisson):
    """Tweedie loss (reference RegressionTweedieLoss, regression_objective.hpp:718)."""

    name = "tweedie"

    def __init__(self, config, label, weight, device):
        super().__init__(config, label, weight, device)
        self.rho = float(config.tweedie_variance_power)

    def _gradients(self, s):
        one, two = _f32(1.0 - self.rho), _f32(2.0 - self.rho)
        exp1 = xla_exp(ftz(s * one))
        exp2 = xla_exp(ftz(s * two))
        neg = -self.label
        grad = ftz(ftz(neg * exp1) + exp2)
        hess = ftz(ftz(ftz(neg * one) * exp1) + ftz(exp2 * two))
        return self._apply_weight(grad, hess)


# ================================================================ binary family
class BinaryLogloss(_Objective):
    """Binary log-loss (reference BinaryLogloss, binary_objective.hpp:20);
    ``is_pos`` picks the positive rows (label > 0; OVA's class k: label == k)."""

    name = "binary"
    is_constant_hessian = False

    def __init__(self, config, label, weight, device, is_pos=None):
        super().__init__(config, label, weight, device)
        self.sigmoid = float(getattr(config, "sigmoid", 1.0))
        if self.sigmoid <= 0:
            raise ValueError("sigmoid parameter must be > 0")
        pos = (self._label_np > 0) if is_pos is None else np.asarray(is_pos, bool)
        self._pos_np = pos
        pos_t = torch.as_tensor(pos, device=self.device)
        one = torch.ones((), dtype=torch.float32, device=self.device)
        self._y = torch.where(pos_t, one, -one)  # label in {-1, +1}
        self.need_train = bool(pos.any() and (~pos).any())

    def _gradients(self, s):
        if not self.need_train:
            z = torch.zeros_like(s)
            return z, z
        sig = _f32(self.sigmoid)
        response = _div(-self._y * sig, 1.0 + xla_exp(ftz(ftz(self._y * sig) * s)))
        abs_resp = torch.abs(response)
        # label weights are 1 (no is_unbalance / scale_pos_weight)
        return self._apply_weight(response, ftz(abs_resp * ftz(sig - abs_resp)))

    def boost_from_score(self, class_id: int = 0) -> float:
        if self._weight_np is None:
            pavg = float(self._pos_np.mean()) if len(self._pos_np) else 0.0
        else:
            pavg = float(np.average(self._pos_np.astype(np.float64), weights=self._weight_np))
        pavg = min(max(pavg, _EPS), 1.0 - _EPS)
        return math.log(pavg / (1.0 - pavg)) / self.sigmoid

    def class_need_train(self, class_id: int) -> bool:
        return self.need_train

    def convert_output(self, raw):
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * raw))

    def train_loss(self, score: torch.Tensor) -> float:
        """Binary log-loss of the raw score, in float64, weighted."""
        p = torch.sigmoid(score.double()).clamp(_EPS, 1.0 - _EPS)
        y = (self._y > 0).double()
        return self._mean(-(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p)))

    def to_string(self):
        return f"{self.name} sigmoid:{self.sigmoid:g}"


# ============================================================ multiclass family
class MulticlassSoftmax(_Objective):
    """Softmax multiclass (reference MulticlassSoftmax, multiclass_objective.hpp:24)."""

    name = "multiclass"

    def __init__(self, config, label, weight, device):
        super().__init__(config, label, weight, device)
        self.num_class = int(config.num_class)
        if self.num_class < 2:
            raise ValueError("multiclass objective requires num_class >= 2")
        # rescales the redundant K-output parameterization (Friedman's GBDT paper)
        self.factor = self.num_class / (self.num_class - 1.0)
        li = self._label_np.astype(np.int64)
        if len(li) and (li.min() < 0 or li.max() >= self.num_class):
            raise ValueError(f"label must be in [0, {self.num_class})")
        if self._weight_np is None:
            probs = np.bincount(li, minlength=self.num_class).astype(np.float64)
            probs /= max(len(li), 1)
        else:
            probs = np.zeros(self.num_class)
            np.add.at(probs, li, self._weight_np)
            probs /= self._weight_np.sum()
        self.class_init_probs = probs
        cls = torch.arange(self.num_class, device=self.device)[:, None]
        self._onehot = (torch.as_tensor(li, device=self.device)[None, :] == cls).float()  # [K, N]

    def get_gradients(self, score):
        p = xla_softmax(score)
        grad = ftz(p - self._onehot)
        hess = ftz(ftz(p * _f32(self.factor)) * ftz(1.0 - p))
        if self.weight is not None:
            grad, hess = ftz(grad * self.weight[None]), ftz(hess * self.weight[None])
        return grad, hess

    def boost_from_score(self, class_id: int = 0) -> float:
        return math.log(max(_EPS, self.class_init_probs[class_id]))

    def class_need_train(self, class_id: int) -> bool:
        p = self.class_init_probs[class_id]
        return _EPS < abs(p) < 1.0 - _EPS

    def convert_output(self, raw):
        """raw [..., K] -> softmax over the last axis."""
        return torch.softmax(raw, dim=-1)

    def to_string(self):
        return f"{self.name} num_class:{self.num_class}"


class MulticlassOVA(_Objective):
    """One-vs-all multiclass (reference MulticlassOVA, multiclass_objective.hpp:178):
    a binary log-loss a class, the rows of label k positive for class k."""

    name = "multiclassova"

    def __init__(self, config, label, weight, device):
        super().__init__(config, label, weight, device)
        self.num_class = int(config.num_class)
        self.sigmoid = float(getattr(config, "sigmoid", 1.0))
        self._binary = [BinaryLogloss(config, label, weight, device,
                                      is_pos=self._label_np == k)
                        for k in range(self.num_class)]

    def get_gradients(self, score):
        pairs = [b._gradients(score[k]) for k, b in enumerate(self._binary)]
        return torch.stack([g for g, _ in pairs]), torch.stack([h for _, h in pairs])

    def boost_from_score(self, class_id: int = 0) -> float:
        return self._binary[class_id].boost_from_score(0)

    def class_need_train(self, class_id: int) -> bool:
        return self._binary[class_id].need_train

    def convert_output(self, raw):
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * raw))

    def to_string(self):
        return f"{self.name} num_class:{self.num_class} sigmoid:{self.sigmoid:g}"


# ============================================================== xentropy family
class CrossEntropy(_Objective):
    """Cross-entropy with labels in [0, 1] (reference xentropy_objective.hpp:38)."""

    name = "cross_entropy"

    def __init__(self, config, label, weight, device):
        super().__init__(config, label, weight, device)
        if len(self._label_np) and (self._label_np.min() < 0 or self._label_np.max() > 1):
            raise ValueError(f"[{self.name}]: labels must be in [0, 1]")
        if self._weight_np is not None:
            if self._weight_np.min() < 0:
                raise ValueError(f"[{self.name}]: at least one weight is negative")
            if self._weight_np.sum() == 0:
                raise ValueError(f"[{self.name}]: sum of weights is zero")

    def _gradients(self, s):
        z = xla_sigmoid(s)
        grad = ftz(z - self.label)
        hess = ftz(z * ftz(1.0 - z))
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id: int = 0) -> float:
        if self._weight_np is None:
            pavg = float(self._label_np.mean()) if len(self._label_np) else 0.0
        else:
            pavg = float(np.average(self._label_np, weights=self._weight_np))
        pavg = min(max(pavg, _EPS), 1.0 - _EPS)
        return math.log(pavg / (1.0 - pavg))

    def convert_output(self, raw):
        return torch.sigmoid(raw)


class CrossEntropyLambda(CrossEntropy):
    """Weighted cross-entropy in its alternative parameterization
    (reference CrossEntropyLambda, xentropy_objective.hpp:180)."""

    name = "cross_entropy_lambda"

    def __init__(self, config, label, weight, device):
        _Objective.__init__(self, config, label, weight, device)
        if len(self._label_np) and (self._label_np.min() < 0 or self._label_np.max() > 1):
            raise ValueError(f"[{self.name}]: labels must be in [0, 1]")
        if self._weight_np is not None and self._weight_np.min() <= 0:
            raise ValueError(f"[{self.name}]: at least one weight is non-positive")

    def _gradients(self, s):
        if self.weight is None:
            z = xla_sigmoid(s)
            return ftz(z - self.label), ftz(z * ftz(1.0 - z))
        w, y = self.weight, self.label
        epf = xla_exp(s)
        hhat = xla_log1p(epf)
        z = ftz(1.0 - xla_exp(ftz(-w * hhat)))
        enf = xla_exp(-s)
        grad = _div(ftz(ftz(1.0 - _div(y, z)) * w), 1.0 + enf)
        c = _div(1.0, ftz(1.0 - z))
        d = 1.0 + epf
        wepf = ftz(w * epf)
        a = _div(wepf, ftz(d * d))
        d2 = ftz(c - 1.0)
        b = ftz(_div(c, ftz(d2 * d2)) * ftz(ftz(1.0 + wepf) - c))
        hess = ftz(a * ftz(1.0 + ftz(y * b)))
        return grad, hess

    def convert_output(self, raw):
        # the normalized exponential parameter, not a probability
        return torch.log1p(torch.exp(raw))


# ====================================================================== factory
_OBJECTIVES = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": RegressionHuber,
    "fair": RegressionFair,
    "poisson": RegressionPoisson,
    "quantile": RegressionQuantile,
    "mape": RegressionMAPE,
    "gamma": RegressionGamma,
    "tweedie": RegressionTweedie,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
}


def create_objective(config, label: np.ndarray, device, weight: Optional[np.ndarray] = None):
    """The objective of ``config`` (a ``Config``, or an objective's name
    with every other parameter at its default) on rows ``label`` / ``weight``
    (ObjectiveFunction::CreateObjectiveFunction, objective_function.cpp:22)."""
    from .config import Config

    if isinstance(config, str):
        config = Config.from_params({"objective": config})
    name = config.objective
    if name not in _OBJECTIVES:
        raise ValueError(f"objective {name!r} not yet ported to lightgbm_tpu_torch")
    return _OBJECTIVES[name](config, label, weight, device)
