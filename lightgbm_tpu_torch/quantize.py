"""Gradient quantization: the scales of the default int8 histogram
accumulator, and quantized-gradient training.

Counterpart of ``lightgbm_tpu/ops/quantize.py``:

* ``hist_acc_scales`` (:78-101).  The scales do not change the training
  values: they only set how the seg histogram kernels accumulate the
  unchanged f32 gradients on the int8 2-digit grid (``ops/seg.py``), whose
  ceiling is ``QMAX = 127*128``.  Every in-bag |g| maps to at most QMAX, a
  relative step of ~6e-5, inside the near-tie tolerance that the grower's
  f32 re-accumulation covers.
* ``quantize_gradients`` (:32-80, the reference's GradientDiscretizer):
  it DOES change the training values, onto ``num_bins`` integer steps per
  iteration, kept as f32 multiples of the scales, so the int8 histograms
  (the ordered layout's, ``ops/histogram.py``, and the segment
  histogram's, ``ops/seg.py``) recover the integers exactly.  The rounding
  offset is 0.5, or, with a key (stochastic rounding, :61-66), a uniform
  draw per value from ``random.uniform`` of the key's two halves, equal to
  the JAX function's ``jax.random`` draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import random as rnd
from .ops.seg import QMAX


def hist_acc_scales(
    grad: torch.Tensor,  # [N] f32 true gradients
    hess: torch.Tensor,  # [N] f32
    mask: Optional[torch.Tensor] = None,  # [N] in-bag mask (None = all)
) -> torch.Tensor:
    """[2] f32 (g_scale, h_scale) = max(max|x*mask| / QMAX, 1e-30), on the
    gradients' device.  Computed once per boosting iteration."""
    if mask is not None:
        grad = grad * mask
        hess = hess * mask
    g_scale = torch.clamp(grad.abs().max() / QMAX, min=1e-30)
    h_scale = torch.clamp(hess.abs().max() / QMAX, min=1e-30)
    return torch.stack([g_scale, h_scale]).to(torch.float32)


def _f32_reciprocal(k: int) -> float:
    return float(np.float32(1.0) / np.float32(k))


def quantize_gradients(
    grad: torch.Tensor,  # [N] f32
    hess: torch.Tensor,  # [N] f32
    num_bins: int = 4,
    constant_hessian: bool = False,
    key: Optional[rnd.Key] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(qg, qh, g_scale, h_scale): grad and hess on the reference's integer
    grid (DiscretizeGradients, gradient_discretizer.cpp:70-160) with the
    rounding offset 0.5 (``key`` None), or with a key the stochastic
    offsets (the key split in two, a uniform [N] draw from each half),
    truncation toward zero, in the JAX function's f32 operation order, so
    the values equal its output bit for bit.  qg = k * g_scale for an
    integer k; a constant hessian quantizes to the scale itself."""
    if num_bins > 127:
        raise ValueError("num_grad_quant_bins must be <= 127 (int8 grid)")
    grad = grad.to(torch.float32)
    hess = hess.to(torch.float32)
    max_g = grad.abs().max()
    max_h = hess.abs().max()
    # XLA folds a division by a constant into a product with its f32
    # reciprocal: so does this, to give the JAX function's scales
    g_scale = torch.clamp(max_g * _f32_reciprocal(num_bins // 2), min=1e-30)
    h_scale = torch.clamp(
        max_h if constant_hessian else max_h * _f32_reciprocal(num_bins), min=1e-30
    )
    gi = grad / g_scale
    hi = hess / h_scale
    rg = rh = 0.5
    if key is not None:
        kg, kh = rnd.split(key)
        rg = rnd.uniform(kg, int(grad.shape[0]), grad.device)
        rh = rnd.uniform(kh, int(hess.shape[0]), hess.device)
    # C's int8 cast truncates toward zero; the offset follows the sign
    qg = torch.trunc(torch.where(gi >= 0, gi + rg, gi - rg))
    qh = torch.ones_like(hi) if constant_hessian else torch.trunc(hi + rh)
    return qg * g_scale, qh * h_scale, g_scale, h_scale
