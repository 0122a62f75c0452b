"""Scales of the default int8 histogram accumulator.

Counterpart of ``hist_acc_scales`` in ``lightgbm_tpu/ops/quantize.py``
(:78-101).  The scales do not change the training values: they only set how
the histogram kernels accumulate the unchanged f32 gradients on the int8
2-digit grid (``ops/seg.py``), whose ceiling is ``QMAX = 127*128``.  Every
in-bag |g| maps to at most QMAX, a relative step of ~6e-5, inside the
near-tie tolerance that the grower's f32 re-accumulation covers.
"""

from __future__ import annotations

from typing import Optional

import torch

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
