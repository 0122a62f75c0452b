"""Row sampling: bagging and GOSS.

Counterpart of ``lightgbm_tpu/boosting/sampling.py`` (the reference's
``SampleStrategy``, ``BaggingSampleStrategy`` and ``GOSSStrategy``) on the
training rows' device, for [k, N] gradients (k trees an iteration; one
mask serves every class's tree):

* ``BaggingStrategy``: a fresh in-bag mask every ``bagging_freq``
  iterations, kept in between: ``bernoulli(key, bagging_fraction)``
  per row, or, balanced (``pos_bagging_fraction`` /
  ``neg_bagging_fraction`` < 1), ``uniform(key) < p`` with p the row's
  class fraction in f32;
* ``GOSSStrategy``: no sampling for the first ``int(1 / learning_rate)``
  iterations; then the rows whose |g * h| (summed over the classes in
  class order, lightgbm_tpu/boosting/sampling.py:161) is at least the
  (n - top_k)-th smallest (ties add rows to the top set) are kept, the
  others with probability other_k / (n - top_k), and the others' g and h
  are multiplied by (n - top_k) / other_k, as ``grad * factor * mask``.

The mask is a dense [N] f32 (1 in bag), as the JAX package's; the keys come
from ``lightgbm_tpu_torch.random``, equal to ``jax.random``'s, so the masks
equal the JAX package's bit for bit.  The JAX package's by-query bagging
and its trace-safe ``scan_sample`` (device-resident boosting) are not
ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import random as rnd
from ..config import Config


class SampleStrategy:
    """No sampling: every row in bag, the gradients as they are."""

    refreshed = False  # whether the last sample drew a fresh mask

    def __init__(self, config: Config, num_data: int, device):
        self.config = config
        self.num_data = num_data
        self.device = torch.device(device)
        self._ones = torch.ones(num_data, dtype=torch.float32, device=self.device)

    def sample(self, iteration: int, grad: torch.Tensor, hess: torch.Tensor,
               key: rnd.Key) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(mask [N] f32, grad, hess) of ``iteration`` with its row key."""
        return self._ones, grad, hess


class BaggingStrategy(SampleStrategy):
    """Per-row Bernoulli bagging, refreshed every ``bagging_freq``
    iterations; balanced when ``is_pos`` ([N] bool) is given."""

    def __init__(self, config: Config, num_data: int, device,
                 is_pos: Optional[torch.Tensor] = None):
        super().__init__(config, num_data, device)
        self._mask = self._ones
        self._p = None  # the rows' class fractions in f32 (balanced bagging)
        if is_pos is not None:
            self._p = torch.where(torch.as_tensor(is_pos, device=self.device),
                                  config.pos_bagging_fraction, config.neg_bagging_fraction)

    def sample(self, iteration, grad, hess, key):
        freq = max(1, self.config.bagging_freq)
        self.refreshed = iteration % freq == 0
        if self.refreshed:
            self._mask = self._fresh_mask(key)
        return self._mask, grad, hess

    def _fresh_mask(self, key) -> torch.Tensor:
        if self._p is not None:
            keep = rnd.uniform(key, self.num_data, self.device) < self._p
        else:
            keep = rnd.bernoulli(key, self.config.bagging_fraction, self.num_data, self.device)
        return keep.to(torch.float32)


class GOSSStrategy(SampleStrategy):
    """Gradient-based One-Side Sampling (the reference's goss.hpp)."""

    def __init__(self, config: Config, num_data: int, device):
        super().__init__(config, num_data, device)  # rates checked by Config
        self.warmup = int(1.0 / max(config.learning_rate, 1e-12))

    def sample(self, iteration, grad, hess, key):
        self.refreshed = iteration >= self.warmup
        if not self.refreshed:
            return self._ones, grad, hess
        cfg = self.config
        n = self.num_data
        prod = torch.abs(grad * hess).reshape(-1, n)  # [k, N]
        metric = prod[0]
        for c in range(1, prod.shape[0]):
            metric = metric + prod[c]
        top_k = max(1, int(n * cfg.top_rate))
        other_k = max(1, int(n * cfg.other_rate))
        threshold = torch.sort(metric).values[n - top_k]
        is_top = metric >= threshold
        # Python floats against f32 tensors compare and combine in f32, as
        # JAX's weak-typed floats do
        sampled = rnd.uniform(key, n, self.device) < other_k / max(1, n - top_k)
        in_bag = is_top | (~is_top & sampled)
        factor = torch.where(is_top, 1.0, (n - top_k) / other_k)
        mask = in_bag.to(torch.float32)
        return mask, grad * factor * mask, hess * factor * mask  # broadcast over classes


def create_sample_strategy(config: Config, num_data: int, device,
                           label=None) -> SampleStrategy:
    """The strategy of ``config`` (SampleStrategy::CreateSampleStrategy,
    sampling.py:194-245): GOSS, bagging (balanced when a class fraction is
    below 1, with ``label`` > 0 the positive class), or none."""
    if config.is_goss():
        return GOSSStrategy(config, num_data, device)
    balanced = config.pos_bagging_fraction < 1.0 or config.neg_bagging_fraction < 1.0
    if config.bagging_freq > 0 and (config.bagging_fraction < 1.0 or balanced):
        is_pos = torch.as_tensor(label, device=device) > 0 if balanced else None
        return BaggingStrategy(config, num_data, device, is_pos)
    return SampleStrategy(config, num_data, device)
