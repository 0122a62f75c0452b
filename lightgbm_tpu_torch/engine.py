"""Training entry point (counterpart of ``lightgbm_tpu/engine.py`` train,
:34, without callbacks or validation sets)."""

from __future__ import annotations

from typing import Any, Dict

from .boosting.gbdt import Booster
from .dataset import Dataset


def train(
    params: Dict[str, Any],
    train_set: Dataset,
    num_boost_round: int = 100,
    device=None,
) -> Booster:
    """Train a GBDT model on ``device`` (the CUDA card unless
    ``device='cpu'``): ``num_boost_round`` iterations, fewer when no split
    has a positive gain."""
    train_set.params = {**dict(params or {}), **train_set.params}
    booster = Booster(params, train_set, device=device)
    for _ in range(num_boost_round):
        if booster.update():
            break
    return booster
