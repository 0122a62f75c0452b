"""Evaluation metrics on the booster's device.

Counterpart of ``lightgbm_tpu/metrics/__init__.py`` for ``l2``, ``rmse``,
``l1``, ``binary_logloss``, ``binary_error`` and ``auc``, each with row
weights, the metric aliases (:593-) and the objective's default metric.
Each metric evaluates the booster's f32 score where it lies and copies one
scalar to the host, as the JAX package's ``eval_device`` does:

* the pointwise metrics take their loss in f32 (the output-space score for
  the binary ones) and sum it there, the weighted sum then divided on the
  host by the f64 sum of weights; labels or weights of magnitude 1e6 or
  more are summed in f64 instead (the JAX package's host fallback there);
* ``auc`` sorts the scores (ties grouped, the tie-aware sweep of
  ``_weighted_auc``, binary_metric.hpp:159) and sums in f64.

A metric the JAX package has and the port lacks raises
``NotImplementedError``; an unknown name raises ``ValueError``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

_EPS = 1e-15
_F32_MAX_MAGNITUDE = 1e6  # labels and weights below this are summed in f32


class Metric:
    """Base metric (reference include/LightGBM/metric.h:44)."""

    name = ""
    is_higher_better = False

    def __init__(self, label: np.ndarray, weight: Optional[np.ndarray], device) -> None:
        self.label = np.asarray(label, np.float64)
        self.weight = None if weight is None else np.asarray(weight, np.float64)
        self.sum_weights = float(len(self.label) if weight is None else self.weight.sum())
        self.device = torch.device(device)

    def eval(self, score: torch.Tensor, objective) -> List[Tuple[str, float]]:
        raise NotImplementedError


class _PointwiseMetric(Metric):
    """Average of a pointwise loss (reference RegressionMetric,
    src/metric/regression_metric.hpp:22)."""

    convert_score = True  # the objective's output space (identity for l2 loss)

    def __init__(self, label, weight, device) -> None:
        super().__init__(label, weight, device)
        big = float(np.abs(self.label).max(initial=0.0)) >= _F32_MAX_MAGNITUDE or (
            weight is not None
            and float(np.abs(self.weight).max(initial=0.0)) >= _F32_MAX_MAGNITUDE)
        self.dtype = torch.float64 if big else torch.float32
        self._label = torch.as_tensor(self.label, dtype=self.dtype, device=self.device)
        self._weight = (None if weight is None else
                        torch.as_tensor(self.weight, dtype=self.dtype, device=self.device))

    def loss(self, label: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def average(self, sum_loss: float, sum_weights: float) -> float:
        return sum_loss / sum_weights

    def eval(self, score, objective):
        s = score.to(self.dtype)
        if self.convert_score and objective is not None:
            s = objective.convert_output(s)
        pt = self.loss(self._label, s)
        if self._weight is not None:
            pt = pt * self._weight
        return [(self.name, self.average(float(pt.sum()), self.sum_weights))]


class L2Metric(_PointwiseMetric):
    name = "l2"

    def loss(self, label, score):
        d = score - label
        return d * d


class RMSEMetric(L2Metric):
    name = "rmse"

    def average(self, sum_loss, sum_weights):
        return math.sqrt(sum_loss / sum_weights)


class L1Metric(_PointwiseMetric):
    name = "l1"

    def loss(self, label, score):
        return torch.abs(score - label)


class BinaryLoglossMetric(_PointwiseMetric):
    name = "binary_logloss"

    def loss(self, label, prob):
        p = torch.clamp(prob, _EPS, 1.0 - _EPS)
        return torch.where(label > 0, -torch.log(p), -torch.log(1.0 - p))


class BinaryErrorMetric(_PointwiseMetric):
    name = "binary_error"

    def loss(self, label, prob):
        wrong = (prob > 0.5) != (label > 0)
        return wrong.to(prob.dtype)


class AUCMetric(Metric):
    """Tie-aware weighted AUC (reference AUCMetric::Eval,
    src/metric/binary_metric.hpp:159)."""

    name = "auc"
    is_higher_better = True

    def __init__(self, label, weight, device) -> None:
        super().__init__(label, weight, device)
        self._pos = torch.as_tensor(self.label > 0, dtype=torch.float64, device=self.device)
        self._weight = (None if weight is None else
                        torch.as_tensor(self.weight, dtype=torch.float64, device=self.device))

    def eval(self, score, objective):
        n = score.shape[0]
        if n == 0:
            return [(self.name, 1.0)]
        order = torch.argsort(score, descending=True, stable=True)
        s = score[order]
        w = torch.ones(n, dtype=torch.float64, device=score.device) if self._weight is None \
            else self._weight[order]
        y = self._pos[order]
        group = torch.zeros(n, dtype=torch.int64, device=score.device)
        group[1:] = torch.cumsum((s[1:] != s[:-1]).long(), 0)
        gp = torch.zeros(n, dtype=torch.float64, device=score.device).index_add_(0, group, w * y)
        gn = torch.zeros(n, dtype=torch.float64, device=score.device).index_add_(
            0, group, w * (1.0 - y))
        before = torch.cumsum(gp, 0) - gp
        accum = (gn * (0.5 * gp + before)).sum()
        sum_pos, sum_all = gp.sum(), w.sum()
        auc = torch.where((sum_pos > 0) & (sum_pos != sum_all),
                          accum / (sum_pos * (sum_all - sum_pos)).clamp(min=1e-300),
                          torch.ones((), dtype=torch.float64, device=score.device))
        return [(self.name, float(auc))]


# the JAX package's metric aliases (metrics/__init__.py:593-645)
_METRIC_ALIASES = {
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression": "l2",
    "regression_l2": "l2", "l2_root": "rmse", "root_mean_squared_error": "rmse",
    "rmse": "rmse", "l1": "l1", "mean_absolute_error": "l1", "mae": "l1",
    "regression_l1": "l1", "quantile": "quantile", "huber": "huber", "fair": "fair",
    "poisson": "poisson", "mape": "mape", "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "gamma_deviance": "gamma_deviance", "tweedie": "tweedie",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error", "auc": "auc",
    "average_precision": "average_precision", "multi_logloss": "multi_logloss",
    "multiclass": "multi_logloss", "softmax": "multi_logloss",
    "multiclassova": "multi_logloss", "multiclass_ova": "multi_logloss",
    "ova": "multi_logloss", "ovr": "multi_logloss", "multi_error": "multi_error",
    "auc_mu": "auc_mu", "ndcg": "ndcg", "lambdarank": "ndcg", "rank_xendcg": "ndcg",
    "xendcg": "ndcg", "map": "map", "mean_average_precision": "map",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "kullback_leibler": "kullback_leibler", "kldiv": "kullback_leibler",
}

_METRICS = {
    "l2": L2Metric,
    "rmse": RMSEMetric,
    "l1": L1Metric,
    "binary_logloss": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
}


def create_metric(name: str, label, weight, device) -> Optional[Metric]:
    """Factory (reference Metric::CreateMetric, src/metric/metric.cpp:21);
    None for 'none' and its synonyms."""
    base = str(name).split("@")[0].strip()
    if base in ("none", "null", "custom", "na", ""):
        return None
    canon = _METRIC_ALIASES.get(base)
    if canon is None:
        raise ValueError(f"unknown metric: {name!r}")
    if canon not in _METRICS:
        raise NotImplementedError(
            f"metric {name!r} not yet ported to lightgbm_tpu_torch "
            f"(ported: {', '.join(_METRICS)})")
    return _METRICS[canon](label, weight, device)


def create_metrics(config, label, weight, device) -> List[Metric]:
    """The metrics of ``config.metric``, or the objective's default."""
    names = config.metric if config.metric else config.default_metric()
    made = [create_metric(m, label, weight, device) for m in names]
    return [m for m in made if m is not None]
