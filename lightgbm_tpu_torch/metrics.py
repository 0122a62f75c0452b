"""Evaluation metrics on the booster's device.

Counterpart of ``lightgbm_tpu/metrics/__init__.py`` for ``l2``, ``rmse``,
``l1``, ``quantile``, ``huber``, ``fair``, ``poisson``, ``mape``,
``gamma``, ``gamma_deviance``, ``tweedie`` (:145-222), ``binary_logloss``,
``binary_error``, ``auc``, ``multi_logloss``, ``multi_error`` (with
``multi_error_top_k``), ``auc_mu`` (with ``auc_mu_weights``, :345-458),
``cross_entropy``, ``cross_entropy_lambda`` and ``kullback_leibler``
(:549-592), each with row weights, the metric aliases (:593-) and the
objective's default metric.  Each metric evaluates the booster's f32 score
where it lies ([N], or [k, N] for the multiclass objectives) and copies one
scalar to the host, as the JAX package's ``eval_device`` does:

* the pointwise metrics take their loss in f32 (the output-space score for
  all but ``cross_entropy_lambda`` and ``kullback_leibler``, which read the
  raw score in f64, as the JAX package's host metrics do) and sum it there,
  the weighted sum then divided on the host by the f64 sum of weights;
  labels or weights of magnitude 1e6 or more are summed in f64 instead
  (the JAX package's host fallback there);
* ``auc`` sorts the scores (ties grouped, the tie-aware sweep of
  ``_weighted_auc``, binary_metric.hpp:159) and sums in f64; ``auc_mu``
  takes that AUC of each pair of classes on the raw scores projected on
  the pair's weight vector, in f64;
* ``multi_logloss`` is the f64 log-softmax at the label for the softmax
  objective (the JAX package's device metric, in f32 there), else minus
  the log of the objective's output at the label; ``multi_error`` counts
  the rows whose label's raw score is not among the ``multi_error_top_k``
  largest (ties count against the label).

A metric the JAX package has and the port lacks (the ranking ones and
``average_precision``) raises ``NotImplementedError``; an unknown name
raises ``ValueError``.
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

    def __init__(self, label: np.ndarray, weight: Optional[np.ndarray], device,
                 config=None) -> None:
        self.config = config
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

    def __init__(self, label, weight, device, config=None) -> None:
        super().__init__(label, weight, device, config)
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


def _param(metric, name: str, default: float) -> float:
    """A metric's parameter from its config (the JAX default without one)."""
    return float(getattr(metric.config, name, default)) if metric.config is not None else default


class QuantileMetric(_PointwiseMetric):
    name = "quantile"

    def loss(self, label, score):
        a = _param(self, "alpha", 0.9)
        delta = label - score
        return torch.where(delta < 0, (a - 1.0) * delta, a * delta)


class HuberMetric(_PointwiseMetric):
    name = "huber"

    def loss(self, label, score):
        a = _param(self, "alpha", 0.9)
        diff = score - label
        ad = diff.abs()
        return torch.where(ad <= a, 0.5 * diff * diff, a * (ad - 0.5 * a))


class FairMetric(_PointwiseMetric):
    name = "fair"

    def loss(self, label, score):
        c = _param(self, "fair_c", 1.0)
        x = (score - label).abs()
        return c * x - c * c * torch.log1p(x / c)


class PoissonMetric(_PointwiseMetric):
    name = "poisson"

    def loss(self, label, score):
        s = torch.clamp(score, min=1e-10)
        return s - label * torch.log(s)


class MAPEMetric(_PointwiseMetric):
    name = "mape"

    def loss(self, label, score):
        return (label - score).abs() / torch.clamp(label.abs(), min=1.0)


def _floor(t: torch.Tensor) -> float:
    """The least positive value a log takes: 1e-300 in f64, 1e-35 in f32."""
    return 1e-300 if t.dtype == torch.float64 else 1e-35


class GammaMetric(_PointwiseMetric):
    name = "gamma"

    def loss(self, label, score):
        # the negative log-likelihood with psi = 1 (regression_metric.hpp:261)
        theta = -1.0 / torch.clamp(score, min=_floor(score))
        b = -torch.log(torch.clamp(-theta, min=_floor(score)))
        return -(label * theta - b)


class GammaDevianceMetric(_PointwiseMetric):
    name = "gamma_deviance"

    def loss(self, label, score):
        tmp = label / (score + 1e-9)
        return tmp - torch.log(torch.clamp(tmp, min=_floor(score))) - 1.0

    def average(self, sum_loss, sum_weights):
        return sum_loss * 2.0


class TweedieMetric(_PointwiseMetric):
    name = "tweedie"

    def loss(self, label, score):
        rho = _param(self, "tweedie_variance_power", 1.5)
        s = torch.clamp(score, min=1e-10)
        a = label * torch.exp((1.0 - rho) * torch.log(s)) / (1.0 - rho)
        b = torch.exp((2.0 - rho) * torch.log(s)) / (2.0 - rho)
        return -a + b


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


def _weighted_auc(pos: torch.Tensor, score: torch.Tensor,
                  weight: Optional[torch.Tensor]) -> torch.Tensor:
    """Tie-aware weighted AUC of f64 positives ``pos`` ranked by ``score``
    (a 0-dim f64 tensor; ``_weighted_auc`` of the JAX package)."""
    n = score.shape[0]
    dev = score.device
    if n == 0:
        return torch.ones((), dtype=torch.float64, device=dev)
    order = torch.argsort(score, descending=True, stable=True)
    s = score[order]
    w = torch.ones(n, dtype=torch.float64, device=dev) if weight is None else weight[order]
    y = pos[order]
    group = torch.zeros(n, dtype=torch.int64, device=dev)
    group[1:] = torch.cumsum((s[1:] != s[:-1]).long(), 0)
    gp = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(0, group, w * y)
    gn = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(0, group, w * (1.0 - y))
    before = torch.cumsum(gp, 0) - gp
    accum = (gn * (0.5 * gp + before)).sum()
    sum_pos, sum_all = gp.sum(), w.sum()
    return torch.where((sum_pos > 0) & (sum_pos != sum_all),
                       accum / (sum_pos * (sum_all - sum_pos)).clamp(min=1e-300),
                       torch.ones((), dtype=torch.float64, device=dev))


class AUCMetric(Metric):
    """Tie-aware weighted AUC (reference AUCMetric::Eval,
    src/metric/binary_metric.hpp:159)."""

    name = "auc"
    is_higher_better = True

    def __init__(self, label, weight, device, config=None) -> None:
        super().__init__(label, weight, device, config)
        self._pos = torch.as_tensor(self.label > 0, dtype=torch.float64, device=self.device)
        self._weight = (None if weight is None else
                        torch.as_tensor(self.weight, dtype=torch.float64, device=self.device))

    def eval(self, score, objective):
        return [(self.name, float(_weighted_auc(self._pos, score, self._weight)))]


class _ClassMetric(Metric):
    """A metric of [k, N] raw scores and integer class labels."""

    def __init__(self, label, weight, device, config=None) -> None:
        super().__init__(label, weight, device, config)
        self._cls = torch.as_tensor(self.label.astype(np.int64), device=self.device)
        self._weight = (None if weight is None else
                        torch.as_tensor(self.weight, dtype=torch.float64, device=self.device))

    def _mean(self, loss: torch.Tensor) -> float:
        if self._weight is not None:
            loss = loss * self._weight
        return float(loss.sum()) / self.sum_weights


class MultiLoglossMetric(_ClassMetric):
    name = "multi_logloss"

    def eval(self, score, objective):
        s = score.double()
        rows = torch.arange(s.shape[1], device=s.device)
        if getattr(objective, "name", "") == "multiclass":
            logp = torch.log_softmax(s, dim=0)[self._cls, rows]
            loss = -torch.clamp(logp, min=math.log(_EPS))
        else:
            probs = s if objective is None else objective.convert_output(s)
            loss = -torch.log(torch.clamp(probs[self._cls, rows], min=_EPS))
        return [(self.name, self._mean(loss))]


class MultiErrorMetric(_ClassMetric):
    def __init__(self, label, weight, device, config=None) -> None:
        super().__init__(label, weight, device, config)
        self.top_k = int(_param(self, "multi_error_top_k", 1))
        self.name = "multi_error" if self.top_k == 1 else f"multi_error@{self.top_k}"

    def eval(self, score, objective):
        s = score.double()
        own = s[self._cls, torch.arange(s.shape[1], device=s.device)]
        num_larger = (s >= own[None, :]).sum(dim=0)
        return [(self.name, self._mean((num_larger > self.top_k).double()))]


class AucMuMetric(_ClassMetric):
    """AUC-mu (reference AucMuMetric, multiclass_metric.hpp:182; Kleiman and
    Page, ICML'19): the mean over class pairs (i, j) of the weighted AUC of
    class i against j on the raw scores projected on the pair's weight
    vector (``auc_mu_weights``, default 1 off the diagonal)."""

    name = "auc_mu"
    is_higher_better = True

    def __init__(self, label, weight, device, config=None) -> None:
        super().__init__(label, weight, device, config)
        self.num_class = int(_param(self, "num_class", 1))
        k = self.num_class
        weights = getattr(config, "auc_mu_weights", None) if config is not None else None
        self.class_weights = (np.asarray(weights, np.float64).reshape(k, k) if weights
                              else np.ones((k, k)) - np.eye(k))

    def eval(self, score, objective):
        s = score.double()
        k = self.num_class
        cw = torch.as_tensor(self.class_weights, device=s.device)
        total = 0.0
        for i in range(k):
            for j in range(i + 1, k):
                curr_v = cw[i] - cw[j]
                t1 = curr_v[i] - curr_v[j]
                sel = (self._cls == i) | (self._cls == j)
                if not bool(sel.any()):
                    continue
                v = t1 * (curr_v @ s[:, sel])
                y = (self._cls[sel] == i).double()
                w = None if self._weight is None else self._weight[sel]
                total += float(_weighted_auc(y, v, w))
        return [(self.name, total / (k * (k - 1) / 2))]


class CrossEntropyMetric(_PointwiseMetric):
    name = "cross_entropy"

    def loss(self, label, prob):
        p = torch.clamp(prob, _EPS, 1.0 - _EPS)
        return -label * torch.log(p) - (1.0 - label) * torch.log(1.0 - p)


class CrossEntropyLambdaMetric(Metric):
    """xentlambda (reference xentropy_metric.hpp CrossEntropyLambdaMetric),
    on the raw score in f64; the weights enter only through z, the mean is
    over the rows."""

    name = "cross_entropy_lambda"

    def eval(self, score, objective):
        s = score.double()
        hhat = torch.log1p(torch.exp(s))
        w = (torch.ones_like(s) if self.weight is None
             else torch.as_tensor(self.weight, device=s.device))
        z = torch.clamp(1.0 - torch.exp(-w * hhat), _EPS, 1.0 - _EPS)
        y = torch.as_tensor(self.label, device=s.device)
        loss = -y * torch.log(z) - (1.0 - y) * torch.log(1.0 - z)
        return [(self.name, float(loss.sum()) / max(len(self.label), 1))]


class KullbackLeiblerDivergence(Metric):
    """kldiv (reference xentropy_metric.hpp KullbackLeiblerDivergence), on
    the raw score in f64."""

    name = "kullback_leibler"

    def eval(self, score, objective):
        s = score.double()
        p = torch.clamp(1.0 / (1.0 + torch.exp(-s)), _EPS, 1.0 - _EPS)
        y = torch.clamp(torch.as_tensor(self.label, device=s.device), 0.0, 1.0)
        term_p = torch.where(y > 0, y * torch.log(torch.clamp(y, min=_EPS) / p),
                             torch.zeros_like(s))
        term_n = torch.where(y < 1, (1 - y) * torch.log(torch.clamp(1 - y, min=_EPS) / (1 - p)),
                             torch.zeros_like(s))
        loss = term_p + term_n
        if self.weight is not None:
            loss = loss * torch.as_tensor(self.weight, device=s.device)
        return [(self.name, float(loss.sum()) / self.sum_weights)]


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
    "quantile": QuantileMetric,
    "huber": HuberMetric,
    "fair": FairMetric,
    "poisson": PoissonMetric,
    "mape": MAPEMetric,
    "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric,
    "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "multi_logloss": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "auc_mu": AucMuMetric,
    "cross_entropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "kullback_leibler": KullbackLeiblerDivergence,
}


def create_metric(name: str, label, weight, device, config=None) -> Optional[Metric]:
    """Factory (reference Metric::CreateMetric, src/metric/metric.cpp:21);
    None for 'none' and its synonyms.  ``config`` gives the metrics'
    parameters (alpha, fair_c, tweedie_variance_power, num_class,
    multi_error_top_k, auc_mu_weights); without it they take the JAX
    package's defaults."""
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
    return _METRICS[canon](label, weight, device, config)


def create_metrics(config, label, weight, device) -> List[Metric]:
    """The metrics of ``config.metric``, or the objective's default."""
    names = config.metric if config.metric else config.default_metric()
    made = [create_metric(m, label, weight, device, config) for m in names]
    return [m for m in made if m is not None]
