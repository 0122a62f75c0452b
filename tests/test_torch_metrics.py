"""The port's metrics (lightgbm_tpu_torch/metrics.py) against the JAX
package's (lightgbm_tpu/metrics), on seeded scores, with and without row
weights, AUC with ties.

The JAX value is its host evaluation in f64.  The port sums the pointwise
losses in f32 on the booster's device, as the JAX package's
``eval_device`` does, so the tolerance is 1e-5 relative; AUC, which the
port sums in f64, is held to 1e-9.
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.metrics import create_metric as jax_create_metric
from lightgbm_tpu.objectives import create_objective as jax_create_objective

from lightgbm_tpu_torch import metrics
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.objectives import create_objective

from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)

N = 4000
BINARY = ("binary_logloss", "binary_error", "auc")


def _inputs(name, weighted, seed=3):
    rng = np.random.default_rng(seed)
    binary = name in BINARY
    label = (rng.random(N) < 0.4).astype(float) if binary else rng.normal(size=N) * 2.0
    score = rng.normal(size=N).astype(np.float32)
    if name == "auc":
        score = np.round(score * 4.0) / 4.0  # many ties
    weight = rng.uniform(0.5, 1.5, N) if weighted else None
    return label, score, weight, ("binary" if binary else "regression")


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", ["l2", "rmse", "l1", "binary_logloss", "binary_error", "auc"])
def test_metric_matches_jax(name, weighted):
    label, score, weight, objective = _inputs(name, weighted)
    jcfg = JaxConfig.from_params({"objective": objective})
    jm = jax_create_metric(name, jcfg)
    jm.init(label, weight)
    jobj = jax_create_objective(jcfg)
    jobj.init(label, weight)
    want = jm.eval(score[None].astype(np.float64), jobj)

    tm = metrics.create_metric(name, label, weight, "cpu")
    tobj = create_objective(objective, label, torch.device("cpu"), weight)
    got = tm.eval(torch.as_tensor(score), tobj)
    assert [g[0] for g in got] == [w[0] for w in want] == [name]
    assert tm.is_higher_better == jm.is_higher_better
    tol = 1e-9 if name == "auc" else 1e-5
    np.testing.assert_allclose(got[0][1], want[0][1], rtol=tol)


@pytest.mark.parametrize("alias,canon", [
    ("mse", "l2"), ("mean_squared_error", "l2"), ("regression", "l2"),
    ("root_mean_squared_error", "rmse"), ("l2_root", "rmse"), ("mae", "l1"),
    ("regression_l1", "l1"), ("binary", "binary_logloss"), ("auc", "auc"),
    ("binary_error", "binary_error"),
])
def test_metric_aliases(alias, canon):
    m = metrics.create_metric(alias, np.zeros(4), None, "cpu")
    assert m.name == canon


@pytest.mark.parametrize("name", ["ndcg", "map", "lambdarank", "average_precision"])
def test_unported_metric_raises(name):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        metrics.create_metric(name, np.zeros(4), None, "cpu")


def test_unknown_and_none_metrics():
    with pytest.raises(ValueError, match="unknown metric"):
        metrics.create_metric("no_such_metric", np.zeros(4), None, "cpu")
    cfg = Config.from_params({"metric": "none"})
    assert metrics.create_metrics(cfg, np.zeros(4), None, "cpu") == []


@pytest.mark.parametrize("objective,want", [("regression", ["l2"]), ("binary", ["binary_logloss"])])
def test_default_metric_is_the_objectives(objective, want):
    cfg = Config.from_params({"objective": objective})
    assert cfg.default_metric() == JaxConfig.from_params({"objective": objective}).default_metric()
    assert [m.name for m in metrics.create_metrics(cfg, np.zeros(4), None, "cpu")] == want
