"""The port's pointwise objectives (lightgbm_tpu_torch/objectives.py,
config.py, metrics.py) against the JAX package, on the CPU.

* every objective's gradients and hessians equal the JAX objective's bit
  for bit on 200,000 seeded scores with extremes (scores of +-100 and
  +-89, subnormals, signed zeros), with and without row weights, as the
  JAX Booster computes them: operation by operation with XLA:CPU (under
  one ``jax.jit`` XLA folds the label and weight constants together and
  fuses multiply-adds, which the Booster never does);
  ``boost_from_score`` and ``renew_tree_output`` equal in f64;
* the XLA:CPU forms of log and log1p equal ``jax.jit(jnp.log)`` /
  ``jax.jit(jnp.log1p)`` bit for bit, subnormal inputs and the branch ends
  included;
* the ten reference scenarios ``tests/golden/scen_obj_*`` (l1, huber, fair,
  poisson, quantile, mape, gamma, tweedie, xentropy, xentlambda) trained
  through the port: the JAX package's trees on the same layout (leaves
  within 1e-5), the final training metric within the 0.05 of the
  reference's that ``test_consistency.py::test_scenario_golden_parity``
  allows; and each reference ``model.txt`` predicting its ``preds.txt`` in
  output space (rtol 1e-4, atol 1e-5, test_consistency.py:250-253);
* the objectives' names, aliases, default metrics and their metrics'
  values (weighted and not) against the JAX package's.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.metrics import create_metric as jax_create_metric
from lightgbm_tpu.objectives import create_objective as jax_create_objective

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import metrics
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.objectives import create_objective, xla_log, xla_log1p

from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)

GOLDEN = pathlib.Path(__file__).parent / "golden"
N = 200_000
OBJECTIVES = {
    "regression": {}, "regression_l1": {}, "huber": {"alpha": 0.9}, "fair": {"fair_c": 1.5},
    "poisson": {}, "quantile": {"alpha": 0.7}, "mape": {}, "gamma": {},
    "tweedie": {"tweedie_variance_power": 1.3}, "binary": {}, "cross_entropy": {},
    "cross_entropy_lambda": {}, "multiclass": {"num_class": 5},
    "multiclassova": {"num_class": 5}, "regression_sqrt": {"objective": "regression",
                                                           "reg_sqrt": True},
}
SCENARIOS = ["l1", "huber", "fair", "poisson", "quantile", "mape", "gamma", "tweedie",
             "xentropy", "xentlambda"]


def _scores(rng, k: int) -> np.ndarray:
    """[k, N] f32: normals of scale 2, uniforms on [-100, 100], and the
    extremes (0, -0, subnormals, the exp clamp's ends, +-100)."""
    edge = np.array([0.0, -0.0, 1e-39, -1e-39, 88.0, 89.0, -88.0, -89.0, 100.0, -100.0] * 100)
    cols = [np.concatenate([rng.normal(0, 2, N - 2000), rng.uniform(-100, 100, 1000), edge])
            for _ in range(k)]
    return np.stack(cols).astype(np.float32)


def _label(rng, name: str) -> np.ndarray:
    if name.startswith("multiclass"):
        return rng.integers(0, 5, N).astype(np.float64)
    if name.startswith("cross_entropy"):
        return rng.random(N)
    if name in ("poisson", "gamma", "tweedie"):
        return rng.poisson(2.0, N) + 1.0 * (name == "gamma")
    if name == "binary":
        return (rng.random(N) < 0.4).astype(np.float64)
    return rng.normal(size=N) * 3.0


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _params(name: str) -> dict:
    extra = dict(OBJECTIVES[name])
    return {"objective": extra.pop("objective", name), **extra}


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_gradients_equal_jax_bit_for_bit(name, weighted):
    rng = np.random.default_rng(sorted(OBJECTIVES).index(name) * 2 + weighted)
    params = _params(name)
    k = OBJECTIVES[name].get("num_class", 1)
    score, label = _scores(rng, k), _label(rng, name)
    weight = rng.uniform(0.5, 1.5, N) if weighted else None
    jobj = jax_create_objective(JaxConfig.from_params(params))
    jobj.init(label, weight)
    jg, jh = jobj.get_gradients(jnp.asarray(score))
    tobj = create_objective(Config.from_params(params), label, "cpu", weight)
    tg, th = tobj.get_gradients(torch.as_tensor(score))
    np.testing.assert_array_equal(_bits(tg.numpy()), _bits(jg))
    np.testing.assert_array_equal(_bits(th.numpy()), _bits(jh))
    for c in range(k):
        assert tobj.boost_from_score(c) == jobj.boost_from_score(c)
        assert tobj.class_need_train(c) == jobj.class_need_train(c)
    assert tobj.to_string() == jobj.to_string()
    assert tobj.is_renew_tree_output == jobj.is_renew_tree_output
    if tobj.is_renew_tree_output:
        s = rng.normal(size=N)
        leaf = rng.integers(0, 31, N)
        mask = (rng.random(N) < 0.8).astype(np.float32)
        lv = rng.normal(size=31)
        for m in (None, mask):
            np.testing.assert_array_equal(tobj.renew_tree_output(s, leaf, lv, m),
                                          jobj.renew_tree_output(s, leaf, lv, m))


@pytest.mark.parametrize("fn,jfn", [(xla_log, jnp.log), (xla_log1p, jnp.log1p)],
                         ids=["log", "log1p"])
def test_xla_log_forms_equal_jax_bit_for_bit(fn, jfn):
    import jax

    rng = np.random.default_rng(3)
    x = np.concatenate([
        np.exp(rng.uniform(-90.0, 88.0, N)), rng.uniform(-1.0, 1.0, N),
        rng.uniform(0.40, 0.43, 1000), -rng.uniform(0.40, 0.43, 1000),
        [0.0, -0.0, 1e-39, -1e-39, np.inf, -np.inf, np.nan, -1.0, 1.0, 2.0 ** -126],
    ]).astype(np.float32)
    got = fn(torch.as_tensor(x)).numpy()
    want = np.asarray(jax.jit(jfn)(x))
    same = (_bits(got) == _bits(want)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), (x[~same][:5], got[~same][:5], want[~same][:5])


def _golden(name):
    arr = np.loadtxt(GOLDEN / f"scen_obj_{name}.train.csv", delimiter=",")
    return arr[:, 1:], arr[:, 0]


@pytest.mark.parametrize("name", SCENARIOS)
def test_reference_objective_model_predicts_its_golden(name):
    x, _ = _golden(name)
    model = GOLDEN / f"scen_obj_{name}.model.txt"
    b = lt.Booster(model_file=str(model), device="cpu")
    assert b.objective is not None
    want = np.loadtxt(GOLDEN / f"scen_obj_{name}.preds.txt", ndmin=1)
    np.testing.assert_allclose(b.predict(x), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", SCENARIOS)
def test_objective_scenario_trains_the_jax_trees_and_reaches_the_reference(name):
    x, y = _golden(name)
    params = json.loads((GOLDEN / f"scen_obj_{name}.params.json").read_text())
    rounds = int(params.pop("num_trees"))
    metric = params["metric"]
    ref_final = json.loads((GOLDEN / f"scen_obj_{name}.evals.json").read_text())[
        f"training:{metric}"][-1][1]
    ds = lt.Dataset(x, y, params=params)
    rec = {}
    tb = lt.train(params, ds, rounds, valid_sets=[ds], valid_names=["training"],
                  callbacks=[lt.record_evaluation(rec)], device="cpu")
    assert tb.hist_mode == "seg" and len(tb.trees) == rounds
    ours = rec["training"][metric][-1]
    assert ours <= ref_final + 0.05 * abs(ref_final) + 1e-9, (ours, ref_final)
    jp = {**params, "hist_mode": "seg", "verbosity": -1, "metric": "none"}
    jb = lgb.train(jp, lgb.Dataset(x, y, params=jp), rounds)
    assert len(jb._bin_records) == rounds
    for i, (jr, tree) in enumerate(zip(jb._bin_records, tb.trees)):
        tr = tree.record()
        for key in ("split_feature", "split_bin", "default_left", "left_child", "right_child"):
            np.testing.assert_array_equal(tr[key], jr[key], err_msg=f"tree {i} {key}")
        np.testing.assert_allclose(tr["leaf_value"], jr["leaf_value"], rtol=0, atol=1e-5)
    # the port's model text reads back to the same predictions in the JAX package
    jt = lgb.Booster(model_str=tb.model_to_string())
    np.testing.assert_allclose(jt.predict(x), tb.predict(x), rtol=1e-5, atol=1e-5)


_ALIASES = ["regression_l2", "l2", "mse", "l2_root", "rmse", "l1", "mae", "mean_absolute_error",
            "mape", "mean_absolute_percentage_error", "huber", "fair", "poisson", "quantile",
            "gamma", "tweedie", "binary", "multiclass", "softmax", "multiclassova", "ova", "ovr",
            "multiclass_ova", "xentropy", "cross_entropy", "xentlambda",
            "cross_entropy_lambda"]


@pytest.mark.parametrize("alias", _ALIASES)
def test_objective_aliases_and_default_metrics_are_the_jax_packages(alias):
    params = {"objective": alias, "num_class": 3 if "multi" in alias or alias in (
        "softmax", "ova", "ovr") else 1}
    cfg, jcfg = Config.from_params(params), JaxConfig.from_params(params)
    assert cfg.objective == jcfg.objective
    assert cfg.reg_sqrt == jcfg.reg_sqrt
    assert cfg.default_metric() == jcfg.default_metric()
    assert cfg.num_tree_per_iteration() == (3 if cfg.objective.startswith("multi") else 1)


@pytest.mark.parametrize("params,word", [
    ({"objective": "multiclass"}, "num_class"),
    ({"objective": "multiclassova", "num_class": 1}, "num_class"),
    ({"objective": "quantile", "alpha": 1.5}, "alpha"),
    ({"objective": "binary", "sigmoid": 0.0}, "sigmoid"),
    ({"objective": "lambdarank"}, "lambdarank"),
])
def test_objective_parameters_are_checked(params, word):
    with pytest.raises(ValueError, match=word):
        Config.from_params(params)


POINTWISE = {"quantile": "quantile", "huber": "huber", "fair": "fair", "poisson": "poisson",
             "mape": "mape", "gamma": "gamma", "gamma_deviance": "gamma",
             "tweedie": "tweedie", "cross_entropy": "cross_entropy",
             "cross_entropy_lambda": "cross_entropy_lambda",
             "kullback_leibler": "cross_entropy"}


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("metric", list(POINTWISE))
def test_pointwise_metric_matches_jax(metric, weighted):
    rng = np.random.default_rng(len(metric) + weighted)
    n = 5000
    obj = POINTWISE[metric]
    params = {"objective": obj, **OBJECTIVES[obj]}
    label = _label(rng, obj)[:n]
    score = (rng.normal(size=n) * 0.5).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, n) if weighted else None
    jcfg = JaxConfig.from_params(params)
    jobj = jax_create_objective(jcfg)
    jobj.init(label, weight)
    jm = jax_create_metric(metric, jcfg)
    jm.init(label, weight)
    want = jm.eval(score[None].astype(np.float64), jobj)
    cfg = Config.from_params(params)
    tm = metrics.create_metric(metric, label, weight, "cpu", cfg)
    got = tm.eval(torch.as_tensor(score), create_objective(cfg, label, "cpu", weight))
    assert got[0][0] == want[0][0] and tm.is_higher_better == jm.is_higher_better
    np.testing.assert_allclose(got[0][1], want[0][1], rtol=1e-5)
