"""Model text I/O of the port (lightgbm_tpu_torch/tree.py, boosting/gbdt.py
model_to_string / Booster(model_str=) / save_model) and its real-space
walker (predict.py), on the CPU.

* the reference LightGBM's scenario goldens (tests/golden/scen_*: the eleven
  regression models with numeric splits only) load into the port and predict
  the reference's own predictions within rtol 1e-4, atol 1e-5 (the check of
  test_consistency.py:250-253);
* model strings cross both ways between the port and the JAX package and
  predict the same within rtol 1e-6, atol 1e-6, on data with NaN and exact
  zeros, with all three missing types (None, Zero, NaN);
* a port model string written, read and written again is byte-equal;
* the port's tree blocks equal the JAX package's in structure, values
  within 1e-5;
* the reference's categorical scenario (``scen_categorical``) predicts its
  ``preds.txt`` through the port, and trains through the port to the JAX
  package's trees, within the 0.05 of the reference's final l2 that
  ``test_consistency.py::test_scenario_golden_parity`` allows, with
  ``cat_threshold`` in its model text;
* linear files raise (the objectives' scenario models predict through
  the port in tests/test_torch_objectives.py);
* the sampled scenarios (scen_bagging, scen_goss, scen_quantized: bagging
  with ``feature_fraction``, GOSS, stochastic quantized training) trained
  through the port: the JAX package's trees, and the final train l2 within
  the 15% of ``test_consistency.py::test_scenario_golden_parity`` of the
  reference's.
"""

import json
import pathlib

import numpy as np
import pytest

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.tree import Tree

from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)

GOLDEN = pathlib.Path(__file__).parent / "golden"
NUMERIC_SCENARIOS = ["bagging", "cegb", "dart", "forcedsplits", "goss", "interaction",
                     "monotone_basic", "monotone_advanced", "quantized", "weighted", "widebin"]


def _golden(name):
    arr = np.loadtxt(GOLDEN / f"scen_{name}.train.csv", delimiter=",")
    return arr[:, 1:], arr[:, 0]


@pytest.mark.parametrize("name", NUMERIC_SCENARIOS)
def test_reference_scenario_model_predicts_its_golden(name):
    x, _ = _golden(name)
    model = GOLDEN / f"scen_{name}.model.txt"
    b = lt.Booster(model_file=str(model), device="cpu")
    text = model.read_text()
    assert b.num_trees() == text.count("\nTree=")
    assert "decision_type=2" in text and b.bin_mappers is None
    want = np.loadtxt(GOLDEN / f"scen_{name}.preds.txt", ndmin=1)
    np.testing.assert_allclose(b.predict(x), want, rtol=1e-4, atol=1e-5)
    # the parameters block is written back as the file had it
    assert b.model_to_string().endswith(text[text.rindex("\nparameters:\n"):])


def _data(n=2500, f=7, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[rng.random((n, f)) < 0.06] = np.nan
    x[rng.random((n, f)) < 0.08] = 0.0
    x[:, 5] = np.where(rng.random(n) < 0.3, 0.0, np.abs(rng.normal(size=n)) + 0.5)  # no NaN
    z = (np.nan_to_num(x[:, 0]) + 0.7 * np.nan_to_num(x[:, 1]) - 0.4 * np.nan_to_num(x[:, 5])
         + 0.5 * np.isnan(x[:, 2]) + rng.normal(size=n) * 0.5)
    return x, z, rng.uniform(0.5, 1.5, n)


CASES = {
    "regression-weighted": ({"objective": "regression"}, True),
    "binary": ({"objective": "binary"}, False),
}


def _params(base):
    return {**base, "num_leaves": 15, "max_bin": 63, "learning_rate": 0.2,
            "verbosity": -1, "enable_bundle": False}


def _label(params, z):
    return (z > 0).astype(float) if params["objective"] == "binary" else z


def _jax_booster(params, x, z, w, rounds=6):
    params = _params(params)
    ds = lgb.Dataset(x, _label(params, z), weight=w, params=params)
    return lgb.train(params, ds, rounds)


def _port_booster(params, x, z, w, rounds=6):
    params = _params(params)
    ds = lt.Dataset(x, _label(params, z), weight=w, params=params)
    return lt.train(params, ds, rounds, device="cpu")


@pytest.mark.parametrize("case", [*CASES, "regression-zero-as-missing"])
def test_jax_model_string_predicts_the_same_in_the_port(case):
    x, z, w = _data()
    if case == "regression-zero-as-missing":
        params, weighted = {"objective": "regression", "zero_as_missing": True}, False
    else:
        params, weighted = CASES[case]
    jb = _jax_booster(params, x, z, w if weighted else None)
    text = jb.model_to_string()
    types = set()
    for line in text.splitlines():
        if line.startswith("decision_type="):
            types |= {int(v) >> 2 for v in line.split("=")[1].split()}
    # the missing types the data gives: NaN (NaN columns) and None (column 5),
    # or Zero on every column under zero_as_missing
    assert types == ({1} if case == "regression-zero-as-missing" else {0, 2}), types
    tb = lt.Booster(model_str=text, device="cpu")
    xt = _data(seed=2)[0]
    for raw in (True, False):
        np.testing.assert_allclose(tb.predict(xt, raw_score=raw), jb.predict(xt, raw_score=raw),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.predict(xt, num_iteration=3, start_iteration=1),
                               jb.predict(xt, num_iteration=3, start_iteration=1),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_port_model_string_predicts_the_same_in_jax(case):
    params, weighted = CASES[case]
    x, z, w = _data()
    tb = _port_booster(params, x, z, w if weighted else None)
    jb = lgb.Booster(model_str=tb.model_to_string())
    xt = _data(seed=2)[0]
    for raw in (True, False):
        np.testing.assert_allclose(jb.predict(xt, raw_score=raw), tb.predict(xt, raw_score=raw),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_port_round_trip_is_byte_equal(case, tmp_path):
    params, weighted = CASES[case]
    x, z, w = _data()
    tb = _port_booster(params, x, z, w if weighted else None)
    text = tb.model_to_string()
    path = tmp_path / "model.txt"
    tb.save_model(str(path))
    assert path.read_text() == text
    loaded = lt.Booster(model_file=str(path), device="cpu")
    assert loaded.model_to_string() == text
    again = lt.Booster(device="cpu").model_from_string(loaded.model_to_string())
    assert again.model_to_string() == text
    # the loaded model walks in real space; the trained one in bin space
    xt = _data(seed=2)[0]
    np.testing.assert_allclose(loaded.predict(xt), tb.predict(xt), rtol=1e-6, atol=1e-6)
    assert tb.model_to_string(num_iteration=2).count("\nTree=") == 2


def _blocks(text):
    return [Tree.from_string(b) for b in
            text.partition("end of trees")[0].split("Tree=")[1:]]


@pytest.mark.parametrize("case", list(CASES))
def test_port_tree_blocks_equal_jax_blocks(case):
    params, weighted = CASES[case]
    x, z, w = _data()
    w = w if weighted else None
    jt, tt = _blocks(_jax_booster(params, x, z, w).model_to_string()), \
        _blocks(_port_booster(params, x, z, w).model_to_string())
    assert len(jt) == len(tt) == 6
    for j, t in zip(jt, tt):
        assert j.num_leaves == t.num_leaves
        for k in ("split_feature_real", "threshold", "decision_type", "left_child",
                  "right_child", "leaf_count", "internal_count"):
            np.testing.assert_array_equal(getattr(t, k), getattr(j, k), err_msg=k)
        for k in ("leaf_value", "internal_value", "leaf_weight", "internal_weight"):
            np.testing.assert_allclose(getattr(t, k), getattr(j, k), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(t.split_gain, j.split_gain, rtol=1e-4)
        assert t.shrinkage == j.shrinkage


@pytest.mark.parametrize("name,match", [("linear", "linear")])
def test_categorical_and_linear_files_raise(name, match):
    with pytest.raises(NotImplementedError, match=match):
        lt.Booster(model_file=str(GOLDEN / f"scen_{name}.model.txt"), device="cpu")


def test_categorical_scenario_model_predicts_its_golden():
    x, _ = _golden("categorical")
    model = GOLDEN / "scen_categorical.model.txt"
    b = lt.Booster(model_file=str(model), device="cpu")
    assert b.num_trees() == model.read_text().count("\nTree=")
    assert sum(t.num_cat for t in b.trees) > 0
    want = np.loadtxt(GOLDEN / "scen_categorical.preds.txt", ndmin=1)
    np.testing.assert_allclose(b.predict(x), want, rtol=1e-4, atol=1e-5)


def test_categorical_scenario_trains_the_jax_trees_and_reaches_the_reference():
    x, y = _golden("categorical")
    params = json.loads((GOLDEN / "scen_categorical.params.json").read_text())
    rounds = int(params.pop("num_trees"))
    ref_final = json.loads((GOLDEN / "scen_categorical.evals.json").read_text())[
        "training:l2"][-1][1]
    rec = {}
    ds = lt.Dataset(x, y, params=params)
    tb = lt.train(params, ds, rounds, valid_sets=[ds], valid_names=["training"],
                  callbacks=[lt.record_evaluation(rec)], device="cpu")
    assert tb.hist_mode == "seg" and len(tb.trees) == rounds
    assert rec["training"]["l2"][-1] <= ref_final + 0.05 * abs(ref_final)
    assert "cat_threshold=" in tb.model_to_string()
    jp = {**params, "hist_mode": "seg", "verbosity": -1, "metric": "none"}
    jb = lgb.train(jp, lgb.Dataset(x, y, params=jp), rounds)
    for i, (jr, tree) in enumerate(zip(jb._bin_records, tb.trees)):
        tr = tree.record()
        for key in ("split_feature", "split_bin", "default_left", "left_child", "right_child",
                    "split_is_cat"):
            np.testing.assert_array_equal(tr[key], jr[key], err_msg=f"tree {i} {key}")
        np.testing.assert_allclose(tr["leaf_value"], jr["leaf_value"], rtol=0, atol=1e-5)
    assert len(jb._bin_records) == rounds


@pytest.mark.parametrize("name", ["bagging", "goss", "quantized"])
def test_sampled_scenario_trains_the_jax_trees_and_reaches_the_reference(name):
    x, y = _golden(name)
    params = json.loads((GOLDEN / f"scen_{name}.params.json").read_text())
    rounds = int(params.pop("num_trees"))
    evals = json.loads((GOLDEN / f"scen_{name}.evals.json").read_text())
    ref_final = evals["training:l2"][-1][1]
    ds = lt.Dataset(x, y, params=params)
    rec = {}
    tb = lt.train(params, ds, rounds, valid_sets=[ds], valid_names=["training"],
                  callbacks=[lt.record_evaluation(rec)], device="cpu")
    assert tb.hist_mode == "seg" and len(tb.trees) == rounds
    assert rec["training"]["l2"][-1] <= ref_final + 0.15 * abs(ref_final)
    # the JAX package on the same layout (its CPU default is 'ordered')
    jp = {**params, "hist_mode": "seg", "verbosity": -1, "metric": "none"}
    jb = lgb.train(jp, lgb.Dataset(x, y, params=jp), rounds)
    for i, (jr, tree) in enumerate(zip(jb._bin_records, tb.trees)):
        tr = tree.record()
        for key in ("split_feature", "split_bin", "default_left", "left_child", "right_child"):
            np.testing.assert_array_equal(tr[key], jr[key], err_msg=f"tree {i} {key}")
        np.testing.assert_allclose(tr["leaf_value"], jr["leaf_value"], rtol=0, atol=1e-5)
    assert len(jb._bin_records) == rounds
