"""The port's train API (lightgbm_tpu_torch/engine.py, callback.py,
config.py, the Booster's evaluation) and row weights / init scores, on the
CPU, against the JAX package.

* with weights, and with ``init_score``, the port's trees equal the JAX
  package's (split features, bins, default directions, children; leaves
  within 1e-5), for regression and binary;
* ``record_evaluation`` of the training set and one validation set equals
  the JAX package's round by round within 1e-5 relative (the leaves' own
  tolerance), for each ported metric;
* early stopping's ``best_iteration`` and ``best_score`` equal the JAX
  package's, with and without ``first_metric_only``;
* the train API's keys are accepted, an unported key still raises;
* scen_weighted: the port's final weighted train l2 is at most the
  reference LightGBM's x 1.05 (the band of test_consistency.py:284).
"""

import json
import pathlib

import numpy as np
import pytest

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config

from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)

GOLDEN = pathlib.Path(__file__).parent / "golden"
METRICS = {"regression": ["l2", "rmse", "l1"], "binary": ["binary_logloss", "binary_error", "auc"]}


def _data(n=3000, f=6, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[rng.random((n, f)) < 0.05] = np.nan
    z = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1])
         - 0.3 * np.nan_to_num(x[:, 2]) ** 2 + rng.normal(size=n))
    return x, z, rng.uniform(0.5, 1.5, n), rng.normal(size=n) * 0.3


def _run(objective, extra=None, meta=(), rounds=6, callbacks=lambda m: [], valid=True,
         n_train=2000):
    """(JAX booster, port booster, JAX records, port records): the same
    params, rows and callbacks through both packages, the training set and
    one validation set evaluated."""
    x, z, w, isc = _data()
    y = (z > 0).astype(float) if objective == "binary" else z
    params = {"objective": objective, "num_leaves": 15, "max_bin": 63, "learning_rate": 0.2,
              "verbosity": -1, "enable_bundle": False, **(extra or {})}
    kw = {"weight": w, "init_score": isc}
    tr = {k: kw[k][:n_train] for k in meta}
    va = {k: kw[k][n_train:] for k in meta if k == "init_score"}
    out = []
    for pkg, more in ((lgb, {}), (lt, {"device": "cpu"})):
        rec = {}
        ds = pkg.Dataset(x[:n_train], y[:n_train], params=params, **tr)
        vs = pkg.Dataset(x[n_train:], y[n_train:], reference=ds, **va)
        sets = dict(valid_sets=[ds, vs], valid_names=["training", "valid"]) if valid else {}
        b = pkg.train(params, ds, rounds, callbacks=[pkg.record_evaluation(rec), *callbacks(pkg)],
                      **sets, **more)
        out += [b, rec]
    jb, jrec, tb, trec = out
    return jb, tb, jrec, trec


def _same_trees(jb, tb) -> int:
    """The trees must be equal, leaves within 1e-5.  The one exception is a
    node that no training row with a missing value reaches, so that its two
    default directions gain the same: the two packages sum f32 histograms
    in other orders, and the direction of such a node follows the last ulp.
    It may differ if its gains agree within 1e-5.  Returns the trees before
    the first such node (from there on validation rows with a missing value
    may take the other side; training rows do not)."""
    assert len(tb.trees) == len(jb._bin_records)
    first_tie = len(tb.trees)
    for i, (jr, tree) in enumerate(zip(jb._bin_records, tb.trees)):
        tr = tree.record()
        for k in ("split_feature", "split_bin", "left_child", "right_child"):
            np.testing.assert_array_equal(tr[k], jr[k], err_msg=k)
        np.testing.assert_allclose(tr["leaf_value"], jr["leaf_value"], rtol=0, atol=1e-5)
        tie = tr["default_left"] != jr["default_left"]
        if tie.any():
            np.testing.assert_allclose(tree.split_gain[tie], jb.models_[i].split_gain[tie],
                                       rtol=1e-5)
            first_tie = min(first_tie, i)
    return first_tie


def _assert_same_records(jrec, trec, valid_rounds=None):
    """Equal records within 1e-5 relative: every round of the training
    set's, the first ``valid_rounds`` of the validation set's."""
    assert list(trec) == list(jrec)
    for data in jrec:
        assert list(trec[data]) == list(jrec[data])
        rounds = None if data == "training" else valid_rounds
        for m in jrec[data]:
            assert len(trec[data][m]) == len(jrec[data][m])
            np.testing.assert_allclose(trec[data][m][:rounds], jrec[data][m][:rounds],
                                       rtol=1e-5, err_msg=f"{data} {m}")


@pytest.mark.parametrize("meta", [("weight",), ("init_score",), ("weight", "init_score")],
                         ids=["weight", "init_score", "both"])
@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_weighted_and_init_score_training_matches_jax(objective, meta):
    jb, tb, jrec, trec = _run(objective, {"metric": METRICS[objective]}, meta)
    _assert_same_records(jrec, trec, _same_trees(jb, tb))
    x = _data()[0][:2000]  # the training rows
    for raw in (True, False):
        np.testing.assert_allclose(tb.predict(x, raw_score=raw), jb.predict(x, raw_score=raw),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("metric", [m for ms in METRICS.values() for m in ms])
def test_record_evaluation_matches_jax(metric):
    objective = "binary" if metric in METRICS["binary"] else "regression"
    jb, tb, jrec, trec = _run(objective, {"metric": metric}, rounds=5)
    assert list(trec) == ["training", "valid"] and len(trec["valid"][metric]) == 5
    _assert_same_records(jrec, trec, _same_trees(jb, tb))
    # each valid score is the forest walk of the valid bins (the bias folded
    # into the first tree adds in another order there)
    np.testing.assert_allclose(tb._valid[0].score.numpy(),
                               tb.predict_raw_bins(tb._valid[0].bins).numpy(),
                               rtol=1e-6, atol=1e-6)


# Early stopping needs a model that overfits, where two features can gain
# the same.  The JAX package's CPU default layout ('ordered') breaks exact
# ties by its best_split rule, the port's default ('seg') by the split-scan
# kernel's; these params put both packages on the seg layout and the
# kernel's rule.
SEG_SLICE = {"hist_mode": "seg", "hist_acc": "bf16", "grow_fused": "off",
             "fused_split_scan": True}


@pytest.mark.parametrize("first_metric_only", [False, True])
def test_early_stopping_matches_jax(first_metric_only):
    extra = {"metric": ["binary_logloss", "auc"], "learning_rate": 0.5,
             "first_metric_only": first_metric_only, **SEG_SLICE}
    jb, tb, jrec, trec = _run(
        "binary", extra, rounds=40,
        callbacks=lambda pkg: [pkg.early_stopping(3, first_metric_only, verbose=False)])
    assert 1 < tb.best_iteration < 30
    assert tb.best_iteration == jb.best_iteration
    assert list(tb.best_score) == list(jb.best_score)
    for data in jb.best_score:
        for m, v in jb.best_score[data].items():
            np.testing.assert_allclose(tb.best_score[data][m], v, rtol=1e-5)
    _assert_same_records(jrec, trec, _same_trees(jb, tb))
    # predict stops at the best iteration
    x = _data()[0][:2000]
    np.testing.assert_array_equal(tb.predict(x), tb.predict(x, num_iteration=tb.best_iteration))
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), rtol=0, atol=1e-5)


def test_early_stopping_round_param_matches_jax():
    extra = {"metric": "l1", "num_leaves": 63, "learning_rate": 0.6, "min_data_in_leaf": 5,
             "early_stopping_rounds": 2, **SEG_SLICE}
    jb, tb, jrec, trec = _run("regression", extra, rounds=40)
    assert tb.best_iteration == jb.best_iteration > 1
    assert tb.num_trees() > tb.best_iteration
    _assert_same_records(jrec, trec, _same_trees(jb, tb))


def test_feval_matches_jax():
    def feval(pred, ds):
        return "mean_pred", float(np.mean(pred)), False

    x, z, _, _ = _data()
    params = {"objective": "binary", "num_leaves": 7, "metric": "none", "verbosity": -1,
              "enable_bundle": False}
    got = []
    for pkg, more in ((lgb, {}), (lt, {"device": "cpu"})):
        rec = {}
        ds = pkg.Dataset(x[:2000], (z[:2000] > 0).astype(float), params=params)
        vs = pkg.Dataset(x[2000:], (z[2000:] > 0).astype(float), reference=ds)
        pkg.train(params, ds, 4, valid_sets=[vs], feval=feval,
                  callbacks=[pkg.record_evaluation(rec)], **more)
        got.append(rec)
    assert list(got[1]["valid_0"]) == ["mean_pred"]
    np.testing.assert_allclose(got[1]["valid_0"]["mean_pred"], got[0]["valid_0"]["mean_pred"],
                               rtol=1e-6)


@pytest.mark.parametrize("key,value,field,want", [
    ("verbosity", -1, "verbosity", -1), ("verbose", 0, "verbosity", 0),
    ("metric", "l2,auc", "metric", ["l2", "auc"]), ("metrics", ["l1"], "metric", ["l1"]),
    ("metric_freq", 2, "metric_freq", 2), ("output_freq", 3, "metric_freq", 3),
    ("is_provide_training_metric", True, "is_provide_training_metric", True),
    ("training_metric", "true", "is_provide_training_metric", True),
    ("first_metric_only", True, "first_metric_only", True),
    ("early_stopping_round", 4, "early_stopping_round", 4),
    ("early_stopping_rounds", 4, "early_stopping_round", 4),
    ("n_iter_no_change", 4, "early_stopping_round", 4),
    ("num_iterations", 7, "num_iterations", 7), ("num_iteration", 7, "num_iterations", 7),
    ("n_iter", 7, "num_iterations", 7), ("num_tree", 7, "num_iterations", 7),
    ("num_trees", 7, "num_iterations", 7), ("num_round", 7, "num_iterations", 7),
    ("num_rounds", 7, "num_iterations", 7), ("num_boost_round", 7, "num_iterations", 7),
    ("n_estimators", 7, "num_iterations", 7),
])
def test_train_api_keys_are_accepted(key, value, field, want):
    assert getattr(Config.from_params({key: value}), field) == want


def test_num_iterations_alias_sets_the_rounds():
    x, z, _, _ = _data()
    params = {"objective": "regression", "num_leaves": 7, "n_estimators": 3, "verbosity": -1,
              "enable_bundle": False}
    b = lt.train(params, lt.Dataset(x, z, params=params), 50, device="cpu")
    assert b.num_trees() == b.current_iteration() == 3


@pytest.mark.parametrize("key", ["extra_trees", "bagging_by_query", "monotone_constraints",
                                 "checkpoint_dir"])
def test_unported_key_still_raises(key):
    with pytest.raises(ValueError, match="not yet ported"):
        Config.from_params({key: 1})


def test_unported_train_arguments_raise():
    x, z, _, _ = _data(n=300)
    ds = lt.Dataset(x, z, params={"enable_bundle": False})
    with pytest.raises(NotImplementedError, match="init_model"):
        lt.train({}, ds, 1, init_model="model.txt", device="cpu")
    with pytest.raises(NotImplementedError, match="resume_from"):
        lt.train({}, ds, 1, resume_from="ckpt", device="cpu")


def test_scen_weighted_training_reaches_the_reference_metric():
    params = json.loads((GOLDEN / "scen_weighted.params.json").read_text())
    params["verbosity"] = -1
    rounds = int(params.pop("num_trees"))
    arr = np.loadtxt(GOLDEN / "scen_weighted.train.csv", delimiter=",")
    weight = np.loadtxt(GOLDEN / "scen_weighted.train.csv.weight", ndmin=1)
    evals = json.loads((GOLDEN / "scen_weighted.evals.json").read_text())
    ref_final = next(v for k, v in evals.items() if k.endswith("l2"))[-1][1]
    ds = lt.Dataset(arr[:, 1:], arr[:, 0], weight=weight, params=params)
    rec = {}
    b = lt.train(params, ds, rounds, valid_sets=[ds], valid_names=["training"],
                 callbacks=[lt.record_evaluation(rec)], device="cpu")
    assert b.num_trees() == rounds and len(rec["training"]["l2"]) == rounds
    ours = rec["training"]["l2"][-1]
    assert ours <= ref_final * 1.05, (ours, ref_final)
    # the recorded metric is the weighted l2 of the model's predictions
    pred = b.predict(arr[:, 1:])
    np.testing.assert_allclose(ours, np.average((pred - arr[:, 0]) ** 2, weights=weight),
                               rtol=1e-5)
