"""Multiclass training and prediction of the port (k trees an iteration:
lightgbm_tpu_torch/boosting/gbdt.py, objectives.py, metrics.py, shap.py,
convert.py, ops/forest_walk.py) against the JAX package, on the CPU.

* softmax and one-vs-all at 5 classes on the seg layout, and softmax with
  GOSS: the JAX package's trees (leaves within 1e-5) and its raw and
  converted predictions; one int8 case against the JAX package's kernels
  in interpret mode;
* a class absent from the labels (its trees constant), and an init score
  of k x N, as the JAX package trains them;
* model text both ways with the JAX package, and a byte-equal round trip;
* ``pred_leaf``, prediction early stopping (the multiclass margin) and
  ``pred_contrib`` ([N, k (F + 1)]) against the JAX package's;
* the plain walk at 10 classes against the JAX package's walk kernel in
  interpret mode;
* multi_logloss, multi_error and auc_mu (weighted and not) within 1e-6 of
  the JAX package's; ``feval`` given [N, k], record_evaluation and early
  stopping as the JAX package's.
"""

import os
import re

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.metrics import create_metric as jax_create_metric
from lightgbm_tpu.objectives import create_objective as jax_create_objective
from lightgbm_tpu.ops.pallas.forest_walk import build_tables as jax_build_tables
from lightgbm_tpu.ops.pallas.forest_walk import forest_walk as jax_forest_walk
from lightgbm_tpu.ops.pallas.forest_walk import pad_bins_for_walk, unpack_walk_scores

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import _build, metrics
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import booster_from_arrays
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.ops import forest_walk as fw

from .test_torch_forest_walk import random_case
from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)
from .test_torch_interpret import int8_on_cpu, jax_interpret

K = 5
BASE = {"num_class": K, "num_leaves": 15, "max_bin": 63, "learning_rate": 0.2,
        "min_data_in_leaf": 10, "verbosity": -1}
CASES = {
    "multiclass": {"objective": "multiclass"},
    "multiclassova": {"objective": "multiclassova"},
    "multiclass-goss": {"objective": "multiclass", "boosting": "goss", "learning_rate": 0.5},
}
ROUNDS = 4


def _data(n=2000, f=6, seed=20, classes=K):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[rng.random((n, f)) < 0.05] = np.nan
    z = np.nan_to_num(x[:, :classes % f + 1]) @ rng.normal(size=(classes % f + 1, classes))
    y = np.argmax(z + rng.normal(size=(n, classes)), axis=1).astype(np.float64)
    return x, y, rng.uniform(0.5, 1.5, n)


def _train_both(params, x, y, rounds=ROUNDS, weight=None, init_score=None):
    jp = {**params, "hist_mode": "seg", "metric": "none"}
    jb = lgb.train(jp, lgb.Dataset(x, y, weight=weight, init_score=init_score, params=jp),
                   rounds)
    tb = lt.train(params, lt.Dataset(x, y, weight=weight, init_score=init_score,
                                     params=params), rounds, device="cpu")
    return jb, tb


def _assert_same_trees(jb, tb):
    assert len(tb.trees) == len(jb._bin_records)
    for i, (jr, tree) in enumerate(zip(jb._bin_records, tb.trees)):
        tr = tree.record()
        for key in ("split_feature", "split_bin", "default_left", "left_child", "right_child"):
            np.testing.assert_array_equal(tr[key], jr[key], err_msg=f"tree {i} {key}")
        np.testing.assert_allclose(tr["leaf_value"], jr["leaf_value"], rtol=0, atol=1e-5,
                                   err_msg=f"tree {i}")


@pytest.fixture(scope="module", params=list(CASES))
def trained(request):
    x, y, _ = _data()
    params = {**BASE, **CASES[request.param]}
    jb, tb = _train_both(params, x, y)
    return request.param, params, x, y, jb, tb


def test_trees_and_predictions_equal_jax(trained):
    name, _, x, _, jb, tb = trained
    _assert_same_trees(jb, tb)
    assert tb.num_class == K and len(tb.trees) == K * ROUNDS
    raw = tb.predict(x, raw_score=True)
    assert raw.shape == (len(x), K)
    np.testing.assert_allclose(raw, jb.predict(x, raw_score=True), rtol=0, atol=1e-5)
    np.testing.assert_allclose(raw, tb.score.numpy().T, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), rtol=0, atol=1e-6)
    if name.startswith("multiclass") and "ova" not in name:
        np.testing.assert_allclose(tb.predict(x).sum(axis=1), 1.0, rtol=0, atol=1e-6)
    if name == "multiclass-goss":
        assert tb.bag_shares and tb.bag_shares[-1][1] < 1.0


def test_model_text_crosses_both_ways_and_round_trips(trained, tmp_path):
    _, _, x, _, jb, tb = trained
    text = tb.model_to_string()
    assert f"num_class={K}\nnum_tree_per_iteration={K}\n" in text
    jt = lgb.Booster(model_str=text)
    np.testing.assert_allclose(jt.predict(x), tb.predict(x), rtol=1e-6, atol=1e-6)
    tj = lt.Booster(model_str=jb.model_to_string(), device="cpu")
    assert tj.num_class == K and tj.num_trees() == K * ROUNDS
    np.testing.assert_allclose(tj.predict(x), jb.predict(x), rtol=1e-6, atol=1e-6)
    path = tmp_path / "model.txt"
    tb.save_model(str(path))
    back = lt.Booster(model_file=str(path), device="cpu")
    assert back.model_to_string() == path.read_text()
    np.testing.assert_allclose(back.predict(x, raw_score=True), tb.predict(x, raw_score=True),
                               rtol=1e-6, atol=1e-6)


def test_pred_leaf_early_stop_and_contrib_equal_jax(trained):
    _, _, x, _, jb, tb = trained
    leaves = tb.predict(x, pred_leaf=True)
    assert leaves.shape == (len(x), K * ROUNDS)
    np.testing.assert_array_equal(leaves, jb.predict(x, pred_leaf=True))
    kw = {"pred_early_stop": True, "pred_early_stop_freq": 1, "pred_early_stop_margin": 0.4}
    early = tb.predict(x, raw_score=True, **kw)
    np.testing.assert_allclose(early, jb.predict(x, raw_score=True, **kw), rtol=0, atol=1e-5)
    assert (np.abs(early - tb.predict(x, raw_score=True)).max(axis=1) > 0).any()
    xs = x[:40]
    contrib = tb.predict(xs, pred_contrib=True)
    assert contrib.shape == (len(xs), K * (x.shape[1] + 1))
    np.testing.assert_allclose(contrib, jb.predict(xs, pred_contrib=True), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(contrib.reshape(len(xs), K, -1).sum(axis=2),
                               tb.predict(xs, raw_score=True), rtol=0, atol=1e-5)


def test_converted_booster_predicts_the_jax_model(trained):
    name, params, x, _, jb, _ = trained
    ds = jb.train_set
    used = list(ds.used_features)
    mappers = [ds.bin_mappers[j] for j in used]
    cb = booster_from_arrays(
        [dict(r) for r in jb._bin_records], [m.bin_upper_bound for m in mappers],
        [m.missing_type for m in mappers], [m.nan_bin for m in mappers], 0.0,
        params["objective"], num_class=K, device="cpu", used_features=used)
    np.testing.assert_allclose(cb.predict(x), jb.predict(x), rtol=0, atol=1e-6)


def test_int8_multiclass_trees_equal_jax_interpret():
    x, y, _ = _data(n=1200, seed=21)
    params = {**BASE, "objective": "multiclass"}
    jp = {**params, "hist_mode": "seg", "metric": "none"}
    with jax_interpret():
        jb = lgb.train(jp, lgb.Dataset(x, y, params=jp), 2)
    assert jb._grower_params.grow_fused
    with int8_on_cpu():
        tb = lt.train(params, lt.Dataset(x, y, params=params), 2, device="cpu")
    assert tb._int8_acc and sum(tb.refine_counts) > 0
    _assert_same_trees(jb, tb)


def test_absent_class_and_init_score_train_as_jax():
    x, y, w = _data(n=1500, seed=22)
    y = np.where(y == 3, 4, y)  # class 3 never appears
    params = {**BASE, "objective": "multiclass"}
    jb, tb = _train_both(params, x, y, rounds=3, weight=w)
    _assert_same_trees(jb, tb)
    assert all(tb.trees[i].num_leaves == 1 for i in range(3, len(tb.trees), K))
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), rtol=0, atol=1e-6)
    rng = np.random.default_rng(23)
    init = rng.normal(size=K * len(x)) * 0.3  # class by class
    jb, tb = _train_both({**params, "objective": "multiclassova"}, x, y, rounds=3,
                         init_score=init)
    _assert_same_trees(jb, tb)
    np.testing.assert_allclose(tb.score.numpy(), np.asarray(jb._score)[:, :len(x)],
                               rtol=0, atol=1e-5)


def test_plain_walk_at_ten_classes_equals_jax_walker():
    bins, recs, nanb = random_case(30, 300, 12, [1, 7, 17, 3, 40, 9, 1, 12, 5, 30, 2, 8,
                                                 21, 6, 11, 4, 2, 19, 13, 1, 3, 9, 15])
    jt = jax_build_tables(recs, nanb)
    out = jax_forest_walk(pad_bins_for_walk(bins), jt, n_trees=jt.n_trees,
                          max_depth=jt.max_depth, k=10, interpret=True)
    want = unpack_walk_scores(np.asarray(out), bins.shape[0], 10)
    got = fw.forest_walk(torch.as_tensor(bins), fw.build_tables(recs, nanb, "cpu"), 10)
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)


def test_kernel_class_blocks_are_the_wrappers():
    """The class block of csrc/forest_walk.cu (kMaxClass, a grid dimension
    of blocks of classes) is the wrapper's CLASS_BLOCK, and the C entry no
    longer refuses more classes than one block holds."""
    with open(os.path.join(_build.CSRC, "forest_walk.cu")) as fh:
        src = fh.read()
    assert int(re.search(r"constexpr int kMaxClass = (\d+);", src).group(1)) == fw.CLASS_BLOCK
    valid = re.search(r"bool valid\(\) const \{(.*?)\}", src, re.S).group(1)
    assert "k <= kMaxClass" not in valid and "class_blocks() <= 65535" in valid
    assert "dim3((unsigned)grid, (unsigned)w.class_blocks())" in src


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_multiclass_metrics_match_jax(objective, weighted):
    rng = np.random.default_rng(24 + weighted)
    n = 3000
    label = rng.integers(0, K, n).astype(np.float64)
    score = (rng.normal(size=(K, n)) + 0.8 * (np.arange(K)[:, None] == label)).astype(np.float32)
    score[:, :50] = np.round(score[:, :50])  # ties
    weight = rng.uniform(0.5, 1.5, n) if weighted else None
    params = {"objective": objective, "num_class": K,
              "auc_mu_weights": list((1.0 + np.arange(K * K) % 3) * (1 - np.eye(K).ravel()))}
    jcfg, cfg = JaxConfig.from_params(params), Config.from_params(params)
    jobj = jax_create_objective(jcfg)
    jobj.init(label, weight)
    tobj = create_objective(cfg, label, "cpu", weight)
    for name in ("multi_logloss", "multi_error", "auc_mu"):
        jm = jax_create_metric(name, jcfg)
        jm.init(label, weight)
        ev = getattr(jm, "eval_device", None)
        want = (ev(score, jobj) if ev is not None else None) or jm.eval(
            score.astype(np.float64), jobj)
        got = metrics.create_metric(name, label, weight, "cpu", cfg).eval(
            torch.as_tensor(score), tobj)
        assert got[0][0] == want[0][0]
        np.testing.assert_allclose(got[0][1], want[0][1], rtol=1e-6, err_msg=name)


def test_train_api_at_five_classes_matches_jax():
    x, y, _ = _data(n=1500, seed=25)
    xv, yv, _ = _data(n=600, seed=26)
    params = {**BASE, "objective": "multiclass", "metric": ["multi_logloss", "multi_error"],
              "learning_rate": 0.5}
    seen = []

    def feval(pred, data):
        seen.append(pred.shape)
        return "mean_top", float(pred.max(axis=1).mean()), True

    out = {}
    for pkg, kw in ((lgb, {"params": {**params, "hist_mode": "seg"}}),
                    (lt, {"params": params, "device": "cpu"})):
        p = kw.pop("params")
        ds = pkg.Dataset(x, y, params=p)
        dv = pkg.Dataset(xv, yv, reference=ds, params=p)
        rec = {}
        b = pkg.train(p, ds, 12, valid_sets=[dv], valid_names=["valid"], feval=feval,
                      callbacks=[pkg.record_evaluation(rec), pkg.early_stopping(2, verbose=False)],
                      **kw)
        out[pkg.__name__] = (b, rec)
    (jb, jrec), (tb, trec) = out["lightgbm_tpu"], out["lightgbm_tpu_torch"]
    assert set(seen) == {(len(xv), K)}
    assert tb.best_iteration == jb.best_iteration
    for name in ("multi_logloss", "multi_error", "mean_top"):
        np.testing.assert_allclose(trec["valid"][name], jrec["valid"][name], rtol=1e-5)
    np.testing.assert_allclose(tb.predict(xv), jb.predict(xv), rtol=0, atol=1e-6)
