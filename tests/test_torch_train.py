"""The whole slice: lightgbm_tpu_torch training on the CPU against the JAX
package's training, plus the port's import and device rules.

* the two-launch path: the JAX package with ``hist_mode='seg', hist_acc='bf16',
  grow_fused='off', fused_split_scan=True``, the port with the same;
* the default path: both with no path parameter (the port's fused grow step
  with f32 sums on the CPU; the JAX package's CPU default);
* int8 accumulation: the port with ``grower.INT8_ON_CPU`` against the JAX
  package with its seg and grow-step kernels in interpret mode (which is
  what engages int8 there off the TPU).  The near-tie refine sums f32 in
  another order there (a bf16 3-term matmul), so structure is compared.

Every tree must have the same split features, bins, default directions and
children; leaf values and predictions must agree within 1e-5 (the two
packages' f32 ``exp`` may differ in the last ulp, which moves binary
gradients by an ulp).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.ops import grower as jax_grower
from lightgbm_tpu.ops.pallas import grow_step as jax_grow_step
from lightgbm_tpu.ops.pallas import seg as jax_seg

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import grower
from lightgbm_tpu_torch.quantize import hist_acc_scales

from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)
from .test_torch_interpret import int8_on_cpu, jax_interpret

SLICE = {"hist_mode": "seg", "hist_acc": "bf16", "grow_fused": "off",
         "fused_split_scan": True}


def _data(objective, n=3000, f=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[rng.random((n, f)) < 0.05] = np.nan
    z = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1])
         - 0.3 * np.nan_to_num(x[:, 2]) ** 2 + rng.normal(size=n))
    return x, (z > 0).astype(float) if objective == "binary" else z


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_training_matches_jax_seg_path(objective):
    x, y = _data(objective)
    params = {"objective": objective, "num_leaves": 15, "max_bin": 63,
              "learning_rate": 0.1}
    jp = {**params, **SLICE, "verbosity": -1, "metric": "none"}
    jb = lgb.train(jp, lgb.Dataset(x, y, params=jp), 5)
    assert jb._grower_params.hist_mode == "seg"
    assert not jb._grower_params.grow_fused and jb._grower_params.fused_split_scan
    tb = lt.train({**params, **SLICE}, lt.Dataset(x, y, params=params), 5, device="cpu")

    assert len(tb.trees) == len(jb._bin_records) == 5
    for jr, tree in zip(jb._bin_records, tb.trees):
        tr = tree.record()
        for k in ("split_feature", "split_bin", "default_left", "left_child", "right_child"):
            np.testing.assert_array_equal(tr[k], jr[k], err_msg=k)
        np.testing.assert_allclose(tr["leaf_value"], jr["leaf_value"], rtol=0, atol=1e-5)
    for jt, tt in zip(jb.models_, tb.trees):
        np.testing.assert_array_equal(tt.threshold, jt.threshold)
        np.testing.assert_array_equal(tt.split_feature_real, jt.split_feature)
    for raw in (True, False):
        np.testing.assert_allclose(tb.predict(x, raw_score=raw), jb.predict(x, raw_score=raw),
                                   rtol=0, atol=1e-5)


def _assert_same_trees(jb, tb, leaf_atol=1e-5):
    assert len(tb.trees) == len(jb._bin_records)
    for jr, tree in zip(jb._bin_records, tb.trees):
        tr = tree.record()
        for k in ("split_feature", "split_bin", "default_left", "left_child", "right_child"):
            np.testing.assert_array_equal(tr[k], jr[k], err_msg=k)
        np.testing.assert_allclose(tr["leaf_value"], jr["leaf_value"], rtol=0, atol=leaf_atol)


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_default_path_matches_jax_defaults(objective):
    """No path parameter on either side: the port resolves the JAX
    package's defaults (fused grow step, int8 off on the CPU)."""
    x, y = _data(objective, seed=11)
    params = {"objective": objective, "num_leaves": 15, "max_bin": 63,
              "learning_rate": 0.1}
    jp = {**params, "verbosity": -1, "metric": "none"}
    jb = lgb.train(jp, lgb.Dataset(x, y, params=jp), 5)
    tb = lt.train(params, lt.Dataset(x, y, params=params), 5, device="cpu")
    assert tb._grower_params.grow_fused and not tb._int8_acc
    assert tb.refine_counts == [0] * 5
    _assert_same_trees(jb, tb)
    for raw in (True, False):
        np.testing.assert_allclose(tb.predict(x, raw_score=raw), jb.predict(x, raw_score=raw),
                                   rtol=0, atol=1e-5)


def _int8_problem():
    """The int8 smoke workload of tools/run_tests.sh (1,200 x 10)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1200, 10)).astype(np.float32)
    y = (x[:, 0] + 0.6 * x[:, 1] + 0.1 * rng.normal(size=1200) > 0.2).astype(np.float32)
    return x, y


def test_int8_training_matches_jax_interpret():
    x, y = _int8_problem()
    params = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.2,
              "min_data_in_leaf": 20, "lambda_l2": 0.25}
    jp = {**params, "hist_mode": "seg", "verbosity": -1, "metric": "none"}
    assert not (jax_seg._INTERPRET or jax_grow_step._INTERPRET)
    with jax_interpret():
        jb = lgb.train(jp, lgb.Dataset(x, y, params=jp), 3)
    assert jb._grower_params.grow_fused
    with int8_on_cpu():
        tb = lt.train(params, lt.Dataset(x, y, params=params), 3, device="cpu")
    assert tb._int8_acc and min(tb.refine_counts) > 0
    _assert_same_trees(jb, tb)
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), rtol=0, atol=1e-5)


def test_int8_tree_refine_count_equals_jax():
    """One int8 tree from the same gradients: the same splits and the same
    number of near-tie refines as the JAX TreeArrays.refine_count."""
    x, _ = _int8_problem()
    ds = lt.Dataset(x, np.zeros(len(x)), params={}).construct()
    rng = np.random.default_rng(1)
    g = rng.normal(size=len(x)).astype(np.float32)
    h = (rng.random(len(x)) + 0.2).astype(np.float32)
    nb, nanb, b = ds.num_bins(), ds.nan_bins(), ds.max_bin_padded
    f = ds.bins.shape[1]
    jp = jax_grower.GrowerParams(num_leaves=31, max_bin=b, min_data_in_leaf=5,
                                 lambda_l2=0.125, hist_mode="seg", grow_fused=True)
    with jax_interpret():
        jt, _ = jax_grower.grow_tree(
            jnp.asarray(ds.bins.astype(np.int32)), jnp.asarray(g), jnp.asarray(h),
            jnp.ones(len(x), jnp.float32), jnp.asarray(nb), jnp.asarray(nanb),
            jnp.ones(f, bool), jp,
        )
    gt, ht, m = torch.as_tensor(g), torch.as_tensor(h), torch.ones(len(x))
    tt, _ = grower.grow_tree(
        torch.as_tensor(np.ascontiguousarray(ds.bins.T)), gt, ht, m,
        torch.as_tensor(nb), torch.as_tensor(nanb), torch.ones(f, dtype=torch.bool),
        grower.GrowerParams(num_leaves=31, max_bin=b, min_data_in_leaf=5, lambda_l2=0.125),
        quant_scales=hist_acc_scales(gt, ht, m),
    )
    k = tt.num_leaves - 1
    assert tt.num_leaves == int(jt.num_leaves)
    np.testing.assert_array_equal(tt.split_feature, np.asarray(jt.split_feature)[:k])
    np.testing.assert_array_equal(tt.split_bin, np.asarray(jt.split_bin)[:k])
    assert tt.refine_count == int(jt.refine_count) > 0


@pytest.mark.parametrize("objective,leaf", [("regression", 4.99862), ("binary", 1.38629)])
def test_constant_first_tree_without_boost_from_average(objective, leaf):
    """No split possible and ``boost_from_average=False``: the first tree is
    the constant init score, added to the scores (ROADMAP.md Queue 3, F2)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(100, 2))
    if objective == "regression":
        y = 5.0 + 0.01 * rng.normal(size=100)
    else:
        y = (np.arange(100) % 5 != 0).astype(float)  # 80% positives
    params = {"objective": objective, "boost_from_average": False, "min_gain_to_split": 1e9}
    jp = {**params, "verbosity": -1, "metric": "none"}
    jb = lgb.train(jp, lgb.Dataset(x, y, params=jp), 3)
    tb = lt.train(params, lt.Dataset(x, y, params=params), 3, device="cpu")
    assert len(tb.trees) == len(jb.models_) == 1
    assert tb.trees[0].num_leaves == 1
    np.testing.assert_allclose(tb.trees[0].leaf_value, jb.models_[0].leaf_value, rtol=0,
                               atol=1e-6)
    assert abs(float(tb.trees[0].leaf_value[0]) - leaf) < 1e-5
    for raw in (True, False):
        np.testing.assert_allclose(tb.predict(x, raw_score=raw), jb.predict(x, raw_score=raw),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb.score.numpy(), tb.predict(x, raw_score=True), rtol=0, atol=1e-6)


def test_training_loss_falls_and_score_matches_predict():
    x, y = _data("binary", n=2000, seed=5)
    params = {"objective": "binary", "num_leaves": 7, "max_bin": 31}
    b = lt.Booster(params, lt.Dataset(x, y, params=params), device="cpu")
    losses = []
    for _ in range(4):
        assert not b.update()
        losses.append(b.train_loss())
    assert all(b2 < b1 for b1, b2 in zip(losses, losses[1:]))
    np.testing.assert_allclose(b.predict(x, raw_score=True), b.score.numpy(), rtol=0, atol=1e-5)


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = (
        "import sys, lightgbm_tpu_torch, lightgbm_tpu_torch.convert, chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'lightgbm_tpu' or m.startswith('lightgbm_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert out.stdout.strip() == ""


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _data("regression", n=200)
    params = {"objective": "regression", "num_leaves": 4}
    with pytest.raises(RuntimeError, match="CUDA"):
        lt.train(params, lt.Dataset(x, y, params=params), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        lt.Booster(params, lt.Dataset(x, y, params=params))
    with pytest.raises(RuntimeError, match="CUDA"):
        lt.Booster(params, lt.Dataset(x, y, params=params), device="cuda")
