"""lightgbm_tpu_torch binning, Dataset and Config against the JAX package.

The port keeps its own copy of the numpy binning code; the same inputs must
give the same bin upper bounds, the same bin matrix and the same per-feature
bin counts as the JAX package's Dataset — exactly, since both are the same
f64 arithmetic on the same row sample.
"""

import numpy as np
import pytest

import lightgbm_tpu as lgb
from lightgbm_tpu.binning import BinMapper as JaxBinMapper
from lightgbm_tpu.config import Config as JaxConfig

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.binning import BinMapper
from lightgbm_tpu_torch.config import Config

from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)


def _data(n=3000, f=8, seed=0, nan_frac=0.05):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[:, 1] = np.round(x[:, 1] * 3)  # few distinct values, zeros included
    x[:, 2] = np.abs(x[:, 2])  # positives and zeros only
    x[:, 3] = 7.0  # constant: trivial, dropped from training
    x[rng.random((n, f)) < nan_frac] = np.nan
    y = (np.nan_to_num(x[:, 0]) + rng.normal(size=n) > 0).astype(float)
    return x, y


@pytest.mark.parametrize("max_bin,sample_cnt", [(63, 200000), (255, 1000), (15, 2000)])
def test_dataset_bins_match_jax(max_bin, sample_cnt):
    x, y = _data()
    params = {"max_bin": max_bin, "bin_construct_sample_cnt": sample_cnt}
    jd = lgb.Dataset(x, y, params={**params, "verbosity": -1}).construct()
    td = lt.Dataset(x, y, params=params).construct()
    assert td.used_features == jd.used_features
    for jm, tm in zip(jd.bin_mappers, td.bin_mappers):
        np.testing.assert_array_equal(tm.bin_upper_bound, jm.bin_upper_bound)
        assert (tm.num_bins, tm.nan_bin, tm.missing_type) == (
            jm.num_bins, jm.nan_bin, jm.missing_type
        )
    np.testing.assert_array_equal(td.bins, jd.bins)
    np.testing.assert_array_equal(td.num_bins(), jd.num_bins_per_feature())
    np.testing.assert_array_equal(td.nan_bins(), jd.plane_nan_bins())
    assert td.bins.dtype == np.uint8


def test_values_to_bins_match_jax():
    rng = np.random.default_rng(3)
    sample = np.concatenate([rng.normal(size=500), np.zeros(40), [np.nan] * 10])
    jm = JaxBinMapper.from_sample(sample, 31)
    tm = BinMapper.from_sample(sample, 31)
    probe = np.concatenate([
        rng.normal(size=300) * 2, jm.bin_upper_bound[:-1],
        np.nextafter(jm.bin_upper_bound[:-1], -np.inf), [0.0, -0.0, np.nan, 1e-36],
    ])
    np.testing.assert_array_equal(tm.values_to_bins(probe), jm.values_to_bins(probe))
    for b in range(tm.num_bins):
        assert tm.bin_to_threshold(b) == jm.bin_to_threshold(b)


def test_config_accepts_the_slice_and_aliases():
    cfg = Config.from_params({
        "objective": "binary", "num_leaf": 7, "eta": 0.3, "hist_mode": "seg",
        "grow_fused": "off", "fused_split_scan": True, "hist_acc": "bf16",
        "min_child_samples": 5, "reg_lambda": 1.0,
    })
    assert (cfg.objective, cfg.num_leaves, cfg.learning_rate) == ("binary", 7, 0.3)
    assert (cfg.min_data_in_leaf, cfg.lambda_l2) == (5, 1.0)
    assert not cfg.resolved_grow_fused()
    for params in ({"hist_acc": "int8"}, {"grow_fused": "on"}):
        Config.from_params(params)


def test_config_accepts_the_jax_defaults():
    """No path parameter: the JAX package's defaults (config.py:320-364),
    resolved as its seg path resolves them (gbdt.py:1410-1415)."""
    cfg = Config.from_params({})
    jcfg = JaxConfig.from_params({})
    for name in ("grow_fused", "hist_acc", "fused_split_scan", "hist_near_tie_tol",
                 "leaf_batch", "leaf_batch_adaptive", "leaf_batch_min_commit_rate"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert (cfg.grow_fused, cfg.hist_acc, cfg.fused_split_scan) == ("auto", "auto", False)
    assert cfg.hist_near_tie_tol == 1e-3
    assert cfg.resolved_grow_fused()
    explicit = Config.from_params({"grow_fused": "auto", "hist_acc": "auto",
                                   "hist_near_tie_tol": 0.01})
    assert explicit.hist_near_tie_tol == 0.01


@pytest.mark.parametrize("params,word", [
    ({"extra_trees": True}, "extra_trees"),
    ({"objective": "lambdarank"}, "lambdarank"),
    ({"hist_acc": "fp16"}, "hist_acc"),
    ({"grow_fused": "off", "fused_split_scan": False}, "grow_fused"),
    ({"hist_mode": "gather"}, "hist_mode"),
    ({"leaf_batch": 0}, "leaf_batch"),
    ({"grow_fused": "sometimes"}, "grow_fused"),
    ({"hist_near_tie_tol": -1.0}, "hist_near_tie_tol"),
    ({"leaf_batch_min_commit_rate": 1.5}, "leaf_batch_min_commit_rate"),
])
def test_config_raises_on_what_is_not_ported(params, word):
    with pytest.raises(ValueError, match=word):
        Config.from_params(params)


def test_config_takes_max_bin_past_255_on_the_ordered_layout():
    """max_bin 1000 with hist_mode='ordered' (refused before the ordered
    histograms' u16 mode) passes the config."""
    cfg = Config.from_params({"max_bin": 1000, "hist_mode": "ordered"})
    assert (cfg.max_bin, cfg.hist_mode) == (1000, "ordered")


def _one_hot_data(n=3000, seed=0):
    """Four 12-level one-hot blocks and 3 normal columns (ROADMAP.md Queue
    3, F3): both packages bundle each block's columns into a shared
    plane."""
    rng = np.random.default_rng(seed)
    levels = rng.integers(0, 12, size=(n, 4))
    blocks = [np.eye(12)[levels[:, k]] for k in range(4)]
    x = np.concatenate(blocks + [rng.normal(size=(n, 3))], axis=1)
    z = levels[:, 0] % 3 - 1 + x[:, -1] + 0.5 * rng.normal(size=n)
    return x, (z > 0).astype(float)


BUNDLE_PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63}


@pytest.mark.parametrize("params", [{}, {"enable_bundle": True}, {"bundle": "true"},
                                    {"is_enable_bundle": 1, "max_conflict_rate": 0.1}])
def test_bundle_layout_and_planes_equal_jax(params):
    """With bundling on (by default or by an alias), the port's Dataset
    bundles as the JAX package's: the same layout, the same packed planes
    and per-plane bin counts."""
    x, y = _one_hot_data()
    jp = {**BUNDLE_PARAMS, **params, "verbosity": -1}
    jd = lgb.Dataset(x, y, params=jp).construct()
    td = lt.Dataset(x, y, params={**BUNDLE_PARAMS, **params}).construct()
    jl, tl = jd.bundle_layout, td.bundle_layout
    assert jl is not None and jl.has_bundles and tl is not None
    assert (tl.planes, tl.starts, tl.widths, tl.plane_bins) == (
        jl.planes, jl.starts, jl.widths, jl.plane_bins)
    np.testing.assert_array_equal(td.bins, jd.bins)
    assert td.bins.dtype == np.uint8 and td.num_planes == jd.num_planes
    np.testing.assert_array_equal(td.num_bins(), jd.plane_num_bins())
    np.testing.assert_array_equal(td.nan_bins(), jd.plane_nan_bins())


def test_bundle_search_finds_the_jax_bundles():
    from lightgbm_tpu_torch.bundling import build_layout

    x, y = _one_hot_data()
    jd = lgb.Dataset(x, y, params={**BUNDLE_PARAMS, "verbosity": -1}).construct()
    td = lt.Dataset(x, y, params={**BUNDLE_PARAMS, "enable_bundle": False}).construct()
    assert td.bundle_check_s == 0.0 and td.bundle_layout is None
    got = build_layout(td.used_features, td.bin_mappers,
                       lambda j: np.flatnonzero(x[:, j]), x.shape[0])
    assert got.planes == jd.bundle_layout.planes
    assert [p for p in got.planes if len(p) > 1] == [list(range(12 * k, 12 * k + 12))
                                                      for k in range(4)]


def test_enable_bundle_false_trains_like_jax_unbundled():
    x, y = _one_hot_data()
    params = {**BUNDLE_PARAMS, "enable_bundle": False}
    jp = {**params, "verbosity": -1, "metric": "none"}
    jb = lgb.train(jp, lgb.Dataset(x, y, params=jp), 5)
    assert jb.train_set.bundle_layout is None
    tb = lt.train(params, lt.Dataset(x, y, params=params), 5, device="cpu")
    assert len(tb.trees) == len(jb._bin_records) == 5
    for jr, tree in zip(jb._bin_records, tb.trees):
        tr = tree.record()
        for k in ("split_feature", "split_bin", "default_left", "left_child", "right_child"):
            np.testing.assert_array_equal(tr[k], jr[k], err_msg=k)
        np.testing.assert_allclose(tr["leaf_value"], jr["leaf_value"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), rtol=0, atol=1e-5)


def test_dense_columns_pass_the_bundle_check():
    x, y = _data()
    td = lt.Dataset(x, y, params={"max_bin": 63}).construct()
    assert td.bundle_check_s > 0.0 and td.bundle_layout is None
    assert Config.from_params({"is_enable_bundle": False}).enable_bundle is False
