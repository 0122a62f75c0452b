"""Row and feature sampling in lightgbm_tpu_torch against the JAX package.

The same inputs, made from a numpy seed, go through both packages on the
CPU:

* the sampling strategies (``boosting/sampling.py``) iteration by
  iteration from the same key streams: per-row bagging at ``bagging_freq``
  1 and 3, balanced bagging, GOSS before and after its warm-up, with its
  reweighted gradients; masks and gradients bit-equal;
* the by-tree ``feature_fraction`` masks of the Booster, the by-node masks
  of ``feature_fraction_bynode``, and stochastic ``quantize_gradients``,
  bit-equal;
* the seeds ``seed`` re-derives;
* training: the trees (split feature, bin, default direction, children)
  identical and the leaves within 1e-5 under bagging, GOSS,
  ``feature_fraction``, ``feature_fraction_bynode`` at K = 1 and K = 4,
  stochastic quantized training, and quantized training with by-node masks
  (the order of the quantization's and the tree's keys), on the seg and the
  ordered layouts; the int8 accumulation with a dead feature (the live
  mode) against the JAX kernels in interpret mode;
* the live mode's plain versions (segment histogram f32 and int8, the fused
  step) against the JAX package's ``seg_hist`` with ``live`` in interpret
  mode: the live features' cells equal, the dead ones' 0.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.boosting.sampling import create_sample_strategy as jax_strategy
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.ops.pallas.seg import hist_bpad, hist_group, hist_ngroups
from lightgbm_tpu.ops.pallas.seg import seg_hist_pallas_batch
from lightgbm_tpu.ops.quantize import quantize_gradients as jax_quantize_gradients

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import random as rnd
from lightgbm_tpu_torch.boosting.sampling import create_sample_strategy
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops import grow_step, seg
from lightgbm_tpu_torch.ops.grower import live_features, node_feature_masks
from lightgbm_tpu_torch.quantize import quantize_gradients

from .test_torch_grow_step import _jax_seg, _problem, _scales, _torch_rows
from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)
from .test_torch_interpret import int8_on_cpu, jax_interpret

TREE_KEYS = ("split_feature", "split_bin", "default_left", "left_child", "right_child")


def _data(n=800, f=8, seed=0, binary=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[rng.random((n, f)) < 0.05] = np.nan
    z = np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1]) ** 2 + 0.3 * rng.normal(size=n)
    return x, ((z > 0.4).astype(float) if binary else z)


def _gradients(n, seed=1):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=n).astype(np.float32)
    h = (rng.random(n) * 0.5 + 0.1).astype(np.float32)
    g[:7] = g[7]  # ties at the GOSS threshold's end of the sort
    return g, h


def _u32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


STRATEGIES = {
    "bagging freq 1": {"bagging_fraction": 0.7, "bagging_freq": 1},
    "bagging freq 3": {"bagging_fraction": 0.55, "bagging_freq": 3},
    "balanced": {"objective": "binary", "pos_bagging_fraction": 0.3,
                 "neg_bagging_fraction": 0.8, "bagging_freq": 2},
    "goss": {"boosting": "goss", "top_rate": 0.2, "other_rate": 0.15, "learning_rate": 0.34},
    "goss by data_sample_strategy": {"data_sample_strategy": "goss", "top_rate": 0.1,
                                     "other_rate": 0.3, "learning_rate": 0.5},
}


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_strategy_masks_and_gradients_equal_jax(name):
    params = STRATEGIES[name]
    n = 3001
    g, h = _gradients(n)
    label = (np.random.default_rng(2).random(n) < 0.3).astype(float)
    cfg, jcfg = Config.from_params(params), JaxConfig.from_params(params)
    ours = create_sample_strategy(cfg, n, "cpu", label)
    jis_pos = jnp.asarray(label > 0) if "pos_bagging_fraction" in params else None
    theirs = jax_strategy(jcfg, n, is_pos=jis_pos)
    assert type(ours).__name__ == type(theirs).__name__
    tk, jk = rnd.prng_key(3), jax.random.PRNGKey(3)
    sampled = 0
    for it in range(7):
        tk, tsub = rnd.split(tk)
        jk, jsub = jax.random.split(jk)
        m, gg, hh = ours.sample(it, torch.as_tensor(g), torch.as_tensor(h), tsub)
        jm, jg, jh = theirs.sample(it, jnp.asarray(g)[None], jnp.asarray(h)[None], jsub)
        np.testing.assert_array_equal(_u32(m.numpy()), _u32(jm), err_msg=f"mask {it}")
        np.testing.assert_array_equal(_u32(gg.numpy()), _u32(jg[0]), err_msg=f"grad {it}")
        np.testing.assert_array_equal(_u32(hh.numpy()), _u32(jh[0]), err_msg=f"hess {it}")
        sampled += bool(ours.refreshed and float(m.mean()) < 1.0)
    assert sampled >= 2  # the mask is drawn (GOSS: after its warm-up) and refreshed


def test_goss_keeps_ties_in_the_top_set_and_reweights_the_rest():
    cfg = Config.from_params({"boosting": "goss", "top_rate": 0.1, "other_rate": 0.2,
                              "learning_rate": 1.0})
    n = 1000
    g = np.ones(n, np.float32)
    g[:50] = 5.0  # 50 rows above the rest, 950 tied at the 100th largest
    h = np.ones(n, np.float32)
    m, gg, _ = create_sample_strategy(cfg, n, "cpu").sample(1, torch.as_tensor(g),
                                                             torch.as_tensor(h), rnd.prng_key(0))
    assert bool((m == 1).all()) and torch.equal(gg, torch.as_tensor(g))


def test_feature_fraction_masks_equal_jax():
    x, z = _data(n=400, f=23)
    params = {"objective": "regression", "num_leaves": 7, "feature_fraction": 0.4,
              "feature_fraction_seed": 9, "enable_bundle": False, "verbosity": -1}
    tb = lt.Booster(params, lt.Dataset(x, z, params=params), device="cpu")
    jb = lgb.Booster(params, lgb.Dataset(x, z, params=params))
    for it in range(6):
        tb._iter = it
        np.testing.assert_array_equal(tb._feature_mask_for_iter().numpy(),
                                      jb._feature_mask_np_for(it))
    full = lt.Booster({**params, "feature_fraction": 1.0}, lt.Dataset(x, z, params=params),
                      device="cpu")
    assert bool(full._feature_mask_for_iter().all())


def test_bynode_masks_and_live_features():
    rng = np.random.default_rng(4)
    tree = rng.random(40) < 0.6
    key = rnd.split(rnd.prng_key(11))[0]
    jkey = jax.random.split(jax.random.PRNGKey(11))[0]
    seeds = [0, 1, 2, 9, 10, 2 * 37 + 1]
    got = node_feature_masks(tree, key, seeds, 0.45)
    for i, s in enumerate(seeds):
        want = jnp.asarray(tree) & (jax.random.uniform(jax.random.fold_in(jkey, s), (40,)) < 0.45)
        np.testing.assert_array_equal(got[i], np.asarray(want), err_msg=str(s))
    tree[0] = False
    live = live_features(tree)
    assert live[0] == 0 and list(live[1:]) == list(np.flatnonzero(tree))
    assert live_features(np.ones(5, bool)) is None
    assert list(live_features(np.zeros(3, bool))) == [0]


@pytest.mark.parametrize("constant_hessian", [False, True])
def test_stochastic_quantize_gradients_equals_jax(constant_hessian):
    g, h = _gradients(5000, seed=3)
    if constant_hessian:
        h = np.ones_like(h)
    key, jkey = rnd.prng_key(21), jax.random.PRNGKey(21)
    for bins in (4, 16):
        got = quantize_gradients(torch.as_tensor(g), torch.as_tensor(h), bins,
                                 constant_hessian=constant_hessian, key=key)
        want = jax_quantize_gradients(jnp.asarray(g), jnp.asarray(h), jkey, num_bins=bins,
                                      stochastic=True, constant_hessian=constant_hessian)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_u32(a.numpy()), _u32(b))
    det = quantize_gradients(torch.as_tensor(g), torch.as_tensor(h), 4)
    assert not torch.equal(det[0], got[0]) or bins != 4


def test_seed_rederives_the_sampling_seeds_as_jax():
    for params in ({"seed": 7}, {"random_state": 7, "bagging_seed": 1},
                   {"seed": 3, "feature_fraction_seed": 40, "data_random_seed": 2}):
        cfg, jcfg = Config.from_params(params), JaxConfig.from_params(params)
        for name in ("bagging_seed", "feature_fraction_seed", "data_random_seed"):
            assert getattr(cfg, name) == getattr(jcfg, name), (params, name)
    assert Config.from_params({}).seed is None


@pytest.mark.parametrize("params,word", [
    ({"boosting": "dart"}, "boosting"),
    ({"boosting": "goss", "top_rate": 0.7, "other_rate": 0.5}, "top_rate"),
    ({"bagging_fraction": 0.0}, "bagging_fraction"),
    ({"feature_fraction_bynode": 1.5}, "feature_fraction_bynode"),
    ({"pos_bagging_fraction": 0.5, "bagging_freq": 1}, "binary"),
    ({"data_sample_strategy": "rows"}, "data_sample_strategy"),
])
def test_config_refuses_bad_sampling_values(params, word):
    with pytest.raises(ValueError, match=word):
        Config.from_params(params)


def _same_trees(jb, tb):
    assert len(jb._bin_records) == len(tb.trees)
    for i, (jr, tree) in enumerate(zip(jb._bin_records, tb.trees)):
        tr = tree.record()
        for key in TREE_KEYS:
            np.testing.assert_array_equal(tr[key], jr[key], err_msg=f"tree {i} {key}")
        np.testing.assert_allclose(tr["leaf_value"], jr["leaf_value"], rtol=0, atol=1e-5,
                                   err_msg=f"tree {i}")


def _train_both(params, x, y, rounds):
    jp = {**params, "verbosity": -1, "metric": "none"}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jb = lgb.train(jp, lgb.Dataset(x, y, params=jp), rounds)
        tb = lt.train(params, lt.Dataset(x, y, params=params), rounds, device="cpu")
    return jb, tb


SEG = {"hist_mode": "seg", "hist_acc": "bf16", "grow_fused": "off", "fused_split_scan": True}
QUANT = {"use_quantized_grad": True}
TRAIN_CASES = {
    "seg bagging": (SEG, {"bagging_fraction": 0.6, "bagging_freq": 2, "bagging_seed": 5}),
    "seg goss": (SEG, {"boosting": "goss", "learning_rate": 0.5}),
    "seg feature_fraction": (SEG, {"feature_fraction": 0.5}),
    "seg bynode K=1": (SEG, {"feature_fraction_bynode": 0.5}),
    "seg bynode K=4": (SEG, {"feature_fraction_bynode": 0.5, "leaf_batch": 4}),
    "seg stochastic quantized": (SEG, QUANT),
    "seg quantized bynode": (SEG, {**QUANT, "feature_fraction_bynode": 0.6}),
    "ordered balanced bagging": ({"hist_mode": "ordered", "objective": "binary"},
                                 {"pos_bagging_fraction": 0.5, "neg_bagging_fraction": 0.8,
                                  "bagging_freq": 1, "feature_fraction": 0.7}),
    "ordered goss bynode": ({"hist_mode": "ordered"},
                            {"data_sample_strategy": "goss", "learning_rate": 0.5,
                             "feature_fraction_bynode": 0.5}),
    "ordered stochastic quantized int8": ({"hist_mode": "ordered"},
                                          {**QUANT, "hist_method": "pallas_int8",
                                           "feature_fraction_bynode": 0.6}),
}


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_sampled_training_gives_the_jax_trees(name):
    layout, extra = TRAIN_CASES[name]
    objective = layout.get("objective", "regression")
    x, y = _data(binary=objective == "binary")
    params = {"objective": objective, "num_leaves": 12, "min_data_in_leaf": 10,
              "learning_rate": 0.3, "enable_bundle": False, **layout, **extra}
    jp = dict(params)
    if params.get("hist_method") == "pallas_int8":
        jp["hist_method"] = "pallas_int8_interpret"  # the JAX int8 kernel off the TPU
    jb = lgb.train({**jp, "verbosity": -1, "metric": "none"},
                   lgb.Dataset(x, y, params=jp), 3)
    tb = lt.train(params, lt.Dataset(x, y, params=params), 3, device="cpu")
    _same_trees(jb, tb)
    assert tb.hist_mode == params["hist_mode"]
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), rtol=0, atol=1e-5)


@pytest.mark.parametrize("extra", [
    {"feature_fraction": 0.5, "bagging_fraction": 0.7, "bagging_freq": 1},
    {**QUANT, "hist_method": "pallas_int8", "feature_fraction": 0.5},
], ids=["int8 accumulation", "quantized int8"])
def test_live_mode_training_on_the_int8_paths_gives_the_jax_trees(extra):
    """The default seg path (fused step, int8 accumulation with the near-tie
    refine) and quantized training on the seg int8 mode, with half the
    features dead, against the JAX kernels in interpret mode (which skip
    dead plane groups; the port skips dead features)."""
    x, y = _data(n=1000, f=10, seed=3)
    params = {"objective": "regression", "num_leaves": 12, "min_data_in_leaf": 10,
              "learning_rate": 0.3, "hist_mode": "seg", "enable_bundle": False, **extra}
    from lightgbm_tpu_torch import _build  # noqa: F401 (the CPU launches nothing)

    with jax_interpret(), int8_on_cpu():
        jb, tb = _train_both(params, x, y, 3)
    _same_trees(jb, tb)
    if "use_quantized_grad" in extra:
        assert tb.refine_counts == [0, 0, 0]
    else:
        assert sum(tb.refine_counts) > 0


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_live_plain_versions_match_jax_seg_hist_with_live(mode):
    """The JAX kernel zeroes whole plane groups of ``hist_group`` features;
    the port zeroes each dead feature.  With a dead group and a dead
    feature in a live group, the live features' cells agree (int8 bit for
    bit, f32 counts exactly and g/h within the interpreter's bf16 digits)
    and each dead feature is 0 in the port; the live cells are the all-live
    call's, and the fused step's likewise."""
    n, f, b = 700, 24, 256
    bins, grad, hess, mask = _problem(n=n, f=f, nb=b, seed=8)
    gb, ng = hist_group(f, hist_bpad(b)), hist_ngroups(f, hist_bpad(b))
    assert ng >= 3
    fmask = np.ones(f, bool)
    fmask[gb:2 * gb] = False  # the second group dead
    fmask[2 * gb + 1] = False  # a dead feature in a live group
    groups = np.pad(fmask, (0, ng * gb - f)).reshape(ng, gb).any(axis=1)
    groups[0] = True
    live = live_features(fmask)
    dead = np.setdiff1d(np.arange(f), live)
    rows = _torch_rows(bins, grad, hess, mask)
    seg_j, n_pad = _jax_seg(bins, grad, hess, mask)
    wins = [(0, n), (101, 333), (500, 0)]
    st, sj = _scales(grad, hess, mask)
    q = st if mode == "int8" else None
    got = seg.seg_hist_batch(rows, wins, b, q, live=live).numpy()
    kw = dict(f=f, num_bins=b, n_pad=n_pad, interpret=True)
    with jax_interpret(grow_step=False):
        want = np.asarray(seg_hist_pallas_batch(
            seg_j, jnp.asarray(wins, jnp.int32), sj if mode == "int8" else None,
            jnp.asarray(groups.astype(np.int32)), quantized=mode == "int8", **kw))
    assert not got[:, dead].any() and not want[:, gb:2 * gb].any()
    np.testing.assert_array_equal(got[:, live, :, 2], want[:, live, :, 2])
    if mode == "int8":
        np.testing.assert_array_equal(got[:, live], want[:, live])
    else:
        scale = float(np.abs(want[..., :2]).max())
        assert float(np.abs(got[:, live] - want[:, live]).max()) <= 5e-6 * scale
    full = seg.seg_hist_batch(rows, wins, b, q).numpy()
    np.testing.assert_array_equal(got[:, live], full[:, live])
    mem = seg.split_members([0, 400], [400, 300], [1, 3], [100, 20], [0, 1], [-1, -1])
    r1, r2 = _torch_rows(bins, grad, hess, mask), _torch_rows(bins, grad, hess, mask)
    d1, h1 = grow_step.fused_grow_step_plain(r1, mem, b, q, live)
    d2, h2 = grow_step.fused_grow_step_plain(r2, mem, b, q)
    assert torch.equal(d1, d2) and torch.equal(r1.bins, r2.bins)
    assert torch.equal(h1[:, live], h2[:, live]) and not h1[:, dead].any()
