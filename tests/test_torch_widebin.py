"""Bins past a byte (``max_bin`` > 255) in lightgbm_tpu_torch against the
JAX package.

The same numpy inputs, made from a seed, go through both packages:

* the Dataset: bins (u16 past 256 bins), ``num_bins``, ``nan_bins`` and
  ``max_bin_padded`` at ``max_bin`` 300 and 1023, with NaNs and a feature
  of few distinct values; a validation set inherits the width;
* the layout rule (``resolve_hist_mode``) against the JAX package's on a
  grid of (columns, padded width), and the ordered layout taken past 256
  bins (tests/test_torch_ordered_widebin.py holds it to the JAX package);
* the u16 modes' plain versions (two byte planes a feature: the segment
  histogram in f32 and on the int8 grid, the partition with and without a
  goes-left-table member, the fused step) against the JAX package's wide
  kernels (one u16 plane a feature) in interpret mode, or its XLA oracle;
* training on seg at ``max_bin`` 1023: the trees identical (split feature,
  bin, default direction, children) and leaves within 1e-5, at K = 1 and
  K = 4, on the two-launch f32 path and the fused path with the int8
  accumulation (``int8_on_cpu`` against the JAX kernels in interpret
  mode); predictions and the model text equal;
* a one-hot table at ``max_bin`` 1023: bundled as the JAX package bundles
  it (bundle planes of 256 bins beside wide singleton planes) and trained
  to its trees;
* ``scen_widebin`` (the reference's 20,000 x 4 regression at ``max_bin``
  1024): the port reaches the reference's final l2 within the 5% of
  ``tests/test_consistency.py::test_scenario_golden_parity`` and gives
  the JAX package's trees and model text.
"""

import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.ops.pallas import grow_step as jax_grow_step
from lightgbm_tpu.ops.pallas.partition import seg_partition_pallas_batch
from lightgbm_tpu.ops.pallas.seg import pack_rows as jax_pack_rows
from lightgbm_tpu.ops.pallas.seg import padded_rows, seg_hist_pallas_batch, seg_vmem_ok
from lightgbm_tpu.ops.pallas.seg import unpack_stats

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.boosting.gbdt import resolve_hist_mode
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import booster_from_arrays
from lightgbm_tpu_torch.ops import grow_step, seg
from lightgbm_tpu_torch.ops.grower import _sum_bins
from lightgbm_tpu_torch.ops.split import bundle_table, prefix_sum_bins

from .test_torch_binning import _data, _one_hot_data
from .test_torch_grow_step import _scales
from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)
from .test_torch_interpret import int8_on_cpu, jax_interpret

GOLDEN = Path(__file__).parent / "golden"
SLICE = {"hist_mode": "seg", "hist_acc": "bf16", "grow_fused": "off", "fused_split_scan": True}
BASE = {"num_leaves": 15, "max_bin": 1023, "learning_rate": 0.1}


# ------------------------------------------------------------------ dataset
@pytest.mark.parametrize("max_bin", [300, 1023])
def test_bins_equal_jax(max_bin):
    x, y = _data(n=4000)
    params = {"max_bin": max_bin}
    jd = lgb.Dataset(x, y, params={**params, "verbosity": -1}).construct()
    td = lt.Dataset(x, y, params=params).construct()
    assert td.used_features == jd.used_features
    assert td.bins.dtype == jd.bins.dtype == np.uint16
    np.testing.assert_array_equal(td.bins, jd.bins)
    np.testing.assert_array_equal(td.num_bins(), jd.plane_num_bins())
    np.testing.assert_array_equal(td.nan_bins(), jd.plane_nan_bins())
    nb = td.num_bins()
    assert nb.max() > 256 and nb[1] < 40  # a wide feature beside one of few values
    assert td.max_bin_padded == 1 << int(nb.max() - 1).bit_length()
    # a validation set keeps its reference's mappers, and so its width
    vd = lt.Dataset(x[:500], y[:500], reference=td).construct()
    assert vd.bins.dtype == np.uint16
    np.testing.assert_array_equal(vd.bins, td.bins[:500])


def _jax_rule(n_used, b):
    """boosting/gbdt.py:1317-1333 of the JAX package, off its backend check."""
    fcap = 242 if b <= 256 else 121
    return "seg" if (b <= 65536 and seg_vmem_ok(max(n_used, 1), b)
                     and 0 < n_used <= fcap) else "ordered"


@pytest.mark.parametrize("n_used,b", [(121, 512), (122, 512), (242, 256), (243, 256),
                                      (28, 8192), (28, 16384), (1, 1024), (0, 1024)])
def test_layout_rule_equals_jax(n_used, b):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = resolve_hist_mode(n_used, b)
    assert got == _jax_rule(n_used, b)
    text = " ".join(str(w.message) for w in caught)
    assert (got == "ordered" and n_used > 0) == ("segment-resident training is unavailable"
                                                 in text)
    if got == "ordered" and n_used > 0 and b > 256:
        assert "or a smaller max_bin" in text
        assert ("exceeds the budget" in text) == (b > 8192)


def test_wide_config_passes_and_the_ordered_layout_takes_it():
    assert Config.from_params({"max_bin": 1023}).max_bin == 1023
    assert Config.from_params({"max_bin": 300, "hist_mode": "ordered"}).max_bin == 300
    # 122 wide columns: the rule picks 'ordered', on u16 row-major bins
    rng = np.random.default_rng(0)
    x = rng.normal(size=(400, 122))
    ds = lt.Dataset(x, x[:, 0], params={"max_bin": 300})
    with pytest.warns(UserWarning, match="122 used features > 121"):
        tb = lt.Booster({"max_bin": 300}, ds, device="cpu")
    assert tb.hist_mode == "ordered" and tb._bins_nf.dtype == torch.uint16
    assert not tb.update() and tb.trees[0].num_leaves > 1


@pytest.mark.parametrize("b", [512, 2048, 8192])
def test_bin_sums_follow_xla_past_256_bins(b):
    """best_split's prefix sums and the root totals in XLA's CPU orders
    past 256 bins (blocks of 16 bins, the block totals' own prefix sum
    carried; blocks of 32 bins summed, their sums summed so again), bit
    for bit: without them trees of the two packages part on ulp ties."""
    rng = np.random.default_rng(b)
    x = (rng.normal(size=(3, b, 3)) * 10.0 ** rng.uniform(-3, 3, size=(3, b, 3))).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(x))
    np.testing.assert_array_equal(prefix_sum_bins(torch.as_tensor(x)).numpy(), want)
    tot = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=0))(x[0]))
    np.testing.assert_array_equal(_sum_bins(x[0]), tot)


# ------------------------------------------------------------------ kernels
def _wide_problem(n=300, f=3, nb=512, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, nb, size=(n, f)).astype(np.int32)
    bins[rng.random((n, f)) < 0.05] = nb - 1  # the NaN bin, past 255
    grad = rng.normal(size=n).astype(np.float32)
    hess = (rng.random(n) + 0.5).astype(np.float32)
    mask = (rng.random(n) < 0.9).astype(np.float32)
    return bins, grad, hess, mask


def _rows(bins, grad, hess, mask):
    return seg.pack_rows(seg.byte_planes(torch.as_tensor(np.ascontiguousarray(bins.T))),
                         torch.as_tensor(grad), torch.as_tensor(hess), torch.as_tensor(mask),
                         wide=True, used_bins=int(bins.max()) + 1)


def _jax_seg(bins, grad, hess, mask):
    n_pad = padded_rows(bins.shape[0])
    return jax_pack_rows(jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
                         jnp.asarray(mask), n_pad, wide=True), n_pad


def _assert_rows_equal(rows, seg_j, f, n):
    b_j, g_j, h_j, m_j, r_j = (np.asarray(a) for a in unpack_stats(seg_j, f, n, wide=True))
    np.testing.assert_array_equal(seg.feature_bins(rows, slice(0, n)).numpy().T, b_j)
    for got, want in ((rows.g, g_j), (rows.h, h_j), (rows.m, m_j), (rows.ridx, r_j)):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_plain_u16_seg_hist_equals_jax_interpret(mode):
    """K=3 windows (one of one row) at 512 bins: int8 bit for bit, f32
    counts exactly and g/h within 5e-6 relative (the TPU kernel's f32 sums
    go through bf16 digits)."""
    bins, grad, hess, mask = _wide_problem()
    rows = _rows(bins, grad, hess, mask)
    seg_j, n_pad = _jax_seg(bins, grad, hess, mask)
    st, sj = _scales(grad, hess, mask)
    windows = [(0, 300), (37, 200), (299, 1)]
    kw = dict(f=3, num_bins=512, n_pad=n_pad, wide=True, interpret=True)
    with jax_interpret(grow_step=False):
        if mode == "int8":
            want = seg_hist_pallas_batch(seg_j, jnp.asarray(windows, jnp.int32), sj,
                                         quantized=True, **kw)
        else:
            want = seg_hist_pallas_batch(seg_j, jnp.asarray(windows, jnp.int32), **kw)
    want = torch.as_tensor(np.array(want))
    got = seg.seg_hist_batch(rows, windows, 512, st if mode == "int8" else None)
    if mode == "int8":
        assert torch.equal(got, want)
    else:
        assert torch.equal(got[..., 2], want[..., 2])
        assert float((got - want).abs().max() / want.abs().max()) < 5e-6
    assert got[0, :, 256:, 2].sum() > 0  # rows past the byte were counted


@pytest.mark.parametrize("table", [False, True], ids=["thresholds", "with a table member"])
def test_plain_u16_partition_equals_jax_interpret(table):
    """K=3 disjoint windows: thresholds at bins 255 and 256 and a NaN bin
    past 255 sent left, or a goes-left-table member (its bins past 255 go
    right, as the JAX kernel's one-hot of a [256] table sends them)."""
    bins, grad, hess, mask = _wide_problem(seed=1)
    bins[:, 1] = np.where(bins[:, 1] < 256, bins[:, 1] % 40, bins[:, 1])  # a plane of few bins
    rows = _rows(bins, grad, hess, mask)
    seg_j, n_pad = _jax_seg(bins, grad, hess, mask)
    members = [(0, 100, 0, 255, 0, 511), (100, 90, 2, 256, 1, 511), (190, 110, 1, 20, 0, -1)]
    iscat = [0, 0, int(table)]
    tab = bundle_table(5, 30, seg.TABLE_BINS)
    mem = seg.split_members(*np.asarray(members).T, iscat, [None, None, tab if table else None])
    nl = seg.sort_partition_batch_plain(rows, mem)
    catm = np.zeros((3, 256), np.float32)
    catm[2] = tab
    scal = np.concatenate([np.asarray(members), np.asarray(iscat)[:, None],
                           np.zeros((3, 1), np.int64)], 1).astype(np.int32)
    seg_j, nl_j = seg_partition_pallas_batch(seg_j, jnp.asarray(scal), jnp.asarray(catm), f=3,
                                             n_pad=n_pad, use_cat=table, wide=True,
                                             interpret=True)
    np.testing.assert_array_equal(nl.numpy(), np.asarray(nl_j))
    _assert_rows_equal(rows, seg_j, 3, 300)


@pytest.mark.parametrize("mode", ["int8"])
def test_plain_u16_fused_step_equals_jax(mode):
    """K=2 adjacent windows at 512 bins against the JAX package's wide fused
    step kernel in interpret mode, on the int8 grid: rows, dec and the
    histograms bit for bit (its f32 mode is the XLA oracle's, which the
    fused f32 training below holds the port to)."""
    bins, grad, hess, mask = _wide_problem(seed=2)
    rows = _rows(bins, grad, hess, mask)
    seg_j, n_pad = _jax_seg(bins, grad, hess, mask)
    members = [(13, 150, 0, 300, 0, 511), (163, 137, 2, 255, 1, 511)]
    cols = np.asarray(members).T
    st, sj = _scales(grad, hess, mask)
    qs, kw = (st, dict(quant_scales=(sj[0], sj[1]))) if mode == "int8" else (None, {})
    got = grow_step.fused_grow_step(rows, *cols, 512, quant_scales=qs)
    with jax_interpret(seg=False, grow_step=mode == "int8"):
        want = jax_grow_step.fused_grow_step(
            seg_j, *(jnp.asarray(c, jnp.int32) for c in cols), jnp.zeros(2, jnp.int32),
            jnp.zeros((2, 1), jnp.float32), f=3, num_bins=512, n_pad=n_pad, wide=True, **kw)
    for i in range(4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i + 1]))
    _assert_rows_equal(rows, want[0], 3, 300)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[5]))


# ----------------------------------------------------------------- training
def _train_data(n=800, f=5, seed=0):
    """Regression rows with NaNs (tests/test_torch_exp.py trains binary
    trees on them, with y = z > 0)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[rng.random((n, f)) < 0.05] = np.nan
    z = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1])
         - 0.3 * np.nan_to_num(x[:, 2]) ** 2 + rng.normal(size=n))
    return x, z


def _assert_same_trees(jb, tb):
    assert len(tb.trees) == len(jb._bin_records)
    for jr, tree in zip(jb._bin_records, tb.trees):
        tr = tree.record()
        for k in ("split_feature", "split_bin", "default_left", "left_child", "right_child"):
            np.testing.assert_array_equal(tr[k], jr[k], err_msg=k)
        np.testing.assert_allclose(tr["leaf_value"], jr["leaf_value"], rtol=0, atol=1e-5)
    assert max(int(np.max(t.record()["split_bin"], initial=0)) for t in tb.trees) > 255


def _model_text(b):
    return b.model_to_string().split("\nparameters:\n")[0]


@pytest.mark.parametrize("path,k", [("two-launch f32", 4), ("fused f32", 1), ("fused int8", 1)])
def test_training_equals_jax(path, k):
    """Seg at max_bin 1023: the port's rows hold two byte planes a feature,
    every leaf is decided by best_split (as the JAX grower leaves its scan
    kernel above 256 bins); predictions and model text equal.  The fused
    paths run with no path parameter on the port's side (the JAX package's
    CPU default is the ordered layout: it is pinned to 'seg')."""
    x, y = _train_data()
    params = {**BASE, "objective": "regression", "num_leaves": 7, "leaf_batch": k,
              **(SLICE if path == "two-launch f32" else {"hist_mode": "seg"})}
    jp = {**params, "verbosity": -1, "metric": "none"}
    tp = {key: v for key, v in params.items() if path == "two-launch f32" or key != "hist_mode"}
    if path == "fused int8":
        with jax_interpret():
            jb = lgb.train(jp, lgb.Dataset(x, y, params=jp), 2)
        with int8_on_cpu():
            tb = lt.train(tp, lt.Dataset(x, y, params=tp), 2, device="cpu")
        assert tb._int8_acc and sum(tb.refine_counts) > 0
    else:
        jb = lgb.train(jp, lgb.Dataset(x, y, params=jp), 2)
        tb = lt.train(tp, lt.Dataset(x, y, params=tp), 2, device="cpu")
    assert tb.hist_mode == "seg" and tb._max_bin == 1024
    assert tb._grower_params.grow_fused == path.startswith("fused")
    assert tb._grower_params.case_major_ties
    _assert_same_trees(jb, tb)
    with pytest.warns(UserWarning, match="plain walker"):
        np.testing.assert_allclose(tb.predict(x), jb.predict(x), rtol=0, atol=1e-5)
    assert _model_text(tb) == _model_text(jb)
    back = lt.Booster(model_str=tb.model_to_string(), device="cpu")
    np.testing.assert_allclose(back.predict(x), tb.predict(x), rtol=1e-6, atol=1e-7)
    # the JAX booster's records and mappers carried across (u16 bins past 255)
    ms = [jb.train_set.bin_mappers[j] for j in jb.train_set.used_features]
    carried = booster_from_arrays(
        [{**r, "leaf_value": np.asarray(r["leaf_value"], np.float32)} for r in jb._bin_records],
        [m.bin_upper_bound for m in ms], [m.missing_type for m in ms], [m.nan_bin for m in ms],
        0.0, "regression", device="cpu", used_features=jb.train_set.used_features)
    assert carried._max_bin == 1024
    np.testing.assert_allclose(carried.predict(x), jb.predict(x), rtol=0, atol=1e-5)


def test_one_hot_table_bundles_and_trains_like_jax():
    """Four 12-level one-hot blocks beside three dense columns at max_bin
    1023: bundle planes of at most 256 bins beside wide singleton planes,
    every plane stored u16; the same layout, planes and trees."""
    x, y = _one_hot_data(n=1200)
    params = {**BASE, "objective": "binary", "hist_mode": "seg"}
    jp = {**params, "verbosity": -1, "metric": "none"}
    jd = lgb.Dataset(x, y, params=jp).construct()
    td = lt.Dataset(x, y, params=params).construct()
    jl, tl = jd.bundle_layout, td.bundle_layout
    assert tl.has_bundles and (tl.planes, tl.plane_bins) == (jl.planes, jl.plane_bins)
    assert max(tl.plane_bins) > 256 and td.bins.dtype == np.uint16
    np.testing.assert_array_equal(td.bins, jd.bins)
    jb = lgb.train(jp, jd, 2)
    tb = lt.train(params, td, 2, device="cpu")
    for jr, tree in zip(jb._bin_records, tb.trees):
        tr = tree.record()
        for key in ("split_feature", "split_bin", "default_left", "left_child", "right_child",
                    "split_is_cat"):
            np.testing.assert_array_equal(tr[key], jr[key], err_msg=key)
        np.testing.assert_allclose(tr["leaf_value"], jr["leaf_value"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), rtol=0, atol=1e-5)


def test_scen_widebin_reaches_the_reference_and_jax_trees():
    arr = np.loadtxt(GOLDEN / "scen_widebin.train.csv", delimiter=",")
    y, x = arr[:, 0], arr[:, 1:]
    params = json.loads((GOLDEN / "scen_widebin.params.json").read_text())
    rounds = int(params.pop("num_trees"))
    evals = json.loads((GOLDEN / "scen_widebin.evals.json").read_text())
    ref_final = evals["training:l2"][-1][1]
    ds = lt.Dataset(x, y, params=params)
    rec = {}
    tb = lt.train(params, ds, rounds, valid_sets=[ds], valid_names=["training"],
                  callbacks=[lt.record_evaluation(rec)], device="cpu")
    assert tb.hist_mode == "seg" and ds.max_bin_padded == 1024
    assert rec["training"]["l2"][-1] <= ref_final + 0.05 * abs(ref_final)
    jp = {**params, "hist_mode": "seg", "verbosity": -1, "metric": "none"}
    jb = lgb.train(jp, lgb.Dataset(x, y, params=jp), 3)
    tb.trees = tb.trees[:3]
    _assert_same_trees(jb, tb)
    assert _model_text(tb) == _model_text(jb)
