"""lightgbm_tpu_torch frontier-batched growth (``leaf_batch=K``) on the CPU
against the JAX package.

The same bins and gradients, made from a numpy seed, go through both
packages:

* ``sort_partition_batch`` (plain) against the JAX ``sort_partition_batch``
  (ops/segpart.py:228, its XLA path): K=3 unaligned windows, one of them
  empty; the same row order and nl;
* ``split_scan_batch`` and ``fused_best_split_batch`` against M single
  calls: bit-equal rows, identical candidates and margins;
* ``grow_tree`` at K=2 and K=4 against the JAX ``grow_tree`` at the same K
  (f32 sums; the fused grow step and the two-launch path): identical
  structure and ``grow_steps``, leaf values within 1e-5 relative; and the
  port at K=4 structurally identical to the port at K=1 (the prefix-commit
  property);
* exact cross-feature gain ties (duplicated columns): batched == serial;
* the int8 path at K=4 against the JAX grower in interpret mode: identical
  structure and ``refine_count``;
* the Booster's adaptive clamp against the JAX Booster's: per-tree commit
  rates and the sequence of effective K.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.boosting.gbdt import Booster as JaxBooster
from lightgbm_tpu.ops import grower as jax_grower
from lightgbm_tpu.ops.pallas.seg import pack_rows as jax_pack_rows
from lightgbm_tpu.ops.pallas.seg import padded_rows, unpack_stats
from lightgbm_tpu.ops.segpart import sort_partition_batch as jax_sort_partition_batch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import grower, seg, split_scan
from lightgbm_tpu_torch.quantize import hist_acc_scales

from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)
from .test_torch_interpret import int8_on_cpu, jax_interpret

KW = dict(lambda_l1=0.0, lambda_l2=0.5, min_data_in_leaf=5, min_sum_hessian_in_leaf=1e-3)


def _rows(n=3000, f=7, nb=32, seed=3):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, nb, size=(n, f)).astype(np.int32)
    grad = rng.normal(size=n).astype(np.float32)
    hess = (rng.random(n) + 0.5).astype(np.float32)
    mask = (rng.random(n) < 0.9).astype(np.float32)
    return bins, grad, hess, mask


def test_sort_partition_batch_plain_equals_jax():
    n, f = 3000, 7
    bins, grad, hess, mask = _rows(n, f)
    # (start, cnt, feat, tbin, dl, nanb): disjoint, unaligned, one empty;
    # the last sends its NaN bin (31) left
    members = [(13, 700, 2, 11, 0, -1), (713, 0, 5, 3, 0, -1), (1501, 1333, 4, 20, 1, 31)]
    cols = np.asarray(members).T
    rows = seg.pack_rows(
        torch.as_tensor(np.ascontiguousarray(bins.T).astype(np.uint8)),
        torch.as_tensor(grad), torch.as_tensor(hess), torch.as_tensor(mask),
    )
    nl = seg.sort_partition_batch(rows, *cols)

    n_pad = padded_rows(n)
    seg_j = jax_pack_rows(jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
                          jnp.asarray(mask), n_pad)
    jc = [jnp.asarray(c, jnp.int32) for c in cols]
    seg_j, nl_j, nr_j = jax_sort_partition_batch(
        seg_j, *jc, jnp.zeros(3, jnp.int32), jnp.zeros((3, 1), jnp.float32),
        f=f, n_pad=n_pad,
    )
    np.testing.assert_array_equal(nl.numpy(), np.asarray(nl_j))
    assert nl.dtype == torch.int32 and int(nl[1]) == 0
    b_j, g_j, h_j, m_j, r_j = (np.asarray(a) for a in unpack_stats(seg_j, f, n))
    np.testing.assert_array_equal(rows.bins.numpy().T, b_j)
    for got, want in ((rows.g, g_j), (rows.h, h_j), (rows.m, m_j), (rows.ridx, r_j)):
        np.testing.assert_array_equal(got.numpy(), want)
    # equal to K single partitions, in any order
    rows1 = seg.pack_rows(
        torch.as_tensor(np.ascontiguousarray(bins.T).astype(np.uint8)),
        torch.as_tensor(grad), torch.as_tensor(hess), torch.as_tensor(mask),
    )
    for s, c, ft, tb, dl, nb in reversed(members):
        seg.sort_partition(rows1, s, c, ft, tb, bool(dl), nb)
    assert all(torch.equal(getattr(rows, k), getattr(rows1, k))
               for k in ("bins", "g", "h", "m", "ridx"))
    with pytest.raises(ValueError, match="overlap"):
        seg.sort_partition_batch(rows, [0, 10], [20, 5], [0, 0], [1, 1], [0, 0], [-1, -1])


def _hists(m=6, f=6, b=32, seed=0):
    rng = np.random.default_rng(seed)
    hist = np.zeros((m, f, b, 3), np.float32)
    hist[..., 0] = rng.normal(size=(m, f, b))
    hist[..., 1] = rng.random((m, f, b)) + 0.5
    hist[..., 2] = rng.integers(0, 40, size=(m, f, b))
    hist[1] = hist[1, :1]  # every feature alike: an exact tie, margin 0
    hist[2, :, 3:] = 0.0  # few rows: min_data_in_leaf rules most bins out
    parents = hist[:, 0].sum(1)
    nan_bins = np.full(f, -1, np.int32)
    nan_bins[2] = b - 1
    return hist, parents, np.full(f, b, np.int32), nan_bins


def test_split_scan_batch_equals_single_scans():
    hist, parents, num_bins, nan_bins = _hists()
    m, f = hist.shape[:2]
    masks = torch.ones((m, f), dtype=torch.bool)
    masks[3, 1] = False
    args = (torch.as_tensor(num_bins), torch.as_tensor(nan_bins))
    rows = split_scan.split_scan_batch(
        torch.as_tensor(hist), torch.as_tensor(parents), *args, masks, **KW)
    assert rows.shape == (m, f, 8)
    for i in range(m):
        one = split_scan.split_scan(
            torch.as_tensor(hist[i]), torch.as_tensor(parents[i]), *args, masks[i], **KW)
        assert torch.equal(rows[i], one), i
    shared = split_scan.split_scan_batch(
        torch.as_tensor(hist), torch.as_tensor(parents), *args, torch.ones(f, dtype=torch.bool), **KW)
    assert torch.equal(shared[0], rows[0]) and not torch.equal(shared[3], rows[3])


@pytest.mark.parametrize("with_nan", [False, True])
def test_fused_best_split_batch_equals_single_calls(with_nan):
    hist, parents, num_bins, nan_bins = _hists(seed=4)
    if not with_nan:
        nan_bins[:] = -1
    args = (torch.as_tensor(num_bins), torch.as_tensor(nan_bins), torch.ones(6, dtype=torch.bool))
    got = split_scan.fused_best_split_batch(
        torch.as_tensor(hist), parents.tolist(), *args, min_gain_to_split=0.0,
        with_margin=True, **KW)
    plain = split_scan.fused_best_split_batch(
        torch.as_tensor(hist), parents, *args, min_gain_to_split=0.0, **KW)
    for i, (cand, margin) in enumerate(got):
        want, want_margin = split_scan.fused_best_split(
            torch.as_tensor(hist[i]), *map(float, parents[i]), *args,
            min_gain_to_split=0.0, with_margin=True, **KW)
        assert cand == want == plain[i], i
        assert np.float32(margin) == np.float32(want_margin), i
    if not with_nan:
        assert got[1][1] == 0.0  # every feature alike: an exact tie


def _problem(n=2000, f=8, seed=0, dup=False):
    """Binned features with NaNs (a port Dataset) and numpy gradients."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) < 0.05] = np.nan
    if dup:  # exact duplicates give exact cross-feature gain ties
        x[:, 1] = x[:, 0]
        x[:, 3] = x[:, 2]
    ds = lt.Dataset(x, np.zeros(n), params={"max_bin": 63}).construct()
    g = rng.normal(size=n).astype(np.float32) + 0.3 * np.nan_to_num(x[:, 0])
    h = (rng.random(n) + 0.2).astype(np.float32)
    return ds, g, h


def _port_tree(ds, g, h, k, leaves=31, int8=False, **kw):
    n, f = ds.bins.shape
    gt, ht, m = torch.as_tensor(g), torch.as_tensor(h), torch.ones(n)
    params = grower.GrowerParams(num_leaves=leaves, max_bin=ds.max_bin_padded,
                                 leaf_batch=k, **kw)
    return grower.grow_tree(
        torch.as_tensor(np.ascontiguousarray(ds.bins.T)), gt, ht, m,
        torch.as_tensor(ds.num_bins()), torch.as_tensor(ds.nan_bins()),
        torch.ones(f, dtype=torch.bool), params,
        quant_scales=hist_acc_scales(gt, ht, m) if int8 else None,
    )


def _jax_tree(ds, g, h, k, leaves=31, **kw):
    n, f = ds.bins.shape
    params = jax_grower.GrowerParams(num_leaves=leaves, max_bin=ds.max_bin_padded,
                                     hist_mode="seg", leaf_batch=k, **kw)
    return jax_grower.grow_tree(
        jnp.asarray(ds.bins.astype(np.int32)), jnp.asarray(g), jnp.asarray(h),
        jnp.ones(n, jnp.float32), jnp.asarray(ds.num_bins()), jnp.asarray(ds.nan_bins()),
        jnp.ones(f, bool), params,
    )


def _assert_same_structure(a, b):
    """a, b: port TreeArrays or JAX TreeArrays (cut to the used nodes)."""
    na, nb = int(a.num_leaves), int(b.num_leaves)
    assert na == nb
    for name in ("split_feature", "split_bin", "default_left", "left_child", "right_child"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name))[: na - 1],
                                      np.asarray(getattr(b, name))[: nb - 1], err_msg=name)


@pytest.mark.parametrize("k,fused", [(2, True), (4, True), (4, False)],
                         ids=["2-fused", "4-fused", "4-two_launch"])
def test_grow_tree_batched_matches_jax_and_serial(k, fused):
    ds, g, h = _problem(seed=k)
    kw = dict(min_data_in_leaf=10, lambda_l2=0.5, grow_fused=fused)
    tt, lid = _port_tree(ds, g, h, k, **kw)
    jt, jlid = _jax_tree(ds, g, h, k, fused_split_scan=True, **kw)
    _assert_same_structure(tt, jt)
    assert tt.num_leaves == 31 and tt.grow_steps == int(jt.grow_steps)
    assert tt.grow_steps < tt.num_leaves - 1  # some steps committed several splits
    np.testing.assert_allclose(tt.leaf_value, np.asarray(jt.leaf_value)[: tt.num_leaves],
                               rtol=1e-5, atol=0)
    np.testing.assert_array_equal(lid.numpy(), np.asarray(jlid))
    serial, slid = _port_tree(ds, g, h, 1, **kw)
    _assert_same_structure(tt, serial)
    assert serial.grow_steps == serial.num_leaves - 1
    np.testing.assert_array_equal(lid.numpy(), slid.numpy())


def test_batched_tie_gains_match_serial():
    ds, g, h = _problem(seed=6, dup=True)
    kw = dict(min_data_in_leaf=5)
    serial, _ = _port_tree(ds, g, h, 1, **kw)
    used = set(serial.split_feature.tolist())
    assert {0, 2} & used and not {1, 3} & used  # ties went to the lower feature
    for k in (2, 4, 8):
        tt, _ = _port_tree(ds, g, h, k, **kw)
        _assert_same_structure(tt, serial)
        np.testing.assert_array_equal(tt.leaf_value, serial.leaf_value)


def test_batched_stops_early_and_counts_the_last_step():
    """Growth that ends for want of a positive gain: the step that finds
    none counts, as in the JAX while loop."""
    ds, g, h = _problem(n=600, seed=8)
    kw = dict(min_data_in_leaf=60)
    tt, _ = _port_tree(ds, g, h, 4, leaves=31, **kw)
    jt, _ = _jax_tree(ds, g, h, 4, leaves=31, **kw)
    assert 1 < tt.num_leaves < 31
    _assert_same_structure(tt, jt)
    assert tt.grow_steps == int(jt.grow_steps)


def test_int8_batched_matches_jax_interpret():
    ds, g, h = _problem(n=1500, seed=2)
    kw = dict(min_data_in_leaf=10, lambda_l2=0.375)
    with int8_on_cpu():
        tt, _ = _port_tree(ds, g, h, 4, int8=True, **kw)
    with jax_interpret():
        jt, _ = _jax_tree(ds, g, h, 4, grow_fused=True, **kw)
    _assert_same_structure(tt, jt)
    assert tt.grow_steps == int(jt.grow_steps)
    assert tt.refine_count == int(jt.refine_count) > 0
    serial, _ = _port_tree(ds, g, h, 1, int8=True, **kw)
    _assert_same_structure(tt, serial)


def test_booster_commit_rate_clamp_follows_jax(monkeypatch):
    """leaf_batch=8 at 31 leaves: the commit rate falls below 0.625 and K
    halves.  Every tree grows with the same K in both packages, and the
    clamp's state (EMA, cap) is the same after the same trees were noted."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1500, 6))
    y = (x[:, 0] + 0.5 * x[:, 1] + rng.normal(size=1500) > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "min_data_in_leaf": 10, "leaf_batch": 8}
    grown = []
    orig = JaxBooster._grow_one

    def grow_one(self, *args, **kw):
        k = self._grower_params.leaf_batch
        ta, leaf_id = orig(self, *args, **kw)
        grown.append((k, int(ta.grow_steps), int(ta.num_leaves)))
        return ta, leaf_id

    monkeypatch.setattr(JaxBooster, "_grow_one", grow_one)
    jp = {**params, "hist_mode": "seg", "verbosity": -1, "metric": "none"}
    jb = lgb.train(jp, lgb.Dataset(x, y, params=jp), 6)
    tb = lt.train(params, lt.Dataset(x, y, params=params), 6, device="cpu")
    assert tb.leaf_batch_effective == [k for k, _, _ in grown]
    assert tb.grow_steps == [s for _, s, _ in grown]
    assert tb.commit_rates == [(nl - 1) / (s * k) for k, s, nl in grown]
    assert tb.leaf_batch_effective[0] == 8 and tb.leaf_batch_effective[-1] < 4
    # the JAX Booster has noted every tree but its last (reading its trees
    # would note that one too): so has the port
    assert tb.leaf_batch_cap == jb._leaf_batch_cap
    assert tb.commit_rate_ema == jb._commit_rate_ema
    assert tb._grower_params.leaf_batch == jb._grower_params.leaf_batch
    for jr, tree in zip(jb._bin_records, tb.trees):
        tr = tree.record()
        for name in ("split_feature", "split_bin", "default_left", "left_child", "right_child"):
            np.testing.assert_array_equal(tr[name], jr[name], err_msg=name)


def test_booster_leaf_batch_params():
    with pytest.raises(ValueError, match="leaf_batch"):
        lt.Booster({"leaf_batch": 0}, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(400, 4))
    y = x[:, 0] + rng.normal(size=400)
    params = {"objective": "regression", "num_leaves": 4, "leaf_batch": 8,
              "leaf_batch_adaptive": False, "min_data_in_leaf": 5}
    b = lt.train(params, lt.Dataset(x, y, params=params), 3, device="cpu")
    # K never exceeds num_leaves - 1, and without the clamp it never halves
    assert b.leaf_batch_effective == [3, 3, 3] and b.leaf_batch_cap is None
    assert all(0.0 < r <= 1.0 for r in b.commit_rates)
    assert len(b.grow_steps) == len(b.refine_counts) == len(b.trees)
