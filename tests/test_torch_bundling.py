"""Exclusive Feature Bundling in lightgbm_tpu_torch against the JAX package.

The same numpy inputs go through both packages (made from a seed):

* three datasets that bundle: four 12-level one-hot blocks beside three
  normal columns (ROADMAP.md Queue 3, F3), eight 15-level one-hot
  variables (``tests/test_bundling.py``'s ``_onehot_problem``, dense), and
  3% random-sparse columns bundled with ``max_conflict_rate`` 0.1, whose
  planes keep one member on a conflict row;
* the layout, its ``bundle_end`` operand and the packed planes: equal;
* training on seg at K = 1 and K = 4 and on the ordered layout: the trees
  identical (split planes, bins, goes-left tables, default directions,
  children; decoded features, thresholds and decision types), leaves and
  predictions within 1e-5; the int8 path against the JAX kernels in
  interpret mode by structure; the model text, a validation set's record;
* ``best_split`` with ``bundle_end`` against the JAX one: the winner, its
  statistics, its margin and its goes-left table, exactly;
* the partition's and the fused step's table mode: the plain versions
  against the JAX package's kernels (``seg_partition_pallas`` /
  ``_batch`` with ``use_cat=True`` and ``fused_grow_step`` in interpret
  mode, or its XLA oracle), and the CPU models of the tiled kernels
  (``test_torch_partition.model_partition``,
  ``test_torch_grow_step_model.model_grow_step``) against the plain ones;
* the plain walker's tables against the JAX walker, and a JAX bundled model
  carried across by ``convert.booster_from_arrays``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.ops.pallas import grow_step as jax_grow_step
from lightgbm_tpu.ops.pallas.partition import seg_partition_pallas, seg_partition_pallas_batch
from lightgbm_tpu.ops.pallas.seg import pack_rows as jax_pack_rows
from lightgbm_tpu.ops.pallas.seg import padded_rows, unpack_stats
from lightgbm_tpu.ops.split import best_split as jax_best_split
from lightgbm_tpu.predict import predict_bins_leaves as jax_predict_bins_leaves
from lightgbm_tpu.predict import stack_bin_trees as jax_stack_bin_trees

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import bench_partition
from lightgbm_tpu_torch.convert import booster_from_arrays, layout_from_arrays
from lightgbm_tpu_torch.ops import grow_step, seg
from lightgbm_tpu_torch.ops.split import best_split, bundle_table
from lightgbm_tpu_torch.predict import predict_bins_leaves, stack_bin_trees
from lightgbm_tpu_torch.tree import Tree

from .test_bundling import _onehot_problem
from .test_torch_binning import _one_hot_data
from .test_torch_grow_step_model import model_grow_step
from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)
from .test_torch_interpret import int8_on_cpu, jax_interpret
from .test_torch_partition import _assert_same, _clone, _rows, model_partition

BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63, "learning_rate": 0.2}


def _onehot_dense():
    x, y = _onehot_problem(n=2500, nvar=8, ncat=15)
    return np.asarray(x.toarray()), (y > np.median(y)).astype(float)


def _sparse_conflicts(n=2000, f=30, seed=3):
    """3% random-sparse positive columns (a few conflicting rows a pair)
    and two dense normal columns."""
    rng = np.random.default_rng(seed)
    x = np.where(rng.random((n, f)) < 0.03, rng.uniform(0.5, 3.0, (n, f)), 0.0)
    x = np.concatenate([x, rng.normal(size=(n, 2))], axis=1)
    z = x[:, :10].sum(1) - x[:, 10:20].sum(1) + x[:, -1] + 0.3 * rng.normal(size=n)
    return x, (z > 0).astype(float)


DATASETS = {
    "F3": (lambda: _one_hot_data(), {}),
    "one-hot 8 x 15": (_onehot_dense, {}),
    "sparse, conflicts": (_sparse_conflicts, {"max_conflict_rate": 0.1}),
}


def _both(name, extra=None, rounds=4):
    """(x, y, JAX booster, port booster) trained on the same data."""
    make, dparams = DATASETS[name]
    x, y = make()
    params = {**BASE, **dparams, **(extra or {})}
    jp = {**params, "verbosity": -1, "metric": "none"}
    jb = lgb.train(jp, lgb.Dataset(x, y, params=jp), rounds)
    tb = lt.train(params, lt.Dataset(x, y, params=params), rounds, device="cpu")
    return x, y, jb, tb


def _assert_same_trees(jb, tb, leaf_atol=1e-5, structure_only=False):
    assert len(tb.trees) == len(jb._bin_records)
    for jr, jt, tree in zip(jb._bin_records, jb.models_, tb.trees):
        tr = tree.record()
        keys = ("split_feature", "split_bin", "default_left", "left_child", "right_child")
        for k in keys + ("split_is_cat",):
            np.testing.assert_array_equal(tr[k], jr[k], err_msg=k)
        np.testing.assert_array_equal(tr["cat_mask"], np.asarray(jr["cat_mask"])[:, :tr[
            "cat_mask"].shape[1]], err_msg="cat_mask")
        np.testing.assert_array_equal(tree.split_feature_real, jt.split_feature)
        np.testing.assert_array_equal(tree.threshold, jt.threshold)
        np.testing.assert_array_equal(tree.decision_type, jt.decision_type)
        if not structure_only:
            np.testing.assert_allclose(tr["leaf_value"], jr["leaf_value"], rtol=0, atol=leaf_atol)


# ------------------------------------------------------------------- layout
@pytest.mark.parametrize("name", list(DATASETS))
def test_layout_and_packed_planes_equal_jax(name):
    make, dparams = DATASETS[name]
    x, y = make()
    params = {**BASE, **dparams}
    jd = lgb.Dataset(x, y, params={**params, "verbosity": -1}).construct()
    td = lt.Dataset(x, y, params=params).construct()
    jl, tl = jd.bundle_layout, td.bundle_layout
    assert jl is not None and jl.has_bundles and tl.has_bundles
    assert (tl.planes, tl.starts, tl.widths, tl.plane_bins) == (
        jl.planes, jl.starts, jl.widths, jl.plane_bins)
    np.testing.assert_array_equal(tl.bundle_end_array(256), jl.bundle_end_array(256))
    np.testing.assert_array_equal(td.bins, jd.bins)
    np.testing.assert_array_equal(td.num_bins(), jd.plane_num_bins())
    np.testing.assert_array_equal(td.nan_bins(), jd.plane_nan_bins())
    # the device packer (predict's) packs as the host one, conflict rows too
    local = np.stack([td.bin_mappers[j].values_to_bins(x[:, j]) for j in td.used_features], 1)
    packed = tl.pack_tensor(torch.as_tensor(local), td.used_features)
    np.testing.assert_array_equal(packed.numpy(), jd.bins)
    for p in range(tl.num_planes):
        for k, j in enumerate(tl.planes[p]):
            assert tl.feature_position(j) == (p, k)
            if tl.is_bundle(p):
                assert tl.decode(p, tl.starts[p][k]) == jl.decode(p, jl.starts[p][k]) == (j, 0)


def test_conflict_rows_keep_the_highest_member():
    x, _ = _sparse_conflicts()
    td = lt.Dataset(x, np.zeros(len(x)), params={"max_conflict_rate": 0.1}).construct()
    lay = td.bundle_layout
    p = next(p for p in range(lay.num_planes) if lay.is_bundle(p))
    feats = lay.planes[p]
    nz = x[:, feats] != 0
    rows = np.flatnonzero(nz.sum(1) >= 2)
    assert len(rows) > 0  # the data has conflicts in a plane
    for r in rows[:20]:
        k = int(np.flatnonzero(nz[r])[-1])
        j = feats[k]
        local = int(td.bin_mappers[j].values_to_bins(x[r:r + 1, j])[0])
        assert int(td.bins[r, p]) == lay.starts[p][k] + local - 1


# ------------------------------------------------------------------ training
@pytest.mark.parametrize("layout", [{"hist_mode": "seg"}, {"hist_mode": "seg", "leaf_batch": 4},
                                    {"hist_mode": "ordered"}], ids=["seg K=1", "seg K=4",
                                                                    "ordered"])
@pytest.mark.parametrize("name", list(DATASETS))
def test_trees_equal_jax(name, layout):
    x, _, jb, tb = _both(name, layout)
    assert tb.hist_mode == jb._grower_params.hist_mode == layout["hist_mode"]
    assert jb._grower_params.use_bundle and tb.bundle_layout is not None
    _assert_same_trees(jb, tb)
    assert any(t.split_is_cat.any() for t in tb.trees)
    for raw in (True, False):
        np.testing.assert_allclose(tb.predict(x, raw_score=raw), jb.predict(x, raw_score=raw),
                                   rtol=0, atol=1e-5)


def test_two_launch_path_equals_jax():
    x, _, jb, tb = _both("F3", {"hist_mode": "seg", "grow_fused": "off",
                                "fused_split_scan": True})
    _assert_same_trees(jb, tb)


def test_default_params_take_seg_by_planes():
    """No path parameter: 700 one-hot columns bundle into 7 planes, and the
    layout rule, counting planes (the JAX package's budget counts the bin
    matrix's columns, boosting/gbdt.py:1295-1297), picks seg, where 700
    unbundled columns take the ordered layout."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 100, size=(3000, 7))
    x = np.zeros((3000, 700))
    x[np.arange(3000)[:, None], np.arange(7) * 100 + codes] = 1.0
    y = (codes[:, 0] % 3 == 0).astype(float)
    ds = lt.Dataset(x, y, params=BASE).construct()
    b = lt.Booster(BASE, ds, device="cpu")
    assert ds.num_planes == 7 and b.hist_mode == "seg"
    jd = lgb.Dataset(x, y, params={**BASE, "verbosity": -1}).construct()
    assert jd.num_planes == 7 and jd.bundle_layout.planes == ds.bundle_layout.planes
    flat = {**BASE, "enable_bundle": False}
    with pytest.warns(UserWarning, match="ordered"):
        unbundled = lt.Booster(flat, lt.Dataset(x, y, params=flat), device="cpu")
    assert unbundled.hist_mode == "ordered"


def test_int8_training_matches_jax_interpret():
    """The card's default path on the CPU: int8 accumulation with the
    near-tie f32 refine, every leaf decided by best_split with the planes'
    bundle_end, against the JAX kernels in interpret mode (structure, as
    test_torch_train.py compares the int8 path)."""
    x, y = _one_hot_data(n=1500)
    params = {**BASE, "lambda_l2": 0.25}
    jp = {**params, "hist_mode": "seg", "verbosity": -1, "metric": "none"}
    with jax_interpret():
        jb = lgb.train(jp, lgb.Dataset(x, y, params=jp), 3)
    with int8_on_cpu():
        tb = lt.train(params, lt.Dataset(x, y, params=params), 3, device="cpu")
    assert tb._int8_acc and sum(tb.refine_counts) > 0
    _assert_same_trees(jb, tb, structure_only=True)
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), rtol=0, atol=1e-5)


def test_model_text_matches_jax(tmp_path):
    x, _, jb, tb = _both("one-hot 8 x 15")
    text = tb.model_to_string()
    jtext = jb.model_to_string()

    def blocks(s):
        return [Tree.from_string(b) for b in s.partition("end of trees")[0].split("Tree=")[1:]]

    for j, t in zip(blocks(jtext), blocks(text)):
        for k in ("split_feature_real", "threshold", "decision_type", "left_child",
                  "right_child", "leaf_count", "internal_count"):
            np.testing.assert_array_equal(getattr(t, k), getattr(j, k), err_msg=k)
        np.testing.assert_allclose(t.leaf_value, j.leaf_value, rtol=0, atol=1e-5)

    def importances(s):
        return s.split("feature_importances:")[1].split("\n\n")[0]

    assert importances(text) == importances(jtext)
    # the model read back predicts in real space what was trained (no
    # conflict rows in one-hot blocks)
    loaded = lt.Booster(model_str=text, device="cpu")
    np.testing.assert_allclose(loaded.predict(x), tb.predict(x), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lgb.Booster(model_str=text).predict(x), tb.predict(x),
                               rtol=1e-6, atol=1e-6)


def test_loaded_model_differs_only_on_conflict_rows():
    """A model read from text walks real values: a conflict row's plane kept
    one member, so there, and only there, it may differ from the bundled
    bin-space predict."""
    x, _, _, tb = _both("sparse, conflicts", rounds=6)
    lay = tb.bundle_layout
    conflict = np.zeros(len(x), bool)
    for feats in lay.planes:
        if len(feats) > 1:
            conflict |= (x[:, feats] != 0).sum(1) >= 2
    loaded = lt.Booster(model_str=tb.model_to_string(), device="cpu")
    diff = np.abs(loaded.predict(x, raw_score=True) - tb.predict(x, raw_score=True)) > 1e-6
    assert conflict.any() and diff.any()
    assert not (diff & ~conflict).any()


def test_validation_record_matches_jax():
    make, _ = DATASETS["F3"]
    x, y = make()
    xv, yv = _one_hot_data(n=800, seed=5)
    params = {**BASE, "metric": "binary_logloss"}
    jp = {**params, "verbosity": -1}
    jd = lgb.Dataset(x, y, params=jp)
    jrec, trec = {}, {}
    lgb.train(jp, jd, 4, valid_sets=[lgb.Dataset(xv, yv, reference=jd)], valid_names=["v"],
              callbacks=[lgb.record_evaluation(jrec)])
    td = lt.Dataset(x, y, params=params)
    tv = lt.Dataset(xv, yv, reference=td)
    tb = lt.train(params, td, 4, valid_sets=[tv], valid_names=["v"],
                  callbacks=[lt.record_evaluation(trec)], device="cpu")
    assert tv.bundle_layout is td.bundle_layout and tv.bins.shape[1] == td.num_planes
    np.testing.assert_allclose(trec["v"]["binary_logloss"], jrec["v"]["binary_logloss"],
                               rtol=1e-6)
    p = np.clip(tb.predict(xv), 1e-15, 1 - 1e-15)
    loss = -np.mean(yv * np.log(p) + (1 - yv) * np.log(1 - p))
    assert abs(trec["v"]["binary_logloss"][-1] - loss) <= 1e-6 * loss


# -------------------------------------------------------------- best_split
def _bundle_hist(seed, tie=False):
    """[F, B, 3] histograms of 5 columns: two bundle planes (members of 1,
    3 and 2 bins; one member ending at the plane's last bin), a singleton
    with a NaN bin, and two singletons (``tie``: equal to a bundle plane's
    gains through the same histogram)."""
    rng = np.random.default_rng(seed)
    b = 16
    layout = layout_from_arrays(
        planes=[[0, 1, 2], [3], [4, 5], [6], [7]],
        starts=[[1, 2, 5], [0], [1, 9], [0], [0]],
        widths=[[1, 3, 2], [12], [8, 7], [10], [14]],
        plane_bins=[7, 12, 16, 10, 14])
    nb = np.asarray(layout.plane_bins, np.int32)
    nan = np.array([-1, 11, -1, -1, -1], np.int32)
    cnt = rng.integers(0, 40, size=(5, b)).astype(np.float32)
    cnt[np.arange(b)[None, :] >= nb[:, None]] = 0
    g = (rng.normal(size=(5, b)) * cnt).astype(np.float32)
    h = (cnt * rng.uniform(0.2, 0.3, size=(5, b))).astype(np.float32)
    hist = np.stack([g, h, cnt], -1)
    # every plane holds every row once
    tot = hist[0].sum(0)
    for p in range(1, 5):
        hist[p] *= 0
        hist[p, : nb[p]] = hist[0, : nb[0]].sum(0) / nb[p] if tie else 0
    if not tie:
        for p in range(1, 5):
            w = rng.dirichlet(np.ones(nb[p])).astype(np.float32)
            hist[p, : nb[p]] = tot[None, :] * w[:, None]
    else:
        hist[3, : nb[0]] = hist[0, : nb[0]]  # plane 3 reads as plane 0
        hist[3, nb[0]:] = 0
    return hist.astype(np.float32), nb, nan, layout.bundle_end_array(b)


@pytest.mark.parametrize("seed,tie", [(0, False), (1, False), (2, False), (3, True)])
@pytest.mark.parametrize("with_margin", [False, True])
def test_best_split_with_bundle_end_equals_jax(seed, tie, with_margin):
    hist, nb, nan, bend = _bundle_hist(seed, tie)
    tot = hist[0].sum(0)
    kw = dict(lambda_l1=0.0, lambda_l2=0.5, min_data_in_leaf=3, min_sum_hessian_in_leaf=1e-3,
              min_gain_to_split=0.0)
    mask = np.ones(len(nb), bool)
    want = jax_best_split(jnp.asarray(hist), *(jnp.float32(v) for v in tot), jnp.asarray(nb),
                          jnp.asarray(nan), jnp.asarray(mask), bundle_end=jnp.asarray(bend),
                          with_margin=with_margin, **kw)
    got = best_split(torch.as_tensor(hist), *(float(v) for v in tot), torch.as_tensor(nb),
                     torch.as_tensor(nan), torch.as_tensor(mask),
                     bundle_end=torch.as_tensor(bend), with_margin=with_margin, **kw)
    if with_margin:
        (want, wm), (got, gm) = want, got
        assert np.float32(gm) == np.float32(wm)
    assert (got.feature, got.bin, got.default_left) == (
        int(want.feature), int(want.bin), bool(want.default_left))
    for k in ("gain", "left_g", "left_h", "left_cnt", "right_g", "right_h", "right_cnt"):
        assert np.float32(getattr(got, k)) == np.float32(getattr(want, k)), k
    assert (got.table is not None) == bool(want.is_cat)
    if got.table is not None:
        np.testing.assert_array_equal(got.table, np.asarray(want.cat_mask))
        end = int(bend[got.feature, got.bin])
        np.testing.assert_array_equal(got.table, bundle_table(got.bin, end, hist.shape[1]))


# ------------------------------------------------------- partition, table mode
def _jax_rows(rows):
    f, n = rows.f, rows.n
    n_pad = padded_rows(n)
    return jax_pack_rows(jnp.asarray(rows.bins.numpy().T.astype(np.int32)),
                         jnp.asarray(rows.g.numpy()), jnp.asarray(rows.h.numpy()),
                         jnp.asarray(rows.m.numpy()), n_pad), n_pad


def _assert_rows_equal_jax(rows, seg_j):
    b_j, g_j, h_j, m_j, r_j = (np.asarray(a) for a in unpack_stats(seg_j, rows.f, rows.n))
    np.testing.assert_array_equal(rows.bins.numpy().T, b_j)
    for got, want in ((rows.g, g_j), (rows.h, h_j), (rows.m, m_j), (rows.ridx, r_j)):
        np.testing.assert_array_equal(got.numpy(), want)


def _catmask(mem):
    return np.stack([seg.member_table(r) if r[6] else np.zeros(256, bool)
                     for r in mem]).astype(np.float32)


TABLE_MEMBERS = [  # (start, cnt, feat, tbin, dl, nanb, (t, end) or None)
    (13, 700, 2, 11, 0, -1, (5, 9)),
    (713, 0, 5, 3, 0, -1, (1, 3)),
    (1501, 1333, 4, 20, 1, 31, None),
    (2900, 29, 1, 7, 0, -1, (20, 255)),
]


def _table_mem(members):
    cols = np.asarray([m[:6] for m in members]).T
    tables = [None if m[6] is None else bundle_table(m[6][0], m[6][1], 256) for m in members]
    return seg.split_members(*cols, [m[6] is not None for m in members], tables)


def test_partition_table_mode_equals_jax_pallas():
    """One window at a time through seg_partition_pallas, then K = 4 (a
    threshold member and an empty one among them) through
    seg_partition_pallas_batch, use_cat=True in interpret mode."""
    rows, nb = _rows(3_000, 6, 5)
    mem = _table_mem(TABLE_MEMBERS)
    seg_j, n_pad = _jax_rows(rows)
    catm = _catmask(mem)
    seq_j = seg_j
    for r, cm in zip(mem, catm):
        seq_j, _ = seg_partition_pallas(seq_j, jnp.asarray(list(r[:7]) + [0], jnp.int32),
                                        jnp.asarray(cm[None]), f=6, n_pad=n_pad, use_cat=True,
                                        interpret=True)
    scal = jnp.asarray(np.concatenate([mem[:, :7], np.zeros((4, 1), np.int64)], 1), jnp.int32)
    bat_j, nl_j = seg_partition_pallas_batch(seg_j, scal, jnp.asarray(catm), f=6, n_pad=n_pad,
                                             use_cat=True, interpret=True)
    nl = seg.sort_partition_batch_plain(rows, mem)
    np.testing.assert_array_equal(nl.numpy(), np.asarray(nl_j).ravel())
    _assert_rows_equal_jax(rows, bat_j)
    _assert_rows_equal_jax(rows, seq_j)


@pytest.mark.parametrize("case", list(bench_partition.table_edge_cases(24_000, np.full(10, 40)))
                         + ["random ranges"])
@pytest.mark.parametrize("tile", [2048, 128])
def test_partition_model_with_tables_equals_plain(case, tile):
    rows, nb = _rows(24_000, 10, 7)
    if case == "random ranges":
        rng = np.random.default_rng(3)
        mem = _table_mem([(s, 3_000, int(rng.integers(10)), 9, 0, -1, (int(a), int(a) + 7))
                          for s, a in zip(range(17, 24_000, 6_000), rng.integers(1, 30, 4))])
    else:
        mem = bench_partition.table_edge_cases(rows.n, nb)[case]
    want = _clone(rows)
    nl_p = seg.sort_partition_batch_plain(want, mem)
    nl = model_partition(rows, mem, tile, np.random.default_rng(11))
    assert torch.equal(nl, nl_p)
    _assert_same(rows, want)


def test_wrappers_take_tables_on_the_cpu():
    """sort_partition / sort_partition_batch / fused_grow_step with tables:
    the plain versions, as many single calls."""
    rows, _ = _rows(3_000, 6, 2)
    mem = _table_mem(TABLE_MEMBERS)
    want = _clone(rows)
    for r in mem:
        seg.sort_partition(want, *(int(v) for v in r[:6]), seg.member_table(r))
    cols, iscats, tables = seg.member_args(mem)
    a = _clone(rows)
    seg.sort_partition_batch(a, *cols, iscats, tables)
    _assert_same(a, want)
    b = _clone(rows)
    grow_step.fused_grow_step(b, *cols, 64, iscats=iscats, tables=tables)
    _assert_same(b, want)
    with pytest.raises(ValueError, match="table"):
        seg.split_members([0], [10], [0], [1], [0], [-1], [1])


# ------------------------------------------------------ fused step, table mode
@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_fused_grow_step_table_mode_equals_jax(mode):
    """The plain step against the JAX package's: the XLA oracle in f32, the
    Pallas kernel in interpret mode for int8 (its cat_ref table)."""
    from .test_torch_grow_step import _jax_seg, _problem, _scales, _torch_rows

    bins, grad, hess, mask = _problem()
    rows = _torch_rows(bins, grad, hess, mask)
    members = [(37, 1900, 3, 120, 0, -1, (90, 160)), (37 + 1900, 2300, 7, 80, 1, 200, None)]
    mem = _table_mem(members)
    seg_j, n_pad = _jax_seg(bins, grad, hess, mask)
    qs, kw = None, {}
    if mode == "int8":
        qs, sj = _scales(grad, hess, mask)
        kw = dict(quant_scales=(sj[0], sj[1]))
    with jax_interpret(seg=False, grow_step=mode == "int8"):
        want = jax_grow_step.fused_grow_step(
            seg_j, *(jnp.asarray(mem[:, i], jnp.int32) for i in range(7)),
            jnp.asarray(_catmask(mem)), f=11, num_bins=256, n_pad=n_pad, **kw)
    cols, iscats, tables = seg.member_args(mem)
    got = grow_step.fused_grow_step(rows, *cols, 256, quant_scales=qs, iscats=iscats,
                                    tables=tables)
    for i in range(4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i + 1]))
    _assert_rows_equal_jax(rows, want[0])
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[5]))


@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("case", ["table and threshold among K", "cnt 0 among K, table",
                                  "cnt < 32, table"])
def test_grow_step_model_with_tables_equals_plain(case, mode):
    rows, nb = bench_partition.synthetic_rows(24_000, 6, torch.device("cpu"), seed=4)
    mem = bench_partition.table_edge_cases(rows.n, nb)[case]
    scales = None
    if mode == "int8":
        from lightgbm_tpu_torch import bench_grow_step
        scales = bench_grow_step.int8_scales(rows)
    want = _clone(rows)
    dec_p, hist_p = grow_step.fused_grow_step_plain(want, mem, 256, scales)
    dec, hist = model_grow_step(rows, mem, 256, scales, 132, np.random.default_rng(5), tile=128)
    assert torch.equal(dec, dec_p)
    _assert_same(rows, want)
    assert torch.equal(hist[..., 2], hist_p[..., 2])
    if scales is not None:
        assert torch.equal(hist, hist_p)


# ---------------------------------------------------------------- walkers
def test_plain_walker_tables_equal_jax():
    x, _, jb, tb = _both("one-hot 8 x 15")
    bins = jb.train_set.bins.astype(np.int32)
    recs = [t.record() for t in tb.trees]
    got = predict_bins_leaves(stack_bin_trees(recs, tb.nan_bins, "cpu"), torch.as_tensor(bins))
    jbatch = jax_stack_bin_trees(jb._bin_records, 15)
    want = jax_predict_bins_leaves(jbatch, jnp.asarray(bins), jnp.asarray(tb.nan_bins))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_booster_from_jax_arrays_predicts_a_bundled_model():
    x, _, jb, _ = _both("sparse, conflicts")
    jd = jb.train_set
    jl = jd.bundle_layout
    used = jd.used_features
    ms = [jd.bin_mappers[j] for j in used]
    recs = [{**r, "leaf_value": np.asarray(r["leaf_value"], np.float32)}
            for r in jb._bin_records]
    tb = booster_from_arrays(
        recs, [m.bin_upper_bound for m in ms], [m.missing_type for m in ms],
        [m.nan_bin for m in ms], 0.0, "binary", device="cpu", used_features=used,
        bundle_layout=layout_from_arrays(jl.planes, jl.starts, jl.widths, jl.plane_bins))
    np.testing.assert_allclose(tb.predict(x, raw_score=True), jb.predict(x, raw_score=True),
                               rtol=0, atol=1e-5)
