"""Categorical features in the port against the JAX package, on the CPU.

* the categorical ``BinMapper`` (lightgbm_tpu/binning.py:380-433): the
  count order, the 99% and ``max_bin`` cuts, NaN, negative values, fractions
  and unseen categories;
* ``best_split`` with ``is_cat`` (ops/split.py:270-343, :440-456) bit for
  bit on random histograms: one-hot, forward and backward sorted subsets,
  ``max_cat_threshold`` binding, ``min_data_per_group`` 1 and 50,
  ``with_margin``, at 16, 256 and 1,024 bins;
* trees equal to the JAX package's, leaves within 1e-5, on mixed numeric
  and categorical data: seg and ordered, K = 1 and 4, int8 with the
  refine, and max_bin 1023 with a 300-level column (tables past 256 bins);
* predict equal to the JAX Booster's on rows with unseen categories, NaN,
  negative and fractional values; model text both ways;
* the plain categorical walk (decoded walk tables) against the JAX
  package's forest walk in interpret mode; ``convert.booster_from_arrays``
  on a categorical JAX booster;
* EFB never bundles a categorical column, as the JAX package.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.binning import BinMapper as JaxBinMapper
from lightgbm_tpu.ops.pallas.forest_walk import build_tables as jax_build_tables
from lightgbm_tpu.ops.pallas.forest_walk import forest_walk as jax_forest_walk
from lightgbm_tpu.ops.pallas.forest_walk import pad_bins_for_walk, unpack_walk_scores
from lightgbm_tpu.ops.split import CatParams as JaxCatParams
from lightgbm_tpu.ops.split import best_split as jax_best_split

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.binning import BinMapper, categorical_bins
from lightgbm_tpu_torch.convert import booster_from_arrays
from lightgbm_tpu_torch.ops import forest_walk as fw
from lightgbm_tpu_torch.ops import seg
from lightgbm_tpu_torch.ops.split import CatParams, best_split, best_split_batch
from lightgbm_tpu_torch.predict import predict_bins_raw, stack_bin_trees

from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)
from .test_torch_interpret import int8_on_cpu, jax_interpret


# ---------------------------------------------------------------- binning
def _cat_column(case, rng):
    n = 3000
    if case == "many":  # more categories than max_bin, the cut at max_bin
        return rng.integers(0, 90, n).astype(float), 40
    if case == "cut99":  # a long thin tail past the 99% cut
        v = np.where(rng.random(n) < 0.985, rng.integers(0, 5, n), rng.integers(5, 400, n))
        return v.astype(float), 255
    if case == "nan":
        v = rng.integers(0, 12, n).astype(float)
        v[rng.random(n) < 0.1] = np.nan
        return v, 255
    return rng.integers(0, 30, n) + rng.random(n) * 0.9, 255  # fractions truncate


@pytest.mark.parametrize("case", ["many", "cut99", "nan", "fractions"])
def test_categorical_bin_mapper_equals_jax(case):
    rng = np.random.default_rng(3)
    v, max_bin = _cat_column(case, rng)
    j = JaxBinMapper.from_sample(v, max_bin, is_categorical=True)
    t = BinMapper.from_sample(v, max_bin, is_categorical=True)
    assert t.is_categorical and t.num_bins == j.num_bins and t.nan_bin == j.nan_bin
    assert t.missing_type == j.missing_type
    np.testing.assert_array_equal(t.bin_to_cat, j.bin_to_cat)
    assert t.cat_to_bin == j.cat_to_bin and t.feature_info_str() == j.feature_info_str()
    # training-time binning: unseen categories (and negatives) at bin 0
    probe = np.concatenate([v[:200], [np.nan, -3.0, 1e6, 2.5, 7.99]])
    np.testing.assert_array_equal(t.values_to_bins(probe), j.values_to_bins(probe))


def test_categorical_bin_mapper_refuses_negative_values():
    with pytest.raises(ValueError, match="non-negative"):
        BinMapper.from_sample(np.array([0.0, 3.0, -1.0]), 255, is_categorical=True)


def test_categorical_bins_send_unseen_values_to_the_sentinel():
    m = BinMapper.from_sample(np.array([0, 1, 1, 2, 2, 2, 5], float), 255, is_categorical=True)
    got = categorical_bins(m, np.array([2, 1, 0, 5, 3, -1, np.nan, 1.7, 9]), 255)
    np.testing.assert_array_equal(got, [0, 1, 2, 3, 255, 255, 255, 1, 255])


# ----------------------------------------------------------- split search
def _hist(rng, f, b, nb):
    hist = np.zeros((f, b, 3), np.float32)
    for j in range(f):
        c = rng.integers(0, 60, nb[j]).astype(np.float32)
        c[rng.random(nb[j]) < 0.1] = 0
        hist[j, : nb[j], 2] = c
        hist[j, : nb[j], 0] = (rng.normal(size=nb[j]) * c).astype(np.float32)
        hist[j, : nb[j], 1] = (rng.random(nb[j]) * c + 0.01 * c).astype(np.float32)
    return hist


SPLIT_CASES = {
    # name: (bins, [num_bins], CatParams keys)
    "16 one-hot and subsets": (16, [4, 16, 11, 9], {"min_data_per_group": 1, "cat_smooth": 2.0}),
    "256 max_cat_threshold 3": (256, [255, 120, 3, 60], {"max_cat_threshold": 3}),
    "1024 min_data_per_group 50": (1024, [1000, 600, 300], {"min_data_per_group": 50,
                                                            "cat_smooth": 5.0}),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_categorical_best_split_equals_jax_bit_for_bit(case):
    b, nb, keys = SPLIT_CASES[case]
    f = len(nb)
    rng = np.random.default_rng(len(case))
    for trial in range(3):
        hist = _hist(rng, f, b, nb)
        nan_bins = np.array([nb[j] - 1 if (j + trial) % 2 else -1 for j in range(f)], np.int32)
        is_cat = np.array([j != 1 or trial == 2 for j in range(f)])
        mask = np.ones(f, bool)
        tot = hist[0].sum(0)
        kw = dict(lambda_l1=0.0, lambda_l2=1.0, min_data_in_leaf=5,
                  min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0)
        # jitted as the JAX grower runs it (one compile a case, not one a primitive)
        jc, jm = jax.jit(functools.partial(jax_best_split, cat_params=JaxCatParams(**keys),
                                           with_margin=True, **kw))(
            jnp.asarray(hist), tot[0], tot[1], tot[2], jnp.asarray(nb, jnp.int32),
            jnp.asarray(nan_bins), jnp.asarray(mask), is_cat=jnp.asarray(is_cat))
        tc, tm = best_split(torch.as_tensor(hist), *map(float, tot),
                            torch.as_tensor(nb, dtype=torch.int32), torch.as_tensor(nan_bins),
                            torch.as_tensor(mask), is_cat=torch.as_tensor(is_cat),
                            cat_params=CatParams(**keys), with_margin=True, **kw)
        assert (tc.feature, tc.bin, tc.default_left, tc.is_cat) == (
            int(jc.feature), int(jc.bin), bool(jc.default_left), bool(jc.is_cat))
        for k in ("gain", "left_g", "left_h", "left_cnt", "right_g", "right_h", "right_cnt"):
            assert np.float32(getattr(tc, k)) == np.float32(getattr(jc, k)), k
        assert np.float32(tm) == np.float32(jm)
        if tc.is_cat:
            np.testing.assert_array_equal(tc.table, np.asarray(jc.cat_mask))


def test_categorical_best_split_batch_members_equal_single_calls():
    rng = np.random.default_rng(5)
    nb = [40, 7, 100]
    hists = np.stack([_hist(rng, 3, 128, nb) for _ in range(3)])
    args = (torch.as_tensor(nb, dtype=torch.int32), torch.full((3,), -1, dtype=torch.int32),
            torch.ones(3, dtype=torch.bool))
    kw = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=3, min_sum_hessian_in_leaf=1e-3,
              min_gain_to_split=0.0, is_cat=torch.tensor([True, True, False]),
              cat_params=CatParams(min_data_per_group=1))
    parents = [tuple(map(float, h[0].sum(0))) for h in hists]
    batch = best_split_batch(torch.as_tensor(hists), parents, *args, **kw)
    for h, p, c in zip(hists, parents, batch):
        one = best_split(torch.as_tensor(h), *p, *args, **kw)
        assert one[:10] == c[:10] and one.is_cat == c.is_cat
        assert (one.table is None) == (c.table is None)


# ------------------------------------------------------------------ trees
def _mixed(n=1500, seed=1, wide_levels=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 5))
    x[:, 1] = rng.integers(0, 12, n)
    x[:, 3] = (rng.zipf(1.3, n) % 40) if not wide_levels else rng.integers(0, wide_levels, n)
    x[rng.random(n) < 0.05, 3] = np.nan
    x[rng.random(n) < 0.05, 0] = np.nan
    y = (np.nan_to_num(x[:, 0]) + np.isin(x[:, 1], [1, 4, 7]) * 2 + (x[:, 3] % 3 == 0)
         + rng.normal(size=n) * 0.3)
    return x, y


BASE = {"objective": "regression", "num_leaves": 15, "verbosity": -1, "min_data_per_group": 5,
        "cat_smooth": 2.0, "learning_rate": 0.2, "metric": "none"}
TREE_CASES = {
    "seg K=4": {"hist_mode": "seg", "leaf_batch": 4},
    "ordered": {"hist_mode": "ordered"},
    "ordered K=4": {"hist_mode": "ordered", "leaf_batch": 4, "objective": "binary"},
    "seg max_bin 1023": {"hist_mode": "seg", "max_bin": 1023, "num_leaves": 31},
}


def _same_trees(jb, tb):
    assert len(jb._bin_records) == len(tb.trees)
    for i, (jr, tree) in enumerate(zip(jb._bin_records, tb.trees)):
        tr = tree.record()
        for key in ("split_feature", "split_bin", "default_left", "left_child", "right_child"):
            np.testing.assert_array_equal(tr[key], jr[key], err_msg=f"tree {i} {key}")
        np.testing.assert_allclose(tr["leaf_value"], jr["leaf_value"], rtol=0, atol=1e-5)
        cat = np.asarray(jr["split_is_cat"], bool)
        np.testing.assert_array_equal(tr["split_is_cat"], cat)
        np.testing.assert_array_equal(tr["cat_mask"][cat], np.asarray(jr["cat_mask"])[cat])


@pytest.mark.parametrize("case", list(TREE_CASES))
def test_categorical_trees_equal_jax(case):
    params = {**BASE, **TREE_CASES[case]}
    wide = params.get("max_bin", 255) > 255
    x, y = _mixed(wide_levels=300 if wide else 0)
    if params["objective"] == "binary":
        y = (y > np.median(y)).astype(float)
    tb = lt.train(params, lt.Dataset(x, y, categorical_feature=[1, 3]), 3, device="cpu")
    jb = lgb.train(params, lgb.Dataset(x, y, categorical_feature=[1, 3]), 3)
    assert tb.hist_mode == params["hist_mode"]
    assert sum(t.num_cat for t in tb.trees) > 0
    _same_trees(jb, tb)
    if wide:  # tables past 256 bins went to the partition
        assert tb._max_bin == 1024 and int(tb.train_set.num_bins().max()) > 256
        assert any(t.cat_mask[:, 256:].any() for t in tb.trees)


def test_categorical_int8_trees_equal_jax():
    params = {**BASE, "hist_mode": "seg"}
    x, y = _mixed(n=1000, seed=4)
    with int8_on_cpu(), jax_interpret():
        tb = lt.train(params, lt.Dataset(x, y, categorical_feature=[1, 3]), 2, device="cpu")
        jb = lgb.train(params, lgb.Dataset(x, y, categorical_feature=[1, 3]), 2)
    assert sum(tb.refine_counts) >= 0 and sum(t.num_cat for t in tb.trees) > 0
    _same_trees(jb, tb)


@pytest.fixture(scope="module")
def pair():
    """A categorical model trained by both packages (names given through the
    ``categorical_feature`` param: a comma string with a column name)."""
    x, y = _mixed()
    params = {**BASE, "hist_mode": "seg", "categorical_feature": "1,Column_3"}
    tb = lt.train(params, lt.Dataset(x, y), 3, device="cpu")
    jb = lgb.train(params, lgb.Dataset(x, y, categorical_feature=[1, 3]), 3)
    probe = x[:400].copy()
    probe[:40, 1] = 99  # unseen
    probe[40:80, 3] = -2  # negative
    probe[80:120, 1] = 3.7  # fraction
    probe[120:160, 1] = np.nan  # NaN without a NaN bin
    probe[160:200, 3] = np.nan
    return tb, jb, probe


def test_categorical_seg_trees_equal_jax(pair):
    tb, jb, _ = pair
    assert tb.hist_mode == "seg" and sum(t.num_cat for t in tb.trees) > 0
    _same_trees(jb, tb)


def test_categorical_predict_equals_jax(pair):
    tb, jb, probe = pair
    assert [m.is_categorical for m in tb.bin_mappers] == [False, True, False, True, False]
    np.testing.assert_allclose(tb.predict(probe), jb.predict(probe), rtol=0, atol=1e-6)


def test_categorical_model_text_both_ways(pair):
    tb, jb, probe = pair
    text = tb.model_to_string()
    assert "num_cat=" in text and "cat_threshold=" in text and "cat_boundaries=" in text
    back = lt.Booster(model_str=text, device="cpu")
    assert back.model_to_string() == text  # written, read and written again
    np.testing.assert_allclose(back.predict(probe), tb.predict(probe), rtol=0, atol=1e-6)
    np.testing.assert_allclose(lgb.Booster(model_str=text).predict(probe), tb.predict(probe),
                               rtol=0, atol=1e-6)
    from_jax = lt.Booster(model_str=jb.model_to_string(), device="cpu")
    np.testing.assert_allclose(from_jax.predict(probe), jb.predict(probe), rtol=0, atol=1e-6)
    # the tree blocks: categorical nodes, bitsets and their bounds as the JAX package's
    jtrees = [blk for blk in jb.model_to_string().split("Tree=")[1:]]
    ttrees = [blk for blk in text.split("Tree=")[1:]]
    for jblk, tblk in zip(jtrees, ttrees):
        for key in ("num_cat=", "cat_boundaries=", "cat_threshold=", "decision_type=",
                    "split_feature="):
            jl = [ln for ln in jblk.splitlines() if ln.startswith(key)]
            tl = [ln for ln in tblk.splitlines() if ln.startswith(key)]
            assert jl == tl, key


def test_categorical_walk_equals_pallas_interpret(pair):
    tb, jb, probe = pair
    recs = [t.record() for t in tb.trees]
    assert fw.walk_reject_reason(recs, tb.nan_bins, 4, tb._max_bin) is None
    tables = fw.build_tables(recs, tb.nan_bins, "cpu")
    assert tables.m_cat > 0
    bins = tb._bin_type(tb._bin_host(probe))
    got = fw.forest_walk(bins, tables, 1)
    # the decoded tables walk as the records do
    want = predict_bins_raw(stack_bin_trees(recs, tb.nan_bins, "cpu"), bins, 1)
    assert torch.equal(got, want)
    jrecs = jb._bin_records
    jt = jax_build_tables(jrecs, np.asarray(jb._nan_bins))
    mat = jb._bin_input_host(probe)
    out = jax_forest_walk(pad_bins_for_walk(mat), jt, n_trees=jt.n_trees,
                          max_depth=jt.max_depth, k=1, interpret=True)
    jax_raw = unpack_walk_scores(np.asarray(out), probe.shape[0], 1)
    np.testing.assert_array_equal(got.numpy(), jax_raw)


def test_walk_rejects_the_sentinel_and_wide_masks():
    rec = {"split_feature": np.array([0]), "split_bin": np.array([0]),
           "default_left": np.array([False]), "left_child": np.array([-1]),
           "right_child": np.array([-2]), "leaf_value": np.zeros(2, np.float32),
           "split_is_cat": np.array([True]), "cat_mask": np.zeros((1, 256), bool)}
    nanb = np.array([-1])
    assert fw.walk_reject_reason([rec], nanb, 1, 256) is None
    rec["cat_mask"][0, 255] = True
    assert "sentinel" in fw.walk_reject_reason([rec], nanb, 1, 256)
    rec["cat_mask"] = np.zeros((1, 512), bool)
    assert "wider than 256" in fw.walk_reject_reason([rec], nanb, 1, 256)


def test_category_at_bin_255_sends_unseen_values_right_like_jax():
    """max_bin 256, a 400-level column with no NaN: 256 categories are kept,
    bin 255 is a real one and a mask claims it, so the plain walker takes
    the model, and an unseen, negative or NaN value still goes right."""
    rng = np.random.default_rng(11)
    n = 1500
    x = rng.normal(size=(n, 5))
    x[:, 1] = rng.integers(0, 400, n)
    params = {**BASE, "hist_mode": "seg", "max_bin": 256}
    mapper = lt.Dataset(x, np.zeros(n), params=params, categorical_feature=[1]).construct()
    top = mapper.bin_mappers[1].bin_to_cat
    assert len(top) == 256 and mapper.bin_mappers[1].nan_bin < 0
    y = np.isin(x[:, 1], top[224:]) * 3.0 + x[:, 0] * 0.1 + rng.normal(size=n) * 0.1
    tb = lt.train(params, lt.Dataset(x, y, categorical_feature=[1]), 3, device="cpu")
    jb = lgb.train(params, lgb.Dataset(x, y, categorical_feature=[1]), 3)
    _same_trees(jb, tb)
    recs = [t.record() for t in tb.trees]
    assert "sentinel" in fw.walk_reject_reason(recs, tb.nan_bins, 5, tb._max_bin)
    probe = x[:200].copy()
    probe[:50, 1] = 1000  # unseen
    probe[50:100, 1] = -3
    probe[100:150, 1] = np.nan
    probe[150:, 1] = top[255]  # the category at bin 255 goes left
    np.testing.assert_allclose(tb.predict(probe), jb.predict(probe), rtol=0, atol=1e-6)
    assert len(np.unique(tb.predict(probe[:150]))) < len(np.unique(tb.predict(probe)))


def test_converted_categorical_booster_predicts_like_jax(pair):
    _, jb, probe = pair
    ds = jb.train_set
    used = list(ds.used_features)
    ms = [ds.bin_mappers[j] for j in used]
    tb = booster_from_arrays(
        [dict(r) for r in jb._bin_records], [m.bin_upper_bound for m in ms],
        [m.missing_type for m in ms], [m.nan_bin for m in ms], 0.0, "regression",
        device="cpu", used_features=used,
        bin_to_cats=[m.bin_to_cat if m.is_categorical else None for m in ms])
    np.testing.assert_allclose(tb.predict(probe), jb.predict(probe), rtol=0, atol=1e-6)


# -------------------------------------------------------- wide tables, EFB
def test_wide_table_members_partition_like_go_left():
    """Member rows past 256 bins carry every table's words; the plain
    partition reads them whole, a bin past a table going right."""
    rng = np.random.default_rng(2)
    n, b = 600, 1024
    bins = torch.as_tensor(rng.integers(0, 300, (2, n)), dtype=torch.int64)
    rows = seg.pack_rows(seg.byte_planes(bins), torch.randn(n), torch.rand(n), torch.ones(n),
                         wide=True, used_bins=300)
    table = (np.arange(b) % 5 == 0) & (np.arange(b) < 300)
    mem = seg.split_members([0, 300], [300, 300], [1, 0], [0, 0], [0, 0], [-1, -1], [1, 0],
                            [table, None])
    assert mem.shape == (2, 7 + b // 32) and seg.wide_words(mem).shape == (2, 32)
    np.testing.assert_array_equal(seg.member_table(mem[0])[:b], table)
    want = seg.go_left(bins[1, :300], 0, False, -1, table)
    nl = seg.sort_partition_batch_plain(rows, mem)
    assert int(nl[0]) == int(want.sum())
    narrow = seg.split_members([0], [300], [1], [0], [0], [-1], [1], [table[:256]])
    assert narrow.shape[1] == seg.MEMBER_COLS and seg.wide_words(narrow) is None


def test_categorical_column_never_bundles_like_jax():
    rng = np.random.default_rng(9)
    n = 2000
    x = np.zeros((n, 8))
    hot = rng.integers(0, 6, n)
    x[np.arange(n), hot] = 1.0  # six exclusive one-hot columns
    x[:, 6] = np.where(rng.random(n) < 0.9, 0, rng.integers(1, 5, n))  # sparse categorical
    x[:, 7] = rng.normal(size=n)
    y = hot * 0.5 + x[:, 6] + rng.normal(size=n)
    params = {"verbosity": -1, "categorical_feature": [6]}
    td = lt.Dataset(x, y, params=params).construct()
    jd = lgb.Dataset(x, y, params=params).construct()
    assert td.bundle_layout is not None
    assert td.bundle_layout.planes == [list(p) for p in jd.bundle_layout.planes]
    assert [6] in td.bundle_layout.planes
    np.testing.assert_array_equal(td.plane_is_cat(), jd.plane_is_cat())
