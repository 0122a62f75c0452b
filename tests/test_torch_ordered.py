"""lightgbm_tpu_torch's ordered layout (``hist_mode='ordered'``) on the CPU
against the JAX package.

The same inputs, made from a numpy seed, go through both packages:

* ``ordered_hist``'s plain version against ``leaf_histogram_segment`` on the
  gathered rows (identical: both add each cell's rows in row order), and
  against the TPU kernel ``histogram_pallas`` in interpret mode (within
  4e-3 of the scale: the interpreter's dot runs at bf16 precision, as
  tests/test_histogram_pallas.py notes; counts exact);
* ``ordered_hist_int8``'s plain version against ``histogram_pallas_int8`` in
  interpret mode: exactly equal (integer digit sums, the same recombine);
* ``quantize_gradients`` (deterministic) against the JAX function: bit for
  bit, binary and L2;
* training on the ordered layout, binary and regression at leaf_batch 1
  and 4, and quantized training on the int8 kernel: identical trees,
  ``grow_steps`` and K, leaf values and predictions within 1e-5;
* the layout rule (300 used features resolve to 'ordered', 28 to 'seg'),
  the refusals of what is not ported, and prediction of a model past the
  walk kernel's 512 features.

Every JAX booster is trained once per module (module-scoped fixtures), to
keep the number of XLA:CPU compiles down.  The JAX side picks its kernels
by argument (``interpret=True``, ``hist_method='pallas_int8_interpret'``),
so no module flag is flipped.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.ops.histogram import leaf_histogram_segment
from lightgbm_tpu.ops.pallas.histogram import histogram_pallas
from lightgbm_tpu.ops.pallas.histogram_int8 import histogram_pallas_int8
from lightgbm_tpu.ops.quantize import quantize_gradients as jax_quantize_gradients

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops import grower, histogram
from lightgbm_tpu_torch.ops.forest_walk import walk_reject_reason
from lightgbm_tpu_torch.quantize import quantize_gradients

from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)
from .test_torch_interpret import int8_on_cpu

TREE_KEYS = ("split_feature", "split_bin", "default_left", "left_child", "right_child")
WINDOWS = {
    "root": None,
    "K=1": [(37, 901)],
    "K=3": [(5, 700), (705, 0), (1100, 1777)],
}


def _rows(n=3000, f=9, nb=64, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, nb, size=(n, f)).astype(np.uint8)
    grad = rng.normal(size=n).astype(np.float32)
    hess = (rng.random(n) + 0.5).astype(np.float32)
    mask = (rng.random(n) < 0.9).astype(np.float32)
    order = rng.permutation(n).astype(np.int32)  # a shuffled index array
    return bins, grad, hess, mask, order


def _port_rows(bins, grad, hess, mask):
    return histogram.OrderedRows(
        bins=histogram.row_major_bins(bins, "cpu"), f=bins.shape[1],
        g=torch.as_tensor(grad), h=torch.as_tensor(hess), m=torch.as_tensor(mask),
    )


def _gathered(order, windows, n):
    """(port order or None, windows, [row indices of each window])."""
    if windows is None:
        return None, [(0, n)], [np.arange(n)]
    return (torch.as_tensor(order), windows,
            [order[s:s + c].astype(np.int64) for s, c in windows])


@pytest.mark.parametrize("where", list(WINDOWS))
def test_ordered_hist_plain_equals_segment_sum(where):
    bins, grad, hess, mask, order = _rows()
    nb = 64
    t_order, wins, idxs = _gathered(order, WINDOWS[where], len(grad))
    got = histogram.ordered_hist(_port_rows(bins, grad, hess, mask), t_order, wins, nb)
    assert got.shape == (len(wins), bins.shape[1], nb, 3)
    for k, idx in enumerate(idxs):
        want = leaf_histogram_segment(
            jnp.asarray(bins[idx].astype(np.int32)), jnp.asarray(grad[idx]),
            jnp.asarray(hess[idx]), jnp.asarray(mask[idx]), nb,
        )
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))


@pytest.mark.parametrize("where", ["root", "K=3"])
def test_ordered_hist_plain_matches_pallas_interpret(where):
    bins, grad, hess, mask, order = _rows(seed=1)
    nb = 64
    t_order, wins, idxs = _gathered(order, WINDOWS[where], len(grad))
    got = histogram.ordered_hist(_port_rows(bins, grad, hess, mask), t_order, wins, nb)
    for k, idx in enumerate(idxs):
        if len(idx) == 0:  # the interpreter takes no empty input
            assert not got[k].any()
            continue
        want = np.asarray(histogram_pallas(
            jnp.asarray(bins[idx]), jnp.asarray(grad[idx]), jnp.asarray(hess[idx]),
            jnp.asarray(mask[idx]), num_bins=nb, interpret=True,
        ))
        np.testing.assert_array_equal(got[k, ..., 2].numpy(), want[..., 2])
        for c in (0, 1):
            scale = max(float(np.abs(want[..., c]).max()), 1.0)
            np.testing.assert_allclose(got[k, ..., c].numpy(), want[..., c],
                                       rtol=0, atol=4e-3 * scale)


@pytest.mark.parametrize("where", ["root", "K=3"])
def test_ordered_hist_int8_plain_equals_pallas_int8_interpret(where):
    bins, grad, hess, mask, order = _rows(seed=2)
    nb = 64
    qg, qh, gs, hs = (np.array(a) for a in jax_quantize_gradients(
        jnp.asarray(grad), jnp.asarray(hess), None, num_bins=16, stochastic=False))
    t_order, wins, idxs = _gathered(order, WINDOWS[where], len(grad))
    got = histogram.ordered_hist_int8(
        _port_rows(bins, qg, qh, mask), t_order, wins, nb, torch.tensor([float(gs), float(hs)]))
    for k, idx in enumerate(idxs):
        if len(idx) == 0:  # the interpreter takes no empty input
            assert not got[k].any()
            continue
        want = histogram_pallas_int8(
            jnp.asarray(bins[idx]), jnp.asarray(qg[idx]), jnp.asarray(qh[idx]),
            jnp.asarray(mask[idx]), nb, jnp.asarray(gs), jnp.asarray(hs), interpret=True,
        )
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))


@pytest.mark.parametrize("constant_hessian", [False, True], ids=["binary", "l2"])
def test_quantize_gradients_equals_jax_bit_for_bit(constant_hessian):
    rng = np.random.default_rng(3)
    grad = rng.normal(size=5000).astype(np.float32)
    hess = (np.ones(5000) if constant_hessian else rng.random(5000) * 0.25).astype(np.float32)
    for bins in (4, 7, 16, 127):
        got = quantize_gradients(torch.as_tensor(grad), torch.as_tensor(hess), bins,
                                 constant_hessian=constant_hessian)
        want = jax_quantize_gradients(jnp.asarray(grad), jnp.asarray(hess), None,
                                      num_bins=bins, stochastic=False,
                                      constant_hessian=constant_hessian)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _data(objective, n=2500, f=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[rng.random((n, f)) < 0.05] = np.nan
    z = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1])
         - 0.3 * np.nan_to_num(x[:, 2]) ** 2 + rng.normal(size=n))
    return x, (z > 0).astype(float) if objective == "binary" else z


def _jax_train(params, x, y, rounds):
    jp = {**params, "verbosity": -1, "metric": "none"}
    return lgb.train(jp, lgb.Dataset(x, y, params=jp), rounds)


def _assert_same_trees(jb, tb, x):
    assert len(tb.trees) == len(jb._bin_records)
    for jr, tree in zip(jb._bin_records, tb.trees):
        tr = tree.record()
        for k in TREE_KEYS:
            np.testing.assert_array_equal(tr[k], jr[k], err_msg=k)
        np.testing.assert_allclose(tr["leaf_value"], jr["leaf_value"], rtol=0, atol=1e-5)
    for raw in (True, False):
        np.testing.assert_allclose(tb.predict(x, raw_score=raw), jb.predict(x, raw_score=raw),
                                   rtol=0, atol=1e-5)


TRAIN_CASES = [("binary", 1), ("binary", 4), ("regression", 1), ("regression", 4)]


@pytest.fixture(scope="module", params=TRAIN_CASES, ids=[f"{o}-K{k}" for o, k in TRAIN_CASES])
def ordered_pair(request):
    """(JAX booster, JAX K per tree, JAX grow steps per tree, port booster,
    x) on the ordered layout, 15 leaves, 5 rounds."""
    objective, k = request.param
    x, y = _data(objective, seed=k)
    params = {"objective": objective, "num_leaves": 15, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 10, "leaf_batch": k,
              "hist_mode": "ordered"}
    grown = []
    orig = lgb.Booster._grow_one

    def grow_one(self, *args, **kw):
        kk = self._grower_params.leaf_batch
        ta, leaf_id = orig(self, *args, **kw)
        grown.append((kk, int(ta.grow_steps)))
        return ta, leaf_id

    mp = pytest.MonkeyPatch()
    mp.setattr(lgb.Booster, "_grow_one", grow_one)
    try:
        jb = _jax_train(params, x, y, 5)
    finally:
        mp.undo()
    assert jb._grower_params.hist_mode == "ordered"
    tb = lt.train(params, lt.Dataset(x, y, params=params), 5, device="cpu")
    return jb, grown, tb, x


def test_ordered_training_matches_jax(ordered_pair):
    jb, grown, tb, x = ordered_pair
    assert tb.hist_mode == "ordered" and not tb._grower_params.grow_fused
    assert tb.leaf_batch_effective == [k for k, _ in grown]
    assert tb.grow_steps == [s for _, s in grown]
    _assert_same_trees(jb, tb, x)


def test_ordered_training_equals_the_seg_layout(ordered_pair):
    """The layout changes where the rows live, not the model."""
    _, _, tb, x = ordered_pair
    params = {**tb.params, "hist_mode": "seg"}
    y = tb.train_set.label
    sb = lt.train(params, lt.Dataset(x, y, params=params), 5, device="cpu")
    assert sb.hist_mode == "seg" and sb.grow_steps == tb.grow_steps
    for a, b in zip(sb.trees, tb.trees):
        for k in TREE_KEYS:
            np.testing.assert_array_equal(a.record()[k], b.record()[k], err_msg=k)
    np.testing.assert_array_equal(sb.score.numpy(), tb.score.numpy())


QUANT = {"use_quantized_grad": True, "stochastic_rounding": False, "num_grad_quant_bins": 4}


@pytest.fixture(scope="module")
def quantized_pair():
    x, y = _data("binary", n=2000, seed=5)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63, "learning_rate": 0.2,
              "min_data_in_leaf": 10, "hist_mode": "ordered", **QUANT}
    jb = _jax_train({**params, "hist_method": "pallas_int8_interpret"}, x, y, 3)
    assert jb._grower_params.hist_method == "pallas_int8_interpret"
    tb = lt.train({**params, "hist_method": "pallas_int8"},
                  lt.Dataset(x, y, params=params), 3, device="cpu")
    return jb, tb, x


def test_quantized_training_matches_jax_int8_kernel(quantized_pair):
    jb, tb, x = quantized_pair
    assert tb.hist_mode == "ordered" and tb.refine_counts == [0] * 3
    _assert_same_trees(jb, tb, x)


def test_quantized_training_on_the_f32_kernel_keeps_the_int8_trees(quantized_pair):
    """hist_method='auto' sums the same quantized values in f32: the same
    splits on this data."""
    _, tb, x = quantized_pair
    params = {**tb.params, "hist_method": "auto"}
    fb = lt.train(params, lt.Dataset(x, tb.train_set.label, params=params), 3, device="cpu")
    for a, b in zip(fb.trees, tb.trees):
        for k in TREE_KEYS:
            np.testing.assert_array_equal(a.record()[k], b.record()[k], err_msg=k)
    np.testing.assert_allclose(fb.score.numpy(), tb.score.numpy(), rtol=0, atol=1e-5)


def _wide(n, f, seed, key_feature=0):
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(size=(n, f)) * 8) / 8
    z = 1.5 * x[:, key_feature] + x[:, 1] + 0.5 * rng.normal(size=n)
    return x, (z > 0).astype(float)


def test_layout_rule_resolves_ordered_when_wide_and_matches_jax():
    x, y = _wide(600, 300, seed=6)
    params = {"objective": "binary", "num_leaves": 7, "max_bin": 15, "min_data_in_leaf": 20}
    with pytest.warns(UserWarning, match="hist_mode='ordered'"):
        tb = lt.train(params, lt.Dataset(x, y, params=params), 2, device="cpu")
    assert tb.hist_mode == "ordered" and len(tb.used_features) == 300
    assert tb._bins_nf.shape == (600, 304)  # row stride padded to 16 bytes
    jb = _jax_train(params, x, y, 2)  # on the CPU the JAX package is ordered anyway
    assert jb._grower_params.hist_mode == "ordered"
    _assert_same_trees(jb, tb, x)
    narrow = lt.Booster(params, lt.Dataset(x[:, :28], y, params=params), device="cpu")
    assert narrow.hist_mode == "seg" and narrow._bins_nf is None


@pytest.mark.parametrize("params,word", [
    ({"use_quantized_grad": True, "extra_trees": True}, "extra_trees"),
    ({**QUANT, "quant_train_renew_leaf": True}, "quant_train_renew_leaf"),
    ({**QUANT, "hist_mode": "seg", "bagging_by_query": True}, "bagging_by_query"),
    ({"hist_method": "pallas_int8"}, "use_quantized_grad"),
    ({"hist_method": "onehot"}, "hist_method"),
    ({**QUANT, "num_grad_quant_bins": 200}, "num_grad_quant_bins"),
    ({"hist_mode": "gather"}, "gather"),
    ({"hist_mode": "full"}, "full"),
], ids=["extra-trees", "renew", "by-query", "int8-unquantized", "onehot",
        "quant-bins", "gather", "full"])
def test_config_refuses_what_is_not_ported(params, word):
    with pytest.raises(ValueError, match=word):
        Config.from_params(params)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "quantized"])
def test_config_and_booster_take_the_ordered_layout_past_255_bins(quantized):
    """max_bin 300 on hist_mode='ordered' (refused before the u16 mode of
    the ordered histograms): the config and the Booster take it, with u16
    row-major bins, quantized or not."""
    params = {"max_bin": 300, "hist_mode": "ordered", **(QUANT if quantized else {})}
    assert Config.from_params(params).max_bin == 300
    x, y = _data("binary", n=600, seed=11)
    tb = lt.Booster({**params, "objective": "binary"}, lt.Dataset(x, y, params=params),
                    device="cpu")
    assert tb.hist_mode == "ordered" and tb._max_bin == 512
    assert tb._bins_nf.dtype == torch.uint16 and not tb.update()


def test_quantized_training_refused_where_the_rule_picks_seg():
    """Where the rule picks seg, quantized training is no longer refused:
    it trains on seg (stochastic rounding too), and the ordered defaults
    pass the seg layout's split-scan check."""
    x, y = _data("binary", n=300)
    for params in ({"objective": "binary", "num_leaves": 4, **QUANT},
                   {"objective": "binary", "num_leaves": 4, "use_quantized_grad": True}):
        tb = lt.Booster(params, lt.Dataset(x, y, params=params), device="cpu")
        assert tb.hist_mode == "seg" and not tb.update() and tb.trees[0].num_leaves == 4
    # the ordered defaults pass the seg layout's split-scan check
    Config.from_params({"hist_mode": "ordered", "grow_fused": "off", "fused_split_scan": False})


def test_int8_accumulation_only_on_seg():
    for dev in ("cuda", "cpu"):
        assert not grower.int8_acc_eligible("auto", "ordered", torch.device(dev))
    assert grower.int8_acc_eligible("auto", "seg", torch.device("cuda"))
    x, y = _data("binary", n=800, seed=9)
    params = {"objective": "binary", "num_leaves": 7, "max_bin": 31}
    with int8_on_cpu():
        tb = lt.train({**params, "hist_mode": "ordered"}, lt.Dataset(x, y, params=params), 2,
                      device="cpu")
        sb = lt.train(params, lt.Dataset(x, y, params=params), 2, device="cpu")
    assert not tb._int8_acc and tb.refine_counts == [0, 0]
    assert sb._int8_acc and sb.hist_mode == "seg"


def test_model_past_the_walk_kernel_predicts_like_jax():
    """520 used features: the walk kernel takes at most 512, so the port
    predicts through the plain walker, as the JAX package falls back to
    its XLA walker."""
    x, y = _wide(400, 520, seed=10, key_feature=515)
    params = {"objective": "binary", "num_leaves": 7, "max_bin": 15, "min_data_in_leaf": 10,
              "hist_mode": "ordered"}
    tb = lt.train(params, lt.Dataset(x, y, params=params), 2, device="cpu")
    records = [t.record() for t in tb.trees]
    assert max(int(r["split_feature"].max()) for r in records) >= 512
    assert "520 features > 512" in walk_reject_reason(records, tb.nan_bins, 520, 16)
    jb = _jax_train(params, x, y, 2)
    with pytest.warns(UserWarning, match="plain walker"):
        raw = tb.predict(x, raw_score=True)
    np.testing.assert_allclose(raw, jb.predict(x, raw_score=True), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), rtol=0, atol=1e-5)
    np.testing.assert_allclose(raw, tb.score.numpy(), rtol=0, atol=1e-5)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        narrow = [dict(r, split_feature=np.minimum(r["split_feature"], 3)) for r in records]
        assert walk_reject_reason(narrow, tb.nan_bins[:4], 4, 16) is None
