"""The ordered layout past 255 bins (u16 row-major bins, the u16 mode of the
ordered histograms) in lightgbm_tpu_torch against the JAX package.

The same numpy inputs, made from a seed, go through both packages:

* the u16 plain histograms at 1,024 bins against ``leaf_histogram_segment``
  (identical) and against the TPU kernels ``histogram_pallas`` (f32, within
  ``tests/test_torch_ordered.py``'s 4e-3 of the scale, counts exact) and
  ``histogram_pallas_int8`` (exactly) in interpret mode, on the root and
  K=3 windows of a shuffled index (one empty), with bins at 255 / 256 and a
  NaN bin past 255;
* the layout rule with no path parameter: 'ordered', with the JAX
  package's warning, at 122 and more columns past 256 bins and at 3
  columns past 8,192 bins; a validation set scored through the plain
  walker;
* training at ``max_bin`` 1023 on 130 columns, binary and regression, in
  f32 at K=1 and K=4, and f32 past 8,192 bins on 3 columns: the trees
  identical, leaves within 1e-5, predictions, the model text and
  ``booster_from_arrays`` of the JAX package's records equal.  The same
  cases quantized on the int8 kernel are in
  ``tests/test_torch_ordered_widebin_int8.py`` (the JAX package's int8
  kernel in interpret mode compiles for tens of seconds a case).

Every JAX booster is trained once per module (module-scoped fixtures).
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
from lightgbm_tpu_torch.boosting.gbdt import resolve_hist_mode
from lightgbm_tpu_torch.convert import booster_from_arrays
from lightgbm_tpu_torch.ops import histogram

from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)

TREE_KEYS = ("split_feature", "split_bin", "default_left", "left_child", "right_child")
NB = 1024
WINDOWS = {"root": None, "K=3": [(5, 400), (405, 0), (600, 333)]}


def _rows(n=1000, f=5, seed=0):
    """u16 bins over 1,024 bins: feature 1 only 300 wide (narrower than the
    widest), feature 2 at bins 255 and 256, a NaN bin (1,023) past 255."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, NB, size=(n, f)).astype(np.uint16)
    bins[:, 1] %= 300
    bins[:, 2] = rng.choice(np.array([0, 255, 256, 700], np.uint16), size=n)
    bins[rng.random((n, f)) < 0.05] = NB - 1
    grad = rng.normal(size=n).astype(np.float32)
    hess = (rng.random(n) + 0.5).astype(np.float32)
    mask = (rng.random(n) < 0.9).astype(np.float32)
    order = rng.permutation(n).astype(np.int32)
    return bins, grad, hess, mask, order


def _port_rows(bins, grad, hess, mask):
    rows = histogram.OrderedRows(
        bins=histogram.row_major_bins(bins, "cpu"), f=bins.shape[1],
        g=torch.as_tensor(grad), h=torch.as_tensor(hess), m=torch.as_tensor(mask),
        used_bins=NB)
    assert rows.wide and rows.bins.dtype == torch.uint16 and rows.bins.shape[1] == 8
    return rows


def _gathered(order, where, n):
    windows = WINDOWS[where]
    if windows is None:
        return None, [(0, n)], [np.arange(n)]
    return (torch.as_tensor(order), windows,
            [order[s:s + c].astype(np.int64) for s, c in windows])


@pytest.mark.parametrize("where", list(WINDOWS))
def test_u16_plain_histogram_equals_segment_sum(where):
    bins, grad, hess, mask, order = _rows()
    t_order, wins, idxs = _gathered(order, where, len(grad))
    got = histogram.ordered_hist(_port_rows(bins, grad, hess, mask), t_order, wins, NB)
    assert got.shape == (len(wins), bins.shape[1], NB, 3)
    for k, idx in enumerate(idxs):
        want = leaf_histogram_segment(
            jnp.asarray(bins[idx].astype(np.int32)), jnp.asarray(grad[idx]),
            jnp.asarray(hess[idx]), jnp.asarray(mask[idx]), NB)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))
    assert got[0, 2, 256, 2] > 0 and got[0, 2, 255, 2] > 0 and got[0, :, NB - 1, 2].sum() > 0
    assert not got[:, 1, 300:NB - 1].any()  # the narrow feature's empty bins


@pytest.mark.parametrize("where", list(WINDOWS))
def test_u16_plain_histogram_matches_pallas_interpret(where):
    bins, grad, hess, mask, order = _rows(seed=1)
    t_order, wins, idxs = _gathered(order, where, len(grad))
    got = histogram.ordered_hist(_port_rows(bins, grad, hess, mask), t_order, wins, NB)
    for k, idx in enumerate(idxs):
        if len(idx) == 0:  # the interpreter takes no empty input
            assert not got[k].any()
            continue
        want = np.asarray(histogram_pallas(
            jnp.asarray(bins[idx]), jnp.asarray(grad[idx]), jnp.asarray(hess[idx]),
            jnp.asarray(mask[idx]), num_bins=NB, interpret=True))
        np.testing.assert_array_equal(got[k, ..., 2].numpy(), want[..., 2])
        for c in (0, 1):
            scale = max(float(np.abs(want[..., c]).max()), 1.0)
            np.testing.assert_allclose(got[k, ..., c].numpy(), want[..., c],
                                       rtol=0, atol=4e-3 * scale)


@pytest.mark.parametrize("where", list(WINDOWS))
def test_u16_plain_int8_histogram_equals_pallas_int8_interpret(where):
    bins, grad, hess, mask, order = _rows(seed=2)
    qg, qh, gs, hs = (np.array(a) for a in jax_quantize_gradients(
        jnp.asarray(grad), jnp.asarray(hess), None, num_bins=16, stochastic=False))
    t_order, wins, idxs = _gathered(order, where, len(grad))
    got = histogram.ordered_hist_int8(
        _port_rows(bins, qg, qh, mask), t_order, wins, NB, torch.tensor([float(gs), float(hs)]))
    for k, idx in enumerate(idxs):
        if len(idx) == 0:
            assert not got[k].any()
            continue
        want = histogram_pallas_int8(
            jnp.asarray(bins[idx]), jnp.asarray(qg[idx]), jnp.asarray(qh[idx]),
            jnp.asarray(mask[idx]), NB, jnp.asarray(gs), jnp.asarray(hs), interpret=True)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))


@pytest.mark.parametrize("num_bins,used,want", [(256, 0, 1), (1024, 0, 4), (1024, 700, 3),
                                                (1024, 1025, 4), (16384, 8193, 33)])
def test_u16_ranges_follow_the_widest_feature(num_bins, used, want):
    rows = histogram.OrderedRows(torch.zeros((4, 8), dtype=torch.uint16), 3,
                                 *(torch.zeros(4) for _ in range(3)), used_bins=used)
    assert histogram.ordered_ranges(rows, num_bins) == want


def test_u8_rows_past_256_bins_are_refused():
    rows = histogram.OrderedRows(torch.zeros((4, 16), dtype=torch.uint8), 3,
                                 *(torch.zeros(4) for _ in range(3)))
    with pytest.raises(ValueError, match="u16 bins past 256"):
        histogram.ordered_ranges(rows, 512)


# ------------------------------------------------------------ layout rule
def _data(objective, n, f, seed, nan_share=0.05):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[rng.random((n, f)) < nan_share] = np.nan
    z = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1])
         - 0.3 * np.nan_to_num(x[:, 2]) ** 2 + rng.normal(size=n))
    return x, (z > 0).astype(float) if objective == "binary" else z


@pytest.mark.parametrize("f,max_bin,why", [
    (122, 511, "122 used features > 121"), (130, 1023, "130 used features > 121"),
    (3, 16383, "exceeds the budget")])
def test_layout_rule_picks_ordered_past_256_bins_with_the_warning(f, max_bin, why):
    x, y = _data("regression", 9000 if f == 3 else 600, f, seed=f)
    params = {"max_bin": max_bin}
    ds = lt.Dataset(x, y, params=params).construct()
    assert ds.max_bin_padded > 256 and ds.bins.dtype == np.uint16
    assert resolve_hist_mode(ds.num_planes, ds.max_bin_padded) == "ordered"
    with pytest.warns(UserWarning, match=why):
        tb = lt.Booster(params, ds, device="cpu")
    assert tb.hist_mode == "ordered" and tb._bins_nf.dtype == torch.uint16
    assert tb._bins_nf.shape == (len(y), -(-f // 8) * 8)  # the row stride: 16 bytes


def test_validation_set_scores_through_the_plain_walker():
    """A validation set of an ordered booster past 255 bins takes each tree
    through the plain walker on its bins: the recorded log-loss equals that
    of predict's probabilities."""
    x, y = _data("binary", 900, 130, seed=9)
    params = {"objective": "binary", "num_leaves": 7, "max_bin": 1023, "min_data_in_leaf": 5,
              "metric": "binary_logloss"}
    tr = lt.Dataset(x[:600], y[:600], params=params)
    va = lt.Dataset(x[600:], y[600:], reference=tr)
    rec = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tb = lt.train(params, tr, 3, valid_sets=[va], valid_names=["valid"],
                      callbacks=[lt.record_evaluation(rec)], device="cpu")
        p = np.clip(tb.predict(x[600:]), 1e-15, 1 - 1e-15)
    assert tb.hist_mode == "ordered" and tb._max_bin == 1024
    want = float(-np.mean(y[600:] * np.log(p) + (1 - y[600:]) * np.log(1 - p)))
    np.testing.assert_allclose(rec["valid"]["binary_logloss"][-1], want, rtol=1e-5)


# ---------------------------------------------------------------- training
QUANT = {"use_quantized_grad": True, "stochastic_rounding": False, "num_grad_quant_bins": 4}
CASES = [(obj, "f32", k) for obj in ("binary", "regression") for k in (1, 4)] + [
    ("regression", "f32 past 8,192 bins", 1)]


def _case_params(objective, mode, k):
    wide8k = "8,192" in mode
    params = {"objective": objective, "num_leaves": 7, "learning_rate": 0.1,
              "min_data_in_leaf": 5, "leaf_batch": k, "max_bin": 16383 if wide8k else 1023}
    if mode == "int8":
        params.update(QUANT)
    return params, (9000, 3) if wide8k else (600, 130)


def train_pair(objective, mode, k):
    """(JAX booster, port booster, x, params) of a case on the ordered
    layout, no path parameter on the port's side, 2 rounds."""
    params, (n, f) = _case_params(objective, mode, k)
    x, y = _data(objective, n, f, seed=k + len(mode))
    jp = {**params, "verbosity": -1, "metric": "none"}
    if mode == "int8":
        jp["hist_method"] = "pallas_int8_interpret"
    jb = lgb.train(jp, lgb.Dataset(x, y, params=jp), 2)
    assert jb._grower_params.hist_mode == "ordered"
    tp = {**params, "hist_method": "pallas_int8"} if mode == "int8" else params
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the layout rule's warning (tested above)
        tb = lt.train(tp, lt.Dataset(x, y, params=tp), 2, device="cpu")
    return jb, tb, x, params


@pytest.fixture(scope="module", params=CASES, ids=[f"{o}-{m}-K{k}" for o, m, k in CASES])
def trained_pair(request):
    return train_pair(*request.param)


def _model_text(b):
    return b.model_to_string().split("\nparameters:\n")[0]


def check_training(pair):
    """The trees identical, leaves within 1e-5, a split past bin 255, and
    predict through the plain walker equal to the JAX package's and to the
    training score."""
    jb, tb, x, params = pair
    assert tb.hist_mode == "ordered" and tb._max_bin > 256 and tb._bins_nf.dtype == torch.uint16
    assert tb._grower_params.case_major_ties and tb.refine_counts == [0, 0]
    assert len(tb.trees) == len(jb._bin_records) == 2
    for jr, tree in zip(jb._bin_records, tb.trees):
        tr = tree.record()
        for k in TREE_KEYS:
            np.testing.assert_array_equal(tr[k], jr[k], err_msg=k)
        np.testing.assert_allclose(tr["leaf_value"], jr["leaf_value"], rtol=0, atol=1e-5)
    assert max(int(np.max(t.record()["split_bin"], initial=0)) for t in tb.trees) > 255
    with pytest.warns(UserWarning, match="plain walker"):
        raw = tb.predict(x, raw_score=True)
    np.testing.assert_allclose(raw, jb.predict(x, raw_score=True), rtol=0, atol=1e-5)
    np.testing.assert_allclose(raw, tb.score.numpy(), rtol=0, atol=1e-5)


def check_model_text_and_arrays(pair):
    """The model text equal to the JAX package's; each package's model read
    from the other's text, and ``booster_from_arrays`` of the JAX
    package's records, predict as trained."""
    jb, tb, x, params = pair
    assert _model_text(tb) == _model_text(jb)
    back = lt.Booster(model_str=jb.model_to_string(), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = tb.predict(x, raw_score=True)
    np.testing.assert_allclose(back.predict(x, raw_score=True), want, rtol=1e-6, atol=1e-6)
    jback = lgb.Booster(model_str=tb.model_to_string())
    np.testing.assert_allclose(jback.predict(x, raw_score=True), jb.predict(x, raw_score=True),
                               rtol=1e-6, atol=1e-6)
    ms = [jb.train_set.bin_mappers[j] for j in jb.train_set.used_features]
    carried = booster_from_arrays(
        [{**r, "leaf_value": np.asarray(r["leaf_value"], np.float32)} for r in jb._bin_records],
        [m.bin_upper_bound for m in ms], [m.missing_type for m in ms], [m.nan_bin for m in ms],
        0.0, params["objective"], device="cpu", used_features=jb.train_set.used_features)
    assert carried._max_bin == tb._max_bin
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = carried.predict(x, raw_score=True)
    np.testing.assert_allclose(got, jb.predict(x, raw_score=True), rtol=0, atol=1e-5)


def test_ordered_training_past_255_bins_equals_jax(trained_pair):
    check_training(trained_pair)


def test_model_text_and_arrays_carry_across(trained_pair):
    check_model_text_and_arrays(trained_pair)
