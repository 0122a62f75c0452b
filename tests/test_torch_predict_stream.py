"""The rest of prediction in the port against the JAX package, on the CPU.

* the bucket ladder (``bucket_rows``, ``ladder_buckets``) equal to the JAX
  functions;
* ``pred_leaf`` bit-equal to the JAX Booster's on a binary model (trained
  by both packages to the same trees), and on an EFB and a categorical
  model (the port's, read by the JAX Booster from its model text: the JAX
  package's real-space walk), at ``pred_chunk_rows`` 1<<20, 512 and 700,
  and on empty input;
* prediction early stopping at freq 1 and 5: the sequential loop of
  ``tests/test_predict.py`` on the port's own per-tree block, the JAX
  Booster's on the same trees, a model read from text with the keys as
  params, and the full model at a margin of 1e30;
* ``pred_contrib``: the reference goldens ``forcedbins`` and
  ``scen_monotone_basic`` (the reference CLI's TreeSHAP), the JAX
  package's on a trained binary and a categorical model, and the SHAP
  identity;
* a model read from text at every chunk size (the real-space walker's
  scores and the engine's per-tree block), with rows planted on the
  thresholds, against the JAX loaded Booster;
* the walk path's chunk loop (``PREDICT_CHUNK`` small) at
  ``pred_num_buffers`` 1, 2 and 3, bit-equal to one chunk;
* ``last_predict_stats``' keys, ``compile_predict`` and
  ``pred_aot_compile``, and the keys that raise.
"""

import pathlib

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu import predict as jax_predict

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import predict as tpredict
from lightgbm_tpu_torch.boosting import gbdt as tgbdt

from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
# the tie rule both packages share at exact feature ties (the train-API tests')
BIN_PARAMS = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.3, "verbosity": -1,
              "metric": "none", "hist_mode": "seg", "hist_acc": "bf16", "grow_fused": "off",
              "fused_split_scan": True}
CHUNKS = (1 << 20, 512, 700)


def _binary_data(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6))
    x[rng.random((n, 6)) < 0.05] = np.nan
    y = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1]) - 0.3 * np.nan_to_num(x[:, 2])
         + 0.3 * rng.normal(size=n) > 0).astype(float)
    return x, y


def _one_hot_data(n=2000, nvar=6, ncat=12, seed=0):
    """Six 12-level one-hot blocks (EFB bundles each into a plane)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, ncat, size=(n, nvar))
    x = np.zeros((n, nvar * ncat))
    x[np.repeat(np.arange(n), nvar), (np.arange(nvar) * ncat + codes).ravel()] = 1.0
    y = x @ rng.normal(size=nvar * ncat) + 0.1 * rng.normal(size=n)
    return x, (y > np.median(y)).astype(float)


def _mixed_data(n=2000, seed=1):
    """Numeric and categorical columns (1: 12 levels, 3: Zipf-like), NaN."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 5))
    x[:, 1] = rng.integers(0, 12, n)
    x[:, 3] = rng.zipf(1.3, n) % 40
    x[rng.random(n) < 0.05, 3] = np.nan
    x[rng.random(n) < 0.05, 0] = np.nan
    y = (np.nan_to_num(x[:, 0]) + np.isin(x[:, 1], [1, 4, 7]) * 2 + (x[:, 3] % 3 == 0)
         + rng.normal(size=n) * 0.3)
    return x, y


def _same_structure(jb, tb, leaves=False):
    for i, (jr, tree) in enumerate(zip(jb._bin_records, tb.trees)):
        tr = tree.record()
        keys = ("split_feature", "split_bin", "default_left", "left_child", "right_child")
        for key in keys + (("leaf_value",) if leaves else ()):
            np.testing.assert_array_equal(tr[key], np.asarray(jr[key], tr[key].dtype),
                                          err_msg=f"tree {i} {key}")


@pytest.fixture(scope="module")
def models():
    """{name: (rows, JAX booster, port booster)}: the same trees in both."""
    out = {}
    x, y = _binary_data()
    tb = lt.train(BIN_PARAMS, lt.Dataset(x, y), 6, device="cpu")
    jb = lgb.train(BIN_PARAMS, lgb.Dataset(x, y), 6)
    _same_structure(jb, tb, leaves=True)
    out["binary"] = (x, jb, tb)
    xe, ye = _one_hot_data()
    tbe = lt.train({**BIN_PARAMS, "max_bin": 63}, lt.Dataset(xe, ye), 3, device="cpu")
    assert tbe.bundle_layout is not None and tbe.bundle_layout.has_bundles
    out["efb"] = (xe, lgb.Booster(model_str=tbe.model_to_string()), tbe)
    xc, yc = _mixed_data()
    params = {"objective": "regression", "num_leaves": 15, "min_data_per_group": 5,
              "cat_smooth": 2.0, "learning_rate": 0.2, "categorical_feature": [1, 3]}
    tbc = lt.train(params, lt.Dataset(xc, yc), 3, device="cpu")
    assert sum(t.num_cat for t in tbc.trees) > 0
    probe = xc[:600].copy()
    probe[:40, 1] = 99  # unseen
    probe[40:80, 3] = -2  # negative
    probe[80:120, 1] = 3.7  # fraction
    probe[120:160, 1] = np.nan  # NaN without a NaN bin
    out["categorical"] = (probe, lgb.Booster(model_str=tbc.model_to_string()), tbc)
    return out


# ------------------------------------------------------------------ ladder
def test_bucket_ladder_equals_jax():
    for chunk in (256, 300, 512, 700, 4096, 5000, 1 << 20):
        assert tpredict.ladder_buckets(chunk) == jax_predict.ladder_buckets(chunk)
        for rows in (1, 255, 256, 257, 511, 700, 4095, 4096, 5000, chunk - 1, chunk, chunk + 7):
            assert tpredict.bucket_rows(rows, chunk) == jax_predict.bucket_rows(rows, chunk)


# ---------------------------------------------------------------- pred_leaf
@pytest.mark.parametrize("name", ["binary", "efb", "categorical"])
def test_pred_leaf_equals_jax_at_every_chunk(models, name):
    x, jb, tb = models[name]
    want = np.asarray(jb.predict(x, pred_leaf=True))
    assert want.dtype == np.int32 and want.shape == (len(x), len(tb.trees))
    for chunk in CHUNKS:
        got = tb.predict(x, pred_leaf=True, pred_chunk_rows=chunk)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"chunk {chunk}")
        stats = tb.last_predict_stats
        assert stats["path"] == "stream_bin" and stats["chunks"] == -(-len(x) // max(256, chunk))
    empty = tb.predict(x[:0], pred_leaf=True)
    assert empty.shape == (0, len(tb.trees)) and empty.dtype == np.int32
    # an empty tree range, as the JAX package
    assert tb.predict(x[:5], pred_leaf=True, start_iteration=99).shape == (5, 0)


# ------------------------------------------------------- early stopping
def _sequential(per_tree, freq, margin):
    """tests/test_predict.py:17-52's loop (reference gbdt_prediction.cpp:18-36)."""
    out = np.zeros(len(per_tree))
    for i in range(len(per_tree)):
        acc, cnt = 0.0, 0
        for t in range(per_tree.shape[1]):
            acc += per_tree[i, t]
            cnt += 1
            if cnt == freq:
                if 2 * abs(acc) > margin:
                    break
                cnt = 0
        out[i] = acc
    return out


@pytest.mark.parametrize("freq", [1, 5])
def test_pred_early_stop_matches_sequential_loop_and_jax(models, freq):
    x, jb, tb = models["binary"]
    leaves = tb.predict(x, pred_leaf=True)
    per_tree = np.stack([t.record()["leaf_value"][leaves[:, i]]
                         for i, t in enumerate(tb.trees)], axis=1).astype(np.float64)
    margin = float(np.median(2 * np.abs(per_tree[:, :freq].sum(axis=1))))
    es = {"pred_early_stop": True, "pred_early_stop_freq": freq, "pred_early_stop_margin": margin}
    got = tb.predict(x, raw_score=True, **es)
    np.testing.assert_allclose(got, _sequential(per_tree, freq, margin), rtol=1e-12, atol=0)
    stopped = got != per_tree.sum(axis=1)
    assert 0 < stopped.sum() < len(x)  # some rows stop, some do not
    # the JAX Booster on the same trees (its leaf values bit-equal)
    np.testing.assert_allclose(got, jb.predict(x, raw_score=True, **es), rtol=1e-12, atol=0)
    # probabilities: the JAX package's sigmoid runs in f32
    np.testing.assert_allclose(tb.predict(x, **es), jb.predict(x, **es), rtol=1e-6, atol=0)
    # an infinite margin gives the full model
    inf = tb.predict(x, raw_score=True, pred_early_stop=True, pred_early_stop_margin=1e30)
    np.testing.assert_allclose(inf, tb.predict(x, raw_score=True), rtol=1e-6, atol=1e-7)
    # a model read from text, the keys as params: its f64 per-tree block
    tl = lt.Booster(es, model_str=tb.model_to_string(), device="cpu")
    leaves = tl.predict(x, pred_leaf=True)
    per_tree = np.stack([t.leaf_value[leaves[:, i]] for i, t in enumerate(tl.trees)], axis=1)
    np.testing.assert_allclose(tl.predict(x, raw_score=True),
                               _sequential(per_tree, freq, margin), rtol=1e-12, atol=0)
    np.testing.assert_allclose(tl.predict(x, raw_score=True, pred_early_stop_margin=1e30),
                               tl.predict(x, raw_score=True, pred_early_stop=False),
                               rtol=1e-12, atol=0)


def test_regression_ignores_pred_early_stop(models):
    probe, _, tb = models["categorical"]
    assert tb._early_stop_type() == "none"
    np.testing.assert_array_equal(
        tb.predict(probe, pred_early_stop=True, pred_early_stop_margin=0.0), tb.predict(probe))


# ------------------------------------------------------------ pred_contrib
@pytest.mark.parametrize("stem", ["forcedbins", "scen_monotone_basic"])
def test_pred_contrib_matches_reference_goldens(stem):
    arr = np.loadtxt(GOLDEN / f"{stem}.train.csv", delimiter=",")
    x = arr[:500, 1:]
    b = lt.Booster(model_str=(GOLDEN / f"{stem}.model.txt").read_text(), device="cpu")
    want = np.loadtxt(GOLDEN / f"{stem}.contribs.txt", delimiter="\t", ndmin=2)
    got = b.predict(x, pred_contrib=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.sum(axis=1), b.predict(x, raw_score=True), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["binary", "categorical"])
def test_pred_contrib_equals_jax_and_sums_to_the_raw_score(models, name):
    x, _, tb = models[name]
    x = x[:60]
    got = tb.predict(x, pred_contrib=True)
    assert got.shape == (len(x), tb.max_feature_idx + 2)
    want = lgb.Booster(model_str=tb.model_to_string()).predict(x, pred_contrib=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.sum(axis=1), tb.predict(x, raw_score=True), rtol=0, atol=1e-6)


# ------------------------------------------------------- model from text
def test_model_text_predicts_the_same_at_every_chunk(models, monkeypatch):
    x, _, tb = models["binary"]
    text = tb.model_to_string()
    probe = x[:900].copy()
    # rows planted exactly on thresholds: each numeric node's threshold in
    # its feature, 20 rows a node
    nodes = [(int(f), float(th)) for t in tb.trees
             for f, th in zip(t.split_feature_real, t.threshold)][:40]
    for i, (f, th) in enumerate(nodes):
        probe[20 * i: 20 * i + 20, f] = th
    tl = lt.Booster(model_str=text, device="cpu")
    jl = lgb.Booster(model_str=text)
    # the scores in chunks of 256, 700 and every row (REAL_WALK_CELLS rows
    # x trees), and the engine's per-tree block at every chunk size
    outs = []
    for rows in (256, 700, len(probe)):
        monkeypatch.setattr(tgbdt, "REAL_WALK_CELLS", rows * len(tl.trees))
        outs.append(tl.predict(probe, raw_score=True))
        assert tl.last_predict_stats["chunks"] == -(-len(probe) // rows)
    for got in outs:
        np.testing.assert_array_equal(got, outs[0])
    eng = tl._stream_engine()
    blocks = [eng.run(probe, 0, len(tl.trees), space="real", kind="value", chunk=c)
              for c in (256, 700, 4096, 1 << 20)]
    for blk in blocks:
        np.testing.assert_array_equal(blk, blocks[0])
    np.testing.assert_allclose(blocks[0].sum(axis=1), outs[0], rtol=1e-12, atol=1e-15)
    # the JAX loaded Booster sums f32 leaf values (its real-space walk in
    # f32, the rows near a threshold re-walked in f64), the port f64 ones
    np.testing.assert_allclose(outs[0], jl.predict(probe, raw_score=True), rtol=1e-6, atol=1e-7)
    leaves = tl.predict(probe, pred_leaf=True, pred_chunk_rows=300)
    np.testing.assert_array_equal(leaves, jl.predict(probe, pred_leaf=True))
    # the same leaves as the trained booster's bins
    np.testing.assert_array_equal(leaves, tb.predict(probe, pred_leaf=True))


# ------------------------------------------------------------ walk path
@pytest.mark.parametrize("name", ["binary", "efb", "categorical"])
def test_walk_path_chunks_and_buffers_are_bit_equal(models, name, monkeypatch):
    x, _, tb = models[name]
    want = tb.predict(x)
    assert tb.last_predict_stats["chunks"] == 1
    monkeypatch.setattr(tgbdt, "PREDICT_CHUNK", 700)
    for nb in (1, 2, 3):
        np.testing.assert_array_equal(tb.predict(x, pred_num_buffers=nb), want, err_msg=f"{nb}")
        assert tb.last_predict_stats["chunks"] == -(-len(x) // 700)


def test_last_predict_stats_have_the_jax_keys(models):
    x, _, tb = models["binary"]
    tb.predict(x)
    assert {"path", "rows", "chunks", "bin_ms", "transfer_ms", "walk_ms", "host_ms"} <= set(
        tb.last_predict_stats)
    assert tb.last_predict_stats["path"] == "forest_walk"
    assert 0 <= tb.last_predict_stats["suspect_rows"] <= len(x)
    text = tb.model_to_string()
    jl = lgb.Booster(model_str=text)
    jl.predict(x[:300], pred_leaf=True)
    tl = lt.Booster(model_str=text, device="cpu")
    tl.predict(x[:300], pred_leaf=True)
    assert set(tl.last_predict_stats) == set(jl.last_predict_stats)
    assert tl.last_predict_stats["path"] == jl.last_predict_stats["path"] == "stream_real"
    # a loaded model's scores take the real-space walker in large chunks
    tl.predict(x[:300])
    assert tl.last_predict_stats["path"] == "real_walk"
    assert tl.last_predict_stats["chunks"] == 1


def test_compile_predict_leaves_nothing_to_build(models):
    x, _, tb = models["binary"]
    tb._tables = {}
    tb._devbin = None
    assert tb.compile_predict(kinds=("value", "leaf")) >= 3
    assert tb.compile_predict(kinds=("value", "leaf")) == 0
    tb.predict(x)
    assert tb.last_predict_stats["compiles"] == 0
    tb.predict(x, pred_leaf=True)
    assert tb.last_predict_stats["compiles"] == 0
    tl = lt.Booster({"pred_aot_compile": True}, model_str=tb.model_to_string(), device="cpu")
    tl.predict(x)
    assert tl.last_predict_stats["compiles"] == 0
    assert len(tl._staging) == len(tpredict.ladder_buckets(4096))


def test_large_staging_lives_for_its_call_only(models, monkeypatch):
    x, _, tb = models["binary"]  # 2,000 rows: one 2,048-row bucket at 4,096 a chunk
    tb._drop_predict_caches()
    want = tb.predict(x, pred_leaf=True)
    assert [key[0] for key in tb._staging] == [2048]
    # past STAGING_KEEP_BYTES a slot lives for its call only
    tb._drop_predict_caches()
    big = tpredict.slot_bytes(2048, tb._bin_matrix_width(), torch.int32, len(tb.trees), "leaf")
    monkeypatch.setattr(tpredict, "STAGING_KEEP_BYTES", big - 1)
    np.testing.assert_array_equal(tb.predict(x, pred_leaf=True), want)
    assert tb.last_predict_stats["buckets"] == [2048] and not tb._staging
    np.testing.assert_array_equal(tb.predict(x, pred_leaf=True, pred_chunk_rows=512), want)
    assert [key[0] for key in tb._staging] == [512]
    monkeypatch.undo()
    # new trees drop them
    tl = lt.Booster(model_str=tb.model_to_string(), device="cpu")
    tl.predict(x, pred_leaf=True)
    assert tl._staging
    tl.model_from_string(tb.model_to_string())
    assert not tl._staging and not tl._tables


def test_unported_prediction_keys_raise(models, monkeypatch):
    x, _, tb = models["binary"]
    for engine in ("matmul", "auto"):
        with pytest.raises(NotImplementedError, match="Queue 1, item 7"):
            tb.predict(x, pred_engine=engine)
        with pytest.raises(NotImplementedError, match="Queue 1, item 7"):
            lt.Booster({"pred_engine": engine}, model_str=tb.model_to_string(), device="cpu")
    with pytest.raises(ValueError, match="pred_exact_binning"):
        tb.predict(x, pred_exact_binning=True)
    assert tpredict.shard_count(-1, "cpu") == 1 and tpredict.shard_count(4, "cpu") == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tpredict.shard_count(1, "cuda") == tpredict.shard_count(0, "cuda") == 1
    for request in (2, 3, -1):
        with pytest.raises(NotImplementedError, match="Queue 1, item 9"):
            tpredict.shard_count(request, "cuda")
