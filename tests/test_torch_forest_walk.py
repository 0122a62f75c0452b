"""lightgbm_tpu_torch prediction (ops/forest_walk.py, predict.py, convert.py)
against the JAX package, on a model the JAX package trained.

The JAX booster's bin-space records and bin mappers go across through
``convert.booster_from_arrays``; then

* the port's table walk equals the Pallas kernel ``forest_walk`` run in
  interpret mode on the same bins exactly: both add the trees' leaf values
  in tree order in f32;
* it equals the port's own level-synchronous walker (predict.py) exactly;
* ``Booster.predict`` (device binning with host re-binning of doubtful
  rows) matches the JAX booster's predict within 1e-6: the JAX CPU walker
  sums the trees in another order;
* f32 device binning flags every row with a value on a bin boundary, and
  agrees with the exact host binning on all other rows.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.ops.pallas.forest_walk import (
    build_tables as jax_build_tables,
    forest_walk as jax_forest_walk,
    pad_bins_for_walk,
    unpack_walk_scores,
)

from lightgbm_tpu_torch.convert import booster_from_arrays
from lightgbm_tpu_torch.ops.forest_walk import (
    bin_numeric,
    build_devbin_tables,
    build_tables,
    forest_walk,
)
from lightgbm_tpu_torch.predict import predict_bins_raw, stack_bin_trees

from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)


@pytest.fixture(scope="module", params=["binary", "regression"])
def trained(request):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1500, 6))
    x[rng.random(x.shape) < 0.1] = np.nan
    z = np.nan_to_num(x[:, 0]) - np.nan_to_num(x[:, 1]) ** 2 + rng.normal(size=1500) * 0.3
    y = (z > 0).astype(float) if request.param == "binary" else z
    params = {"objective": request.param, "num_leaves": 15, "max_bin": 63,
              "verbosity": -1, "metric": "none"}
    jb = lgb.train(params, lgb.Dataset(x, y, params=params), 4)
    ds = jb.train_set
    used = list(ds.used_features)
    mappers = [ds.bin_mappers[j] for j in used]
    tb = booster_from_arrays(
        [dict(r) for r in jb._bin_records],
        [m.bin_upper_bound for m in mappers], [m.missing_type for m in mappers],
        [m.nan_bin for m in mappers], 0.0, request.param, device="cpu",
        used_features=used,
    )
    return jb, tb, x


def test_table_walk_equals_pallas_interpret(trained):
    jb, tb, x = trained
    bins = jb._bin_input_host(x)
    recs = jb._bin_records
    nanb = np.asarray(jb._nan_bins)
    jt = jax_build_tables(recs, nanb)
    out = jax_forest_walk(
        pad_bins_for_walk(bins), jt, n_trees=jt.n_trees, max_depth=jt.max_depth,
        k=1, interpret=True,
    )
    want = unpack_walk_scores(np.asarray(out), x.shape[0], 1)
    tables = build_tables(recs, nanb, "cpu")
    got = forest_walk(torch.as_tensor(bins.astype(np.uint8)), tables, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_table_walk_equals_level_sync_walker(trained):
    jb, _, x = trained
    bins = torch.as_tensor(jb._bin_input_host(x).astype(np.uint8))
    recs = jb._bin_records
    nanb = np.asarray(jb._nan_bins)
    got = forest_walk(bins, build_tables(recs, nanb, "cpu"), 1)
    want = predict_bins_raw(stack_bin_trees(recs, nanb, "cpu"), bins, 1)
    assert torch.equal(got, want)


def test_converted_booster_predicts_like_jax(trained):
    jb, tb, x = trained
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), rtol=0, atol=1e-6)


def test_device_binning_flags_boundaries(trained):
    jb, tb, x = trained
    xb = x[:64].copy()
    ub = tb.bin_mappers[tb.used_features[0]].bin_upper_bound
    xb[::2, 0] = ub[: len(xb[::2])]  # values exactly on bin boundaries
    xs = torch.as_tensor(xb[:, tb.used_features].astype(np.float32))
    bins, suspect = bin_numeric(xs, *build_devbin_tables(tb.bin_mappers, tb.used_features, "cpu"))
    host = jb._bin_input_host(xb)
    assert bool(suspect[::2].all())
    ok = ~suspect.numpy()
    np.testing.assert_array_equal(bins.numpy()[ok], host[ok])
    np.testing.assert_allclose(tb.predict(xb, raw_score=True),
                               jb.predict(xb, raw_score=True), rtol=0, atol=1e-6)
