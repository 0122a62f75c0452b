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
  agrees with the exact host binning on all other rows;
* the tables of random forests (single-leaf trees, NaN rows under
  default-left and default-right nodes, k classes) walk as the JAX kernel
  does in interpret mode, exactly;
* a numpy model of the kernel's schedule (persistent blocks in random
  orders, tree chunks of ``walk_plan``'s size, two rows a thread, each with
  its own cursor, staged and NaN-left words) gives the plain walker's
  scores to the bit, and a warp's loop runs no longer than a lockstep walk;
* ``walk_plan`` at the bench's shapes, and the source's constants, C entry
  and its lack of float atomics.
"""

import os
import re

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

from lightgbm_tpu_torch import _build
from lightgbm_tpu_torch.bench_forest_walk import categorize, grow_tree, leaf_depths
from lightgbm_tpu_torch.convert import booster_from_arrays
from lightgbm_tpu_torch.ops.forest_walk import (
    bin_numeric,
    build_devbin_tables,
    build_tables,
    forest_walk,
)
from lightgbm_tpu_torch.ops import forest_walk as fw
from lightgbm_tpu_torch.predict import predict_bins_leaves, predict_bins_raw, stack_bin_trees

from .lane_hist_model import atomic_types
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


# ---------------------------------------------------------------------------
# The kernel (csrc/forest_walk.cu): its tables against the JAX kernel, a
# numpy model of its schedule against the plain walker, and the source.

with open(os.path.join(_build.CSRC, "forest_walk.cu")) as _fh:
    SRC = _fh.read()


def random_case(seed: int, n: int, f: int, leaves, nbins: int = 64, nan_share: float = 0.3):
    """(bins [n, f] u8, records, nan_bins): every other feature has a NaN bin
    (its last bin; feature 1's is bin 0), which ``nan_share`` of its rows
    sit in; trees of ``leaves`` leaves grown best-first on the rows
    (``bench_forest_walk.grow_tree``, default_left at random)."""
    rng = np.random.default_rng(seed)
    nan_bins = np.where(np.arange(f) % 2 == 1, nbins - 1, -1)
    nan_bins[1] = 0
    bins = rng.integers(0, nbins - 1, size=(n, f))
    nan_rows = rng.random((n, f)) < nan_share
    bins = np.where(nan_rows & (nan_bins >= 0), nan_bins, bins).astype(np.uint8)
    records = [grow_tree(bins, int(nl), rng) for nl in leaves]
    return bins, records, nan_bins


@pytest.mark.parametrize("k", [1, 2])
def test_new_tables_equal_pallas_interpret(k):
    """build_tables' encoding, walked by forest_walk_plain, equals the JAX
    kernel in interpret mode exactly: single-leaf trees, NaN rows in
    default-left and default-right nodes, a NaN bin of 0, k classes."""
    bins, recs, nanb = random_case(5 + k, 300, 28, [1, 2, 17, 1, 40, 63, 9])
    assert any(r["default_left"].any() and (~r["default_left"]).any() for r in recs)
    jt = jax_build_tables(recs, nanb)
    out = jax_forest_walk(pad_bins_for_walk(bins), jt, n_trees=jt.n_trees,
                          max_depth=jt.max_depth, k=k, interpret=True)
    want = unpack_walk_scores(np.asarray(out), bins.shape[0], k)
    got = forest_walk(torch.as_tensor(bins), build_tables(recs, nanb, "cpu"), k).numpy()
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def _prmt(a: np.ndarray, b: np.ndarray, sel: np.ndarray) -> np.ndarray:
    """The PTX byte permute, elementwise on u32 arrays: byte n of the result
    is byte (sel >> 4n) & 7 of {b, a}, or its sign replicated where bit
    4n + 3 of sel is set."""
    src = np.stack([(a >> s) & 0xFF for s in (0, 8, 16, 24)]
                   + [(b >> s) & 0xFF for s in (0, 8, 16, 24)], axis=-1).astype(np.uint32)
    out = np.zeros_like(a, dtype=np.uint32)
    for nib in range(4):
        s = (sel >> (4 * nib)) & 0xF
        byte = np.take_along_axis(src, (s & 7).astype(np.int64)[..., None], -1)[..., 0]
        byte = np.where(s & 8, np.where(byte & 0x80, 0xFF, 0), byte).astype(np.uint32)
        out |= byte << np.uint32(8 * nib)
    return out


def model_walk(bins: np.ndarray, tables, k: int, plan, grid: int, rng):
    """The kernel's schedule in numpy: ``grid`` persistent blocks in a random
    order, each staging the chunks of ``plan.chunk_trees`` trees in turn (the
    table bytes, then the sink record after them) and walking every tile it
    owns (tiles blockIdx, blockIdx + grid, ...) through each chunk.  A tile
    is ``plan.threads / plan.groups`` threads of ROWS_PER_THREAD rows, whose
    words (the 4-byte groups of the flat bins from the row's first byte: the
    next row's bytes, or 0 past the last byte) and NaN-left words are staged
    once; group g of ``plan.groups`` walks the chunk's trees g, g + groups,
    ..., each row with its own cursor (the byte offsets of its tree and node;
    the node's word permuted against its split word, the chosen child's u16
    offset a node record, or past the records a leaf's value), stepping
    until every row is parked on the sink; with one group the values are
    added as they come, else kept in a stash [tree, row] that is then added
    row by row in tree order.  Sums carried in ``out`` between chunks.
    Returns (scores [n, k] f32, {(tile, chunk, warp): loop iterations},
    {the same key: [(group, rows, trees) of each of its threads]})."""
    n, f = bins.shape
    t_all, m, lm, nw = tables.n_trees, tables.m_nodes, tables.m_leaves, tables.n_words
    tb = 8 * m + 4 * lm + 32 * tables.m_cat
    raw = tables.tables.numpy().view(np.uint8).reshape(-1)
    nan_words = tables.nan_words.numpy().view(np.uint32)
    flat = np.concatenate([bins.reshape(-1), np.zeros(4 * nw + 4, np.uint8)])
    group_threads = plan.threads // plan.groups
    tile_rows = group_threads * fw.ROWS_PER_THREAD
    tiles = -(-n // tile_rows)
    out = np.full((n, k), np.nan, np.float32)
    iters, work = {}, {}
    u32 = lambda mem, at: (mem[at[:, None] + np.arange(4)].astype(np.uint32)  # noqa: E731
                           << np.arange(0, 32, 8, dtype=np.uint32)).sum(axis=1, dtype=np.uint32)
    for b in rng.permutation(grid):
        for t0 in range(0, t_all, plan.chunk_trees):
            tc = min(plan.chunk_trees, t_all - t0)
            end = tc * tb
            smem = np.zeros(plan.chunk_trees * tb + fw.SINK_BYTES, np.uint8)
            smem[:end] = raw[t0 * tb:end + t0 * tb]
            smem[end:end + 8] = 0
            for tile in range(b, tiles, grid):
                slot = np.arange(tile_rows)
                row = tile * tile_rows + slot
                live = row < n
                r = np.where(live, row, 0)
                staged = flat[(r * f)[:, None] + np.arange(4 * nw)[None, :]].reshape(-1, nw, 4)
                staged = (staged.astype(np.uint32) << np.arange(0, 32, 8, dtype=np.uint32)).sum(
                    axis=2, dtype=np.uint32)
                for q, nanw, mask in nan_words:
                    wv = staged[:, q]
                    eq = np.zeros_like(wv)
                    for s in (0, 8, 16, 24):
                        eq |= np.where(((wv >> s) & 0xFF) == ((nanw >> s) & 0xFF),
                                       np.uint32(0xFF << s), np.uint32(0))
                    staged = np.concatenate([staged, (wv & ~(eq & mask))[:, None]], axis=1)
                stash = np.full((tc, tile_rows), np.nan, np.float32)
                thread_steps, trees_of = [None] * plan.groups, [None] * plan.groups
                for g in range(plan.groups):
                    go = live & (g < tc)
                    base = np.where(go, g * tb, end).astype(np.int64)
                    tt = np.full(tile_rows, g)
                    node = base.copy()
                    steps = np.zeros(tile_rows, np.int64)
                    while (base < end).any():
                        steps += base < end
                        x, y = u32(smem, node), u32(smem, node + 4)
                        word = _prmt(x, np.zeros_like(x), np.full_like(x, 0x4442))
                        wv = staged[slot, word.astype(np.int64)]
                        # a categorical node: the feature's byte v of the
                        # word, then bit v & 31 of word v >> 5 of its bitset
                        is_cat = (x & 0xFF) == fw.CAT_MARKER
                        v = _prmt(wv, np.zeros_like(wv),
                                  (0x4440 | ((x >> 8) & 3)).astype(np.uint32)).astype(np.int64)
                        o = (((x >> 10) & 0x3F) | ((x >> 24) << 6)).astype(np.int64)
                        bits = u32(smem, np.where(is_cat, base + 4 * o + 4 * (v >> 5), 0))
                        gl = np.where(is_cat, ((bits >> (v & 31).astype(np.uint32)) & 1) != 0,
                                      _prmt(wv, x, x) <= x)
                        c = _prmt(y, np.zeros_like(y),
                                  np.where(gl, 0x4410, 0x4432).astype(np.uint32)).astype(np.int64)
                        leaf = c >= 8 * m
                        val = u32(smem, np.where(leaf, base + c, 0)).view(np.float32)
                        hit = np.nonzero(leaf)[0]
                        stash[tt[hit], hit] = val[hit]
                        tt = np.where(leaf, tt + plan.groups, tt)
                        base = np.where(leaf, np.minimum(base + plan.groups * tb, end), base)
                        node = np.where(leaf, base, base + c)
                    # a thread's loop runs until both its rows are parked
                    thread_steps[g] = steps.reshape(fw.ROWS_PER_THREAD, group_threads).max(axis=0)
                    trees_of[g] = np.arange(g, tc, plan.groups)
                # a warp's loop runs until its 32 threads' loops end (threads
                # g * group_threads + lane; a warp may span groups)
                flat_steps = np.concatenate(thread_steps)
                for w in range(plan.threads // 32):
                    members = [(t // group_threads, t % group_threads)
                               for t in range(32 * w, 32 * w + 32)]
                    iters[(tile, t0, w)] = int(flat_steps[32 * w:32 * w + 32].max())
                    work[(tile, t0, w)] = [
                        (g, row[[lane + j * group_threads for j in range(fw.ROWS_PER_THREAD)]],
                         trees_of[g]) for g, lane in members]
                acc = np.zeros((tile_rows, k), np.float32)
                if t0 > 0:
                    acc[live] = out[row[live]]
                for u in range(tc):  # each row adds its stashed values in tree order
                    cls = (t0 + u) % k
                    acc[live, cls] = acc[live, cls] + stash[u, live]
                out[row[live]] = acc[live]
    return out, iters, work


@pytest.mark.parametrize("f,k,sms,grid,n,max_groups", [
    (28, 1, 2, 3, 1000, 1), (28, 3, 1, 2, 1000, 1), (100, 1, 1, 1, 1000, 1),
    (13, 2, 4, 64, 1000, 32), (28, 1, 132, 7, 1000, 32), (100, 3, 132, 5, 1000, 32)])
def test_schedule_model_equals_plain_walker(f, k, sms, grid, n, max_groups):
    """The model of the kernel's schedule, at the plan walk_plan picks (trees
    of up to 1,000 leaves, so a chunk holds fewer trees than the forest; rows
    of 13 to 100 features with NaN-left words; one group of threads, or
    many groups on a tile's rows, each walking every groups-th tree), in
    random block orders and grids of fewer blocks than
    tiles, gives the plain walker's scores to the bit (each row adds its
    trees in tree order, carried across chunks in out); a warp's loop runs
    as long as its rows' largest sum of depths over its trees, no longer
    than the lockstep walk of the same rows."""
    leaves = [1000, 1, 700, 1000, 1000, 2, 900, 1000, 1000, 800, 1000, 1000, 600, 1000, 3, 1000,
              1000, 1000, 950, 1000, 1000, 1000]
    bins, recs, nanb = random_case(f * 10 + k, n, f, leaves, nbins=200)
    tables = build_tables(recs, nanb, "cpu")
    n_nan = int(tables.nan_words.shape[0])
    plan = fw._walk_plan(n, f, tables.n_trees, tables.m_nodes, tables.m_leaves, sms, n_nan,
                         max_groups)
    assert plan.chunk_trees < tables.n_trees and n_nan > 0
    assert (plan.groups > 1) == (max_groups > 1)
    batch = stack_bin_trees(recs, nanb, "cpu")
    want = predict_bins_raw(batch, torch.as_tensor(bins), k).numpy()
    leaves_of = predict_bins_leaves(batch, torch.as_tensor(bins)).numpy()
    width = max(len(r["leaf_value"]) for r in recs)
    depth = np.stack([np.pad(leaf_depths(r), (0, width - len(r["leaf_value"]))) for r in recs])
    row_depth = depth[np.arange(len(recs))[None, :], leaves_of]  # [n, T]
    for seed in range(2):
        got, iters, work = model_walk(bins, tables, k, plan, grid, np.random.default_rng(seed))
        assert got.tobytes() == want.tobytes()
    for key, n_iter in iters.items():
        longest, lockstep = 0, {}
        for g, rows, trees in work[key]:
            rows = rows[rows < n]
            if len(rows) == 0 or len(trees) == 0:
                continue
            d = row_depth[rows][:, key[1] + trees]
            longest = max(longest, int(d.sum(axis=1).max()))
            lockstep[g] = np.maximum(lockstep.get(g, 0), d.max(axis=0))
        assert n_iter == longest
        assert n_iter <= max([int(v.sum()) for v in lockstep.values()] + [0])


@pytest.mark.parametrize("f,sms,grid,max_groups", [(28, 2, 3, 1), (13, 132, 7, 32)])
def test_schedule_model_walks_categorical_nodes(f, sms, grid, max_groups):
    """The kernel's schedule on a forest with categorical nodes (every other
    node, ``bench_forest_walk.categorize``; the bitsets after the leaf
    values, staged with the tree) and rows in bin 255, the predict sentinel
    that no mask holds: the plain walker's scores to the bit, which are the
    walk of the records themselves."""
    leaves = [300, 1, 255, 40, 300, 2, 255, 300]
    bins, recs, nanb = random_case(f, 1000, f, leaves, nbins=200)
    bins[::7, :] = 255
    recs = categorize(recs, seed=f)
    tables = build_tables(recs, nanb, "cpu")
    assert tables.m_cat > 0
    plan = fw._walk_plan(1000, f, tables.n_trees, tables.m_nodes,
                         tables.m_leaves + 8 * tables.m_cat, sms,
                         int(tables.nan_words.shape[0]), max_groups)
    want = predict_bins_raw(stack_bin_trees(recs, nanb, "cpu"), torch.as_tensor(bins), 1)
    assert torch.equal(forest_walk(torch.as_tensor(bins), tables, 1), want)
    got, _, _ = model_walk(bins, tables, 1, plan, grid, np.random.default_rng(0))
    assert got.tobytes() == want.numpy().tobytes()


def test_walk_plan():
    """The launch plan at the bench's shapes: the Higgs forest (254 nodes,
    256 leaves a tree, 10 or 500 trees) on 1,048,576 rows takes 512-thread
    blocks of one group; a 4,096-row batch takes 32 groups of 16 threads
    on 32-row tiles (one group alone: 32-thread blocks); F = 242 and 512
    take tiles of fewer rows, so that the staged words stay within
    BIN_SHARED, and one group (at 4,096 rows F = 512 takes 32 groups too);
    the largest admitted tree fits a
    chunk (a block of the most shared memory at the widest rows with every
    word NaN-left too)."""
    assert fw.walk_plan(1 << 20, 28, 10, 254, 256, 132) == fw.WalkPlan(512, 10, 1)
    assert fw.walk_plan(1 << 20, 28, 500, 254, 256, 132) == fw.WalkPlan(512, 28, 1)
    assert fw.walk_plan(4096, 28, 500, 254, 256, 132) == fw.WalkPlan(512, 36, 32)
    assert fw._walk_plan(4096, 28, 500, 254, 256, 132, 0, 1) == fw.WalkPlan(32, 37, 1)
    assert fw.walk_plan(1 << 20, 28, 500, 254, 256, 132, 7) == fw.WalkPlan(512, 19, 1)
    assert fw.walk_plan(1 << 20, 242, 100, 254, 256, 132) == fw.WalkPlan(128, 17, 1)
    assert fw.walk_plan(1 << 20, 512, 100, 254, 256, 132) == fw.WalkPlan(64, 16, 1)
    assert fw.walk_plan(4096, 512, 100, 254, 256, 132) == fw.WalkPlan(512, 31, 32)
    # the largest tree walk_reject_reason admits: 4,095 nodes and 4,096 leaves
    assert fw.walk_plan(1 << 20, 512, 3, 4096, 4096, 132, 128) == fw.WalkPlan(32, 1, 1)
    with pytest.raises(ValueError):
        fw.walk_plan(100, 512, 3, 32768, 8192, 132)


def _c_entry_accepts(plan, n, f, n_trees, m_nodes, m_leaves, n_nan):
    """Walk::valid() and Walk::shared() of csrc/forest_walk.cu for a plan:
    the launch's own checks, and its shared memory within a block's most."""
    threads, chunk, groups = plan
    tile_rows = threads // groups * fw.ROWS_PER_THREAD
    shared = (chunk * (8 * m_nodes + 4 * m_leaves) + fw.SINK_BYTES
              + tile_rows * (-(-f // 4) + n_nan) * 4
              + (chunk * tile_rows * 4 if groups > 1 else 0))
    return (32 <= threads <= fw.MAX_THREADS and threads % 32 == 0 and groups >= 1
            and threads % groups == 0 and 1 <= chunk <= n_trees
            and shared <= fw.MAX_BLOCK_SHARED)


@pytest.mark.parametrize("f", [13, 28, 242, 512])
def test_walk_plan_meets_the_c_entrys_checks(f):
    """Every plan the wrapper can ask for passes the C entry's checks
    (threads a multiple of 32 and of the groups, shared memory within a
    block's most), for every n up to 2^20 on 132, 114 and 16
    multiprocessors, with and without NaN-left words, for the Higgs trees,
    single-leaf trees and the largest admitted tree.  The plan depends on n
    only through ceil(n / (2 * ROWS_PER_THREAD * sms)), so one n for each of
    its values covers every n.  140,000 and 240,000 rows on 132
    multiprocessors once gave 272 and 464 threads (a lone group of an odd
    number of half warps), which the C entry refuses."""
    assert fw.walk_plan(140_000, 28, 10, 254, 256, 132) == fw.WalkPlan(288, 10, 1)
    assert fw.walk_plan(240_000, 28, 10, 254, 256, 132) == fw.WalkPlan(480, 10, 1)
    rng = np.random.default_rng(f)
    for sms in (132, 114, 16):
        per = 2 * fw.ROWS_PER_THREAD * sms
        ns = list(range(per, 1 << 20, per)) + [1, 1 << 20]
        for n_nan in (0, -(-f // 4)):
            for m_nodes, m_leaves, n_trees in ((254, 256, 500), (2, 4, 7), (4096, 4096, 3)):
                for n in ns:
                    plan = fw.walk_plan(n, f, n_trees, m_nodes, m_leaves, sms, n_nan)
                    assert _c_entry_accepts(plan, n, f, n_trees, m_nodes, m_leaves, n_nan), (
                        n, f, sms, n_nan, m_nodes, plan)
                    one = fw._walk_plan(n, f, n_trees, m_nodes, m_leaves, sms, n_nan, 1)
                    assert one.groups == 1
                    assert _c_entry_accepts(one, n, f, n_trees, m_nodes, m_leaves, n_nan)
                # n enters only through its count of tiles' rows a thread
                for n in rng.integers(1, 1 << 20, 20):
                    top = -(-int(n) // per) * per
                    assert (fw.walk_plan(int(n), f, n_trees, m_nodes, m_leaves, sms, n_nan)
                            == fw.walk_plan(top, f, n_trees, m_nodes, m_leaves, sms, n_nan))


def test_kernel_source_constants_and_no_float_atomics():
    """The constants walk_plan mirrors are the source's, the C entry takes
    the arguments of _build.SIGNATURES, and no atomicAdd in the source adds
    a float (each row adds its own trees in registers)."""
    def const(name):
        return int(re.search(r"constexpr int %s = (\d+);" % name, SRC).group(1))

    assert int(re.search(r"#define FW_ROWS (\d+)", SRC).group(1)) == fw.ROWS_PER_THREAD
    assert "constexpr int kRows = FW_ROWS;" in SRC
    assert const("kMaxThreads") == fw.MAX_THREADS
    assert const("kSinkBytes") == fw.SINK_BYTES
    assert const("kMaxF") == fw.MAX_F
    # the checks _c_entry_accepts mirrors
    valid = re.search(r"bool valid\(\) const \{(.*?)\}", SRC, re.S).group(1)
    for rule in ("threads >= 32", "threads <= kMaxThreads", "threads % 32 == 0",
                 "chunk_trees >= 1", "groups >= 1", "threads % groups == 0"):
        assert rule in valid
    assert "(groups > 1 ? (size_t)chunk_trees * tile_rows() * 4 : 0)" in SRC
    code = re.sub(r"//[^\n]*", "", SRC)
    assert len(re.findall(r"\batomicAdd\s*\(", code)) == len(
        re.findall(r"\batomicAdd\s*\(\s*&\s*\w+\s*\[", code))
    assert not atomic_types(code) & {"float", "double", "half", "?"}
    decl = re.search(r'extern "C" int lgbt_forest_walk\(([^)]*)\)', SRC).group(1)
    assert len(decl.split(",")) == len(_build.SIGNATURES["forest_walk"])
