"""The forest walk (``csrc/forest_walk.cu``) on the card: its cases, its
check against the plain walker, and its time against another build of it.

Run from the root of a checkout, on a machine with the card::

    python3 -m lightgbm_tpu_torch.bench_forest_walk [--baseline OTHER.cu]
        [--variant NAME=FLAGS ...] [--sass FILE]
        [--reps N]

It makes bins on the card from a seed (uniform over 255 bins a feature) and
forests of 255-leaf trees grown best-first on the first 16,384 rows
(``grow_forest``: the leaf with the most rows splits next, on a random
feature at a random quantile of its rows, default-left at random), and
prints their mean levels walked a (row, tree) (8.6 on the Higgs model that
``chip_smoke.py`` trains).  Cases, at F = 28 unless named: 1,048,576 rows
x 10 trees (the smoke's forest), x 100 (LightGBM's default
``num_iterations``), x 500 (the Higgs run of the reference's
``docs/Experiments.rst``), 4,096 rows x 500 (a served batch), and
1,048,576 rows x 100 at F = 242 and F = 512.  Every build's scores are
checked bit-equal to ``forest_walk_plain`` (walked in blocks of rows);
then the builds are timed in turns (baseline, this source, variants, then
the reverse order) by CUDA events and by device time alone under
torch.profiler, with the device operations a call, beside the bound (the
bins, tables and scores' bytes once over the HBM rate, or the levels
walked over the f32 rate if that is larger).  ``this, one group`` is this
source's C entry at the plan of one group of threads a block
(``_walk_plan`` with one group), where the plan would put several groups
on a tile.

Edge cases, checked only: single-leaf trees among full ones; 30% of the
rows in their feature's NaN bin with default-left nodes on both sides (at
F = 28 and F = 100); the largest tree ``walk_reject_reason`` admits (4,095
nodes, 4,096 leaves; at F = 28 and F = 512, where a chunk holds one tree);
row counts that are not a multiple of a tile, and 140,000 and 240,000
rows (whose tiles want an odd number of half warps on 132
multiprocessors); three classes.

Categorical nodes (``categorize``): ``1,048,576 x 100, half categorical``
is the x 100 forest with every other node made categorical, its 256-bit
mask a random set of as many bins as its threshold sent left (so a row's
depth is spread as the numeric forest's), timed beside that numeric forest
on this source's builds; its edge case: 30 trees, every node categorical,
10% of the rows in bin 255 (predict's sentinel of an unseen category,
which no mask holds), checked.

``--other NAME=SOURCE`` builds another forest_walk.cu of this C interface
(for example the parent commit's) and times it on the numeric cases.
``--baseline`` builds another source with the C interface of the earlier
design (node, child and leaf tables of one i32 a node each, the launch
plan in the C entry) into a temporary directory and walks tables of that
encoding; ``--variant`` builds this source with extra compiler flags (for
example ``rows1=-DFW_ROWS=1``: one row a thread); ``--sass`` writes this
build's SASS (``cuobjdump -sass``) to a file.
"""

from __future__ import annotations

import argparse
import ctypes
import heapq
import json
import os
import statistics
import subprocess
import sys
import tempfile
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import _build
from ._bench import HBM_BYTES_PER_S, build_library, card_line, device_profile, time_ms
from .ops import forest_walk as fw
from .predict import predict_bins_leaves

F32_OPS_PER_S = 67e12
BINS = 255  # bins a feature
LEAVES = 255
SAMPLE = 16_384  # rows the synthetic trees are grown on
ROWS = 1 << 20
PLAIN_BLOCK = 1 << 17  # rows the plain walker takes at a time


# ------------------------------------------------------------------ data
def make_bins(n: int, f: int, dev, seed: int, nan_share: float = 0.0):
    """(bins [n, f] u8 on the card, nan_bins [f]): uniform over BINS - 1
    value bins; with ``nan_share``, every other feature's bin BINS - 1 is
    its NaN bin, which that share of its rows sit in."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bins = torch.randint(0, BINS - 1, (n, f), generator=gen, device=dev, dtype=torch.uint8)
    nan_bins = np.full(f, -1, np.int64)
    if nan_share > 0:
        nan_bins[1::2] = BINS - 1
        nan_rows = torch.rand((n, f), generator=gen, device=dev) < nan_share
        nan_rows &= torch.as_tensor(nan_bins >= 0, device=dev)[None, :]
        bins[nan_rows] = BINS - 1
    return bins, nan_bins


def grow_tree(sample: np.ndarray, n_leaves: int, rng) -> dict:
    """A bin-space record grown best-first on ``sample`` [S, F]: the leaf
    with the most rows splits next, on a random feature at a random
    quantile (0.2-0.8) of its rows' bins; default_left at random; leaf
    values normal."""
    f = sample.shape[1]
    sf, sb, dl, lc, rc = [], [], [], [], []
    rows = {0: np.arange(len(sample))}
    slot = {0: None}  # leaf -> (node, side) that points at it
    heap = [(-len(sample), 0)]
    n_leaf = 1
    while n_leaf < n_leaves and heap:
        _, j = heapq.heappop(heap)
        idx = rows[j]
        for _ in range(8):
            feat = int(rng.integers(f))
            vals = sample[idx, feat]
            thr = int(np.quantile(vals, rng.uniform(0.2, 0.8), method="lower"))
            go_left = vals <= thr
            if 0 < int(go_left.sum()) < len(idx):
                break
        else:
            continue  # a leaf whose rows no split separates stays a leaf
        node = len(sf)
        sf.append(feat)
        sb.append(thr)
        dl.append(bool(rng.random() < 0.5))
        if slot[j] is not None:
            (lc if slot[j][1] == 0 else rc)[slot[j][0]] = node
        lc.append(~j)
        rc.append(~n_leaf)
        rows[j], rows[n_leaf] = idx[go_left], idx[~go_left]
        slot[j], slot[n_leaf] = (node, 0), (node, 1)
        for leaf in (j, n_leaf):
            if len(rows[leaf]) > 1:
                heapq.heappush(heap, (-len(rows[leaf]), leaf))
        n_leaf += 1
    return {
        "split_feature": np.asarray(sf, np.int32), "split_bin": np.asarray(sb, np.int32),
        "default_left": np.asarray(dl, bool), "left_child": np.asarray(lc, np.int32),
        "right_child": np.asarray(rc, np.int32),
        "leaf_value": (rng.normal(size=n_leaf) * 0.1).astype(np.float32),
    }


def grow_forest(bins: torch.Tensor, n_trees: int, seed: int, n_leaves: int = LEAVES) -> List[dict]:
    sample = bins[:SAMPLE].cpu().numpy()
    rng = np.random.default_rng(seed)
    return [grow_tree(sample, n_leaves, rng) for _ in range(n_trees)]


def categorize(records: Sequence[dict], seed: int, every: int = 2) -> List[dict]:
    """The records with every ``every``-th node categorical: its goes-left
    mask [256] a random set of threshold + 1 of the BINS - 1 value bins
    (the share of uniform rows its threshold sent left); bin 255 never in
    a mask."""
    rng = np.random.default_rng(seed)
    out = []
    for r in records:
        n = len(r["split_feature"])
        is_cat = (np.arange(n) % every) == 0
        mask = np.zeros((n, 256), bool)
        for i in np.flatnonzero(is_cat):
            mask[i, rng.choice(BINS - 1, size=int(r["split_bin"][i]) + 1, replace=False)] = True
        out.append({**r, "split_is_cat": is_cat, "cat_mask": mask,
                    "default_left": np.where(is_cat, False, r["default_left"])})
    return out


# ----------------------------------------------------------- reference
def leaf_depths(rec: dict) -> np.ndarray:
    """Levels a row walks to each leaf of a record (1 for a single leaf)."""
    lc, rc = rec["left_child"], rec["right_child"]
    depth = np.ones(len(rec["leaf_value"]), np.int64)
    stack = [(0, 1)] if len(lc) else []
    while stack:
        node, d = stack.pop()
        for c in (int(lc[node]), int(rc[node])):
            if c >= 0:
                stack.append((c, d + 1))
            else:
                depth[~c] = d
    return depth


def plain(bins: torch.Tensor, tables: fw.ForestTables, k: int) -> torch.Tensor:
    """``forest_walk_plain`` in blocks of PLAIN_BLOCK rows (rows are
    independent; the [rows, trees] leaves of one call would not fit)."""
    return torch.cat([fw.forest_walk_plain(bins[i:i + PLAIN_BLOCK], tables, k)
                      for i in range(0, bins.shape[0], PLAIN_BLOCK)])


def visits(bins: torch.Tensor, tables: fw.ForestTables, records: Sequence[dict]) -> float:
    """Levels walked over all (row, tree) pairs of these bins."""
    dev = bins.device
    width = tables.m_leaves
    depth = torch.as_tensor(np.stack([np.pad(leaf_depths(r), (0, width - len(r["leaf_value"])))
                                      for r in records]), device=dev)
    batch = fw.decode_tables(tables)
    trees = torch.arange(len(records), device=dev)[None, :]
    total = 0
    for i in range(0, bins.shape[0], PLAIN_BLOCK):
        total += int(depth[trees, predict_bins_leaves(batch, bins[i:i + PLAIN_BLOCK])].sum())
    return float(total)


def bound_ms(n: int, f: int, k: int, tables: fw.ForestTables, levels: float):
    """(ms, 'bytes' or 'operations'): the bins, the tables and the scores
    once over the HBM rate, or one operation a level walked over the f32
    rate."""
    nbytes = n * f + tables.tables.numel() * 4 + n * k * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = levels / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ launchers
def old_tables(records: Sequence[dict], nan_bins: np.ndarray, dev):
    """The earlier design's encoding: node [T, M] i32 thr | feat << 9 |
    dl << 18 | (nan_bin + 1) << 19, child [T, M] i32 left & 0xFFFF |
    right << 16, leaf [T, Lm] f32."""
    t = len(records)
    m = max([len(r["split_feature"]) for r in records] + [1])
    lm = max(len(r["leaf_value"]) for r in records)
    node = np.zeros((t, m), np.int64)
    child = np.zeros((t, m), np.int64)
    leaf = np.zeros((t, lm), np.float32)
    for i, r in enumerate(records):
        sf = np.asarray(r["split_feature"], np.int64)
        leaf[i, :len(r["leaf_value"])] = r["leaf_value"]
        if len(sf) == 0:
            child[i, 0] = 0xFFFFFFFF
            continue
        node[i, :len(sf)] = (np.asarray(r["split_bin"], np.int64) | (sf << 9)
                             | (np.asarray(r["default_left"], np.int64) << 18)
                             | ((nan_bins[sf] + 1) << 19))
        child[i, :len(sf)] = ((np.asarray(r["left_child"], np.int64) & 0xFFFF)
                              | ((np.asarray(r["right_child"], np.int64) & 0xFFFF) << 16))
    as_i32 = lambda a: torch.as_tensor(a.astype(np.uint32).view(np.int32), device=dev)  # noqa: E731
    return as_i32(node), as_i32(child), torch.as_tensor(leaf, device=dev)


def baseline_launcher(lib: str) -> Callable:
    """The earlier design's C entry (node, child, leaf tables; its own
    launch plan) on tables of its encoding, made once a forest."""
    fn = ctypes.CDLL(lib).lgbt_forest_walk
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [vp] * 4 + [i64] + [i32] * 5 + [vp] * 2
    fn.restype = ctypes.c_int
    made: Dict[int, tuple] = {}

    def prepare(case):
        made[id(case)] = old_tables(case["records"], case["nan_bins"], case["bins"].device)

    def launch(case):
        node, child, leaf = made[id(case)]
        bins, k = case["bins"], case["k"]
        n, f = bins.shape
        out = torch.empty((n, k), dtype=torch.float32, device=bins.device)
        rc = fn(bins.data_ptr(), node.data_ptr(), child.data_ptr(), leaf.data_ptr(), n, f,
                node.shape[0], node.shape[1], leaf.shape[1], k, out.data_ptr(),
                torch.cuda.current_stream(bins.device).cuda_stream)
        _build.check(rc, "forest_walk (the baseline build)")
        return out

    launch.prepare = prepare
    return launch


def this_launcher(fn=None, max_groups: int = fw.MAX_GROUPS) -> Callable:
    """The wrapper (``fn`` None), or this source's C entry ``fn`` of a build
    at the plan of at most ``max_groups`` groups of threads (``walk_plan``'s
    at ``fw.MAX_GROUPS``; 1: one group of threads a block at every size)."""
    def launch(case):
        bins, tables, k = case["bins"], case["tables"], case["k"]
        if fn is None:
            return fw.forest_walk(bins, tables, k)
        n, f = bins.shape
        plan = plan_of(case, max_groups)
        out = torch.empty((n, k), dtype=torch.float32, device=bins.device)
        rc = fn(bins.data_ptr(), tables.tables.data_ptr(), tables.nan_words.data_ptr(), n, f,
                tables.nan_words.shape[0], tables.n_trees, tables.m_nodes,
                tables.m_leaves + 8 * tables.m_cat, k, plan.threads, plan.chunk_trees,
                plan.groups, out.data_ptr(), torch.cuda.current_stream(bins.device).cuda_stream,
                int(tables.m_cat > 0))
        _build.check(rc, "forest_walk (a variant build)")
        return out

    launch.prepare = lambda case: None
    return launch


def plan_of(case, max_groups: int = fw.MAX_GROUPS) -> fw.WalkPlan:
    bins, tables = case["bins"], case["tables"]
    return fw._walk_plan(bins.shape[0], bins.shape[1], tables.n_trees, tables.m_nodes,
                         tables.m_leaves + 8 * tables.m_cat, fw.sm_count(bins.device),
                         tables.nan_words.shape[0], max_groups)


def _c_entry(lib: str):
    fn = ctypes.CDLL(lib).lgbt_forest_walk
    fn.argtypes, fn.restype = list(_build.SIGNATURES["forest_walk"]), ctypes.c_int
    return fn


# ---------------------------------------------------------------- cases
def case(bins, records, nan_bins, k: int = 1) -> dict:
    return {"bins": bins, "records": records, "nan_bins": nan_bins, "k": k,
            "tables": fw.build_tables(records, nan_bins, bins.device)}


def check(name: str, c: dict, builds: Dict[str, Callable], want: torch.Tensor) -> None:
    """Every build's scores bit-equal to the plain walker's; raises."""
    for bname, launch in builds.items():
        launch.prepare(c)
        got = launch(c)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            diff = int((got != want).sum())
            raise AssertionError(f"forest_walk {name}: the {bname} build differs from the plain "
                                 f"walker on {diff} scores (max |err| "
                                 f"{float((got - want).abs().max()):.3g})")


def run_case(name: str, c: dict, builds: Dict[str, Callable], reps: int) -> Dict[str, float]:
    """Checks, then every build's times of one call, beside the bound."""
    bins, tables, k = c["bins"], c["tables"], c["k"]
    n, f = bins.shape
    check(name, c, builds, plain(bins, tables, k))
    levels = visits(bins, tables, c["records"])
    active = builds
    times: Dict[str, List[float]] = {}
    order = list(active) + list(active)[::-1]
    for bname in order:
        launch = active[bname]
        times.setdefault(f"{bname} event", []).append(
            time_ms(lambda: launch(c), reps=reps))
    res = {key: statistics.median(v) for key, v in times.items()}
    for bname, launch in active.items():
        res[f"{bname} device"], res[f"{bname} ops"] = device_profile(lambda: launch(c), reps=5)
    res["bound"], by = bound_ms(n, f, k, tables, levels)
    res["bound by operations"] = float(by == "operations")
    res["levels a row-tree"] = levels / (n * tables.n_trees)
    print(f"case {name}: {n} rows x {f} features, {tables.n_trees} trees; plan "
          f"{tuple(plan_of(c))}; {res['levels a row-tree']:.3f} levels a row-tree; bound "
          f"{res['bound']:.5f} ms by {by}; "
          + ", ".join(f"{key} {v:.4f}" for key, v in res.items()
                      if key not in ("bound", "bound by operations", "levels a row-tree"))
          + "; every build bit-equal to forest_walk_plain")
    return res


def edge_cases(dev, builds: Dict[str, Callable]) -> None:
    """The edge cases of the module docstring, checked, not timed."""
    rng = np.random.default_rng(7)
    bins, nanb = make_bins(100_000, 28, dev, seed=11)
    sample = bins[:SAMPLE].cpu().numpy()
    recs = [grow_tree(sample, 1 if i % 2 == 0 else LEAVES, rng) for i in range(30)]
    c = case(bins, recs, nanb)
    check("single-leaf trees", c, builds, plain(bins, c["tables"], 1))
    print("edge case single-leaf trees: 15 of 30 trees a single leaf, 100,000 rows: bit-equal")
    for f in (28, 100):
        bins, nanb = make_bins(262_144, f, dev, seed=12 + f, nan_share=0.3)
        recs = grow_forest(bins, 50, seed=f)
        assert any(r["default_left"].any() and (~r["default_left"]).any() for r in recs)
        c = case(bins, recs, nanb)
        check(f"NaN F={f}", c, builds, plain(bins, c["tables"], 1))
        print(f"edge case 30% NaN, default-left both sides, F = {f}, 262,144 rows x 50 trees: "
              "bit-equal")
    for f in (28, 512):
        bins, nanb = make_bins(100_000, f, dev, seed=13)
        recs = grow_forest(bins, 3, seed=3, n_leaves=4096)
        assert max(len(r["split_feature"]) for r in recs) == 4095
        assert fw.walk_reject_reason(recs, nanb, f, 256) is None
        c = case(bins, recs, nanb)
        check(f"largest tree F={f}", c, builds, plain(bins, c["tables"], 1))
        plan = plan_of(c)
        print(f"edge case largest admitted tree (4,095 nodes, 4,096 leaves), F = {f}, "
              f"{plan.chunk_trees} tree(s) a chunk: bit-equal")
    bins, nanb = make_bins(ROWS - 333, 28, dev, seed=14)
    recs = grow_forest(bins, 10, seed=14)
    c = case(bins, recs, nanb)
    check("ragged rows", c, builds, plain(bins, c["tables"], 1))
    c = case(bins[:4096 + 17], grow_forest(bins, 60, seed=15), nanb)
    check("ragged batch", c, builds, plain(c["bins"], c["tables"], 1))
    print(f"edge case rows not a multiple of a tile: {ROWS - 333} x 10 trees, 4,113 x 60: "
          "bit-equal")
    # row counts whose tiles want an odd number of half warps a block (on
    # 132 multiprocessors): the plan rounds such a lone group to whole warps
    for n in (140_000, 240_000):
        c = case(bins[:n], recs, nanb)
        check(f"{n} rows", c, builds, plain(c["bins"], c["tables"], 1))
        print(f"edge case {n} rows x 10 trees, plan {tuple(plan_of(c))}: bit-equal")
    for f in (28, 100):
        bins, nanb = make_bins(100_003, f, dev, seed=16, nan_share=0.1)
        c = case(bins, grow_forest(bins, 99, seed=16), nanb, k=3)
        check(f"3 classes F={f}", c, builds, plain(bins, c["tables"], 3))
    print("edge case 3 classes (99 trees, class t % 3), F = 28 and 100: bit-equal")
    cat_builds = {k: v for k, v in builds.items() if k.startswith("this")}
    bins, nanb = make_bins(100_000, 28, dev, seed=17)
    bins[torch.rand(bins.shape, device=dev) < 0.1] = BINS  # the sentinel bin 255
    c = case(bins, categorize(grow_forest(bins, 30, seed=17), seed=17, every=1), nanb)
    check("categorical, sentinel rows", c, cat_builds, plain(bins, c["tables"], 1))
    print("edge case 30 trees, every node categorical, 10% of the bins 255 (the sentinel): "
          "bit-equal")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline",
                    help="a forest_walk.cu of the earlier design to time beside this one")
    ap.add_argument("--sass", help="write this build's SASS to this file")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAGS: this source built with extra nvcc flags")
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=SOURCE: another forest_walk.cu of this C interface")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_forest_walk: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    took = _build.build_all(["forest_walk"])
    for name, (secs, report) in sorted(took.items()):
        print(f"build {name}: {secs:.1f} s; ptxas: {report}")
    builds: Dict[str, Callable] = {}
    tmp = tempfile.mkdtemp(prefix="forest_walk_bench_")
    if args.baseline:
        lib, report = build_library(args.baseline, [], tmp)
        print(f"build baseline: ptxas: {report}")
        builds["baseline"] = baseline_launcher(lib)
    builds["this"] = this_launcher()
    builds["this, one group"] = this_launcher(_build.entry("forest_walk"), max_groups=1)
    src = f"{_build.CSRC}/forest_walk.cu"
    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
        with open(args.sass, "w") as fh:
            subprocess.run([cuobjdump, "-sass", os.path.join(_build.BUILD, "libforest_walk.so")],
                           stdout=fh, check=True)
    extra = [(name, path, []) for name, _, path in (v.partition("=") for v in args.other)]
    extra += [(name, src, flags.split())
              for name, _, flags in (v.partition("=") for v in args.variant)]
    for vname, vsrc, flags in extra:
        lib, report = build_library(vsrc, flags, tmp)
        print(f"build {vname}: ptxas: {report}")
        builds[vname] = this_launcher(_c_entry(lib))
    results = {}
    bins, nanb = make_bins(ROWS, 28, dev, seed=1)
    forest = grow_forest(bins, 500, seed=1)
    for name, n, t in (("1,048,576 x 10", ROWS, 10), ("1,048,576 x 100", ROWS, 100),
                       ("1,048,576 x 500", ROWS, 500), ("4,096 x 500", 4096, 500)):
        results[name] = run_case(name, case(bins[:n], forest[:t], nanb), builds, args.reps)
    # categorical nodes: this source's builds (variants included), beside
    # the numeric forest of the same trees
    cat_builds = {k: v for k, v in builds.items()
                  if k.startswith("this") or k in {n for n, _, _ in (
                      v.partition("=") for v in args.variant)}}
    name = "1,048,576 x 100, half categorical"
    results[name] = run_case(name, case(bins, categorize(forest[:100], seed=2), nanb),
                             cat_builds, args.reps)
    del bins
    for f in (242, 512):
        bins, nanb = make_bins(ROWS, f, dev, seed=f)
        name = f"1,048,576 x 100, F = {f}"
        results[name] = run_case(name, case(bins, grow_forest(bins, 100, seed=f), nanb), builds,
                                 args.reps)
        del bins
        torch.cuda.empty_cache()
    edge_cases(dev, builds)
    print(json.dumps({"card": card, "cases": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
