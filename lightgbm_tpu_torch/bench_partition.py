"""The stable partition kernel (``csrc/partition.cu``) on the card: its
cases, its check against the plain versions, and its time against another
build of it and against PyTorch calls that compute the same function.

Run from the root of a checkout, on a machine with the card::

    python3 -m lightgbm_tpu_torch.bench_partition [--baseline OTHER.cu]
        [--variant NAME=-DMACRO=VALUE ...] [--rows N] [--reps N]

It makes seg rows on the card from a seed (``synthetic_rows``: u8 bins
``[F, n]``, feature j with 208-256 bins of which the last is its NaN bin
holding ~2% of the rows, bin 0 left empty; g, h, m f32; ridx i32), then for
each case below checks every build against the plain version
(``sort_partition_batch_plain``): nl exact and every column of the whole
rows byte-equal after the call (the windows partitioned, the rows outside
them untouched).  It times the builds in turns (baseline, this source,
variants, ..., then the reverse order) by CUDA events, one call at a time
with the rows restored before each call outside the events, and each
build's device time alone under torch.profiler (``device``; the restore
left out), with its device operations per call.  Beside each case:

* ``bound``: the windows' rows read once and written once,
  2 * rows * (F + 16) bytes over the card's HBM rate;
* ``sort``: one stable ``torch.sort`` of the go-left keys (one u8 key a
  row; (window, goes right) i32 keys for K windows): the permutation only;
* ``composite``: that sort, then ``index_select`` of the windows' bins
  (dim 1) and of g, h, m and ridx, then ``copy_`` back into each window:
  the same function through PyTorch calls.

Cases (``cases``): the root at 1,048,576 x 28 (Higgs shape) split at a
median bin; K=4 windows laid out as chip_smoke.py's ``k4_members``
(1,045,576 rows, one window empty); one window of 16,384 rows and one of
4,096 rows, each at an unaligned start; K=16 windows of 4,096 rows; the
root at F = 242, the widest table the seg layout takes.  The edge cases
(``edge_cases``: every row left, every row right, an empty window among K,
windows of fewer than 32 rows, a NaN-bin split with missing values left)
are checked, not timed.

``--baseline`` builds another version of the source with the C interface
of the earlier design (four launches over wrapper-allocated scratch, as
its wrapper called it) into a temporary directory; ``--variant`` builds
this source with extra compiler flags.  chip_smoke.py checks the same cases
on this build alone, through the wrappers.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import sys
import tempfile
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import _build
from ._bench import (HBM_BYTES_PER_S, build_library, card_line, device_by_name, device_profile,
                     time_ms)
from .ops import seg

ROOT_FEATURES = 28
WIDE_FEATURES = 242  # the seg layout's widest table (boosting/gbdt.py)
NAN_SHARE = 0.02


def synthetic_rows(n: int, f: int, dev, seed: int = 0):
    """(seg rows, [F] bins a feature): feature j has 208-256 bins; its
    values are uniform over bins 1 .. nb_j - 2 and ~2% of the rows sit in
    its NaN bin nb_j - 1 (bin 0 stays empty, so a split at bin 0 sends
    every non-NaN row right)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    nb = torch.randint(208, 257, (f, 1), generator=gen, device=dev)
    bins = torch.empty((f, n), dtype=torch.uint8, device=dev)
    step = max(1, (1 << 26) // max(f, 1))  # bound the f32 temporaries
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        u = torch.rand((f, hi - lo), generator=gen, device=dev)
        v = 1 + (u * (nb - 2).to(torch.float32)).to(torch.int64)
        nan = torch.rand((f, hi - lo), generator=gen, device=dev) < NAN_SHARE
        bins[:, lo:hi] = torch.where(nan, nb - 1, v).to(torch.uint8)
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev) + 0.01
    m = (torch.rand(n, generator=gen, device=dev) < 0.9).to(torch.float32)
    rows = seg.SegRows(bins, g, h, m, torch.arange(n, dtype=torch.int32, device=dev))
    return rows, nb[:, 0].cpu().numpy()


def _members(nb, starts, cnts, feats, dls, tbins=None) -> np.ndarray:
    """[K, 6] split members: each split at its feature's median bin unless
    ``tbins`` names the bins, the feature's NaN bin as nanb."""
    nb = np.asarray(nb)
    feats = [int(j) % len(nb) for j in feats]
    tb = [int(nb[j]) // 2 for j in feats] if tbins is None else tbins
    return seg.split_members(starts, cnts, feats, tb, dls, [int(nb[j]) - 1 for j in feats])


def cases(n: int, nb) -> Dict[str, np.ndarray]:
    """{name: [K, 6] members} of the timed cases at n rows (the root and
    chip_smoke.py's K=4 layout scale with n; the small windows do not)."""
    small = [(16_384, 12_345), (4_096, n // 3 + 5)]
    out = {
        "root": _members(nb, [0], [n], [3], [0]),
        "K=4": _members(nb, [37, n // 4 + 5, n // 4 + 5, n // 2 + 1001],
                        [n // 4 - 100, 0, n // 4 - 900, n // 2 - 2000], [3, 4, 4, 5],
                        [0, 0, 1, 0]),
    }
    for cnt, start in small:
        out[f"{cnt} rows"] = _members(nb, [start], [min(cnt, n - start)], [7], [1])
    out["K=16 x 4,096"] = _members(nb, [11 + i * (4_096 + 37) for i in range(16)],
                                   [4_096] * 16, range(16), [i % 2 for i in range(16)])
    return out


def edge_cases(n: int, nb) -> Dict[str, np.ndarray]:
    """{name: [K, 6] members} checked but not timed."""
    w = max(64, n // 16)
    return {
        "all left": _members(nb, [101], [w], [2], [0], tbins=[255]),
        "all right": _members(nb, [203], [w], [2], [0], tbins=[0]),
        "cnt 0 among K": _members(nb, [5, 9_000, 9_000, 20_000], [5_000, 0, 3_000, 17],
                                  [1, 2, 2, 3], [0, 1, 0, 1]),
        "cnt < 32": _members(nb, [3, 1_000, 2_000], [17, 31, 1], [4, 5, 6], [0, 0, 1]),
        "NaN bin left": _members(nb, [55], [w], [9], [1]),
    }


def bound_ms(f: int, mem: np.ndarray) -> float:
    """The windows' rows read once and written once: F bin bytes and four
    4-byte columns a row."""
    return 2 * int(mem[:, 1].sum()) * (f + 16) / HBM_BYTES_PER_S * 1e3


def window_rows(mem: np.ndarray, dev) -> torch.Tensor:
    """The windows' row indices, concatenated in member order (i64)."""
    return torch.cat([torch.arange(int(s), int(s) + int(c), device=dev)
                      for s, c in mem[:, :2]])


def sort_keys(rows: seg.SegRows, mem: np.ndarray) -> torch.Tensor:
    """One stable-sort key a window row: goes right (u8) for one window,
    2 * window + goes right (i32) for K."""
    keys = [(~seg.go_left(rows.bins[int(ft), int(s):int(s) + int(c)], int(tb), bool(dl),
                          int(nb))).to(torch.int32) + 2 * i
            for i, (s, c, ft, tb, dl, nb) in enumerate(mem)]
    out = torch.cat(keys)
    return out.to(torch.uint8) if len(mem) == 1 else out


def composite(rows: seg.SegRows, mem: np.ndarray, keys: torch.Tensor, idx: torch.Tensor) -> None:
    """The partition through PyTorch calls: the stable sort of the keys,
    the gathers of every column, the copies back into the windows."""
    src = idx[torch.sort(keys, stable=True).indices]
    spans, off = [], 0
    for s, c in mem[:, :2]:
        spans.append((int(s), int(c), off))
        off += int(c)
    bins = rows.bins.index_select(1, src)
    for s, c, o in spans:
        rows.bins[:, s:s + c].copy_(bins[:, o:o + c])
    for col in (rows.g, rows.h, rows.m, rows.ridx):
        vals = col.index_select(0, src)
        for s, c, o in spans:
            col[s:s + c].copy_(vals[o:o + c])


def _copy_rows(dst: seg.SegRows, src: seg.SegRows) -> None:
    for name in ("bins", "g", "h", "m", "ridx"):
        getattr(dst, name).copy_(getattr(src, name))


def _clone_rows(rows: seg.SegRows) -> seg.SegRows:
    return seg.SegRows(rows.bins.clone(), rows.g.clone(), rows.h.clone(), rows.m.clone(),
                       rows.ridx.clone())


def same_rows(a: seg.SegRows, b: seg.SegRows) -> bool:
    return all(torch.equal(getattr(a, c), getattr(b, c)) for c in ("bins", "g", "h", "m", "ridx"))


# ----------------------------------------------------------------- builds
_EARLIER_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                                              ctypes.c_int) + (ctypes.c_void_p,) * 8
_EARLIER_TILE = 1024


def earlier_launcher(lib: str) -> Callable:
    """A launch of a build of the earlier design's source (C entry
    ``lgbt_partition`` over scratch that the caller allocates on every
    call, as its wrapper did): (rows, members) -> nl [K] i32."""
    fn = ctypes.CDLL(lib).lgbt_partition
    fn.argtypes = list(_EARLIER_ARGTYPES)
    fn.restype = ctypes.c_int

    def launch(rows: seg.SegRows, mem: np.ndarray) -> torch.Tensor:
        k, f, dev = mem.shape[0], rows.f, rows.device
        total = int(mem[:, 1].sum())
        tiles = int(sum(-(-int(c) // _EARLIER_TILE) for c in mem[:, 1]))
        s_bins = torch.empty((f, total), dtype=torch.uint8, device=dev)
        s_g = torch.empty((total,), dtype=torch.float32, device=dev)
        s_h = torch.empty_like(s_g)
        s_m = torch.empty_like(s_g)
        s_ridx = torch.empty((total,), dtype=torch.int32, device=dev)
        tile_counts = torch.empty((max(tiles, 1),), dtype=torch.int32, device=dev)
        nl = torch.empty((k,), dtype=torch.int32, device=dev)
        rc = fn(rows.bins.data_ptr(), rows.g.data_ptr(), rows.h.data_ptr(), rows.m.data_ptr(),
                rows.ridx.data_ptr(), rows.n, f, mem.ctypes.data, k, s_bins.data_ptr(),
                s_g.data_ptr(), s_h.data_ptr(), s_m.data_ptr(), s_ridx.data_ptr(),
                tile_counts.data_ptr(), nl.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "partition (the earlier design)")
        return nl

    return launch


def _c_entry(lib: str):
    """The ``lgbt_partition`` entry of a build of this source's interface."""
    fn = ctypes.CDLL(lib).lgbt_partition
    fn.argtypes, fn.restype = list(_build.SIGNATURES["partition"]), ctypes.c_int
    return fn


def this_launcher(fn=None) -> Callable:
    """A launch of this source as its wrapper makes it, on members already
    checked (``fn``: the C entry of another build of it, else the repo's
    own)."""
    def launch(rows: seg.SegRows, mem: np.ndarray) -> torch.Tensor:
        return seg._partition_launch(rows, mem, "partition" if len(mem) == 1
                                     else "partition_batch", fn)

    return launch


def kernel_name(name: str) -> str:
    """A device operation's function name without its namespace and
    arguments ("partition_tile_kernel<1024>", "lane_hist_reduce<true>")."""
    m = re.search(r"(\w+(?:<[\w, ]+>)?)\(", name)
    return m.group(1) if m else name


def wrapper_launch(rows: seg.SegRows, mem: np.ndarray) -> torch.Tensor:
    """The public wrappers on the members: ``sort_partition`` for one,
    ``sort_partition_batch`` for K; nl [K] i32."""
    if len(mem) == 1:
        s, c, ft, tb, dl, nb = (int(v) for v in mem[0])
        return seg.sort_partition(rows, s, c, ft, tb, bool(dl), nb).reshape(1)
    return seg.sort_partition_batch(rows, *mem.T)


def run_case(name: str, rows: seg.SegRows, mem: np.ndarray, builds: Dict[str, Callable],
             reps: int, timed: bool = True, plain_reps: int = 0,
             kernels: bool = False) -> Dict[str, float]:
    """Check every build on one case (raises on a difference); with
    ``timed``, their times and the yardsticks (with ``plain_reps`` the
    plain version's time, with ``kernels`` each build's device time by
    kernel).  The rows are as they were when it returns."""
    pristine = _clone_rows(rows)
    want = _clone_rows(rows)
    nl_p = seg.sort_partition_batch_plain(want, mem)

    def restore():
        _copy_rows(rows, pristine)

    for bname, launch in builds.items():
        restore()
        nl = launch(rows, mem)
        torch.cuda.synchronize()
        if not torch.equal(nl.cpu(), nl_p.cpu()) or not same_rows(rows, want):
            raise AssertionError(f"partition {name} ({bname}): nl {nl.tolist()} vs "
                                 f"{nl_p.tolist()}, or the rows differ from the plain version")
    res: Dict[str, float] = {}
    if timed:
        times: Dict[str, List[float]] = {}
        for bname in list(builds) + list(builds)[::-1]:
            launch = builds[bname]
            times.setdefault(bname, []).append(
                time_ms(lambda: launch(rows, mem), reps=reps, setup=restore))
        res = {k: statistics.median(v) for k, v in times.items()}
        for bname, launch in builds.items():
            res[f"{bname} device"], res[f"{bname} ops"] = device_profile(
                lambda: launch(rows, mem), setup=restore)
            if kernels:
                for kname, ms in device_by_name(lambda: launch(rows, mem), setup=restore).items():
                    res[f"{bname} [{kernel_name(kname)}]"] = ms
        keys = sort_keys(pristine, mem)
        idx = window_rows(mem, rows.device)
        res["bound"] = bound_ms(rows.f, mem)
        res["sort"] = time_ms(lambda: torch.sort(keys, stable=True), reps=reps)
        res["composite"] = time_ms(lambda: composite(rows, mem, keys, idx), reps=reps,
                                   setup=restore)
        res["composite device"], _ = device_profile(lambda: composite(rows, mem, keys, idx),
                                                    setup=restore)
        restore()
        composite(rows, mem, keys, idx)
        if not same_rows(rows, want):
            raise AssertionError(f"partition {name}: the composite differs from the plain version")
        del keys, idx
        if plain_reps:
            res["plain"] = time_ms(lambda: seg.sort_partition_batch_plain(rows, mem),
                                   reps=plain_reps, setup=restore)
    restore()
    torch.cuda.synchronize()
    del pristine, want
    torch.cuda.empty_cache()
    return res


TRACE_PHASES = ("start copies", "rank", "copies land", "look-back", "wait staged", "write")


def trace_phases(rows: seg.SegRows, mem: np.ndarray, launch: Callable, read) -> str:
    """One call of a -DPART_TRACE build on the case (the rows restored after
    it): per phase of a tile, the median and largest time over the tiles,
    the spread of the tiles' starts and ends, in microseconds, and the
    median clock of the multiprocessors while a tile ran."""
    pristine = _clone_rows(rows)
    launch(rows, mem)
    torch.cuda.synchronize()
    marks = np.zeros((4096, len(TRACE_PHASES) + 3), dtype=np.uint64)
    _build.check(read(marks.ctypes.data), "partition trace")
    _copy_rows(rows, pristine)
    tile = seg.partition_tile_rows(rows.f, int(mem[:, 1].sum()))
    tiles = min(4096, int(sum(-(-int(c) // tile) for c in mem[:, 1])))
    m = marks[:tiles, :-2].astype(np.float64) / 1e3
    clocks = marks[:tiles, -2:].astype(np.float64)
    ghz = np.median((clocks[:, 1] - clocks[:, 0]) / np.maximum(1.0, (m[:, -1] - m[:, 0]) * 1e3))
    d = np.diff(m, axis=1)
    out = [f"{name} {np.median(d[:, i]):.2f}/{d[:, i].max():.2f}"
           for i, name in enumerate(TRACE_PHASES)]
    t0 = m[:, 0].min()
    return (f"{tiles} tiles, per tile median/largest us: " + ", ".join(out)
            + f"; starts {m[:, 0].max() - t0:.2f} us after the first, last end at "
            f"{m[:, -1].max() - t0:.2f} us; multiprocessor clock {ghz:.2f} GHz")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="a partition.cu of the earlier design to time beside this one")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAGS: this source built with extra nvcc flags")
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=SOURCE: another partition.cu with this source's C entry")
    ap.add_argument("--trace", action="store_true",
                    help="also build this source with -DPART_TRACE and print each case's "
                         "phase times per tile")
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_partition: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    took = _build.build_all(["partition"])
    if "partition" in took:
        print(f"build this: ptxas: {took['partition'][1]}")
    builds: Dict[str, Callable] = {}
    tmp = tempfile.mkdtemp(prefix="partition_bench_")
    if args.baseline:
        lib, report = build_library(args.baseline, [], tmp)
        print(f"build baseline: ptxas: {report}")
        builds["baseline"] = earlier_launcher(lib)
    builds["this"] = this_launcher()
    src = f"{_build.CSRC}/partition.cu"
    extra = [(name, path, []) for name, _, path in (v.partition("=") for v in args.other)]
    extra += [(name, src, flags.split())
              for name, _, flags in (v.partition("=") for v in args.variant)]
    for vname, vsrc, flags in extra:
        lib, report = build_library(vsrc, flags, tmp)
        print(f"build {vname}: ptxas: {report}")
        builds[vname] = this_launcher(_c_entry(lib))
    tracer = None
    if args.trace:
        lib, _ = build_library(src, ["-DPART_TRACE"], tmp)
        read = ctypes.CDLL(lib).lgbt_partition_trace
        read.argtypes = [ctypes.c_void_p]
        tracer = (this_launcher(_c_entry(lib)), read)
    results = {}
    for f in (ROOT_FEATURES, WIDE_FEATURES):
        rows, nb = synthetic_rows(args.rows, f, dev)
        todo = cases(rows.n, nb) if f == ROOT_FEATURES else {"root": cases(rows.n, nb)["root"]}
        for cname, mem in todo.items():
            key = cname if f == ROOT_FEATURES else f"{cname} F={f}"
            res = run_case(key, rows, mem, builds, args.reps, kernels=True)
            results[key] = res
            if tracer is not None:
                print(f"trace {key}: {trace_phases(rows, mem, *tracer)}")
            rows_k = int(mem[:, 1].sum())
            print(f"case {key}: {len(mem)} window(s), {rows_k} rows x {f} features; "
                  + ", ".join(f"{k} {v:.4f}" + ("" if k.endswith("ops") else " ms")
                              for k, v in res.items()))
        if f == ROOT_FEATURES:
            for cname, mem in edge_cases(rows.n, nb).items():
                run_case(cname, rows, mem, builds, args.reps, timed=False)
                print(f"edge case {cname}: windows {mem[:, :2].tolist()}: every build equals "
                      "the plain version")
        del rows
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "cases": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
