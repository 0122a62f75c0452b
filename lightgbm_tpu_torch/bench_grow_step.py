"""The fused grow step (``csrc/grow_step.cu``) on the card: its cases, its
check against the plain version, and its time against another build of it,
against the port's own pair of launches that computes the same function, and
against PyTorch calls that do.

Run from the root of a checkout, on a machine with the card::

    python3 -m lightgbm_tpu_torch.bench_grow_step [--baseline OTHER.cu]
        [--other NAME=SOURCE ...] [--variant NAME=FLAGS ...] [--trace]
        [--rows N] [--reps N]

It makes seg rows on the card from a seed (``bench_partition.synthetic_rows``)
and, for each case of ``bench_partition.cases`` (the root at 1,048,576 x 28,
K=4 as chip_smoke.py's ``k4_members`` with one window empty, one window of
16,384 rows and one of 4,096 at unaligned starts, K=16 windows of 4,096
rows), one window of 14,012 rows (a default tree's median) and the root
at F = 242, in f32 and in int8 mode (the scales of
``quantize.hist_acc_scales``), checks every build against
``fused_grow_step_plain``: ``dec`` exact, every column of the whole rows
byte-equal after the call, the int8 histogram bit-equal, the f32
histogram's counts exact and g/h within ``f32_tol``, and in f32 the same
bits from a second call on the same rows (``<build> repeatable``; a
difference fails this source's build and is reported for the others,
whose f32 sums may change from call to call).  The edge cases
(``edge_cases``: every row left, every row right, an empty window among K,
windows under 32 rows, a NaN-bin split with missing values left, a window
whose two children are equal in size; ``few_bins``: the root of a table of
64 bins) are checked, not timed.  The table mode (a window going left by
the goes-left table of an EFB bundle-plane split): ``bench_partition``'s
``table_cases`` timed and ``table_edge_cases`` checked, in both modes, on
this interface's builds.  The u16 mode (bins past a byte, two byte planes a
feature at a padded width of 1,024: ``bench_partition.synthetic_rows_u16``):
``bench_partition``'s ``u16_cases`` timed in both modes, each beside this
build on the u8 rows' same windows (``u8``), and its ``u16_edge_cases``
checked (``run_u16``).  Tables past 256 bins: ``bench_partition``'s
``wide_table_cases`` at 1,024 and 8,192 bins in both modes on this build,
each beside its 256-bin twin (``bench_partition.run_wide_tables``).

Times: the builds in turns (baseline, this source, variants, then the
reverse order) by CUDA events through the wrapper, one call at a time with
the rows restored before each call outside the events; each build's
device time alone under torch.profiler (``device``, the restore left out),
its device operations per call and its device time by kernel.  Beside
each case:

* ``bound``: the windows' rows read once and written once,
  2 * rows * (F + 16) bytes, plus the K * F * B * 12 output bytes, over the
  card's HBM rate (chip_smoke.py's reckoning);
* ``pair``: the port's partition (``seg._partition_launch``), one host read
  of nl, then ``seg.seg_hist_batch`` on the elected children: the same
  function in two kernels (``pair device``: its device time, the read of nl
  included);
* ``composite``: a stable ``torch.sort`` of the go-left keys,
  ``index_select`` of the windows' bins and of g/h/m/ridx, ``copy_`` back,
  then one ``index_add_`` of the children's rows into a [K, F, B] table
  (int8: of the i32 digit rows, recombined as ``combine_int8``): the same
  function through PyTorch calls.

``--baseline`` builds another source with the C interface of the earlier
design (one cooperative launch over scratch that its wrapper allocated on
every call, a zeroed output, the int8 recombine outside the kernel) into a
temporary directory; ``--other`` builds another source of this one's C
interface (with the headers beside it, for example an earlier
``lane_hist.cuh``); ``--variant`` builds this source with extra compiler
flags.  ``--trace`` builds this source with ``-DPART_TRACE -DHIST_TRACE``
and prints each case's per-tile partition phases and per-block histogram
phases (``clock64`` and the global timer).  chip_smoke.py checks the root,
K=2 and K=4 windows of the binned Higgs table and these edge cases through
the wrapper alone.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import tempfile
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import _build
from ._bench import (HBM_BYTES_PER_S, build_library, card_line, device_by_name, device_profile,
                     f32_tol, time_ms)
from .bench_partition import (ROOT_FEATURES, WIDE_FEATURES, _clone_rows, _copy_rows, _members,
                              kernel_name, same_rows, sort_keys, synthetic_rows, window_rows)
from .bench_partition import cases as partition_cases
from .bench_partition import edge_cases as partition_edge_cases
from .bench_partition import (U16_CASES, run_wide_tables, synthetic_rows_u16, table_cases,
                              table_edge_cases, u16_cases, u16_edge_cases)
from .ops import grow_step, seg
from .quantize import hist_acc_scales

MODES = ("f32", "int8")


def cases(n: int, nb) -> Dict[str, np.ndarray]:
    """{name: [K, MEMBER_COLS] members} of the timed cases: the partition bench's, and
    one window of 14,012 rows (the median window of a default tree's fused
    steps) at an unaligned start."""
    out = partition_cases(n, nb)
    out["14,012 rows"] = _members(nb, [4_321], [min(14_012, n - 4_321)], [7], [1])
    return out


def equal_children(rows: seg.SegRows, nb, start: int = 77, feat: int = 5,
                   least: int = 1000) -> np.ndarray:
    """[1, MEMBER_COLS] members of a window at ``start`` whose split of ``feat`` sends
    exactly half its rows left (nl == nr, so the left child is elected):
    the shortest such window of at least ``least`` rows, at the threshold
    bins nearest an even split first."""
    j = feat % len(nb)
    nanb = int(nb[j]) - 1
    col = rows.bins[j, start:]
    share = torch.stack([(col <= t).float().mean() for t in range(nanb)]).cpu().numpy()
    for tbin in np.argsort(np.abs(share - 0.5), kind="stable"):
        gl = seg.go_left(col, int(tbin), False, nanb)
        balance = torch.cumsum(gl.to(torch.int32) * 2 - 1, 0)
        ends = torch.nonzero(balance == 0)[:, 0] + 1
        ends = ends[ends >= least]
        if len(ends):
            return _members(nb, [start], [int(ends[0])], [j], [0], tbins=[int(tbin)])
    raise ValueError("no window with equal children")


def edge_cases(rows: seg.SegRows, nb) -> Dict[str, np.ndarray]:
    """{name: [K, MEMBER_COLS] members} checked but not timed: the partition bench's
    edge cases and a window with equal children."""
    out = dict(partition_edge_cases(rows.n, nb))
    out["nl == nr"] = equal_children(rows, nb)
    return out


def few_bins(rows: seg.SegRows, b: int = 64):
    """(rows, members): a copy of ``rows`` whose bins are taken modulo
    ``b`` (the table of a dataset with ``max_bin`` below 255: ``b``
    histogram bins) and its root split at bin ``b // 2``, checked and not
    timed."""
    small = _clone_rows(rows)
    small.bins.remainder_(b)
    return small, seg.split_members([0], [rows.n], [3], [b // 2], [0], [-1])


def bound_ms(f: int, b: int, mem: np.ndarray, planes: Optional[int] = None) -> float:
    """The windows' rows read once and written once (F bin bytes, or
    ``planes`` byte planes, two a feature in the u16 mode, and four 4-byte
    columns a row), plus the [K, F, B, 3] f32 output."""
    planes = f if planes is None else planes
    nbytes = 2 * int(mem[:, 1].sum()) * (planes + 16) + len(mem) * f * b * 12
    return nbytes / HBM_BYTES_PER_S * 1e3


def int8_scales(rows: seg.SegRows) -> torch.Tensor:
    return hist_acc_scales(rows.g, rows.h, rows.m)


# ----------------------------------------------------------------- builds
_EARLIER_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                                              ctypes.c_int, ctypes.c_int) + (ctypes.c_void_p,) * 10
_EARLIER_TILE = 1024


def earlier_launcher(lib: str) -> Callable:
    """A launch of a build of the earlier design's source (C entry
    ``lgbt_grow_step``: one cooperative launch over scratch that its wrapper
    allocated on every call, a zeroed output, the int8 recombine after it),
    as its wrapper made it: (rows, members, B, scales) -> (dec, hist)."""
    fn = ctypes.CDLL(lib).lgbt_grow_step
    fn.argtypes = list(_EARLIER_ARGTYPES)
    fn.restype = ctypes.c_int

    def launch(rows: seg.SegRows, mem: np.ndarray, b: int, qs) -> tuple:
        mem = np.ascontiguousarray(mem[:, :6])  # its rows: no table mode
        k, f, dev = mem.shape[0], rows.f, rows.device
        total = int(mem[:, 1].sum())
        planes = 3 if qs is None else 5
        out = torch.zeros((k, f, b, planes), dtype=torch.float32 if qs is None else torch.int32,
                          device=dev)
        tiles = int(sum(-(-int(c) // _EARLIER_TILE) for c in mem[:, 1]))
        s_bins = torch.empty((f, total), dtype=torch.uint8, device=dev)
        s_g = torch.empty((total,), dtype=torch.float32, device=dev)
        s_h = torch.empty_like(s_g)
        s_m = torch.empty_like(s_g)
        s_ridx = torch.empty((total,), dtype=torch.int32, device=dev)
        tile_counts = torch.empty((tiles,), dtype=torch.int32, device=dev)
        dec = torch.empty((k, 4), dtype=torch.int32, device=dev)
        rc = fn(rows.bins.data_ptr(), rows.g.data_ptr(), rows.h.data_ptr(), rows.m.data_ptr(),
                rows.ridx.data_ptr(), rows.n, f, mem.ctypes.data, k, b, s_bins.data_ptr(),
                s_g.data_ptr(), s_h.data_ptr(), s_m.data_ptr(), s_ridx.data_ptr(),
                tile_counts.data_ptr(), dec.data_ptr(), None if qs is None else qs.data_ptr(),
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "fused grow step (the earlier design)")
        return dec, (out if qs is None else seg.combine_int8(out, qs))

    return launch


def this_launcher(fn=None) -> Callable:
    """The public wrapper on the members, (nl, nr, child_start, child_cnt,
    hist); with ``fn`` (the C entry of another build of this source) its
    launch alone, (dec [K, 4], hist)."""
    def launch(rows: seg.SegRows, mem: np.ndarray, b: int, qs) -> tuple:
        if fn is not None:
            return grow_step._launch(rows, mem, b, qs, fn)
        cols, iscats, tables = seg.member_args(mem)
        return grow_step.fused_grow_step(rows, *cols, b, quant_scales=qs, iscats=iscats,
                                         tables=tables)

    return launch


def _c_entry(lib: str):
    fn = ctypes.CDLL(lib).lgbt_grow_step
    fn.argtypes, fn.restype = list(_build.SIGNATURES["grow_step"]), ctypes.c_int
    return fn


def pair(rows: seg.SegRows, mem: np.ndarray, b: int, qs) -> tuple:
    """The port's two kernels: the partition, one host read of nl, the
    histogram of the elected children."""
    nl = seg._partition_launch(rows, mem, "partition_batch").cpu().numpy().astype(np.int64)
    dec = grow_step._decision(mem, nl)
    return torch.as_tensor(dec, device=rows.device), seg.seg_hist_batch(rows, dec[:, 2:4], b, qs)


def composite(rows: seg.SegRows, mem: np.ndarray, b: int, qs, keys: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
    """The step through PyTorch calls: the stable sort of the go-left keys,
    the gathers of every column and the copies back (the partition), then
    one index_add_ of every window's smaller child, elected on the card,
    into a [K, F, B] table; returns the histogram."""
    src = idx[torch.sort(keys, stable=True).indices]
    bins = rows.bins.index_select(1, src)
    off = 0
    spans = []
    for s, c in mem[:, :2]:
        spans.append((int(s), int(c), off))
        off += int(c)
    for s, c, o in spans:
        rows.bins[:, s:s + c].copy_(bins[:, o:o + c])
    for col in (rows.g, rows.h, rows.m, rows.ridx):
        vals = col.index_select(0, src)
        for s, c, o in spans:
            col[s:s + c].copy_(vals[o:o + c])
    goes_left = (keys & 1) == 0
    f, k, dev = rows.f, len(mem), rows.device
    counts = torch.stack([goes_left[o:o + c].sum() for _, c, o in spans])
    cnt = torch.as_tensor(mem[:, 1], device=dev)
    left = counts <= cnt - counts
    cs = torch.as_tensor(mem[:, 0], device=dev) + torch.where(left, 0, counts)
    cc = torch.where(left, counts, cnt - counts)
    # the children's rows, window by window, and their table rows
    rows_of = torch.cat([torch.arange(int(c), device=dev) for c in mem[:, 1]])
    win_of = torch.repeat_interleave(torch.arange(k, device=dev), cnt)
    pick = rows_of < cc[win_of]
    r = cs[win_of][pick] + rows_of[pick]
    w = win_of[pick]
    ids = (seg.feature_bins(rows, r) + (w[None, :] * f + torch.arange(f, device=dev)[:, None]) * b)
    m = rows.m[r]
    if qs is None:
        stats = torch.stack([rows.g[r] * m, rows.h[r] * m, m], 1)
        table = torch.zeros((k * f * b, 3), device=dev)
        return table.index_add_(0, ids.reshape(-1), stats.repeat(f, 1)).reshape(k, f, b, 3)
    g_hi, g_lo = seg.int8_digits(rows.g[r] * m, qs[0])
    h_hi, h_lo = seg.int8_digits(rows.h[r] * m, qs[1])
    stats = torch.stack([g_hi, g_lo, h_hi, h_lo, (m != 0).to(torch.int32)], 1)
    table = torch.zeros((k * f * b, 5), dtype=torch.int32, device=dev)
    table.index_add_(0, ids.reshape(-1), stats.repeat(f, 1))
    return seg.combine_int8(table.reshape(k, f, b, 5), qs)


def check(what: str, rows, want_rows, got, dec_p, hist_p, tol) -> None:
    """Raise unless dec and the rows are exact, the histogram bit-equal
    (int8: ``tol`` None) or its counts exact and g/h within ``tol``.
    ``got``: (dec, hist), or the wrapper's (nl, nr, child_start, child_cnt,
    hist)."""
    dec, hist = (torch.stack(got[:4], 1), got[4]) if len(got) == 5 else got
    if not torch.equal(dec.cpu(), dec_p.cpu()) or not same_rows(rows, want_rows):
        raise AssertionError(f"{what}: dec {dec.tolist()} vs {dec_p.tolist()}, or the rows "
                             "differ from the plain version")
    if tol is None:
        if not torch.equal(hist, hist_p):
            raise AssertionError(f"{what}: the int8 histogram differs from the plain version")
        return
    err = (hist[..., :2] - hist_p[..., :2]).abs()
    if not torch.equal(hist[..., 2], hist_p[..., 2]) or bool((err > tol).any()):
        raise AssertionError(f"{what}: f32 histogram off by {float(err.max())}")


def run_case(name: str, rows: seg.SegRows, mem: np.ndarray, b: int, qs,
             builds: Dict[str, Callable], reps: int, timed: bool = True,
             kernels: bool = False, plain_reps: int = 0) -> Dict[str, float]:
    """Check every build on one case in one mode (``qs``: the int8 scales,
    None for f32; raises on a difference); with ``timed``, their times,
    the bound, the pair and the composite; with ``plain_reps``, the plain
    version's time.  The rows are as they were
    when it returns."""
    pristine = _clone_rows(rows)
    want = _clone_rows(rows)
    dec_p, hist_p = grow_step.fused_grow_step_plain(want, mem, b, qs)
    tol = None if qs is not None else f32_tol(want, dec_p[:, 2:4].tolist(), b, hist_p[..., 2:3])

    def restore():
        _copy_rows(rows, pristine)

    res: Dict[str, float] = {}
    for bname, launch in builds.items():
        restore()
        got = launch(rows, mem, b, qs)
        torch.cuda.synchronize()
        check(f"grow step {name} ({bname})", rows, want, got, dec_p, hist_p, tol)
        if qs is None:  # f32: the same bits from a second call on the same rows
            first = got[-1].clone()
            restore()
            same = torch.equal(first, launch(rows, mem, b, qs)[-1])
            res[f"{bname} repeatable"] = float(same)
            if not same and bname == "this":
                raise AssertionError(f"grow step {name}: f32 sums differ between two calls")
    if timed:
        times: Dict[str, List[float]] = {}
        for bname in list(builds) + list(builds)[::-1]:
            launch = builds[bname]
            times.setdefault(bname, []).append(
                time_ms(lambda: launch(rows, mem, b, qs), reps=reps, setup=restore))
        res.update({k: statistics.median(v) for k, v in times.items()})
        for bname, launch in builds.items():
            res[f"{bname} device"], res[f"{bname} ops"] = device_profile(
                lambda: launch(rows, mem, b, qs), setup=restore)
            if kernels:
                for kname, ms in device_by_name(lambda: launch(rows, mem, b, qs),
                                                setup=restore).items():
                    res[f"{bname} [{kernel_name(kname)}]"] = ms
        res["bound"] = bound_ms(rows.f, b, mem, rows.planes)
        restore()
        check(f"grow step {name} (pair)", rows, want, pair(rows, mem, b, qs), dec_p, hist_p, tol)
        res["pair"] = time_ms(lambda: pair(rows, mem, b, qs), reps=reps, setup=restore)
        res["pair device"], res["pair ops"] = device_profile(lambda: pair(rows, mem, b, qs),
                                                             setup=restore)
        keys = sort_keys(pristine, mem).to(torch.int32)
        idx = window_rows(mem, rows.device)
        restore()
        hist = composite(rows, mem, b, qs, keys, idx)
        check(f"grow step {name} (composite)", rows, want, (dec_p, hist), dec_p, hist_p, tol)
        res["composite"] = time_ms(lambda: composite(rows, mem, b, qs, keys, idx), reps=reps,
                                   setup=restore)
        res["composite device"], _ = device_profile(
            lambda: composite(rows, mem, b, qs, keys, idx), setup=restore)
        del keys, idx
        if plain_reps:
            res["plain"] = time_ms(lambda: grow_step.fused_grow_step_plain(rows, mem, b, qs),
                                   reps=plain_reps, setup=restore)
    restore()
    torch.cuda.synchronize()
    del pristine, want, hist_p
    torch.cuda.empty_cache()
    return res


# per-block marks of a -DHIST_TRACE build: start, table zeroed, rows added,
# image written (the global timer, ns), then the multiprocessor's clock at
# the first and the last
HIST_PHASES = ("zero", "add rows", "write image")
PART_PHASES = ("start copies", "rank", "copies land", "look-back", "wait staged", "write")


def _phase_line(marks: np.ndarray, names) -> str:
    m = marks[:, :-2].astype(np.float64) / 1e3
    clocks = marks[:, -2:].astype(np.float64)
    ghz = np.median((clocks[:, 1] - clocks[:, 0]) / np.maximum(1.0, (m[:, -1] - m[:, 0]) * 1e3))
    d = np.diff(m, axis=1)
    out = [f"{nm} {np.median(d[:, i]):.2f}/{d[:, i].max():.2f}" for i, nm in enumerate(names)]
    t0 = m[:, 0].min()
    return (", ".join(out) + f"; starts {m[:, 0].max() - t0:.2f} us after the first, last end "
            f"at {m[:, -1].max() - t0:.2f} us; multiprocessor clock {ghz:.2f} GHz")


def trace_phases(rows: seg.SegRows, mem: np.ndarray, b: int, qs, launch: Callable,
                 lib: ctypes.CDLL) -> str:
    """One call of a traced build on the case (the rows restored after it):
    per phase of a partition tile and of a histogram block, the median and
    largest time over the tiles / blocks, in microseconds."""
    pristine = _clone_rows(rows)
    launch(rows, mem, b, qs)
    torch.cuda.synchronize()
    part = np.zeros((4096, len(PART_PHASES) + 3), dtype=np.uint64)
    hist = np.zeros((4096, len(HIST_PHASES) + 3), dtype=np.uint64)
    _build.check(lib.lgbt_partition_trace(ctypes.c_void_p(part.ctypes.data)), "partition trace")
    _build.check(lib.lgbt_grow_step_trace(ctypes.c_void_p(hist.ctypes.data)), "histogram trace")
    hist = hist[hist[:, 0] != 0]  # the blocks that ran
    _copy_rows(rows, pristine)
    tile = seg.partition_tile_rows(rows.planes, int(mem[:, 1].sum()))
    tiles = min(4096, int(sum(-(-int(c) // tile) for c in mem[:, 1])))
    return (f"{tiles} partition tiles, median/largest us: {_phase_line(part[:tiles], PART_PHASES)}"
            f" | {len(hist)} histogram blocks: {_phase_line(hist, HIST_PHASES)}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="a grow_step.cu of the earlier, one-launch design to time "
                    "beside this one")
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=SOURCE: another grow_step.cu with this source's C entry")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAGS: this source built with extra nvcc flags")
    ap.add_argument("--trace", action="store_true",
                    help="also build this source with -DPART_TRACE -DHIST_TRACE and print each "
                         "case's phase times")
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_grow_step: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    took = _build.build_all(["grow_step", "partition", "seg_hist"])
    for name, (secs, report) in sorted(took.items()):
        print(f"build {name}: {secs:.1f} s; ptxas: {report}")
    builds: Dict[str, Callable] = {}
    tmp = tempfile.mkdtemp(prefix="grow_step_bench_")
    if args.baseline:
        lib, report = build_library(args.baseline, [], tmp)
        print(f"build baseline: ptxas: {report}")
        builds["baseline"] = earlier_launcher(lib)
    builds["this"] = this_launcher()
    src = f"{_build.CSRC}/grow_step.cu"
    extra = [(name, path, []) for name, _, path in (v.partition("=") for v in args.other)]
    extra += [(name, src, flags.split())
              for name, _, flags in (v.partition("=") for v in args.variant)]
    for vname, vsrc, flags in extra:
        lib, report = build_library(vsrc, flags, tmp)
        print(f"build {vname}: ptxas: {report}")
        builds[vname] = this_launcher(_c_entry(lib))
    tracer = None
    if args.trace:
        lib, _ = build_library(src, ["-DPART_TRACE", "-DHIST_TRACE"], tmp)
        traced = ctypes.CDLL(lib)
        tracer = (this_launcher(_c_entry(lib)), traced)
    results = {}
    for f in (ROOT_FEATURES, WIDE_FEATURES):
        rows, nb = synthetic_rows(args.rows, f, dev)
        scales = int8_scales(rows)
        todo = cases(rows.n, nb) if f == ROOT_FEATURES else {"root": cases(rows.n, nb)["root"]}
        for cname, mem in todo.items():
            for mode in MODES:
                qs = scales if mode == "int8" else None
                key = f"{cname} {mode}" if f == ROOT_FEATURES else f"{cname} F={f} {mode}"
                res = run_case(key, rows, mem, 256, qs, builds, args.reps, kernels=True)
                results[key] = res
                if tracer is not None:
                    print(f"trace {key}: {trace_phases(rows, mem, 256, qs, *tracer)}")
                print(f"case {key}: {len(mem)} window(s), {int(mem[:, 1].sum())} rows x {f} "
                      "features; " + ", ".join(f"{k} {v:.4f}" + ("" if k.endswith("ops") else " ms")
                                               for k, v in res.items()))
        if f == ROOT_FEATURES:
            for cname, mem in edge_cases(rows, nb).items():
                for mode in MODES:
                    run_case(cname, rows, mem, 256, scales if mode == "int8" else None, builds,
                             args.reps, timed=False)
                print(f"edge case {cname}: windows {mem[:, :2].tolist()}: every build equals the "
                      "plain version in both modes")
            small, mem = few_bins(rows)
            for mode in MODES:
                run_case("root at 64 bins", small, mem, 64, scales if mode == "int8" else None,
                         builds, args.reps, timed=False)
            print("edge case root at 64 bins: every build equals the plain version in both modes")
            del small
            # the table mode: builds of this interface (the earlier design has none)
            table_builds = {k: v for k, v in builds.items() if k != "baseline"}
            for cname, mem in table_cases(rows.n, nb).items():
                for mode in MODES:
                    key = f"{cname} {mode}"
                    results[key] = res = run_case(key, rows, mem, 256,
                                                  scales if mode == "int8" else None,
                                                  table_builds, args.reps)
                    print(f"case {key}: " + ", ".join(
                        f"{k} {v:.4f}" + ("" if k.endswith("ops") else " ms")
                        for k, v in res.items()))
            for cname, mem in table_edge_cases(rows.n, nb).items():
                for mode in MODES:
                    run_case(cname, rows, mem, 256, scales if mode == "int8" else None,
                             table_builds, args.reps, timed=False)
                print(f"edge case {cname}: windows {mem[:, :2].tolist()}: every build equals the "
                      "plain version in both modes")
        del rows
        torch.cuda.empty_cache()
    results.update(run_u16(builds, args.rows, args.reps, dev))
    # the wide tables in both modes on this build (another build of this
    # interface reads only the parameter words)
    this = {"this": builds["this"]}

    def wide_modes(key, rows, mem, b):
        scales = int8_scales(rows)
        return {f"{key} {mode}": run_case(f"{key} {mode}", rows, mem, b,
                                          scales if mode == "int8" else None, this, args.reps)
                for mode in MODES}

    results.update(run_wide_tables(wide_modes, args.rows, dev))
    print(json.dumps({"card": card, "cases": results}))
    return 0


def run_u16(builds: Dict[str, Callable], n: int, reps: int, dev, verbose: bool = True,
            kernels: bool = True, plain_reps: int = 0) -> Dict[str, Dict[str, float]]:
    """The u16 mode's cases in both modes on builds of this interface
    (timed, each beside this build's time on the u8 rows' same windows,
    ``u8`` and ``u8 device``; with ``plain_reps``, the plain version's time)
    and edge cases (checked); {case: results}."""
    builds = {k: v for k, v in builds.items() if k != "baseline"}
    rows8, nb8 = synthetic_rows(n, ROOT_FEATURES, dev, seed=1)
    u8 = {name: mem for name, mem in cases(n, nb8).items() if name in U16_CASES}
    rows, nb = synthetic_rows_u16(n, ROOT_FEATURES, dev)
    scales, scales8 = int8_scales(rows), int8_scales(rows8)
    results: Dict[str, Dict[str, float]] = {}
    for cname, mem in u16_cases(n, nb).items():
        for mode in MODES:
            qs, qs8 = (scales, scales8) if mode == "int8" else (None, None)
            key = f"u16 {cname} {mode}"
            res = run_case(key, rows, mem, 1024, qs, builds, reps, kernels=kernels,
                           plain_reps=plain_reps)
            r8 = run_case(f"{cname} {mode}", rows8, u8[cname], 256, qs8,
                          {"this": builds["this"]}, reps)
            res["u8"], res["u8 device"] = r8["this"], r8["this device"]
            results[key] = res
            if verbose:
                print(f"case {key}: {len(mem)} window(s), {int(mem[:, 1].sum())} rows x "
                      f"{rows.f} features (u16); " + ", ".join(
                          f"{k} {v:.4f}" + ("" if k.endswith("ops") else " ms")
                          for k, v in res.items()))
    del rows8
    for cname, mem in u16_edge_cases(n, nb).items():
        for mode in MODES:
            run_case(f"u16 {cname}", rows, mem, 1024, scales if mode == "int8" else None,
                     builds, reps, timed=False)
        if verbose:
            print(f"edge case u16 {cname}: windows {mem[:, :2].tolist()}: every build equals "
                  "the plain version in both modes")
    del rows
    torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    sys.exit(main())
