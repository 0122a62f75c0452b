"""The segment histogram (``csrc/seg_hist.cu``) on the card: its cases, its
check against the plain version, and its time against another build of it
and against the PyTorch call that computes the same function.

Run from the root of a checkout, on a machine with the card::

    python3 -m lightgbm_tpu_torch.bench_seg_hist [--baseline OTHER.cu]
        [--variant NAME=FLAGS ...] [--trace] [--rows N] [--reps N]

It makes seg rows on the card from a seed (``bench_partition.synthetic_rows``:
208-256 bins a feature, ~2% of the rows in its NaN bin) and, for each case
of ``cases`` (the root at 1,048,576 x 28; K=2 windows of 873,814 rows; the
serial near-tie refine, one window of 14,012 rows and one empty; the
batched refine, K=8 windows of 4,096-65,536 rows at unaligned starts; one
window of 16,384 rows and one of 4,096 at unaligned starts; K=16 windows
of 4,096 rows; the root at F = 242), in f32 and in int8 mode (the scales of
``quantize.hist_acc_scales``), checks every build against
``seg_hist_batch_plain``: the counts exact, the int8 histogram bit-equal,
the f32 one's g/h within ``_bench.f32_tol`` and, but for the baseline,
the same on two calls.
The edge cases (``edge_cases``: every window empty but one, windows under
32 rows, a window ending at row n; ``few_bins``: the root of a 64-bin
table; ``largest_int8``: one int8 window of ``seg.MAX_INT8_ROWS`` rows,
every row in one bin at the grid's largest digit) are checked, not timed.
The u16 mode (bins past a byte, two byte planes a feature,
``bench_partition.synthetic_rows_u16``: 300-1,024 bins a feature at a
padded width of 1,024, four bin ranges): ``u16_cases`` (the root, K=2, K=4,
16,384 rows, 4,096 rows), each timed beside this build on the u8 rows'
same windows (``u8``); the root at F = 121 (242 byte planes) and at a
padded width of 8,192 (5,000-8,192 bins a feature, 32 ranges), timed; the
edge cases in the u16 mode and the root of rows of at most 700 bins at
1,024 (three ranges, the fourth written 0), checked.

Times: the builds in turns (baseline, this source, variants, then the
reverse order) by CUDA events through the wrapper, one call at a time;
each build's device time alone under torch.profiler (``device``), its
device operations per call and its device time by kernel.  Beside each
case:

* ``bound``: the windows' rows read once, rows * (F + 12) bytes (F bin
  bytes, g, h, m), plus the K * F * B * 12 output bytes, over the card's
  HBM rate;
* ``library``: one ``index_add_`` of the windows' rows into a [K, F, B]
  table, f32 (g*m, h*m, m) or, in int8 mode, the i32 digit rows (the ids
  and values made beforehand, outside the time).

``--baseline`` builds another source with the C interface of the earlier
design (a zeroed output filled by global atomics; in int8 mode raw i32
[K, F, B, 5] digit planes, recombined by ``seg.combine_int8`` after the
launch, as its wrapper did) into a temporary directory; ``--variant``
builds this source with extra compiler flags.  ``--trace`` builds this
source with ``-DHIST_TRACE`` and prints each case's per-block phases
(``bench_grow_step.trace_phases``' reckoning).  chip_smoke.py checks the
root and K=2 windows of the binned Higgs table, and these cases and edge
cases, through the public wrapper alone.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from ._bench import (HBM_BYTES_PER_S, build_library, card_line, device_by_name, device_profile,
                     f32_tol, time_ms)
from .bench_partition import (ROOT_FEATURES, WIDE_BIN_FEATURES, WIDE_FEATURES, kernel_name,
                              synthetic_rows, synthetic_rows_u16)
from .ops import seg
from .quantize import hist_acc_scales

MODES = ("f32", "int8")
Windows = List[Tuple[int, int]]

# the batched refine's windows (2K children at K=4): 4,096-65,536 rows
REFINE_BATCH = (65_536, 4_096, 30_011, 14_012, 8_191, 49_999, 20_480, 5_003)
# the median window of a default tree's fused steps (chip_smoke.py's profile)
REFINE_SERIAL = 14_012


def _spaced(cnts: Sequence[int], first: int, gap: int = 37) -> Windows:
    """Adjacent windows of ``cnts`` rows from ``first``, ``gap`` rows apart."""
    out, s = [], first
    for c in cnts:
        out.append((s, int(c)))
        s += int(c) + gap
    return out


def cases(n: int) -> Dict[str, Windows]:
    """{name: [(start, cnt), ...]} of the timed cases at n rows (the root
    and K=2 scale with n; the other windows do not)."""
    return {
        "root": [(0, n)],
        "K=2": [(37, n // 3 + 1), (37 + n // 3 + 1, n // 2)],
        "refine serial": [(12_345, REFINE_SERIAL), (40_000, 0)],
        "refine batched": _spaced(REFINE_BATCH, 101),
        "16,384 rows": [(12_345, 16_384)],
        "4,096 rows": [(n // 3 + 5, 4_096)],
        "K=16 x 4,096": _spaced([4_096] * 16, 11),
    }


def edge_cases(n: int) -> Dict[str, Windows]:
    """{name: windows} checked but not timed."""
    return {
        "every window empty but one": [(5, 0), (100, 0), (9_001, 3_000), (20_000, 0)],
        "windows under 32 rows": [(3, 17), (1_000, 31), (2_000, 1), (2_003, 32)],
        "a window ending at row n": [(1_000, 5_000), (n - 10_003, 10_003)],
    }


def few_bins(rows: seg.SegRows, b: int = 64) -> seg.SegRows:
    """A copy of ``rows`` whose bins are taken modulo ``b`` (the table of a
    dataset with ``max_bin`` below 255: ``b`` histogram bins)."""
    return seg.SegRows(rows.bins.remainder(b), rows.g, rows.h, rows.m, rows.ridx)


def largest_int8(dev, f: int = 4) -> Tuple[seg.SegRows, Windows]:
    """(rows, [one window]) of ``seg.MAX_INT8_ROWS`` rows at an unaligned
    start, every row in bin 7 of feature 0 with g = h = m = 1, so that the
    int8 grid's digit sums of that cell reach 127 * MAX_INT8_ROWS, the
    largest i32 the mode promises to keep exact; the other features'
    bins random."""
    n = seg.MAX_INT8_ROWS + 5
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    bins = torch.randint(0, 256, (f, n), generator=gen, device=dev, dtype=torch.uint8)
    bins[0] = 7
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    rows = seg.SegRows(bins, ones, ones.clone(), ones.clone(),
                       torch.arange(n, dtype=torch.int32, device=dev))
    return rows, [(5, seg.MAX_INT8_ROWS)]


def u16_cases(n: int) -> Dict[str, Windows]:
    """{name: windows} of the u16 mode's timed cases: ``cases``' root, K=2,
    16,384 rows and 4,096 rows, and K=4 windows laid out as the partition
    bench's (one empty)."""
    c = cases(n)
    k4 = [(37, n // 4 - 100), (n // 4 + 5, 0), (n // 4 + 5, n // 4 - 900),
          (n // 2 + 1001, n // 2 - 2000)]
    return {"root": c["root"], "K=2": c["K=2"], "K=4": k4, "16,384 rows": c["16,384 rows"],
            "4,096 rows": c["4,096 rows"]}


def bound_ms(f: int, b: int, wins: Windows, planes: Optional[int] = None) -> float:
    """The windows' rows read once (F bin bytes, or ``planes`` byte planes,
    two a feature in the u16 mode, and three f32 columns a row) and the
    [K, F, B, 3] f32 output written once."""
    planes = f if planes is None else planes
    nbytes = sum(c for _, c in wins) * (planes + 12) + len(wins) * f * b * 12
    return nbytes / HBM_BYTES_PER_S * 1e3


def int8_scales(rows: seg.SegRows) -> torch.Tensor:
    return hist_acc_scales(rows.g, rows.h, rows.m)


def library_call(rows: seg.SegRows, wins: Windows, b: int, qs) -> Callable:
    """One ``index_add_`` of the windows' rows into a [K, F, B] table: f32
    (g*m, h*m, m), or the i32 digit rows of the int8 grid; the ids and
    values are made here, once."""
    f, dev = rows.f, rows.device
    live = [(k, s, c) for k, (s, c) in enumerate(wins) if c > 0]
    ids = torch.cat([seg.feature_bins(rows, slice(s, s + c))
                     + (k * f + torch.arange(f, device=dev)[:, None]) * b
                     for k, s, c in live], dim=1).reshape(-1)
    r = torch.cat([torch.arange(s, s + c, device=dev) for _, s, c in live])
    m = rows.m[r]
    if qs is None:
        vals = torch.stack([rows.g[r] * m, rows.h[r] * m, m], 1)
    else:
        g_hi, g_lo = seg.int8_digits(rows.g[r] * m, qs[0])
        h_hi, h_lo = seg.int8_digits(rows.h[r] * m, qs[1])
        vals = torch.stack([g_hi, g_lo, h_hi, h_lo, (m != 0).to(torch.int32)], 1)
    vals = vals.repeat(f, 1)
    shape = (len(wins) * f * b, vals.shape[1])
    return lambda: torch.zeros(shape, dtype=vals.dtype, device=dev).index_add_(0, ids, vals)


# ----------------------------------------------------------------- builds
_EARLIER_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_longlong, ctypes.c_void_p)
                     + (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 3)


def earlier_launcher(lib: str) -> Callable:
    """A launch of a build of the earlier design's source (C entry
    ``lgbt_seg_hist`` into a zeroed output, int8 as raw i32 digit planes),
    as its wrapper made it: (rows, windows, B, scales) -> [K, F, B, 3]."""
    fn = ctypes.CDLL(lib).lgbt_seg_hist
    fn.argtypes = list(_EARLIER_ARGTYPES)
    fn.restype = ctypes.c_int

    def launch(rows: seg.SegRows, wins: Windows, b: int, qs) -> torch.Tensor:
        k, f, dev = len(wins), rows.f, rows.device
        if qs is None:
            out = torch.zeros((k, f, b, 3), dtype=torch.float32, device=dev)
        else:
            out = torch.zeros((k, f, b, 5), dtype=torch.int32, device=dev)
        if any(c for _, c in wins):
            win_host = np.asarray(wins, dtype=np.int64).reshape(k, 2)
            rc = fn(rows.bins.data_ptr(), rows.g.data_ptr(), rows.h.data_ptr(),
                    rows.m.data_ptr(), rows.n, win_host.ctypes.data, k, f, b,
                    None if qs is None else qs.data_ptr(), out.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
            _build.check(rc, "seg_hist (the earlier design)")
        return out if qs is None else seg.combine_int8(out, qs)

    return launch


def this_launcher(fn=None) -> Callable:
    """The public wrapper on the windows; with ``fn`` (the C entry of
    another build of this source) its launch alone."""
    def launch(rows: seg.SegRows, wins: Windows, b: int, qs) -> torch.Tensor:
        if fn is not None:
            return seg._seg_hist_launch(rows, wins, b, qs, fn)
        return seg.seg_hist_batch(rows, wins, b, qs)

    return launch


def _c_entry(lib: str):
    fn = ctypes.CDLL(lib).lgbt_seg_hist
    fn.argtypes, fn.restype = list(_build.SIGNATURES["seg_hist"]), ctypes.c_int
    return fn


def check(what: str, got: torch.Tensor, want: torch.Tensor, tol) -> None:
    """Raise unless the counts are exact and the histogram bit-equal
    (int8: ``tol`` None) or its g/h within ``tol``."""
    if got.shape != want.shape or not torch.equal(got[..., 2], want[..., 2]):
        raise AssertionError(f"{what}: the counts differ from the plain version")
    if tol is None:
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: the int8 histogram differs from the plain version")
        return
    err = (got[..., :2] - want[..., :2]).abs()
    if bool((err > tol).any()):
        raise AssertionError(f"{what}: f32 histogram off by {float(err.max())}")


def run_case(name: str, rows: seg.SegRows, wins: Windows, b: int, qs,
             builds: Dict[str, Callable], reps: int, timed: bool = True,
             kernels: bool = False, plain_reps: int = 0,
             want: Optional[torch.Tensor] = None,
             varies: Sequence[str] = ("baseline",)) -> Dict[str, float]:
    """Check every build on one case in one mode (``qs``: the int8 scales,
    None for f32; raises on a difference): the counts exact, int8
    bit-equal, f32 g/h within ``f32_tol`` and, in f32 mode, the same bits
    from a second call (``<build> repeatable``), except for the builds
    named in ``varies``, whose f32 sums may change from call to call (the
    earlier design's global atomics), where it is only reported.  With ``timed``,
    their times, the bound and the library call; with ``plain_reps``, the
    plain version's time.  ``want``: the plain version's histogram, where
    the caller made it."""
    if want is None:
        want = seg.seg_hist_batch_plain(rows, wins, b, qs)
    tol = None if qs is not None else f32_tol(rows, wins, b, want[..., 2:3])
    res: Dict[str, float] = {}
    for bname, launch in builds.items():
        got = launch(rows, wins, b, qs)
        torch.cuda.synchronize()
        check(f"seg_hist {name} ({bname})", got, want, tol)
        if qs is None:
            same = torch.equal(got, launch(rows, wins, b, qs))
            res[f"{bname} repeatable"] = float(same)
            if not same and bname not in varies:
                raise AssertionError(f"seg_hist {name} ({bname}): f32 sums differ between "
                                     "two calls")
        del got
    if timed:
        times: Dict[str, List[float]] = {}
        for bname in list(builds) + list(builds)[::-1]:
            launch = builds[bname]
            times.setdefault(bname, []).append(
                time_ms(lambda: launch(rows, wins, b, qs), reps=reps))
        res.update({k: statistics.median(v) for k, v in times.items()})
        for bname, launch in builds.items():
            res[f"{bname} device"], res[f"{bname} ops"] = device_profile(
                lambda: launch(rows, wins, b, qs))
            if kernels:
                for kname, ms in device_by_name(lambda: launch(rows, wins, b, qs)).items():
                    res[f"{bname} [{kernel_name(kname)}]"] = ms
        res["bound"] = bound_ms(rows.f, b, wins, rows.planes)
        lib = library_call(rows, wins, b, qs)
        res["library"] = time_ms(lib, reps=reps)
        res["library device"], _ = device_profile(lib)
        del lib
        if plain_reps:
            res["plain"] = time_ms(lambda: seg.seg_hist_batch_plain(rows, wins, b, qs),
                                   reps=plain_reps)
    torch.cuda.synchronize()
    del want
    torch.cuda.empty_cache()
    return res


def check_largest_int8(builds: Dict[str, Callable], dev) -> Windows:
    """The int8 edge case of ``largest_int8``, its plain version taken one
    feature at a time (the plain scatter's i64 values take 40 bytes a row
    and feature); returns its windows."""
    rows, wins = largest_int8(dev)
    qs = int8_scales(rows)
    want = torch.cat([seg.seg_hist_batch_plain(
        seg.SegRows(rows.bins[j:j + 1], rows.g, rows.h, rows.m, rows.ridx), wins, 256, qs)
        for j in range(rows.f)], dim=1)
    run_case("largest int8 window", rows, wins, 256, qs, builds, 0, timed=False, want=want)
    del rows, want
    torch.cuda.empty_cache()
    return wins


HIST_PHASES = ("zero", "add rows", "write image")


def trace_phases(rows: seg.SegRows, wins: Windows, b: int, qs, launch: Callable,
                 lib: ctypes.CDLL) -> str:
    """One call of a -DHIST_TRACE build on the case: per phase of an
    accumulate block, the median and largest time over the blocks, in
    microseconds."""
    from .bench_grow_step import _phase_line

    launch(rows, wins, b, qs)
    torch.cuda.synchronize()
    marks = np.zeros((4096, len(HIST_PHASES) + 3), dtype=np.uint64)
    _build.check(lib.lgbt_seg_hist_trace(ctypes.c_void_p(marks.ctypes.data)), "histogram trace")
    marks = marks[marks[:, 0] != 0]  # the blocks that ran
    return f"{len(marks)} accumulate blocks: {_phase_line(marks, HIST_PHASES)}"


def _line(res: Dict[str, float]) -> str:
    def fmt(k, v):
        if k.endswith("ops") or k.endswith("repeatable"):
            return f"{k} {v:g}"
        return f"{k} {v:.4f} ms"

    return ", ".join(fmt(k, v) for k, v in res.items())


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="a seg_hist.cu of the earlier design (zeroed output, raw "
                    "int8 planes) to time beside this one")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAGS: this source built with extra nvcc flags")
    ap.add_argument("--trace", action="store_true",
                    help="also build this source with -DHIST_TRACE and print each case's "
                         "per-block phase times")
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_seg_hist: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    took = _build.build_all(["seg_hist"])
    for name, (secs, report) in sorted(took.items()):
        print(f"build {name}: {secs:.1f} s; ptxas: {report}")
    builds: Dict[str, Callable] = {}
    tmp = tempfile.mkdtemp(prefix="seg_hist_bench_")
    if args.baseline:
        lib, report = build_library(args.baseline, [], tmp)
        print(f"build baseline: ptxas: {report}")
        builds["baseline"] = earlier_launcher(lib)
    builds["this"] = this_launcher()
    src = f"{_build.CSRC}/seg_hist.cu"
    for vname, _, flags in (v.partition("=") for v in args.variant):
        lib, report = build_library(src, flags.split(), tmp)
        print(f"build {vname}: ptxas: {report}")
        builds[vname] = this_launcher(_c_entry(lib))
    tracer = None
    if args.trace:
        lib, _ = build_library(src, ["-DHIST_TRACE"], tmp)
        tracer = (this_launcher(_c_entry(lib)), ctypes.CDLL(lib))
    results = {}
    for f in (ROOT_FEATURES, WIDE_FEATURES):
        rows, _ = synthetic_rows(args.rows, f, dev)
        scales = int8_scales(rows)
        todo = cases(rows.n) if f == ROOT_FEATURES else {"root": cases(rows.n)["root"]}
        for cname, wins in todo.items():
            for mode in MODES:
                qs = scales if mode == "int8" else None
                key = f"{cname} {mode}" if f == ROOT_FEATURES else f"{cname} F={f} {mode}"
                res = run_case(key, rows, wins, 256, qs, builds, args.reps, kernels=True)
                results[key] = res
                if tracer is not None:
                    print(f"trace {key}: {trace_phases(rows, wins, 256, qs, *tracer)}")
                print(f"case {key}: {len(wins)} window(s), {sum(c for _, c in wins)} rows x {f} "
                      f"features; {_line(res)}")
        if f == ROOT_FEATURES:
            for cname, wins in edge_cases(rows.n).items():
                for mode in MODES:
                    run_case(cname, rows, wins, 256, scales if mode == "int8" else None, builds,
                             args.reps, timed=False)
                print(f"edge case {cname}: windows {wins}: every build equals the plain version "
                      "in both modes")
            small = few_bins(rows)
            for mode in MODES:
                run_case("root at 64 bins", small, [(0, rows.n)], 64,
                         scales if mode == "int8" else None, builds, args.reps, timed=False)
            print("edge case root at 64 bins: every build equals the plain version in both modes")
            del small
        del rows
        torch.cuda.empty_cache()
    wins = check_largest_int8(builds, dev)
    print(f"edge case largest int8 window: windows {wins}, every row in one bin at digit 127: "
          "every build bit-equal to the plain version")
    results.update(run_u16(builds, args.rows, args.reps, dev))
    print(json.dumps({"card": card, "cases": results}))
    return 0


def run_u16(builds: Dict[str, Callable], n: int, reps: int, dev, verbose: bool = True,
            kernels: bool = True, plain_reps: int = 0) -> Dict[str, Dict[str, float]]:
    """The u16 mode's cases in both modes on builds of this interface:
    ``u16_cases`` at 1,024 bins, each beside this build on the u8 rows'
    same windows (``u8``, ``u8 device``), the root at F = 121 and at 8,192
    bins, timed (with ``plain_reps``, the plain version's time at the
    1,024-bin cases); the edge cases and the root of rows of at most 700 bins,
    checked.  {case: results}."""
    builds = {k: v for k, v in builds.items() if k != "baseline"}
    results: Dict[str, Dict[str, float]] = {}

    def report(key, rows, wins, res):
        results[key] = res
        if verbose:
            print(f"case {key}: {len(wins)} window(s), {sum(c for _, c in wins)} rows x "
                  f"{rows.f} features (u16, {rows.planes} planes); {_line(res)}")

    rows8, _ = synthetic_rows(n, ROOT_FEATURES, dev, seed=1)
    rows, _ = synthetic_rows_u16(n, ROOT_FEATURES, dev)
    scales, scales8 = int8_scales(rows), int8_scales(rows8)
    for cname, wins in u16_cases(n).items():
        for mode in MODES:
            qs, qs8 = (scales, scales8) if mode == "int8" else (None, None)
            res = run_case(f"u16 {cname} {mode}", rows, wins, 1024, qs, builds, reps,
                           kernels=kernels, plain_reps=plain_reps)
            r8 = run_case(f"{cname} {mode}", rows8, wins, 256, qs8, {"this": builds["this"]},
                          reps)
            res["u8"], res["u8 device"] = r8["this"], r8["this device"]
            report(f"u16 {cname} {mode}", rows, wins, res)
    del rows8
    for cname, wins in edge_cases(n).items():
        for mode in MODES:
            run_case(f"u16 {cname}", rows, wins, 1024, scales if mode == "int8" else None,
                     builds, reps, timed=False)
        if verbose:
            print(f"edge case u16 {cname}: windows {wins}: every build equals the plain "
                  "version in both modes")
    del rows
    torch.cuda.empty_cache()
    narrow, _ = synthetic_rows_u16(n, ROOT_FEATURES, dev, seed=2, bins=(300, 700))
    for mode in MODES:
        run_case("u16 root, 700 bins of 1,024", narrow, [(0, n)], 1024,
                 int8_scales(narrow) if mode == "int8" else None, builds, reps, timed=False)
    if verbose:
        print("edge case u16 root, 700 bins of 1,024 (three ranges, the fourth 0): every build "
              "equals the plain version in both modes")
    del narrow
    torch.cuda.empty_cache()
    for f, span, b in ((WIDE_BIN_FEATURES, (300, 1024), 1024), (ROOT_FEATURES, (5000, 8192), 8192)):
        rows, _ = synthetic_rows_u16(n, f, dev, seed=3, bins=span)
        for mode in MODES:
            key = f"u16 root F={f} B={b} {mode}"
            report(key, rows, [(0, n)], run_case(key, rows, [(0, n)], b,
                                                 int8_scales(rows) if mode == "int8" else None,
                                                 builds, reps, kernels=kernels))
        del rows
        torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    sys.exit(main())
