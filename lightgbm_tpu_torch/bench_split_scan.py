"""The split scan (``csrc/split_scan.cu``) on the card: one call from the
leaves' histograms to their candidates on the host, checked and timed
against another build of the kernel with the host path that went with it.

Run from the root of a checkout, on a machine with the card::

    python3 -m lightgbm_tpu_torch.bench_split_scan [--baseline OTHER.cu]
        [--reps N]

It makes leaf histograms on the card from a seed (16,384 rows a leaf,
208-256 bins a feature, B = 256, a NaN bin on every other feature), and for
each case -- the Higgs root (F = 28, one leaf), the two children of a split
(M = 2, as the serial loop scans them), 2K = 8 children at K = 4, 32
children at K = 16, one leaf at F = 242, one at F = 700 with the
case-major tie rule -- checks, under both tie rules and with the margin:

* the kernel's packed candidates bit-equal to ``candidates_plain`` of the
  kernel's own rows (left in the call's scratch), and those rows
  bit-equal to the rows entry's;
* feature, bin and direction equal to the plain version's from the
  histograms (``split_scan_batch_plain``, ``candidates_plain``);
* each member bit-equal to a call of that member alone;
* one call is one kernel launch and one device-to-host copy, with no
  host-to-device copy (torch.profiler's device events).

Then it times one call (a list of candidates on the host) by CUDA events,
by the host's clock, and by device time alone under torch.profiler, with
the device operations and host transfers a call, beside the bound.
``--baseline`` builds an earlier source of the rows-only C entry (the
histograms [M, F, B, 3] and parents on the card) and runs it through the
host path of that design: the parents copied to the card, the casts and
allocation of each call, then the candidates from the rows in PyTorch
operators and one transfer; the two children of a split as two calls, as
the serial loop made them.  The builds run in turns (baseline, this, this,
baseline).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import _build
from ._bench import HBM_BYTES_PER_S, _device_events, build_library, card_line, time_ms
from .ops import split_scan as ss
from .ops.split import _EPS, SplitCandidate, leaf_gain

F32_OPS_PER_S = 67e12
LEAF_ROWS = 16_384
KW = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=20, min_sum_hessian_in_leaf=1e-3)
MIN_GAIN = 0.0


def leaves(m: int, f: int, dev, seed: int):
    """(hist [M, F, 256, 3] f32, parents [M, 3] host f32, num_bins i32,
    nan_bins i32 on the card): each leaf the histogram of LEAF_ROWS rows
    with binary-objective gradients, feature j with 208-256 bins, every
    other feature's last bin its NaN bin."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    nb = torch.randint(208, 257, (f,), generator=gen, device=dev)
    nan = torch.where(torch.arange(f, device=dev) % 2 == 1, nb - 1, -1)
    hist = torch.zeros((m, f * 256, 3), dtype=torch.float32, device=dev)
    for i in range(m):
        u = torch.rand((f, LEAF_ROWS), generator=gen, device=dev)
        bins = (u * nb[:, None]).long() + torch.arange(f, device=dev)[:, None] * 256
        p = torch.sigmoid(torch.randn(LEAF_ROWS, generator=gen, device=dev))
        y = (torch.rand(LEAF_ROWS, generator=gen, device=dev) < 0.5).float()
        st = torch.stack([p - y, p * (1 - p), torch.ones_like(p)], 1)
        hist[i].index_add_(0, bins.reshape(-1), st.repeat(f, 1))
    hist = hist.reshape(m, f, 256, 3)
    parents = hist[:, 0].sum(1).cpu().numpy()
    return hist, parents, nb.to(torch.int32), nan.to(torch.int32)


def cases(dev) -> Dict[str, tuple]:
    """{name: (hist, parents, num_bins, nan_bins, case_major for the timed
    call)}."""
    out = {}
    for name, m, f, major in (("Higgs root", 1, 28, False), ("2 children", 2, 28, False),
                              ("K=4: 8 children", 8, 28, False),
                              ("K=16: 32 children", 32, 28, False),
                              ("F=242 root", 1, 242, False), ("F=700 root, case_major", 1, 700, True)):
        out[name] = (*leaves(m, f, dev, seed=len(out)), major)
    return out


def this_call(hist, parents, inputs, major, with_margin=True):
    """The public call the grower makes: the M candidates (and margins)."""
    return ss.fused_best_split_batch(list(hist), parents, *inputs, min_gain_to_split=MIN_GAIN,
                                     with_margin=with_margin, case_major=major, **KW)


def packed_call(hist, parents, inputs, major) -> List[List[float]]:
    """The launch behind ``this_call``: the packed rows as the host reads
    them."""
    return ss._launch(list(hist), parents, inputs, KW, cand=(MIN_GAIN, major))


# ----------------------------------------------------------------- baseline
def _old_candidates(rows, parent, major):
    """The earlier design's host reduction of the rows [M, F, 8] on the
    card: PyTorch operators, then one transfer."""
    m, f = rows.shape[0], rows.shape[1]
    dev = rows.device
    gain = rows[..., 0]
    if major:
        cases_ = torch.cat([torch.where(rows[..., 2] <= 0.5, gain, float("-inf")), gain], dim=1)
        feat = torch.argmax(cases_, dim=1) % f
    else:
        feat = torch.argmax(gain, dim=1)
    r = rows[torch.arange(m, device=dev), feat]
    improvement = (r[:, 0] - leaf_gain(parent[:, 0], parent[:, 1], KW["lambda_l1"],
                                       KW["lambda_l2"]) - MIN_GAIN)
    others = torch.where(torch.arange(f, device=dev)[None, :] == feat[:, None], float("-inf"),
                         gain)
    sec = torch.maximum(others.max(dim=1).values, r[:, 6])
    margin = torch.where(torch.isfinite(r[:, 0]) & torch.isfinite(sec),
                         (r[:, 0] - sec) / torch.clamp(r[:, 0].abs(), min=_EPS), float("inf"))
    out = []
    for v in torch.cat([improvement[:, None], r[:, :6], parent - r[:, 3:6],
                        feat.to(torch.float32)[:, None], margin[:, None]], dim=1).tolist():
        gain_v = v[0] if np.isfinite(v[1]) else float("-inf")
        out.append((SplitCandidate(gain_v, int(v[10]), int(v[2]), v[3] > 0.5, v[4], v[5], v[6],
                                   v[7], v[8], v[9]), v[11]))
    return out


def baseline_launcher(lib: str) -> Callable:
    """The earlier design (C entry of hist [M, F, B, 3], parent, ... on the
    card -> rows [M, F, 8]) through its host path: one call a member for
    the two children of a split, else one call for all."""
    fn = ctypes.CDLL(lib).lgbt_split_scan
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 5 + [i32] * 4 + [f32] * 4 + [vp] * 2
    fn.restype = ctypes.c_int

    def one(hist, parents, num_bins, nan_bins, mask, major):
        dev = hist.device
        m, f, b, _ = hist.shape
        parent = torch.as_tensor(parents, dtype=torch.float32).to(dev).reshape(m, 3)
        hist = hist.to(torch.float32).contiguous()
        nb = num_bins.to(device=dev, dtype=torch.int32).contiguous()
        nanb = nan_bins.to(device=dev, dtype=torch.int32).contiguous()
        mk = mask.to(device=dev, dtype=torch.float32).contiguous()
        out = torch.empty((m, f, 8), dtype=torch.float32, device=dev)
        rc = fn(hist.data_ptr(), parent.data_ptr(), nb.data_ptr(), nanb.data_ptr(),
                mk.data_ptr(), m, f, b, 0, *map(float, KW.values()), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "split_scan (the baseline build)")
        return _old_candidates(out, parent, major)

    masks: Dict[int, torch.Tensor] = {}  # the grower's bool mask, a tree's

    def launch(hist, parents, inputs, major):
        nb, nan = inputs[0], inputs[1]
        f = hist.shape[1]
        mask = masks.setdefault(f, torch.ones(f, dtype=torch.bool, device=hist.device))
        if hist.shape[0] == 2:  # the serial loop: a call a child
            return [one(hist[i:i + 1], parents[i:i + 1], nb, nan, mask, major)[0]
                    for i in range(2)]
        return one(hist, parents, nb, nan, mask, major)

    return launch


# ----------------------------------------------------------------- checks
def transfers(fn: Callable) -> Dict[str, float]:
    """Device operations of one call by kind: kernels, host-to-device and
    device-to-host copies, other (memsets), from torch.profiler."""
    fn()
    reps = 5
    # a trace can lose device events but never adds one, and every call does
    # the same operations: each kind's count is the largest of three traces
    # whose counts are whole multiples of the calls (another is taken again;
    # a process's first traces on the card have come back empty up to 6 times)
    most = {"kernels": 0, "HtoD": 0, "DtoH": 0, "other": 0}
    whole = 0
    for _ in range(32):
        kinds = dict.fromkeys(most, 0)
        for e in _device_events(fn, reps, None):
            name = e.name
            kind = ("HtoD" if "HtoD" in name else "DtoH" if "DtoH" in name else
                    "other" if name.startswith(("Memcpy", "Memset")) else "kernels")
            kinds[kind] += 1
        if not kinds["kernels"] or any(v % reps for v in kinds.values()):
            print(f"transfers: a trace of {reps} calls lost events ({kinds}); taken again",
                  file=sys.stderr)
            continue
        most = {k: max(v, kinds[k]) for k, v in most.items()}
        whole += 1
        if whole == 3:
            break
    return {k: v / reps for k, v in most.items()}


def check_case(name, hist, parents, inputs) -> None:
    """The checks of the module docstring on one case, both tie rules;
    raises on a difference."""
    dev = hist.device
    m, f = hist.shape[0], hist.shape[1]
    par_t = torch.as_tensor(parents, dtype=torch.float32, device=dev)
    plain_rows = ss.split_scan_batch_plain(hist, par_t, *inputs, **KW)
    for major in (False, True):
        packed = torch.tensor(packed_call(hist, parents, inputs, major), dtype=torch.float32)
        rows = ss._BUFFERS[dev].rows[:m * f * 8].view(m, f, 8).clone()
        want = ss.candidates_plain(rows, par_t, lambda_l1=KW["lambda_l1"],
                                   lambda_l2=KW["lambda_l2"], min_gain_to_split=MIN_GAIN,
                                   case_major=major).cpu()
        what = f"split_candidates {name} (case_major={major})"
        if not torch.equal(packed, want):
            raise AssertionError(f"{what}: the packed candidates differ from candidates_plain "
                                 f"of the kernel's rows: {packed.tolist()} vs {want.tolist()}")
        if not torch.equal(rows, ss.split_scan_batch(hist, par_t, *inputs, **KW)):
            raise AssertionError(f"{what}: the rows differ from the rows entry's")
        plain = ss.candidates_plain(plain_rows, par_t, lambda_l1=KW["lambda_l1"],
                                    lambda_l2=KW["lambda_l2"], min_gain_to_split=MIN_GAIN,
                                    case_major=major).cpu()
        if not torch.equal(packed[:, 1:4], plain[:, 1:4]):
            raise AssertionError(f"{what}: feature, bin or direction differs from the plain "
                                 f"version: {packed[:, 1:4].tolist()} vs {plain[:, 1:4].tolist()}")
        for i in range(m):
            one = packed_call(hist[i:i + 1], parents[i:i + 1], inputs, major)[0]
            if one != packed[i].tolist():
                raise AssertionError(f"{what}: member {i} differs from a call of it alone")
    kinds = transfers(lambda: this_call(hist, parents, inputs, False))
    if (kinds["kernels"], kinds["HtoD"], kinds["DtoH"]) != (1, 0, 1):
        raise AssertionError(f"split_candidates {name}: a call is {kinds}, not one launch and "
                             "one device-to-host copy")


def bound_ms(m: int, f: int, b: int = 256):
    """(ms, 'bytes' or 'operations'): the histograms and parents read once,
    the candidates written once; ~20 f32 operations a (bin, direction)."""
    t_bytes = (m * f * b * 12 + m * 12 + m * 48 + f * 12) / HBM_BYTES_PER_S * 1e3
    t_ops = m * f * b * 2 * 20 / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def host_ms(fn: Callable, reps: int) -> float:
    """Median wall time of one call by the host's clock (each call ends
    with its candidates on the host)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_case(name, hist, parents, nb, nan, major, builds, reps: int) -> Dict[str, float]:
    """Checks (``check_case``), then every build's times of one call."""
    dev = hist.device
    inputs = ss.scan_inputs(nb, nan, torch.ones(hist.shape[1], device=dev), dev)
    check_case(name, hist, parents, inputs)
    want = this_call(hist, parents, inputs, major)
    res: Dict[str, float] = {}
    for bname, launch in builds.items():
        got = launch(hist, parents, inputs, major)
        if [c for c, _ in got] != [c for c, _ in want]:
            raise AssertionError(f"split scan {name}: the {bname} build's candidates differ")
    times: Dict[str, List[float]] = {}
    for bname in list(builds) + list(builds)[::-1]:
        launch = builds[bname]
        fn = lambda: launch(hist, parents, inputs, major)  # noqa: E731
        times.setdefault(f"{bname} event", []).append(time_ms(fn, reps=reps))
        times.setdefault(f"{bname} host", []).append(host_ms(fn, reps))
    res = {k: statistics.median(v) for k, v in times.items()}
    for bname, launch in builds.items():
        fn = lambda: launch(hist, parents, inputs, major)  # noqa: E731
        fn()
        events = _device_events(fn, 10, None)
        res[f"{bname} device"] = sum(e.time_range.elapsed_us() for e in events) / 10 / 1e3
        kinds = transfers(fn)
        res[f"{bname} ops"] = sum(kinds.values())
        res[f"{bname} transfers"] = kinds["HtoD"] + kinds["DtoH"]
    res["bound"] = bound_ms(hist.shape[0], hist.shape[1])[0]
    return res


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="a split_scan.cu of the earlier rows-only C entry")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_split_scan: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    took = _build.build_all(["split_scan"])
    for name, (secs, report) in sorted(took.items()):
        print(f"build {name}: {secs:.1f} s; ptxas: {report}")
    builds: Dict[str, Callable] = {}
    if args.baseline:
        lib, report = build_library(args.baseline, [], tempfile.mkdtemp(prefix="scan_bench_"))
        print(f"build baseline: ptxas: {report}")
        builds["baseline"] = baseline_launcher(lib)
    builds["this"] = lambda hist, parents, inputs, major: this_call(hist, parents, inputs, major)
    results = {}
    for name, (hist, parents, nb, nan, major) in cases(dev).items():
        res = run_case(name, hist, parents, nb, nan, major, builds, args.reps)
        results[name] = res
        print(f"case {name}: {hist.shape[0]} leaves x {hist.shape[1]} features; "
              + ", ".join(f"{k} {v:.4f}" for k, v in res.items())
              + "; packed candidates bit-equal to candidates_plain of the kernel's rows under "
              "both tie rules, members bit-equal to single calls")
    print(json.dumps({"card": card, "cases": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
