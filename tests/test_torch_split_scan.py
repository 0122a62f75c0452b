"""lightgbm_tpu_torch split search (ops/split.py, ops/split_scan.py) against
the JAX package, on leaf histograms made from a numpy seed.

* the blocked prefix sum equals XLA's CPU cumsum bit for bit (the order the
  JAX package's best_split runs in);
* the port's best_split equals the JAX best_split: same feature, bin and
  direction, and the same f32 gain and left statistics (same arithmetic on
  the same prefix sums);
* the plain scan rows match the Pallas kernel split_scan_pallas in
  interpret mode: same bin and direction per feature, gains and sums within
  1e-5 relative (the kernel's prefix sums go through bf16 digits, ~26 bits);
* fused_best_split agrees with best_split on the chosen split;
* exact gain ties between features: where the JAX package's split-scan
  kernel is off (the ordered layout's default, more than 64 features or
  256 bins), the port takes best_split's case-major rule, serial and
  batched; where the kernel is on, the kernel's first-feature rule;
* the packed candidate row the kernel reduces to (``candidates_plain``):
  bit-equal to the old host reduction of the same rows and within 1e-5 of
  the JAX package's fused_best_split, on random leaves and exact ties,
  under both tie rules, with and without margin; a split's two children in
  one call equal two single calls.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.ops.pallas.split_scan import fused_best_split as jax_fused_best_split
from lightgbm_tpu.ops.pallas.split_scan import split_scan_pallas
from lightgbm_tpu.ops.split import best_split as jax_best_split

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops.split import SplitCandidate, best_split, leaf_gain, prefix_sum_bins
from lightgbm_tpu_torch.ops.split_scan import (
    CAND_COLS,
    candidates_plain,
    fused_best_split,
    fused_best_split_batch,
    split_scan,
    unpack_candidates,
)

from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)

HYPER = [
    dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=20,
         min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0),
    dict(lambda_l1=0.3, lambda_l2=1.0, min_data_in_leaf=40,
         min_sum_hessian_in_leaf=2.0, min_gain_to_split=0.1),
]


def _leaf(n, f, b, seed, nan_frac):
    """A leaf histogram [F, B, 3] built from n rows, its parent stats and
    per-feature bin counts (ragged) with NaN bins on a share of features."""
    rng = np.random.default_rng(seed)
    num_bins = rng.integers(max(2, b // 2), b + 1, size=f).astype(np.int32)
    has_nan = rng.random(f) < nan_frac
    nan_bins = np.where(has_nan, num_bins - 1, -1).astype(np.int32)
    g = rng.normal(size=n).astype(np.float32)
    h = (rng.random(n) + 0.1).astype(np.float32)
    hist = np.zeros((f, b, 3), np.float32)
    for j in range(f):
        bj = rng.integers(0, num_bins[j], size=n)
        np.add.at(hist[j, :, 0], bj, g)
        np.add.at(hist[j, :, 1], bj, h)
        np.add.at(hist[j, :, 2], bj, 1.0)
    parent = hist[0].sum(axis=0)
    return hist, parent, num_bins, nan_bins


CASES = [(4000, 8, 64, 0.5), (3000, 6, 16, 1.0), (60, 3, 8, 0.0)]


def test_prefix_sum_is_xla_cpu_cumsum():
    rng = np.random.default_rng(0)
    for b in (8, 64, 256):
        x = rng.normal(size=(5, b, 3)).astype(np.float32) * 100
        got = prefix_sum_bins(torch.as_tensor(x)).numpy()
        want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=1))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hp", HYPER)
@pytest.mark.parametrize("n,f,b,nan_frac", CASES)
def test_best_split_equals_jax(hp, n, f, b, nan_frac):
    hist, parent, num_bins, nan_bins = _leaf(n, f, b, seed=n + f, nan_frac=nan_frac)
    mask = np.ones(f, bool)
    want = jax_best_split(
        jnp.asarray(hist), *map(jnp.float32, parent), jnp.asarray(num_bins),
        jnp.asarray(nan_bins), jnp.asarray(mask), **hp,
    )
    got = best_split(
        torch.as_tensor(hist), *map(float, parent), torch.as_tensor(num_bins),
        torch.as_tensor(nan_bins), torch.as_tensor(mask), **hp,
    )
    assert got.gain == float(want.gain)
    if not np.isfinite(got.gain):
        return
    assert (got.feature, got.bin, got.default_left) == (
        int(want.feature), int(want.bin), bool(want.default_left)
    )
    for k in ("left_g", "left_h", "left_cnt", "right_g", "right_h", "right_cnt"):
        assert getattr(got, k) == float(getattr(want, k)), k


@pytest.mark.parametrize("n,f,b,nan_frac", CASES)
def test_scan_rows_match_pallas_interpret(n, f, b, nan_frac):
    hp = dict(HYPER[0])
    hp.pop("min_gain_to_split")
    hist, parent, num_bins, nan_bins = _leaf(n, f, b, seed=7 * n + f, nan_frac=nan_frac)
    mask = np.ones(f, bool)
    mask[-1] = False  # a masked-out feature has no candidate
    got = split_scan(
        torch.as_tensor(hist), torch.as_tensor(parent), torch.as_tensor(num_bins),
        torch.as_tensor(nan_bins), torch.as_tensor(mask), **hp,
    ).numpy()
    want = np.asarray(split_scan_pallas(
        jnp.asarray(hist), jnp.asarray(parent), jnp.asarray(num_bins),
        jnp.asarray(nan_bins), jnp.asarray(mask), f=f, num_bins_pad=b,
        l1=hp["lambda_l1"], l2=hp["lambda_l2"], min_data=hp["min_data_in_leaf"],
        min_hess=hp["min_sum_hessian_in_leaf"], interpret=True,
    ))
    live = np.isfinite(want[:, 0])
    np.testing.assert_array_equal(np.isfinite(got[:, 0]), live)
    np.testing.assert_array_equal(got[live, 1:3], want[live, 1:3])
    np.testing.assert_allclose(got[live][:, [0, 3, 4, 5]], want[live][:, [0, 3, 4, 5]],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("hp", HYPER)
@pytest.mark.parametrize("n,f,b,nan_frac", CASES)
def test_fused_best_split_agrees_with_best_split(hp, n, f, b, nan_frac):
    hist, parent, num_bins, nan_bins = _leaf(n, f, b, seed=3 * n + f, nan_frac=nan_frac)
    args = (
        torch.as_tensor(hist), *map(float, parent), torch.as_tensor(num_bins),
        torch.as_tensor(nan_bins), torch.ones(f, dtype=torch.bool),
    )
    want = best_split(*args, **hp)
    got = fused_best_split(*args, **hp)
    assert got.gain == want.gain
    if np.isfinite(want.gain):
        assert got[1:] == want[1:]


# two features tie at gain 50: feature 0 only with its NaN rows sent left,
# feature 1 with missing-right (ROADMAP.md Queue 3, F1)
TIE_X = np.array([[np.nan, 0], [np.nan, 0], [1, 0], [1, 0], [2, 1], [2, 1], [2, 1], [2, 1]],
                 dtype=np.float64)
TIE_Y = np.array([5, 5, 5, 5, 0, 0, 0, 0], dtype=np.float64)
TIE_PARAMS = {"objective": "regression", "num_leaves": 2, "min_data_in_leaf": 1,
              "min_sum_hessian_in_leaf": 0.0}


def _first_split(tree):
    return int(tree.split_feature[0]), int(tree.split_bin[0]), bool(tree.default_left[0])


def test_exact_tie_on_the_ordered_layout_follows_jax_best_split():
    params = {**TIE_PARAMS, "hist_mode": "ordered"}
    jp = {**params, "verbosity": -1, "metric": "none"}
    jb = lgb.train(jp, lgb.Dataset(TIE_X, TIE_Y, params=jp), 1)
    tb = lt.train(params, lt.Dataset(TIE_X, TIE_Y, params=params), 1, device="cpu")
    assert tb._grower_params.case_major_ties
    jr = jb._bin_records[0]
    want = (int(jr["split_feature"][0]), int(jr["split_bin"][0]), bool(jr["default_left"][0]))
    assert want == (1, 0, False)
    assert _first_split(tb.trees[0]) == want
    np.testing.assert_allclose(tb.predict(TIE_X), jb.predict(TIE_X), rtol=0, atol=1e-6)


def test_exact_tie_on_seg_keeps_the_kernel_rule():
    """At F <= 64 on seg the JAX package's kernel scan (fused_ok) takes the
    first feature with the largest row gain, and so does the port."""
    tb = lt.train(TIE_PARAMS, lt.Dataset(TIE_X, TIE_Y, params=TIE_PARAMS), 1, device="cpu")
    assert tb.hist_mode == "seg" and not tb._grower_params.case_major_ties
    assert _first_split(tb.trees[0]) == (0, 0, True)


def _tied_leaves():
    """Leaf histograms [3, 2, 4, 3] of TIE_X's two features at the root's
    gradients (g = mean - y, h = 1): as they are; swapped (the missing-right
    feature first); feature 0 twice (missing-left only)."""
    g = np.where(TIE_Y > 0, -2.5, 2.5).astype(np.float32)
    f0 = np.array([3, 3, 0, 0, 1, 1, 1, 1])  # NaN -> bin 3
    f1 = np.array([0, 0, 0, 0, 1, 1, 1, 1])

    def feat(bins):
        out = np.zeros((4, 3), np.float32)
        np.add.at(out, bins, np.stack([g, np.ones(8), np.ones(8)], 1).astype(np.float32))
        return out

    hist = np.stack([np.stack([feat(f0), feat(f1)]), np.stack([feat(f1), feat(f0)]),
                     np.stack([feat(f0), feat(f0)])])
    nan_bins = [np.array(v, np.int32) for v in ([3, -1], [-1, 3], [3, 3])]
    return hist, nan_bins


@pytest.mark.parametrize("hp", HYPER)
@pytest.mark.parametrize("n,f,b,nan_frac", CASES)
def test_case_major_candidate_agrees_with_best_split(hp, n, f, b, nan_frac):
    hist, parent, num_bins, nan_bins = _leaf(n, f, b, seed=3 * n + f, nan_frac=nan_frac)
    args = (
        torch.as_tensor(hist), *map(float, parent), torch.as_tensor(num_bins),
        torch.as_tensor(nan_bins), torch.ones(f, dtype=torch.bool),
    )
    want = best_split(*args, **hp)
    got = fused_best_split(*args, case_major=True, **hp)
    assert got.gain == want.gain
    if np.isfinite(want.gain):
        assert got[1:] == want[1:]


@pytest.mark.parametrize("batched", [False, True])
def test_case_major_candidates_equal_best_split_on_ties(batched):
    hist, nan_bins = _tied_leaves()
    m, f, b, _ = hist.shape
    hp = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=1,
              min_sum_hessian_in_leaf=0.0, min_gain_to_split=0.0)
    num_bins = torch.full((f,), 3, dtype=torch.int32)
    mask = torch.ones(f, dtype=torch.bool)
    parents = hist[:, 0].sum(axis=1)
    want, kernel, got = [], [], []
    for i in range(m):
        args = (torch.as_tensor(hist[i]), *map(float, parents[i]), num_bins,
                torch.as_tensor(nan_bins[i]), mask)
        want.append(best_split(*args, **hp))
        kernel.append(fused_best_split(*args, **hp))
        if batched:  # one leaf a launch: the members' NaN bins differ
            got += fused_best_split_batch(
                torch.as_tensor(hist[i:i + 1]), torch.as_tensor(parents[i:i + 1]),
                num_bins, torch.as_tensor(nan_bins[i]), mask, case_major=True,
                with_margin=True, **hp)
        else:
            got.append(fused_best_split(*args, case_major=True, with_margin=True, **hp))
    assert [c for c, _ in got] == want
    assert [margin for _, margin in got] == [0.0] * m  # exact ties
    # the kernel's rule takes the missing-left feature 0 of the first leaf
    assert [(c.feature, c.default_left) for c in kernel] == [(0, True), (0, False), (0, True)]
    assert [(c.feature, c.default_left) for c in want] == [(1, False), (0, False), (0, True)]


def _old_candidates(rows, parent, *, lambda_l1, lambda_l2, min_gain_to_split, with_margin,
                    case_major=False):
    """The candidates as the port computed them before the kernel reduced
    them (its host ``_candidates``): the oracle of the packed row."""
    m, f = rows.shape[0], rows.shape[1]
    if case_major:
        gain = rows[..., 0]
        cases = torch.cat([torch.where(rows[..., 2] <= 0.5, gain, float("-inf")), gain], dim=1)
        feat = torch.argmax(cases, dim=1) % f
    else:
        feat = torch.argmax(rows[..., 0], dim=1)
    r = rows[torch.arange(m), feat]
    improvement = (r[:, 0] - leaf_gain(parent[:, 0], parent[:, 1], lambda_l1, lambda_l2)
                   - min_gain_to_split)
    parts = [improvement[:, None], r[:, :6], parent - r[:, 3:6], feat.to(torch.float32)[:, None]]
    if with_margin:
        others = torch.where(torch.arange(f)[None, :] == feat[:, None], float("-inf"),
                             rows[..., 0])
        sec = torch.maximum(others.max(dim=1).values, r[:, 6])
        margin = torch.where(torch.isfinite(r[:, 0]) & torch.isfinite(sec),
                             (r[:, 0] - sec) / torch.clamp(r[:, 0].abs(), min=1e-15),
                             float("inf"))
        parts.append(margin[:, None])
    out = []
    for vals in torch.cat(parts, dim=1).tolist():
        gain = vals[0] if np.isfinite(vals[1]) else float("-inf")
        cand = SplitCandidate(gain, int(vals[10]), int(vals[2]), vals[3] > 0.5, vals[4],
                              vals[5], vals[6], vals[7], vals[8], vals[9])
        out.append((cand, vals[11]) if with_margin else cand)
    return out


def _leaves_and_ties():
    """[(hist, parent, num_bins, nan_bins)]: the random leaves of CASES and
    the three exactly tied leaves of ``_tied_leaves``."""
    out = [_leaf(n, f, b, seed=5 * n + f, nan_frac=nan_frac) for n, f, b, nan_frac in CASES]
    hist, nan_bins = _tied_leaves()
    for i in range(hist.shape[0]):
        out.append((hist[i], hist[i, 0].sum(axis=0), np.full(2, 3, np.int32), nan_bins[i]))
    return out


@pytest.mark.parametrize("case_major", [False, True])
@pytest.mark.parametrize("with_margin", [False, True])
@pytest.mark.parametrize("hp", HYPER)
def test_packed_candidates_equal_the_old_candidates(hp, with_margin, case_major):
    """candidates_plain, unpacked, is the old host reduction of the same
    rows, bit for bit (gains, statistics, margins), on random leaves and on
    exact ties, under both tie rules."""
    hp = {**hp, "min_data_in_leaf": 1} if hp is HYPER[0] else hp
    scan_kw = {k: v for k, v in hp.items() if k != "min_gain_to_split"}
    for hist, parent, num_bins, nan_bins in _leaves_and_ties():
        f = hist.shape[0]
        rows = split_scan(torch.as_tensor(hist), torch.as_tensor(parent),
                          torch.as_tensor(num_bins), torch.as_tensor(nan_bins),
                          torch.ones(f, dtype=torch.bool), **scan_kw)[None]
        par = torch.as_tensor(parent, dtype=torch.float32)[None]
        packed = candidates_plain(rows, par, lambda_l1=hp["lambda_l1"],
                                  lambda_l2=hp["lambda_l2"],
                                  min_gain_to_split=hp["min_gain_to_split"],
                                  case_major=case_major)
        assert packed.shape == (1, CAND_COLS) and packed.dtype == torch.float32
        want = _old_candidates(rows, par, lambda_l1=hp["lambda_l1"], lambda_l2=hp["lambda_l2"],
                               min_gain_to_split=hp["min_gain_to_split"],
                               with_margin=with_margin, case_major=case_major)
        assert unpack_candidates(packed.tolist(), with_margin) == want


def _jax_kw(hp):
    return dict(lambda_l1=hp["lambda_l1"], lambda_l2=hp["lambda_l2"],
                min_data_in_leaf=hp["min_data_in_leaf"],
                min_sum_hessian_in_leaf=hp["min_sum_hessian_in_leaf"],
                min_gain_to_split=hp["min_gain_to_split"])


@pytest.mark.parametrize("with_margin", [False, True])
@pytest.mark.parametrize("n,f,b,nan_frac", CASES)
def test_packed_candidate_agrees_with_jax_fused_best_split(n, f, b, nan_frac, with_margin):
    """The port's candidate (the plain scan, then candidates_plain) against
    the JAX package's fused_best_split, its Pallas scan in interpret mode:
    the same feature, bin and direction; gain, statistics and margin within
    1e-5 relative (the TPU kernel's prefix sums go through bf16 digits)."""
    hp = HYPER[1]
    hist, parent, num_bins, nan_bins = _leaf(n, f, b, seed=11 * n + f, nan_frac=nan_frac)
    got = fused_best_split(torch.as_tensor(hist), *map(float, parent), torch.as_tensor(num_bins),
                           torch.as_tensor(nan_bins), torch.ones(f, dtype=torch.bool),
                           with_margin=with_margin, **hp)
    want = jax_fused_best_split(jnp.asarray(hist), *map(jnp.float32, parent),
                                jnp.asarray(num_bins), jnp.asarray(nan_bins), jnp.ones(f, bool),
                                interpret=True, with_margin=with_margin, **_jax_kw(hp))
    if with_margin:
        (got, margin), (want, want_margin) = got, want
        np.testing.assert_allclose(margin, float(want_margin), rtol=1e-4, atol=1e-6)
    assert (got.feature, got.bin, got.default_left) == (
        int(want.feature), int(want.bin), bool(want.default_left))
    for k in ("gain", "left_g", "left_h", "left_cnt", "right_g", "right_h", "right_cnt"):
        np.testing.assert_allclose(getattr(got, k), float(getattr(want, k)), rtol=1e-5,
                                   atol=1e-4, err_msg=k)


def test_packed_candidates_on_exact_ties_agree_with_jax():
    """The three tied leaves: the kernel rule against the JAX package's
    fused_best_split (interpret mode), the case-major rule against its
    best_split; margin 0 in both (an exact tie)."""
    hist, nan_bins = _tied_leaves()
    hp = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=1,
              min_sum_hessian_in_leaf=0.0, min_gain_to_split=0.0)
    num_bins = np.full(2, 3, np.int32)
    mask = np.ones(2, bool)
    for i in range(hist.shape[0]):
        parent = hist[i, 0].sum(axis=0)
        targs = (torch.as_tensor(hist[i]), *map(float, parent), torch.as_tensor(num_bins),
                 torch.as_tensor(nan_bins[i]), torch.as_tensor(mask))
        jargs = (jnp.asarray(hist[i]), *map(jnp.float32, parent), jnp.asarray(num_bins),
                 jnp.asarray(nan_bins[i]), jnp.asarray(mask))
        for case_major in (False, True):
            got, margin = fused_best_split(*targs, with_margin=True, case_major=case_major, **hp)
            if case_major:
                want, want_margin = jax_best_split(*jargs, with_margin=True, **hp)
            else:
                want, want_margin = jax_fused_best_split(*jargs, interpret=True, with_margin=True,
                                                         **_jax_kw(hp))
            assert (got.feature, got.bin, got.default_left) == (
                int(want.feature), int(want.bin), bool(want.default_left)), (i, case_major)
            assert got.gain == float(want.gain)
            assert margin == float(want_margin) == 0.0


@pytest.mark.parametrize("case_major", [False, True])
def test_two_children_in_one_call_equal_two_single_calls(case_major):
    """The serial loop's M = 2 call (two separate [F, B, 3] histograms, as
    the grower passes a split's children) against one call a child: the same
    candidates and margins, bit for bit."""
    hp = HYPER[1]
    (h0, p0, num_bins, nan_bins), (h1, p1, _, _) = [
        _leaf(4000, 8, 64, seed=s, nan_frac=0.5) for s in (21, 22)]
    args = (torch.as_tensor(num_bins), torch.as_tensor(nan_bins), torch.ones(8, dtype=torch.bool))
    both = fused_best_split_batch([torch.as_tensor(h0), torch.as_tensor(h1)],
                                  [tuple(map(float, p0)), tuple(map(float, p1))], *args,
                                  with_margin=True, case_major=case_major, **hp)
    one = [fused_best_split(torch.as_tensor(h), *map(float, p), *args, with_margin=True,
                            case_major=case_major, **hp) for h, p in ((h0, p0), (h1, p1))]
    assert both == one


def test_kernel_source_agrees_with_the_wrapper():
    """csrc/split_scan.cu's constants and C entry as ops/split_scan.py calls
    it (the kernel builds only on the card): the members a launch, the
    packed row's columns, the arity _build gives, the ticket counter reset
    by the member's last block, one copy to the host and -fmad=false (the
    improvement and margin round as candidates_plain's f32 operations)."""
    import os
    import re

    from lightgbm_tpu_torch import _build
    from lightgbm_tpu_torch.ops import split_scan as ss

    with open(os.path.join(_build.CSRC, "split_scan.cu")) as fh:
        src = fh.read()
    assert int(re.search(r"kMaxMembers = (\d+);", src).group(1)) == ss.MAX_MEMBERS
    assert int(re.search(r"kCandCols = (\d+);", src).group(1)) == ss.CAND_COLS == 12
    decl = re.search(r'extern "C" int lgbt_split_scan\(([^)]*)\)', src).group(1)
    assert len(decl.split(",")) == len(_build.SIGNATURES["split_scan"])
    assert "if (last) tickets[member] = 0;" in src
    assert src.count("cudaMemcpyAsync(") == 1 and "cudaMemcpyDeviceToHost" in src
    assert "cudaMemcpyHostToDevice" not in src
    assert "-fmad=false" in _build.NVCC_FLAGS


@pytest.mark.parametrize("extra", [0, 1])
def test_transfers_reads_every_call_through_traces_that_lost_events(monkeypatch, extra):
    """bench_split_scan.transfers, which the card's check of one launch and
    one device-to-host copy a call reads: a trace of five calls may lose
    device events (one seen on the card kept a single call's), so a trace
    whose counts are not whole multiples of the calls is taken again, and
    each kind's count is the largest of three whole traces. Traces that
    lose events never hide an extra launch that every call makes."""
    from types import SimpleNamespace

    from lightgbm_tpu_torch import bench_split_scan as bss

    def trace(kernels, copies):
        return ([SimpleNamespace(name="split_scan_kernel")] * kernels +
                [SimpleNamespace(name="Memcpy DtoH (Device -> Pinned)")] * copies)

    k = 5 * (1 + extra)
    traces = iter([trace(1 + extra, 1), trace(0, 0), trace(k, 5), trace(k, 0), trace(k, 5)])
    monkeypatch.setattr(bss, "_device_events", lambda fn, reps, setup: next(traces))
    calls = []
    kinds = bss.transfers(lambda: calls.append(1))
    assert kinds == {"kernels": 1 + extra, "HtoD": 0, "DtoH": 1, "other": 0}
    assert len(calls) == 1 and next(traces, None) is None
