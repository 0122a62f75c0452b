"""lightgbm_tpu_torch fused grow step and int8 accumulation against the JAX
package.

The same bins and statistics, made from a numpy seed, are packed by both
packages:

* the plain ``fused_grow_step`` against the JAX XLA oracle on K=2 adjacent,
  non-tile-aligned windows (the shapes of test_fused_step.py): row order,
  nl, nr, child_start, child_cnt and the f32 histogram exactly;
* the plain int8 ``seg_hist`` (K windows) and int8 ``fused_grow_step``
  against the JAX Pallas kernels in interpret mode with the same scales:
  histograms bit for bit (integer digit sums, the same f32 recombine);
* ``hist_acc_scales`` against the JAX package's, exactly;
* ``fused_best_split(with_margin=True)`` against JAX ``best_split(...,
  with_margin=True)``: the same candidate and the same f32 margin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.pallas import grow_step as jax_grow_step
from lightgbm_tpu.ops.pallas.seg import (
    pack_rows as jax_pack_rows,
    padded_rows,
    seg_hist_pallas_batch,
    unpack_stats,
)
from lightgbm_tpu.ops.quantize import hist_acc_scales as jax_hist_acc_scales
from lightgbm_tpu.ops.split import best_split as jax_best_split

from lightgbm_tpu_torch.ops import grow_step, seg, split_scan
from lightgbm_tpu_torch.quantize import hist_acc_scales

from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)
from .test_torch_interpret import jax_interpret

# K=2 adjacent windows, neither start aligned to a tile: (start, cnt, feat,
# tbin, dl, nanb); the second sends its NaN bin left
MEMBERS = [(37, 1900, 3, 120, 0, -1), (37 + 1900, 2300, 7, 80, 1, 200)]


def _problem(n=5000, f=11, nb=256, seed=5):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, nb, size=(n, f)).astype(np.int32)
    grad = rng.normal(size=n).astype(np.float32)
    hess = (rng.random(n) + 0.5).astype(np.float32)
    mask = (rng.random(n) < 0.9).astype(np.float32)
    return bins, grad, hess, mask


def _torch_rows(bins, grad, hess, mask):
    return seg.pack_rows(
        torch.as_tensor(np.ascontiguousarray(bins.T).astype(np.uint8)),
        torch.as_tensor(grad), torch.as_tensor(hess), torch.as_tensor(mask),
    )


def _jax_seg(bins, grad, hess, mask):
    n_pad = padded_rows(bins.shape[0])
    return jax_pack_rows(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(mask), n_pad,
    ), n_pad


def _jax_members():
    cols = np.asarray(MEMBERS, np.int32).T
    return tuple(jnp.asarray(c) for c in cols) + (
        jnp.zeros(2, jnp.int32), jnp.zeros((2, 1), jnp.float32),
    )


def _port_step(rows, scales=None):
    cols = np.asarray(MEMBERS).T
    return grow_step.fused_grow_step(rows, *cols, 256, quant_scales=scales)


def _assert_rows_equal(rows, seg_j, f, n):
    b_j, g_j, h_j, m_j, r_j = (np.asarray(a) for a in unpack_stats(seg_j, f, n))
    np.testing.assert_array_equal(rows.bins.numpy().T, b_j)
    np.testing.assert_array_equal(rows.g.numpy(), g_j)
    np.testing.assert_array_equal(rows.h.numpy(), h_j)
    np.testing.assert_array_equal(rows.m.numpy(), m_j)
    np.testing.assert_array_equal(rows.ridx.numpy(), r_j)


def test_fused_grow_step_plain_equals_xla_oracle():
    bins, grad, hess, mask = _problem()
    rows = _torch_rows(bins, grad, hess, mask)
    got = _port_step(rows)
    seg_j, n_pad = _jax_seg(bins, grad, hess, mask)
    want = jax_grow_step.fused_grow_step(
        seg_j, *_jax_members(), f=11, num_bins=256, n_pad=n_pad,
    )
    for i, name in enumerate(("nl", "nr", "child_start", "child_cnt")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i + 1]), err_msg=name)
    _assert_rows_equal(rows, want[0], 11, 5000)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[5]))
    # the smaller child's rows are where dec says, and the step composes
    # from the two launches it replaces
    rows2 = _torch_rows(bins, grad, hess, mask)
    for (s, c, ft, tb, dl, nb), cs, cc, h in zip(MEMBERS, got[2], got[3], got[4]):
        seg.sort_partition(rows2, s, c, ft, tb, bool(dl), nb)
        assert torch.equal(seg.seg_hist(rows2, int(cs), int(cc), 256), h)


def test_hist_acc_scales_equal_jax():
    _, grad, hess, mask = _problem(seed=9)
    grad[17] = -7.25  # the largest |g| is a negative one
    got = hist_acc_scales(torch.as_tensor(grad), torch.as_tensor(hess), torch.as_tensor(mask))
    want = jax_hist_acc_scales(jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
    tiny = hist_acc_scales(torch.zeros(4), torch.zeros(4))
    np.testing.assert_array_equal(tiny.numpy(), np.float32([1e-30, 1e-30]))


def _scales(grad, hess, mask):
    s = jax_hist_acc_scales(jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(mask))
    return torch.as_tensor(np.asarray(s, np.float32)), jnp.asarray(np.asarray(s, np.float32))


def test_int8_seg_hist_plain_equals_pallas_interpret():
    bins, grad, hess, mask = _problem(n=2000, f=5, nb=64, seed=2)
    rows = _torch_rows(bins, grad, hess, mask)
    seg_j, n_pad = _jax_seg(bins, grad, hess, mask)
    st, sj = _scales(grad, hess, mask)
    windows = [(0, 2000), (130, 333), (1999, 1), (500, 0)]
    got = seg.seg_hist_batch(rows, windows, 64, st).numpy()
    want = np.asarray(seg_hist_pallas_batch(
        seg_j, jnp.asarray(windows, jnp.int32), sj, f=5, num_bins=64,
        n_pad=n_pad, quantized=True, interpret=True,
    ))
    np.testing.assert_array_equal(got, want)
    assert not got[3].any()  # cnt = 0: a zero histogram
    # the int8 grid stays within a step of the f32 sums
    f32 = seg.seg_hist_batch(rows, windows, 64).numpy()
    np.testing.assert_array_equal(got[..., 2], f32[..., 2])
    step = float(st.max()) * 2000
    assert np.abs(got[..., :2] - f32[..., :2]).max() <= step


def test_int8_fused_grow_step_plain_equals_pallas_interpret():
    bins, grad, hess, mask = _problem()
    rows = _torch_rows(bins, grad, hess, mask)
    st, sj = _scales(grad, hess, mask)
    got = _port_step(rows, st)
    seg_j, n_pad = _jax_seg(bins, grad, hess, mask)
    assert not jax_grow_step._INTERPRET
    with jax_interpret(seg=False, grow_step=True):
        want = jax_grow_step.fused_grow_step(
            seg_j, *_jax_members(), f=11, num_bins=256, n_pad=n_pad,
            quant_scales=(sj[0], sj[1]),
        )
    for i, name in enumerate(("nl", "nr", "child_start", "child_cnt")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i + 1]), err_msg=name)
    _assert_rows_equal(rows, want[0], 11, 5000)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[5]))


def test_fused_grow_step_raises_on_a_categorical_member():
    rows = _torch_rows(*_problem(n=300, f=3, nb=16))
    with pytest.raises(ValueError, match="categorical"):
        grow_step.fused_grow_step(rows, [0], [300], [0], [5], [0], [-1], 16, iscats=[1])


@pytest.mark.parametrize("seed,tie", [(0, False), (3, True)])
def test_fused_best_split_margin_equals_best_split(seed, tie):
    rng = np.random.default_rng(seed)
    f, b = 6, 32
    hist = np.zeros((f, b, 3), np.float32)
    hist[..., 0] = rng.normal(size=(f, b))
    hist[..., 1] = rng.random((f, b)) + 0.5
    hist[..., 2] = rng.integers(5, 40, size=(f, b))
    num_bins = np.full(f, b, np.int32)
    nan_bins = np.full(f, -1, np.int32)
    if tie:  # every feature alike: an exact tie, margin 0
        hist[:] = hist[0]
    else:
        nan_bins[2] = b - 1
    tot = hist[0].sum(0)
    kw = dict(lambda_l1=0.0, lambda_l2=0.5, min_data_in_leaf=5,
              min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0)
    cand, margin = split_scan.fused_best_split(
        torch.as_tensor(hist), *map(float, tot), torch.as_tensor(num_bins),
        torch.as_tensor(nan_bins), torch.ones(f, dtype=torch.bool),
        with_margin=True, **kw,
    )
    jc, jm = jax_best_split(
        jnp.asarray(hist), jnp.float32(tot[0]), jnp.float32(tot[1]), jnp.float32(tot[2]),
        jnp.asarray(num_bins), jnp.asarray(nan_bins), jnp.ones(f, bool),
        with_margin=True, **kw,
    )
    assert (cand.feature, cand.bin, cand.default_left) == (
        int(jc.feature), int(jc.bin), bool(jc.default_left))
    assert np.float32(margin) == np.float32(jm)
    assert (margin == 0.0) == tie
