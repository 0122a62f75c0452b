"""lightgbm_tpu_torch segment rows (ops/seg.py) against the JAX package.

The same bins and statistics, made from a numpy seed, are packed by both
packages; window histograms and stable window partitions are compared:

* the plain histogram against ``seg_hist_cpu`` exactly: both add each
  cell's rows in row order in f32;
* against the Pallas kernel ``seg_hist_pallas`` in interpret mode at one
  tiny shape within 5e-6 relative: the kernel splits every addend into
  three bf16 digits (~26 bits), so its sums differ in the last bits;
* the partition against ``sort_partition_xla`` exactly, row order and nl.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.pallas.seg import (
    pack_rows as jax_pack_rows,
    padded_rows,
    seg_hist_cpu,
    seg_hist_pallas,
    unpack_stats,
)
from lightgbm_tpu.ops.segpart import sort_partition_xla

from lightgbm_tpu_torch.ops import seg

from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)


def _problem(n, f, nb, seed, nan_bin=True):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, nb, size=(n, f)).astype(np.int32)
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.random(n).astype(np.float32) + 0.01
    mask = (rng.random(n) < 0.9).astype(np.float32)
    return bins, grad, hess, mask


def _torch_rows(bins, grad, hess, mask):
    return seg.pack_rows(
        torch.as_tensor(np.ascontiguousarray(bins.T).astype(np.uint8)),
        torch.as_tensor(grad), torch.as_tensor(hess), torch.as_tensor(mask),
    )


def _jax_seg(bins, grad, hess, mask):
    n = bins.shape[0]
    n_pad = padded_rows(n)
    return jax_pack_rows(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(mask), n_pad,
    ), n_pad


@pytest.mark.parametrize("start,cnt", [(0, 3000), (17, 1200), (2999, 1), (500, 0)])
def test_seg_hist_plain_equals_seg_hist_cpu(start, cnt):
    bins, grad, hess, mask = _problem(3000, 8, 64, seed=1)
    rows = _torch_rows(bins, grad, hess, mask)
    got = seg.seg_hist(rows, start, cnt, 64).numpy()
    segj, n_pad = _jax_seg(bins, grad, hess, mask)
    want = np.asarray(seg_hist_cpu(
        segj, jnp.asarray([start, cnt], jnp.int32), f=8, num_bins=64, n_pad=n_pad,
    ))
    np.testing.assert_array_equal(got, want)


def test_seg_hist_plain_matches_pallas_interpret():
    bins, grad, hess, mask = _problem(700, 5, 16, seed=2)
    rows = _torch_rows(bins, grad, hess, mask)
    segj, n_pad = _jax_seg(bins, grad, hess, mask)
    for start, cnt in [(0, 700), (130, 333)]:
        got = seg.seg_hist(rows, start, cnt, 16).numpy()
        want = np.asarray(seg_hist_pallas(
            segj, jnp.asarray([start, cnt], jnp.int32), f=5, num_bins=16,
            n_pad=n_pad, interpret=True,
        ))
        np.testing.assert_array_equal(got[..., 2], want[..., 2])  # counts exact
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < 5e-6


@pytest.mark.parametrize("start,cnt,feat,tbin,dl,nanb", [
    (0, 3000, 3, 20, False, -1),
    (250, 1700, 0, 40, True, 63),  # the NaN bin goes left
    (250, 1700, 0, 40, False, 63),  # the NaN bin goes right
    (1000, 1, 5, 0, False, -1),
    (40, 900, 7, 63, False, -1),  # every row goes left
])
def test_sort_partition_equals_xla(start, cnt, feat, tbin, dl, nanb):
    bins, grad, hess, mask = _problem(3000, 8, 64, seed=3)
    rows = _torch_rows(bins, grad, hess, mask)
    nl = int(seg.sort_partition(rows, start, cnt, feat, tbin, dl, nanb))

    segj, n_pad = _jax_seg(bins, grad, hess, mask)
    seg2, nl_j, _ = sort_partition_xla(
        segj, jnp.int32(start), jnp.int32(cnt), jnp.int32(feat),
        jnp.int32(tbin), jnp.int32(int(dl)), jnp.int32(nanb), jnp.int32(0),
        jnp.zeros((1,), jnp.float32), f=8, n_pad=n_pad,
    )
    b_j, g_j, h_j, m_j, r_j = (np.asarray(a) for a in unpack_stats(seg2, 8, 3000))
    assert nl == int(nl_j)
    np.testing.assert_array_equal(rows.bins.numpy().T, b_j)
    np.testing.assert_array_equal(rows.g.numpy(), g_j)
    np.testing.assert_array_equal(rows.h.numpy(), h_j)
    np.testing.assert_array_equal(rows.m.numpy(), m_j)
    np.testing.assert_array_equal(rows.ridx.numpy(), r_j)


def test_partition_then_histogram_windows_add_up():
    """After a partition the two child windows' histograms add up to the
    parent's (counts exactly)."""
    bins, grad, hess, mask = _problem(2000, 6, 32, seed=4)
    rows = _torch_rows(bins, grad, hess, mask)
    parent = seg.seg_hist(rows, 100, 1500, 32)
    nl = int(seg.sort_partition(rows, 100, 1500, 2, 11, False, -1))
    left = seg.seg_hist(rows, 100, nl, 32)
    right = seg.seg_hist(rows, 100 + nl, 1500 - nl, 32)
    torch.testing.assert_close(left + right, parent, rtol=1e-6, atol=1e-5)
    assert torch.equal(left[..., 2] + right[..., 2], parent[..., 2])
    assert bool((rows.bins[2, 100 : 100 + nl] <= 11).all())
    assert bool((rows.bins[2, 100 + nl : 1600] > 11).all())
