"""lightgbm_tpu_torch.random against ``jax.random``, bit for bit.

The port's threefry2x32 generator must give the keys, splits, fold-ins,
uniforms and Bernoulli draws of JAX's default generator in its
partitionable mode (``jax_threefry_partitionable``, asserted here so that a
change of JAX's default shows), on the CPU: the keys of seeds 0-3 and
2^31 - 1, chains of splits and fold-ins, ``uniform`` / ``bernoulli`` /
``random_bits`` at 1, 7, 4,096 and 1,000,003 draws, and the per-node draws
of ``fold_in_uniform``.
"""

import jax
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch import random as rnd

from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)

SEEDS = [0, 1, 2, 3, 2**31 - 1]
SIZES = [1, 7, 4096, 1_000_003]


def _pair(key) -> tuple:
    return tuple(int(v) for v in np.asarray(key).tolist())


def _u32(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32)


def test_jax_threefry_is_partitionable():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_and_fold_in_equal_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), rnd.prng_key(seed)
    assert _pair(jk) == tk
    for num in (2, 3, 5):
        assert [_pair(k) for k in jax.random.split(jk, num)] == rnd.split(tk, num)
    # a chain as the Booster draws its keys: split, keep the first, fold in
    for step, data in enumerate((0, 1, 7, 2**31 - 1, 2**32 - 1)):
        jk, jsub = jax.random.split(jk)
        tk, tsub = rnd.split(tk)
        assert _pair(jk) == tk and _pair(jsub) == tsub, step
        assert _pair(jax.random.fold_in(jsub, data)) == rnd.fold_in(tsub, data), (step, data)


@pytest.mark.parametrize("seed,n", [(s, n) for n in SIZES for s in (0, 2**31 - 1)
                                    if n < SIZES[-1] or s == 0])
def test_uniform_bernoulli_and_bits_equal_jax(seed, n):
    """(The largest draw, ~1.5 s a call on the CPU, at one seed and one p.)"""
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    tk = rnd.fold_in(rnd.prng_key(seed), 11)
    got = rnd.uniform(tk, n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(_u32(got.numpy()), _u32(jax.random.uniform(jk, (n,))))
    small = n < SIZES[-1]
    if small:
        np.testing.assert_array_equal(rnd.random_bits(tk, n).numpy().astype(np.uint32),
                                      np.asarray(jax.random.bits(jk, (n,))))
    for p in (0.7, 0.5, 0.1) if small else (0.7,):
        np.testing.assert_array_equal(rnd.bernoulli(tk, p, n).numpy(),
                                      np.asarray(jax.random.bernoulli(jk, p, (n,))))


def test_uniform_takes_its_key_and_device_only():
    """Draws of one key at two lengths share their prefix (the counters are
    the element indices) and a tensor p compares in f32."""
    k = rnd.prng_key(9)
    short, long_ = rnd.uniform(k, 100), rnd.uniform(k, 1000)
    assert torch.equal(short, long_[:100])
    p = torch.linspace(0.0, 1.0, 1000)
    assert torch.equal(rnd.bernoulli(k, p, 1000), long_ < p)


def test_fold_in_uniform_equals_jax_per_row():
    key = rnd.split(rnd.prng_key(4))[1]
    jkey = jax.random.split(jax.random.PRNGKey(4))[1]
    seeds = [0, 1, 2, 5, 6, 2 * 254 + 2, 4_000_000_000]
    got = rnd.fold_in_uniform(key, seeds, 28)
    assert got.shape == (len(seeds), 28)
    for i, s in enumerate(seeds):
        want = jax.random.uniform(jax.random.fold_in(jkey, s), (28,))
        np.testing.assert_array_equal(_u32(got[i].numpy()), _u32(want), err_msg=str(s))


def test_threefry_on_tensor_keys_matches_each_key_alone():
    keys = [rnd.prng_key(s) for s in (0, 5, 77)]
    k1 = torch.tensor([k[0] for k in keys])[:, None]
    k2 = torch.tensor([k[1] for k in keys])[:, None]
    x0 = torch.zeros((1, 16), dtype=torch.int64)
    x1 = torch.arange(16)[None, :]
    b0, b1 = rnd.threefry2x32(k1, k2, x0, x1)
    for i, k in enumerate(keys):
        c0, c1 = rnd.threefry2x32(k[0], k[1], x0[0], x1[0])
        assert torch.equal(b0[i], c0) and torch.equal(b1[i], c1)
    assert int(b0.max()) < 2**32 and int(b0.min()) >= 0


def test_prng_key_refuses_a_negative_seed():
    with pytest.raises(ValueError, match="seed >= 0"):
        rnd.prng_key(-1)
