"""Counter-based random numbers equal bit for bit to ``jax.random``.

Counterpart of the ``jax.random`` calls the JAX package makes (``PRNGKey``,
``split``, ``fold_in``, ``uniform`` in f32, ``bernoulli``) under JAX's
default generator, threefry2x32 (Salmon et al., "Parallel random numbers:
as easy as 1, 2, 3", SC 2011) in its partitionable mode
(``jax_threefry_partitionable=True``, the default since jax 0.5):

* ``threefry2x32(k1, k2, x0, x1)``: 20 rounds on two 32-bit words with
  the rotations (13, 15, 26, 6) / (17, 29, 16, 24) and a key injection
  every four rounds (jax/_src/prng.py ``_threefry2x32_lowering``);
* ``split(key, n)`` and ``random_bits(key, n)`` hash the 64-bit counters
  0 .. n-1 given as (hi, lo) word pairs (``iota_2x32_shape``): a split's
  key i is the hash's pair i, 32-bit bits are the two words xor-ed;
* ``fold_in(key, d)`` is the hash of the one pair (0, d);
* ``uniform`` keeps the top 23 bits as the mantissa of a float in [1, 2)
  and subtracts 1; ``bernoulli(key, p)`` is ``uniform < p`` in f32.

A key is a pair of Python ints (each below 2^32), kept on the host: a
split or a fold-in is a hash of a few counters in Python integers, and the
per-node draws of a tree (``fold_in_uniform``, a few features a node) one
numpy pass, so neither needs the device nor costs more than microseconds.
``random_bits`` / ``uniform`` / ``bernoulli`` hash n counters on the given
device in PyTorch operators, in int64 masked to 32 bits (``torch.uint32``
has few operators); the JAX package computes these in XLA outside every
kernel, so there is no kernel to port.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

Key = Tuple[int, int]

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x0, x1):
    """The threefry2x32 hash of the word pairs (x0, x1) under the key (k1,
    k2): words and keys are Python ints, int64 tensors or uint64 numpy
    arrays of values below 2^32 (keys broadcast against the words: a key a
    row); returns the two hashed words in the same type."""
    ks = (k1 & _MASK, k2 & _MASK, (k1 ^ k2 ^ _PARITY) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _hash_pairs(key: Key, hi: torch.Tensor, lo: torch.Tensor):
    return threefry2x32(int(key[0]), int(key[1]), hi, lo)


def _counters(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 64-bit counters 0 .. n-1 as (hi, lo) words."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _MASK


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``: (seed >> 32, seed & 0xFFFFFFFF), for
    0 <= seed < 2^32 the pair (0, seed)."""
    seed = int(seed)
    if seed < 0:
        raise ValueError("prng_key takes a seed >= 0")
    return ((seed >> 32) & _MASK, seed & _MASK)


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)``: key i is the hash of counter i."""
    return [_hash_pairs(key, i >> 32, i & _MASK) for i in range(num)]


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: the hash of the pair (0, data),
    data taken as uint32."""
    return _hash_pairs(key, 0, int(data) & _MASK)


def fold_in_uniform(key: Key, data: Sequence[int], n: int) -> torch.Tensor:
    """[len(data), n] f32 on the host: row i is ``uniform(fold_in(key,
    data[i]), n)``, every row hashed in one numpy pass (the per-node draws
    of a tree, a row a node)."""
    d = np.array([int(v) & _MASK for v in data], dtype=np.uint64)
    k1, k2 = _hash_pairs(key, np.zeros_like(d), d)
    lo = np.arange(n, dtype=np.uint64)
    b0, b1 = threefry2x32(k1[:, None], k2[:, None], np.zeros_like(lo)[None, :], lo[None, :])
    bits = (((b0 ^ b1) >> 9) | 0x3F800000).astype(np.uint32)
    return torch.from_numpy(bits.view(np.float32) - np.float32(1.0))


def _to_uniform(bits: torch.Tensor) -> torch.Tensor:
    bits = (bits >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def random_bits(key: Key, n: int, device="cpu") -> torch.Tensor:
    """[n] 32-bit words (int64 tensor) of ``jax.random.bits(key, (n,))``."""
    b0, b1 = _hash_pairs(key, *_counters(n, device))
    return b0 ^ b1


def uniform(key: Key, n: int, device="cpu") -> torch.Tensor:
    """[n] f32 ``jax.random.uniform(key, (n,))`` in [0, 1)."""
    return _to_uniform(random_bits(key, n, device))


def bernoulli(key: Key, p: Union[float, torch.Tensor], n: int, device="cpu") -> torch.Tensor:
    """[n] bool ``jax.random.bernoulli(key, p, (n,))``: uniform < p, with
    p in f32 (a Python float as JAX's weak type rounds it)."""
    p = torch.as_tensor(p, dtype=torch.float32, device=device)
    return uniform(key, n, device) < p
