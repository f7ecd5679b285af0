"""Threefry-2x32 keys and the draws of ``jax.random`` the port needs, bit for bit.

The reference samples with ``jax.random`` (``serve/sampling.py``): a key
``PRNGKey(seed)``, ``fold_in`` of the batch row and the token index, then
``categorical(key, logits)``, which is the argmax of ``logits + gumbel``
with the Gumbel noise drawn from ``uniform(minval=tiny)`` over
``random_bits(key, 32, (V,))``.  This module computes the same bits with
jax 0.9.0's defaults (threefry-2x32, ``jax_threefry_partitionable=True``,
the "low" Gumbel mode):

* a key is a pair of uint32 words, here two Python ints;
* ``PRNGKey(seed)`` of a non-negative seed < 2^32 is ``(0, seed)``;
* ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under ``key``;
* ``random_bits(key, (V,))`` hashes the counter pairs ``(0, i)`` for
  i < V and XORs the two output words; a shaped draw hashes the pair
  (high word, low word) of each element's flat row-major index, so
  ``bits(key, (2, 3))`` is ``bits(key, (6,))`` reshaped;
* ``split(key, n)[i]`` is the hash's two output words of ``(0, i)``;
* ``uniform`` puts the top 23 bits in the mantissa of a float in [1, 2) and
  subtracts 1; ``bernoulli(key, p)`` is ``uniform < p`` and ``rademacher``
  ``2 · bernoulli(key, ½) − 1`` (the quantizers' and ``metrics.pma``'s
  draws).

The hash runs in int64 tensors with every sum reduced mod 2^32 (PyTorch
has no unsigned 32-bit shifts), on the device of the logits, so a row that
lives on the card is sampled there.  Scalar hashes (keys) run on Python
ints.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1: int, k2: int, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x0, x1)`` under
    the key ``(k1, k2)``.  ``x0``/``x1`` are Python ints or int64 tensors
    holding values in [0, 2^32); returns the two output words alike."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^32)."""
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed must be in [0, 2^32), got {seed}")
    return (0, int(seed))


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)`` for data in [0, 2^32)."""
    return threefry2x32(key[0], key[1], 0, int(data) & _MASK)


def split(key: tuple[int, int], n: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, n)``: key i is the hash of ``(0, i)``."""
    count = torch.arange(n, dtype=torch.int64)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(count), count)
    return list(zip(y0.tolist(), y1.tolist()))


def random_bits(key: tuple[int, int], shape, device) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (an int ``shape`` is ``(shape,)``) as
    int64 values in [0, 2^32)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = 1
    for d in shape:
        n *= d
    count = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key[0], key[1], count >> 32, count & _MASK)
    return (y0 ^ y1).reshape(shape)


def fold_in_many(key: tuple[int, int], data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``fold_in(key, d)`` for every d of an int64 tensor of uint32 values:
    a batch of keys as two int64 word tensors shaped like ``data``, made on
    ``data``'s device (what ``jax.vmap`` of ``fold_in`` over ``data`` gives)."""
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data & _MASK)


def split_many(keys: tuple[torch.Tensor, torch.Tensor],
               n: int = 2) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """:func:`split` of every key of a batch ``keys`` (two word tensors [E]):
    n batches of keys, batch i holding each key's i-th subkey."""
    count = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    y0, y1 = threefry2x32(keys[0][:, None], keys[1][:, None], torch.zeros_like(count), count)
    return [(y0[:, i], y1[:, i]) for i in range(n)]


def uniform_many(keys: tuple[torch.Tensor, torch.Tensor], shape) -> torch.Tensor:
    """:func:`uniform` under every key of a batch (two word tensors [E]):
    [E, *shape], row e drawn under key e (``jax.vmap`` of ``uniform``)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = 1
    for d in shape:
        n *= d
    count = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    y0, y1 = threefry2x32(keys[0][:, None], keys[1][:, None], count >> 32, count & _MASK)
    return torch.clamp_min(_unit(y0 ^ y1), 0.0).reshape(keys[0].shape[0], *shape)


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """The top 23 of 32 bits as the mantissa of a float in [1, 2), minus 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _unit_floats(key: tuple[int, int], shape, device) -> torch.Tensor:
    return _unit(random_bits(key, shape, device))


def uniform(key: tuple[int, int], shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1)."""
    return torch.clamp_min(_unit_floats(key, shape, device), 0.0)


def bernoulli(key: tuple[int, int], p: float, shape, device) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` (bool)."""
    return uniform(key, shape, device) < p


def rademacher(key: tuple[int, int], shape, device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.rademacher(key, shape, dtype)``: ±1."""
    return (2 * bernoulli(key, 0.5, shape, device).to(dtype) - 1).to(dtype)


def uniform_tiny(key: tuple[int, int], n: int, device) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval=tiny, maxval=1)``:
    :func:`_unit_floats` plus tiny (1 − tiny rounds to 1 in f32), at least
    tiny."""
    return torch.clamp_min(_unit_floats(key, n, device) + _TINY, _TINY)


def gumbel(key: tuple[int, int], n: int, device) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` in its "low" mode:
    −log(−log(u)) in f32."""
    return -torch.log(-torch.log(uniform_tiny(key, n, device)))


def categorical(key: tuple[int, int], logits: torch.Tensor) -> int:
    """``jax.random.categorical(key, logits)`` of one f32 row [V]: the first
    argmax of ``gumbel + logits``."""
    noise = gumbel(key, logits.shape[-1], logits.device)
    return int(torch.argmax(noise + logits.to(torch.float32)))
