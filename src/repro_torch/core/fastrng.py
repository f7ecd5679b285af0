"""Counter-based inline PRNG for stochastic rounding.

Port of ``repro.core.fastrng``, bit for bit: the bits of element i are a
murmur3-finalizer hash of (seed, salt, i), where i is the row-major linear
index of the element in the *logical* shape, wrapped mod 2^32.  The
backward Stage-1 kernel (``csrc/sr_hadamard_quant.cu``) computes the same
hash in registers, so no buffer of random bits ever exists on the card.

PyTorch has no unsigned 32-bit arithmetic on the CPU (no ``>>`` on
``uint32``), so the hash runs in int64 with every product reduced mod 2^32.
A product of two 32-bit values can reach 2^64 and overflow int64, so
:func:`_mul32` multiplies by the constant's two 16-bit halves (each partial
product stays below 2^48).

A seed is a Python int, or an int64 tensor of uint32 values ``[E]`` (a MoE
layer's per-expert seeds): then every function draws for each seed at
once, its output ``[E, *shape]`` holding, in slice e, exactly what the
Python seed ``seeds[e]`` draws.  The seed's product with the hash constant
goes through :func:`_mul32` too (a seed of 2^31 or more times the constant
overflows int64).
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h · c) mod 2^32 for int64 h in [0, 2^32) and a 32-bit constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK


def _murmur3_fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _seed_term(seed, ndim: int, device):
    """seed · 2246822519 mod 2^32: a Python int, or for a tensor of seeds
    [E] an int64 tensor [E, 1, ..., 1] that broadcasts over ``ndim`` axes."""
    if isinstance(seed, torch.Tensor):
        s = seed.to(device=device, dtype=torch.int64) & _MASK
        return _mul32(s, 2246822519).reshape(-1, *([1] * ndim))
    return (seed & _MASK) * 2246822519 % (1 << 32)


def random_bits(seed, shape, salt: int = 0, device="cpu") -> torch.Tensor:
    """u32 bits (held in int64, in [0, 2^32)) of shape ``shape``, or
    ``[E, *shape]`` for a tensor of seeds [E]."""
    shape = tuple(shape) if shape else (1,)
    n = 1
    for d in shape:
        n *= d
    lin = torch.arange(n, dtype=torch.int64, device=device).reshape(shape) & _MASK
    h = _mul32(lin, 2654435761)
    h = (h + _seed_term(seed, len(shape), device)) & _MASK
    h = (h + (salt & _MASK) * 3266489917 % (1 << 32)) & _MASK
    # two fmix rounds, as the reference
    h = _murmur3_fmix(h)
    return _murmur3_fmix((h + 0x9E3779B9) & _MASK)


def uniform(seed, shape, salt: int = 0, device="cpu") -> torch.Tensor:
    """U[0, 1) float32 from the top 24 bits (exactly representable)."""
    bits = random_bits(seed, shape, salt, device)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def rademacher(seed, n: int, salt: int = 0, device="cpu") -> torch.Tensor:
    """±1 f32 signs [n] (or [E, n] for a tensor of seeds) for the randomized
    Hadamard transform."""
    bits = random_bits(seed, (n,), salt, device)
    return torch.where((bits & 1) == 1, 1.0, -1.0).to(torch.float32)
