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

A window (``offset``, ``row_len``) draws a block of a larger logical
tensor: element (row, col) of ``shape`` (its leading dims flattened into
rows) hashes the index ``offset + row · row_len + col``, mod 2^32, so a
block draws exactly the bits the whole tensor draws at its elements.  A
data-parallel rank's [B_l, N] rows of a [B, N] operand take offset
``r · B_l · N``; its [K, B_l] columns of a [K, B] operand take offset
``r · B_l`` and row length B.  The defaults (0, the last dim) draw the
tensor itself.
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


def _linear_index(shape, offset: int, row_len: int | None, device) -> torch.Tensor:
    """The hashed index of every element of ``shape`` (int64, mod 2^32)."""
    cols = shape[-1]
    rows = 1
    for d in shape[:-1]:
        rows *= d
    if row_len is None or row_len == cols:
        lin = torch.arange(rows * cols, dtype=torch.int64, device=device) + offset
    else:
        if row_len < cols:
            raise ValueError(f"window row length {row_len} < the block's {cols} columns")
        r = torch.arange(rows, dtype=torch.int64, device=device)[:, None] * row_len
        lin = r + torch.arange(cols, dtype=torch.int64, device=device)[None, :] + offset
    return lin.reshape(shape) & _MASK


def random_bits(seed, shape, salt: int = 0, device="cpu", offset: int = 0,
                row_len: int | None = None) -> torch.Tensor:
    """u32 bits (held in int64, in [0, 2^32)) of shape ``shape``, or
    ``[E, *shape]`` for a tensor of seeds [E]; (``offset``, ``row_len``) a
    window of a larger logical tensor (the module's docstring)."""
    shape = tuple(shape) if shape else (1,)
    lin = _linear_index(shape, offset, row_len, device)
    h = _mul32(lin, 2654435761)
    h = (h + _seed_term(seed, len(shape), device)) & _MASK
    h = (h + (salt & _MASK) * 3266489917 % (1 << 32)) & _MASK
    # two fmix rounds, as the reference
    h = _murmur3_fmix(h)
    return _murmur3_fmix((h + 0x9E3779B9) & _MASK)


def uniform(seed, shape, salt: int = 0, device="cpu", offset: int = 0,
            row_len: int | None = None) -> torch.Tensor:
    """U[0, 1) float32 from the top 24 bits (exactly representable)."""
    bits = random_bits(seed, shape, salt, device, offset, row_len)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def rademacher(seed, n: int, salt: int = 0, device="cpu", offset: int = 0) -> torch.Tensor:
    """±1 f32 signs [n] (or [E, n] for a tensor of seeds) for the randomized
    Hadamard transform; ``offset`` draws elements offset .. offset + n − 1
    of a longer sign vector."""
    bits = random_bits(seed, (n,), salt, device, offset)
    return torch.where((bits & 1) == 1, 1.0, -1.0).to(torch.float32)
