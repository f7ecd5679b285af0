"""Grouped (block-diagonal) Hadamard transforms.

Quartet rotates each contiguous group of g = 32 elements (the MXFP4 block)
by the normalized Sylvester matrix H_g, which is symmetric and involutory:
the forward uses the fixed H_g, the backward the randomized
Ĥ_g(x, ξ) = H_g · diag(ξ) with Rademacher signs ξ shared by the two operands
of each backward GEMM, so (x D H)(H D w) = x w before quantization.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def hadamard_matrix(g: int) -> np.ndarray:
    """Normalized g×g Hadamard matrix (Sylvester construction), g = 2^k."""
    if g & (g - 1) != 0 or g <= 0:
        raise ValueError(f"group size must be a power of two, got {g}")
    h = np.array([[1.0]])
    while h.shape[0] < g:
        h = np.block([[h, h], [h, -h]])
    return (h / np.sqrt(g)).astype(np.float32)


def hadamard_transform(x: torch.Tensor, g: int = 32, dim: int = -1) -> torch.Tensor:
    """Rotate every contiguous group of ``g`` elements along ``dim`` by H_g
    (a matrix product, as the reference computes it)."""
    x = torch.movedim(x, dim, -1)
    k = x.shape[-1]
    if k % g != 0:
        raise ValueError(f"axis length {k} not divisible by hadamard group {g}")
    h = torch.as_tensor(hadamard_matrix(g), dtype=x.dtype, device=x.device)
    out = (x.reshape(*x.shape[:-1], k // g, g) @ h).reshape(x.shape)
    return torch.movedim(out, -1, dim)


def _along(signs: torch.Tensor, x: torch.Tensor, dim: int) -> torch.Tensor:
    shape = [1] * x.dim()
    shape[dim] = x.shape[dim]
    return signs.reshape(shape).to(x.dtype)


def randomized_hadamard_transform(x: torch.Tensor, signs: torch.Tensor, g: int = 32,
                                  dim: int = -1) -> torch.Tensor:
    """Ĥ_g(x, ξ): sign flip along ``dim`` (``signs`` has that axis' length),
    then the grouped Hadamard along it."""
    return hadamard_transform(x * _along(signs, x, dim), g=g, dim=dim)
