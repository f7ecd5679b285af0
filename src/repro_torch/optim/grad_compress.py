"""Gradient compression with error feedback: an SR-int8 round trip.

Port of ``repro.optim.grad_compress``.  Each gradient leaf (plus the error
carried from the last step) is stochastically rounded to int8 with one
absmax scale per block of 256 of its flattened elements, and dequantized:
the value a data-parallel all-reduce would average at 1 byte an element.
The residual stays local as the next step's error, so the compressed sum
tracks the true sum over steps (error feedback) and SR keeps it unbiased.
The uniforms are ``jax.random.uniform(key, [blocks, 256])``'s bits
(``core.threefry``), so a round trip equals the reference's bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from repro_torch.core import formats as F
from repro_torch.core import threefry

_BLOCK = 256


def _sr_int8(x: torch.Tensor, key: tuple[int, int]):
    """x (any shape) → (int8 codes [blocks, 256], f32 scales [blocks, 1]):
    the flattened x zero-padded to whole blocks, scale absmax / 127, codes
    floor(v) + 1 with probability v − floor(v), clipped to ±127."""
    flat = x.reshape(-1)
    b = Fn.pad(flat, (0, (-flat.numel()) % _BLOCK)).reshape(-1, _BLOCK)
    amax = torch.amax(torch.abs(b), dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-30) * F.recip(127.0)  # the jitted reference's / 127
    v = b / scale
    lo = torch.floor(v)
    u = threefry.uniform(key, v.shape, v.device)
    q = torch.clamp(torch.where(u < v - lo, lo + 1.0, lo), -127, 127)
    return q.to(torch.int8), scale


def compress_decompress_gradient(g: torch.Tensor, err: torch.Tensor, key: tuple[int, int]):
    """One error-feedback SR-int8 round trip of ``g`` under ``key``: returns
    (ĝ in g's dtype, the f32 residual g + err − ĝ carried to the next
    step)."""
    gf = g.to(torch.float32) + err
    q, scale = _sr_int8(gf, key)
    ghat = (q.to(torch.float32) * scale).reshape(-1)[: g.numel()].reshape(g.shape)
    # the reference's jitted residual is one fused multiply-add, gf − q·scale
    # rounded once (XLA:CPU contracts it): in float64 q·scale is exact and
    # the difference rounds once more only where |gf| is below 2^-29 of the
    # block's scale and q is ±1
    qs = (q.to(torch.float64) * scale.to(torch.float64)).reshape(-1)[: g.numel()]
    new_err = (gf.to(torch.float64) - qs.reshape(g.shape)).to(torch.float32)
    return ghat.to(g.dtype), new_err
