"""Quantizers: QuEST (forward), stochastic rounding (backward), packed KV.

Port of ``repro.core.quantizers`` (``quest``, ``sr_absmax_fast``,
``kv_quantize``, ``kv_dequantize``).  Blocks are 1-D along the last axis.
The paper's baseline quantizers (``rtn_absmax``, ``sr_absmax`` …) arrive
with the baselines slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import fastrng
from repro_torch.core import formats as F
from repro_torch.core.formats import Format


class QuantResult(NamedTuple):
    values: torch.Tensor  # f32, on-grid × scale, input's shape
    codes: torch.Tensor  # int8 half-codes (2 × grid value), input's shape
    scales: torch.Tensor  # f32 [..., K/block]
    mask: torch.Tensor  # bool, input's shape (True = inside the grid)


class PackedQuant(NamedTuple):
    """Storage payload, 4.25 bits/element: ``codes`` u8 [..., K/2] (two E2M1
    nibbles per byte), ``scales`` u8 E8M0 codes [..., K/block]."""

    codes: torch.Tensor
    scales: torch.Tensor


def _block_scales(x: torch.Tensor, fmt: Format, kind: str) -> torch.Tensor:
    """Raw (pre-rounding) per-block scales; kind 'absmax' | 'rms'."""
    xb = F.to_blocks(x.to(torch.float32), fmt.block)
    if kind == "absmax":
        raw = F.div_exact(torch.amax(torch.abs(xb), dim=-1), fmt.max_value)
    elif kind == "rms":
        c = float(torch.tensor(F.gaussian_optimal_clip(fmt.name), dtype=torch.float32))
        rms = torch.sqrt(torch.mean(xb * xb, dim=-1))
        raw = F.div_exact(rms * c, fmt.max_value)
    else:
        raise ValueError(kind)
    return torch.clamp(raw, min=2.0 ** F.E8M0_MIN_EXP)


def _finish(x: torch.Tensor, scales: torch.Tensor, fmt: Format,
            q: torch.Tensor) -> QuantResult:
    values = F.from_blocks(q * scales[..., None])
    codes = F.from_blocks(torch.round(q * 2.0).to(torch.int8))
    xb = F.to_blocks(x.to(torch.float32), fmt.block)
    mask = F.from_blocks(torch.abs(xb / scales[..., None]) <= fmt.max_value)
    return QuantResult(values, codes, scales, mask)


def quest(x: torch.Tensor, fmt: Format = F.MXFP4) -> QuantResult:
    """QuEST: Gaussian-fit clip scale c*·rms (E8M0 nearest) + E2M1 RTN + the
    trust mask.  Callers rotate by the grouped Hadamard first."""
    scales = F.round_scale_e8m0(_block_scales(x, fmt, "rms"))
    xb = F.to_blocks(x.to(torch.float32), fmt.block)
    q = F.rtn_e2m1(torch.clamp(xb / scales[..., None], -fmt.max_value, fmt.max_value))
    return _finish(x, scales, fmt, q)


def sr_absmax_fast(x: torch.Tensor, seed, fmt: Format = F.MXFP4,
                   scale_mode: str = "ceil", salt: int = 0) -> QuantResult:
    """Stochastic rounding with per-block AbsMax scales (E8M0 ``ceil``: no
    clipping, so unbiased) and uniforms from the counter hash over the
    element's index in ``[..., K/block, block]`` (``core.fastrng``).  A
    tensor of seeds [E] takes x [E, ...], slice e hashed at seeds[e] over its
    own index, as the reference's vmap over the leading axis draws."""
    scales = F.round_scale_e8m0(_block_scales(x, fmt, "absmax"), scale_mode)
    xb = F.to_blocks(x.to(torch.float32), fmt.block)
    per_slice = isinstance(seed, torch.Tensor)
    u = fastrng.uniform(seed, xb.shape[1:] if per_slice else xb.shape, salt, x.device)
    q = F.stochastic_round_to_grid(xb / scales[..., None], fmt.grid, u)
    return _finish(x, scales, fmt, q)


def kv_quantize(x: torch.Tensor, fmt: Format = F.MXFP4) -> PackedQuant:
    """Quantize-on-write for KV pages: per-block AbsMax → E8M0 nearest →
    E2M1 RTN → packed nibbles + biased-exponent scale bytes."""
    scales = F.round_scale_e8m0(_block_scales(x, fmt, "absmax"))
    xb = F.to_blocks(x.to(torch.float32), fmt.block)
    q = F.rtn_e2m1(torch.clamp(xb / scales[..., None], -fmt.max_value, fmt.max_value))
    codes = F.pack_nibbles(F.from_blocks(F.e2m1_to_nibble(q)))
    return PackedQuant(codes, F.scale_to_e8m0_code(scales))


def kv_dequantize(pq: PackedQuant, fmt: Format = F.MXFP4,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Packed nibbles × E8M0 block scales → values in ``dtype``."""
    vals = F.nibble_to_e2m1(F.unpack_nibbles(pq.codes))
    scales = F.e8m0_code_to_scale(pq.scales)
    return F.from_blocks(F.to_blocks(vals, fmt.block) * scales[..., None]).to(dtype)
