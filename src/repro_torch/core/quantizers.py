"""Quantizers: the four forward schemes of Table 2, stochastic rounding for
the backward, LSQ, and the packed KV payload.

Port of ``repro.core.quantizers``.  Each quantizer maps a tensor to a
block-scaled representation (blocks 1-D along the last axis; a format's
block 0 is one scale over the whole last axis) and returns a
:class:`QuantResult`: the dequantized values, the codes (int8 half-codes,
2 × grid value, for grids up to 63; the grid index for wider grids,
wrapped to int8 as the reference stores it), the scales after the format's
scale-dtype rounding, and the QuEST trust mask.

Every step is the reference's, element for element, so the outputs agree
bit for bit on the CPU and between the CPU and the card: divisions and
square roots round correctly on both, and QuEST's mean of squares sums a block's
squares one after another from its first element (XLA:CPU's order for rows
of up to 32 elements; a device-independent order for longer rows, which
the reference sums in an order of its own).  ``sr_absmax`` draws its
uniforms with ``core.threefry`` (``jax.random.uniform`` of a key, bit for
bit), ``sr_absmax_fast`` with the counter hash of ``core.fastrng``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import fastrng, threefry
from repro_torch.core import formats as F
from repro_torch.core.formats import Format


class QuantResult(NamedTuple):
    values: torch.Tensor  # f32, on-grid × scale, input's shape
    codes: torch.Tensor  # int8 codes, input's shape
    scales: torch.Tensor  # f32 [..., K/block]
    mask: torch.Tensor  # bool, input's shape (True = inside the grid)


class PackedQuant(NamedTuple):
    """Storage payload, 4.25 bits/element: ``codes`` u8 [..., K/2] (two E2M1
    nibbles per byte), ``scales`` u8 E8M0 codes [..., K/block]."""

    codes: torch.Tensor
    scales: torch.Tensor


def _block(x: torch.Tensor, fmt: Format) -> int:
    return fmt.block if fmt.block > 0 else x.shape[-1]


def _mean_square(xb: torch.Tensor) -> torch.Tensor:
    """Mean of squares over the last axis, the squares summed one after
    another from the first (module docstring), then divided by the count."""
    sq = xb * xb
    acc = sq[..., 0]
    for i in range(1, sq.shape[-1]):
        acc = acc + sq[..., i]
    return F.div_exact(acc, float(sq.shape[-1]))


def _block_scales(x: torch.Tensor, fmt: Format, kind: str) -> torch.Tensor:
    """Raw (pre-rounding) per-block scales; kind 'absmax' | 'rms'."""
    xb = F.to_blocks(x.to(torch.float32), _block(x, fmt))
    if kind == "absmax":
        raw = F.div_exact(torch.amax(torch.abs(xb), dim=-1), fmt.max_value)
    elif kind == "rms":
        c = float(torch.tensor(F.gaussian_optimal_clip(fmt.name), dtype=torch.float32))
        # the square root through float64 rounds correctly on every device
        # (torch's vectorised f32 sqrt on the CPU is off by an ulp at times)
        rms = torch.sqrt(_mean_square(xb).to(torch.float64)).to(torch.float32)
        raw = F.div_exact(rms * c, fmt.max_value)
    else:
        raise ValueError(kind)
    return torch.clamp(raw, min=2.0 ** F.E8M0_MIN_EXP)


def _codes_from_values(q: torch.Tensor, fmt: Format) -> torch.Tensor:
    """Half-codes (int8 = 2 × grid value) for grids up to 63, with the
    reference's float → int8 conversion (NaN → 0, saturating); for wider
    grids the index into the signed grid, wrapped to int8 as the
    reference's ``astype(int8)`` wraps it (MXFP8's and INT8's upper
    indices come out negative)."""
    if fmt.max_value <= 63.0:
        c = torch.clamp(torch.round(q * 2.0), -128.0, 127.0)
        return torch.where(torch.isnan(c), torch.zeros_like(c), c).to(torch.int8)
    grid = torch.as_tensor(fmt.grid_array, device=q.device)
    idx = torch.searchsorted(grid, q.contiguous())
    return ((idx + 128) % 256 - 128).to(torch.int8)


def _finish(x: torch.Tensor, scales: torch.Tensor, fmt: Format,
            q: torch.Tensor) -> QuantResult:
    values = F.from_blocks(q * scales[..., None])
    codes = F.from_blocks(_codes_from_values(q, fmt))
    xb = F.to_blocks(x.to(torch.float32), _block(x, fmt))
    mask = F.from_blocks(torch.abs(xb / scales[..., None]) <= fmt.max_value)
    return QuantResult(values, codes, scales, mask)


def _rtn(scaled: torch.Tensor, fmt: Format) -> torch.Tensor:
    """Round to nearest on the format's grid: the hardware E2M1 cast for the
    FP4 formats (saturating), else the grid's midpoints after a clip."""
    if fmt.name in ("mxfp4", "nvfp4"):
        return F.rtn_e2m1(scaled)
    return F.rtn_to_grid(torch.clamp(scaled, -fmt.max_value, fmt.max_value), fmt.grid)


# ---------------------------------------------------------------------------
# forward quantizers (Table 2)
# ---------------------------------------------------------------------------


def rtn_absmax(x: torch.Tensor, fmt: Format = F.MXFP4, scale_mode: str = "ceil") -> QuantResult:
    """Round to nearest with per-block AbsMax scales."""
    scales = F.quantize_scale(_block_scales(x, fmt, "absmax"), fmt, scale_mode)
    xb = F.to_blocks(x.to(torch.float32), _block(x, fmt))
    return _finish(x, scales, fmt, _rtn(xb / scales[..., None], fmt))


def sr_absmax(x: torch.Tensor, key: tuple[int, int], fmt: Format = F.MXFP4,
              scale_mode: str = "ceil") -> QuantResult:
    """Stochastic rounding with per-block AbsMax scales, uniforms
    ``jax.random.uniform(key, blocks' shape)`` (``key`` a threefry key).
    With ``scale_mode='ceil'`` nothing clips, so it is unbiased."""
    scales = F.quantize_scale(_block_scales(x, fmt, "absmax"), fmt, scale_mode)
    xb = F.to_blocks(x.to(torch.float32), _block(x, fmt))
    u = threefry.uniform(key, xb.shape, x.device)
    return _finish(x, scales, fmt, F.stochastic_round_to_grid(xb / scales[..., None],
                                                             fmt.grid, u))


def sr_absmax_fast(x: torch.Tensor, seed, fmt: Format = F.MXFP4,
                   scale_mode: str = "ceil", salt: int = 0, offset: int = 0,
                   row_len: int | None = None) -> QuantResult:
    """Stochastic rounding with per-block AbsMax scales and uniforms from the
    counter hash over the element's index in ``[..., K/block, block]``
    (``core.fastrng``), or in the window (``offset``, ``row_len``) of a
    larger logical [rows, row_len] operand that x [rows, K] is a block of.
    A tensor of seeds [E] takes x [E, ...], slice e hashed at seeds[e] over
    its own index, as the reference's vmap over the leading axis draws."""
    scales = F.quantize_scale(_block_scales(x, fmt, "absmax"), fmt, scale_mode)
    xb = F.to_blocks(x.to(torch.float32), _block(x, fmt))
    per_slice = isinstance(seed, torch.Tensor)
    if offset or row_len is not None:
        u = fastrng.uniform(seed, x.shape[1:] if per_slice else x.shape, salt, x.device,
                            offset, row_len).reshape(xb.shape)
    else:
        u = fastrng.uniform(seed, xb.shape[1:] if per_slice else xb.shape, salt, x.device)
    q = F.stochastic_round_to_grid(xb / scales[..., None], fmt.grid, u)
    return _finish(x, scales, fmt, q)


def quest(x: torch.Tensor, fmt: Format = F.MXFP4, scale_mode: str = "nearest") -> QuantResult:
    """QuEST: Gaussian-fit clip scale c*·rms + RTN + the trust mask.
    Callers rotate by the grouped Hadamard first."""
    scales = F.quantize_scale(_block_scales(x, fmt, "rms"), fmt, scale_mode)
    xb = F.to_blocks(x.to(torch.float32), _block(x, fmt))
    scaled = torch.clamp(xb / scales[..., None], -fmt.max_value, fmt.max_value)
    return _finish(x, scales, fmt, _rtn(scaled, fmt))


def rtn_absmax_pma(x: torch.Tensor, fmt: Format = F.MXFP4) -> QuantResult:
    """RTN AbsMax PMA (paper §4.3): RTN with ceil scales, values and scales
    multiplied by γ ≈ E[S] for Gaussian blocks (:func:`pma_gamma`)."""
    r = rtn_absmax(x, fmt, scale_mode="ceil")
    gamma = torch.tensor(pma_gamma(fmt), dtype=torch.float32, device=x.device)
    return QuantResult(r.values * gamma, r.codes, r.scales * gamma, r.mask)


@functools.lru_cache(maxsize=None)
def pma_gamma(fmt: Format) -> float:
    """E[S] for Gaussian blocks under RTN-AbsMax in this format, the
    reference's way: numpy ``default_rng(0)``, 4096 blocks, f32 sums."""
    rng = np.random.default_rng(0)
    block = fmt.block if fmt.block > 0 else 32
    x = rng.standard_normal((4096, block)).astype(np.float32)
    q = rtn_absmax(torch.from_numpy(x), fmt, scale_mode="ceil").values.numpy()
    num = float((x * x).sum())
    den = float((x * q).sum())
    return num / max(den, 1e-30)


# ---------------------------------------------------------------------------
# LSQ (learned step size)
# ---------------------------------------------------------------------------


class _LSQRound(torch.autograd.Function):
    """clip(round(x / step), ±qmax) · step with LSQ's gradients: the straight
    through estimator inside the grid for x; for the step, (round(v) − v)
    inside and ±qmax at the clip points, summed and scaled by
    1/√(qmax · numel)."""

    @staticmethod
    def forward(ctx, x, step, qmax):
        ctx.save_for_backward(x, step)
        ctx.qmax = qmax
        return torch.clamp(torch.round(x / step), -qmax, qmax) * step

    @staticmethod
    def backward(ctx, g):
        x, step = ctx.saved_tensors
        qmax = ctx.qmax
        v = x / step
        inside = (torch.abs(v) <= qmax).to(g.dtype)
        q = torch.clamp(torch.round(v), -qmax, qmax)
        dstep = torch.sum(g * torch.where(inside > 0, q - v, torch.sign(v) * qmax))
        grad_scale = 1.0 / torch.sqrt(torch.tensor(qmax * x.numel(), dtype=torch.float32,
                                                   device=x.device))
        return g * inside, (dstep * grad_scale).reshape(step.shape).to(step.dtype), None


def lsq(x: torch.Tensor, step: torch.Tensor, fmt: Format = F.INT4) -> torch.Tensor:
    """LSQ with a learnable per-tensor step (uniform grid formats)."""
    return _LSQRound.apply(x, step, fmt.max_value)


# ---------------------------------------------------------------------------
# packed KV payload
# ---------------------------------------------------------------------------


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


def state_quantize(x: torch.Tensor, fmt: Format = F.MXFP4) -> PackedQuant:
    """Quantize-on-write for flat per-slot state (the SSM state rings): the
    last axis, any length, zero-padded to whole blocks, then
    :func:`kv_quantize`.  Padding lanes sit in trailing blocks when the true
    extent is block-aligned, and otherwise only lower the last block's
    AbsMax; callers slice the true extent back in :func:`state_dequantize`."""
    pad = (-x.shape[-1]) % fmt.block
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return kv_quantize(x, fmt)


def state_dequantize(pq: PackedQuant, n: int, fmt: Format = F.MXFP4,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`state_quantize`: the padded payload dequantized and
    the last axis sliced back to its true extent ``n``."""
    return kv_dequantize(pq, fmt, dtype)[..., :n]
