"""Numeric formats: MXFP4 = E2M1 elements + E8M0 power-of-two block scales.

Port of ``repro.core.formats`` for the serving path.  Every rounding rule is
written as exact integer / power-of-two arithmetic, so the same code gives
the same bits on the CPU, on the card, and inside the CUDA kernels:

* E2M1 round-to-nearest-even is the arithmetic form of the reference's
  native ``float4_e2m1fn`` cast (no fp4 type exists on the CPU or before
  ``sm_100a``);
* E8M0-nearest (``round(log2 s)``) compares the f32 mantissa with √2
  instead of calling ``log2``, so it is exact.  A float ``log2`` is not: the
  reference's (XLA on the CPU) rounds the wrong way for ``s`` within about
  8 ulps of ``√2·2^k`` (tests/test_torch_numerics.py sweeps that window).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

# E2M1 positive grid: subnormal 0, 0.5; normals 1, 1.5, 2, 3, 4, 6
_E2M1_POS = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class Format:
    """A block-scaled quantization format: the signed element grid at scale
    1 and the block size sharing one E8M0 scale (1-D, along the last axis)."""

    name: str
    grid: tuple[float, ...]
    block: int

    @property
    def max_value(self) -> float:
        return float(self.grid[-1])


MXFP4 = Format("mxfp4", tuple(np.unique(np.concatenate([-_E2M1_POS, _E2M1_POS]))), 32)
FORMATS: dict[str, Format] = {MXFP4.name: MXFP4}


def get_format(name: str) -> Format:
    try:
        return FORMATS[name]
    except KeyError:
        raise ValueError(f"unknown format {name!r}; have {sorted(FORMATS)}") from None


# ---------------------------------------------------------------------------
# exact arithmetic helpers
# ---------------------------------------------------------------------------


def div_exact(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded once, as IEEE division.

    PyTorch on CUDA turns division by a Python scalar into multiplication by
    its reciprocal (two roundings); a 0-d tensor on ``x``'s device keeps a
    true division, matching the reference's ``x / 6.0``."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# E8M0 scales
# ---------------------------------------------------------------------------

E8M0_MIN_EXP = -126
E8M0_MAX_EXP = 127
# mantissa bits of the smallest f32 above √2 (0x3FB504F4): 1.m ≥ √2 ⇔ m ≥ this
_SQRT2_MANTISSA = 0x3504F4


def exp2i(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e (f32) for integer e ∈ [-126, 127], built from the bits."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def e8m0_nearest_exponent(scale: torch.Tensor) -> torch.Tensor:
    """int32 ``round(log2(max(scale, 2^-126)))`` clamped to [-126, 127].

    Exact: the exponent field plus one when the mantissa is at or above √2
    (``log2`` of a positive f32 is never exactly k + ½, so no tie exists)."""
    s = torch.clamp(scale.to(torch.float32), min=2.0 ** E8M0_MIN_EXP)
    bits = s.view(torch.int32)
    e = (bits >> 23) - 127 + ((bits & 0x7FFFFF) >= _SQRT2_MANTISSA).to(torch.int32)
    return torch.clamp(e, E8M0_MIN_EXP, E8M0_MAX_EXP)


def round_scale_e8m0(scale: torch.Tensor, mode: str = "nearest") -> torch.Tensor:
    """Positive f32 scales → nearest power of two (the forward's rule).

    The backward's ``"ceil"`` mode arrives with the training slice."""
    if mode != "nearest":
        raise NotImplementedError(f"e8m0 rounding mode {mode!r} is not ported yet")
    return exp2i(e8m0_nearest_exponent(scale))


def scale_to_e8m0_code(scale: torch.Tensor) -> torch.Tensor:
    """Biased-exponent uint8 code of a power-of-two scale (storage format)."""
    return (e8m0_nearest_exponent(scale) + 127).to(torch.uint8)


def e8m0_code_to_scale(code: torch.Tensor) -> torch.Tensor:
    return exp2i(code.to(torch.int32) - 127)


# ---------------------------------------------------------------------------
# E2M1 rounding and nibble codes
# ---------------------------------------------------------------------------


def _binade(a: torch.Tensor) -> torch.Tensor:
    """2^e with e = clip(floor(log2(max(a, 1))), 0, 2), by comparisons."""
    one = torch.ones_like(a)
    return torch.where(a >= 4.0, 4.0 * one, torch.where(a >= 2.0, 2.0 * one, one))


def rtn_e2m1(x: torch.Tensor) -> torch.Tensor:
    """E2M1 round-to-nearest, ties to even, saturating at ±6 (f32 out).

    One mantissa bit per binade: round(a / 2^e · 2) / 2 · 2^e with
    ``torch.round`` (half to even); below 1 the grid is uniform at ½."""
    x = x.to(torch.float32)
    a = torch.clamp(torch.abs(x), max=6.0)
    pw = _binade(a)
    q_norm = torch.round(a / pw * 2.0) * 0.5 * pw
    q_sub = torch.round(a * 2.0) * 0.5
    # copysign keeps the sign of ±0 and of values that round to zero, as the
    # reference's native cast does
    return torch.copysign(torch.where(a >= 1.0, q_norm, q_sub), x)


def e2m1_to_nibble(q: torch.Tensor) -> torch.Tensor:
    """On-grid E2M1 values → 4-bit codes 0..15 (uint8, bit 3 = sign).
    Negative zero maps to code 0."""
    q = q.to(torch.float32)
    a = torch.abs(q)
    pw = _binade(a)
    e = (a >= 2.0).to(torch.float32) + (a >= 4.0).to(torch.float32)
    idx = torch.where(a >= 1.0, 2.0 + 2.0 * e + (a / pw * 2.0 - 2.0), a * 2.0)
    sign = (q < 0).to(torch.uint8) << 3
    return idx.to(torch.uint8) | sign


def nibble_to_e2m1(codes: torch.Tensor) -> torch.Tensor:
    """4-bit codes 0..15 (uint8) → f32 E2M1 grid values."""
    table = torch.as_tensor(_E2M1_POS, dtype=torch.float32, device=codes.device)
    mag = table[(codes & 7).to(torch.int64)]
    return torch.where((codes & 8) > 0, -mag, mag)


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """uint8 codes [..., K] → packed uint8 [..., K/2], even element high."""
    k = codes.shape[-1]
    if k % 2 != 0:
        raise ValueError(f"last dim {k} not even")
    pairs = codes.reshape(*codes.shape[:-1], k // 2, 2)
    return (pairs[..., 0] << 4) | (pairs[..., 1] & 0xF)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """packed uint8 [..., K/2] → uint8 codes [..., K] (high nibble first)."""
    return torch.stack([(packed >> 4) & 0xF, packed & 0xF],
                       dim=-1).reshape(*packed.shape[:-1], -1)


# ---------------------------------------------------------------------------
# block reshaping
# ---------------------------------------------------------------------------


def to_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """[..., K] → [..., K // block, block]."""
    k = x.shape[-1]
    if k % block != 0:
        raise ValueError(f"last dim {k} not divisible by block {block}")
    return x.reshape(*x.shape[:-1], k // block, block)


def from_blocks(xb: torch.Tensor) -> torch.Tensor:
    return xb.reshape(*xb.shape[:-2], xb.shape[-2] * xb.shape[-1])


@functools.lru_cache(maxsize=None)
def gaussian_optimal_clip(fmt_name: str) -> float:
    """Clip multiplier c* minimising E[(x − Q(clip(x)))²] for x ~ N(0, 1),
    by numeric integration on the host (QuEST's RMS-fit scale = c*·std)."""
    grid = np.asarray(get_format(fmt_name).grid, dtype=np.float64)
    gmax = grid[-1]
    xs = np.linspace(-12.0, 12.0, 48001)
    pdf = np.exp(-0.5 * xs**2) / np.sqrt(2 * np.pi)
    mids = (grid[1:] + grid[:-1]) / 2.0

    def mse(c: float) -> float:
        scaled = xs / (c / gmax)
        q = grid[np.searchsorted(mids, np.clip(scaled, -gmax, gmax))]
        return float(np.trapezoid((xs - q * (c / gmax)) ** 2 * pdf, xs))

    cs = np.linspace(1.0, 8.0, 141)
    c0 = cs[int(np.argmin([mse(c) for c in cs]))]
    cs2 = np.linspace(c0 - 0.1, c0 + 0.1, 81)
    return float(cs2[int(np.argmin([mse(c) for c in cs2]))])
