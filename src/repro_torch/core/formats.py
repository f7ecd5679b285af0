"""Numeric formats: MXFP4 = E2M1 elements + E8M0 power-of-two block scales.

Port of ``repro.core.formats``.  Every rounding rule is written as exact
integer / power-of-two arithmetic, so the same code gives the same bits on
the CPU, on the card, and inside the CUDA kernels:

* E2M1 round-to-nearest-even is the arithmetic form of the reference's
  native ``float4_e2m1fn`` cast (no fp4 type exists on the CPU or before
  ``sm_100a``);
* E8M0-nearest (``round(log2 s)``) compares the f32 mantissa with √2
  instead of calling ``log2``, so it is exact.  A float ``log2`` is not: the
  reference's (XLA on the CPU) rounds the wrong way for ``s`` within about
  8 ulps of ``√2·2^k`` (tests/test_torch_numerics.py sweeps that window);
* E8M0-ceil (``ceil(log2 s − 1e-6)``, the backward's rule) reads the
  exponent field and rounds up when the mantissa field is at least 6: that
  is the float64 value of the formula (log2(1 + m·2⁻²³) exceeds 1e-6 exactly
  when m ≥ 6).  The reference evaluates it with an f32 ``log2`` and an f32
  subtraction, which keeps 2^k for some m ≥ 6 and rounds some exact powers
  of two up (tests/test_torch_train.py sweeps m = 0..64 at every k);
* E8M0-floor (``floor(log2 s + 1e-6)``) likewise reads the bits: the
  exponent field, plus one when the mantissa field is at least
  2^23 − 11 (log2(1 + m·2⁻²³) + 1e-6 ≥ 1 exactly from there, so the
  11 floats below each power of two round up to it, as the formula says);
* the E4M3 scale cast of NVFP4 rounds to nearest-even by the bits and
  reproduces the reference's cast (``astype(float8_e4m3fn)`` in XLA), which
  turns every scale above 464 (and ∞, NaN) into NaN and every scale at or
  below 2⁻¹⁰ into 0; PyTorch's own cast saturates to 448 instead.

The grids of the other formats (E3M2, E4M3, E5M2, the symmetric integer
grids) are the reference's, built the same way on the host.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Literal

import numpy as np
import torch

# ---------------------------------------------------------------------------
# element grids (positive halves, float64, as the reference builds them)
# ---------------------------------------------------------------------------

# E2M1: subnormal 0, 0.5; normals 1, 1.5, 2, 3, 4, 6
_E2M1_POS = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], dtype=np.float64)

# E3M2 (FP6)
_E3M2_POS = np.array(
    [0.0, 0.0625, 0.125, 0.1875, 0.25, 0.3125, 0.375, 0.4375]
    + [v * 2.0**e for e in range(-2, 5) for v in (1.0, 1.25, 1.5, 1.75)],
    dtype=np.float64,
)


def _e4m3_grid() -> np.ndarray:
    """E4M3 (FN): subnormals m/8 · 2^-6, normals 1.m · 2^e for e in −6..8;
    the top code is NaN, so the largest value is 448."""
    vals = [0.0] + [m / 8.0 * 2.0**-6 for m in range(1, 8)]
    vals += [v for e in range(-6, 9) for m in range(8)
             if (v := (1.0 + m / 8.0) * 2.0**e) <= 448.0]
    return np.array(sorted(set(vals)), dtype=np.float64)


def _e5m2_grid() -> np.ndarray:
    """E5M2: subnormals m/4 · 2^-14, normals up to 57344."""
    vals = [0.0] + [m / 4.0 * 2.0**-14 for m in range(1, 4)]
    vals += [v for e in range(-14, 16) for m in range(4)
             if (v := (1.0 + m / 4.0) * 2.0**e) <= 57344.0]
    return np.array(sorted(set(vals)), dtype=np.float64)


_E4M3_POS = _e4m3_grid()
_E5M2_POS = _e5m2_grid()


def _int_grid(bits: int) -> np.ndarray:
    """Symmetric integer grid's positive half, e.g. INT4 → 0..7 (no −8)."""
    return np.arange(0, 2 ** (bits - 1), dtype=np.float64)


def _signed(pos: np.ndarray) -> tuple[float, ...]:
    return tuple(np.unique(np.concatenate([-pos, pos])))


@dataclasses.dataclass(frozen=True)
class Format:
    """A block-scaled quantization format.

    ``grid``: the signed element grid at scale 1 (sorted); ``block``: the
    elements sharing one scale (1-D, along the last axis; 0 = one scale over
    the whole last axis); ``scale_dtype``: "e8m0" (powers of two, the MX
    formats), "e4m3" (NVFP4) or "fp32"; ``bits``: the element width."""

    name: str
    grid: tuple[float, ...]
    block: int
    scale_dtype: Literal["e8m0", "e4m3", "fp32"]
    bits: int

    @property
    def grid_array(self) -> np.ndarray:
        return np.asarray(self.grid, dtype=np.float32)

    @property
    def max_value(self) -> float:
        return float(self.grid[-1])

    @property
    def num_levels(self) -> int:
        return len(self.grid)


MXFP4 = Format("mxfp4", _signed(_E2M1_POS), 32, "e8m0", 4)
NVFP4 = Format("nvfp4", _signed(_E2M1_POS), 16, "e4m3", 4)
MXFP6 = Format("mxfp6", _signed(_E3M2_POS), 32, "e8m0", 6)
MXFP8 = Format("mxfp8", _signed(_E4M3_POS), 32, "e8m0", 8)
FP8_E4M3 = Format("fp8_e4m3", _signed(_E4M3_POS), 0, "fp32", 8)
FP8_E5M2 = Format("fp8_e5m2", _signed(_E5M2_POS), 0, "fp32", 8)
INT4 = Format("int4", _signed(_int_grid(4)), 32, "fp32", 4)
INT8 = Format("int8", _signed(_int_grid(8)), 32, "fp32", 8)
BF16 = Format("bf16", (), 0, "fp32", 16)  # passthrough sentinel

FORMATS: dict[str, Format] = {
    f.name: f for f in (MXFP4, NVFP4, MXFP6, MXFP8, FP8_E4M3, FP8_E5M2, INT4, INT8, BF16)
}


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


def recip(c: float) -> float:
    """1/c rounded to f32.  Under ``jax.jit`` the reference's ``x / c`` of a
    constant c is XLA's ``x * (1/c)`` (its simplifier folds the
    reciprocal): one f32 rounding more than a true division when 1/c is no
    power of two.  Multiplying by this value reproduces it."""
    return float(np.float32(1.0) / np.float32(c))


# ---------------------------------------------------------------------------
# E8M0 scales
# ---------------------------------------------------------------------------

E8M0_MIN_EXP = -126
E8M0_MAX_EXP = 127
# mantissa bits of the smallest f32 above √2 (0x3FB504F4): 1.m ≥ √2 ⇔ m ≥ this
_SQRT2_MANTISSA = 0x3504F4
# log2(1 + m·2^-23) > 1e-6 ⇔ m ≥ 6: the "− 1e-6" of the ceil rule
_CEIL_MANTISSA = 6
# log2(1 + m·2^-23) + 1e-6 ≥ 1 ⇔ m ≥ 2^23 − 11: the "+ 1e-6" of the floor rule
_FLOOR_MANTISSA = (1 << 23) - 11


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


def e8m0_ceil_exponent(scale: torch.Tensor) -> torch.Tensor:
    """int32 ``ceil(log2(max(scale, 2^-126)) − 1e-6)`` clamped to [-126, 127],
    as float64 evaluates it: the exponent field, plus one when the mantissa
    field is at least 6 (exact powers of two and the 5 floats above each
    stay put)."""
    s = torch.clamp(scale.to(torch.float32), min=2.0 ** E8M0_MIN_EXP)
    bits = s.view(torch.int32)
    e = (bits >> 23) - 127 + ((bits & 0x7FFFFF) >= _CEIL_MANTISSA).to(torch.int32)
    return torch.clamp(e, E8M0_MIN_EXP, E8M0_MAX_EXP)


def e8m0_floor_exponent(scale: torch.Tensor) -> torch.Tensor:
    """int32 ``floor(log2(max(scale, 2^-126)) + 1e-6)`` clamped to [-126, 127],
    as float64 evaluates it: the exponent field, plus one when the mantissa
    field is at least 2^23 − 11."""
    s = torch.clamp(scale.to(torch.float32), min=2.0 ** E8M0_MIN_EXP)
    bits = s.view(torch.int32)
    e = (bits >> 23) - 127 + ((bits & 0x7FFFFF) >= _FLOOR_MANTISSA).to(torch.int32)
    return torch.clamp(e, E8M0_MIN_EXP, E8M0_MAX_EXP)


_E8M0_EXPONENT = {"nearest": e8m0_nearest_exponent, "ceil": e8m0_ceil_exponent,
                  "floor": e8m0_floor_exponent}


def round_scale_e8m0(scale: torch.Tensor, mode: str = "nearest") -> torch.Tensor:
    """Positive f32 scales → powers of two: ``"nearest"`` (the forward's
    rule), ``"ceil"`` (the backward's: ``absmax/scale`` stays inside the
    grid, so stochastic rounding does not clip) or ``"floor"``."""
    exponent = _E8M0_EXPONENT.get(mode)
    if exponent is None:
        raise ValueError(f"bad e8m0 rounding mode {mode!r}")
    return exp2i(exponent(scale))


# E4M3 (FN): 3 mantissa bits, normals from 2^-6, largest finite 448; the
# reference's cast sends everything that rounds past 448 to NaN
_E4M3_MIN_NORMAL_EXP = -6
_E4M3_MAX = 448.0


def round_scale_e4m3(scale: torch.Tensor) -> torch.Tensor:
    """f32 → E4M3 → f32 as the reference's ``astype(float8_e4m3fn)``:
    round to nearest, ties to even, on the grid step 2^(max(e, −6) − 3) of
    the value's binade e (subnormals below 2^-6), so 2^-10 and below go to
    0; a value that rounds past 448 (above 464), ±∞ and NaN go to NaN."""
    s = scale.to(torch.float32)
    e = ((s.view(torch.int32) >> 23) & 0xFF) - 127  # the binade (f32 subnormals: −127)
    step_e = torch.clamp(e, min=_E4M3_MIN_NORMAL_EXP) - 3  # in [-9, 125]
    # s · 2^-step_e and back are exact: powers of two inside E8M0's range
    q = torch.round(s * exp2i(-step_e)) * exp2i(step_e)
    return torch.where(torch.isnan(s) | (torch.abs(q) > _E4M3_MAX),
                       torch.full_like(q, float("nan")), q)


def quantize_scale(scale: torch.Tensor, fmt: Format, mode: str) -> torch.Tensor:
    """The format's scale-dtype rounding of raw positive f32 scales: E8M0
    (``mode``), E4M3 (:func:`round_scale_e4m3`) or none (fp32)."""
    if fmt.scale_dtype == "e8m0":
        return round_scale_e8m0(scale, mode)
    if fmt.scale_dtype == "e4m3":
        return round_scale_e4m3(scale)
    return scale.to(torch.float32)


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
    ``torch.round`` (half to even); below 1 the grid is uniform at ½.  ±∞
    saturate to ±6 and NaN (a zero NVFP4 scale's 0/0) becomes −0, as the
    reference's native ``float4_e2m1fn`` cast gives them."""
    x = x.to(torch.float32)
    a = torch.clamp(torch.abs(x), max=6.0)
    pw = _binade(a)
    q_norm = torch.round(a / pw * 2.0) * 0.5 * pw
    q_sub = torch.round(a * 2.0) * 0.5
    # copysign keeps the sign of ±0 and of values that round to zero, as the
    # reference's native cast does
    q = torch.copysign(torch.where(a >= 1.0, q_norm, q_sub), x)
    return torch.where(torch.isnan(x), torch.full_like(q, -0.0), q)


def rtn_to_grid(x: torch.Tensor, grid) -> torch.Tensor:
    """Round to nearest onto a sorted grid, ties to the lower index (the
    reference's searchsorted over the f32 midpoints, right side); NaN goes
    to the grid's largest value, as there."""
    g = torch.as_tensor(np.asarray(grid, dtype=np.float32), device=x.device)
    mids = (g[1:] + g[:-1]) / 2.0
    return g[torch.searchsorted(mids, x.to(torch.float32).contiguous(), right=True)]


def stochastic_round_to_grid(x: torch.Tensor, grid, u: torch.Tensor) -> torch.Tensor:
    """Unbiased stochastic rounding onto a symmetric sorted grid.

    Sign-magnitude, as the reference: |x| (clipped to the grid's max) goes
    up to the next grid point with probability (|x| − lo)/(hi − lo), else
    down to lo, and the sign is put back as the reference's
    ``sign(x) · magnitude`` (a grid whose zero is stored as −0, as
    ``np.unique`` leaves E4M3's, gives −0 for x ≥ 0 rounding to zero; NaN
    stays NaN).  ``u`` ~ U[0, 1), x's shape."""
    x = x.to(torch.float32)
    g = np.asarray(grid, dtype=np.float32)
    pos = torch.as_tensor(g[g >= 0], device=x.device)
    a = torch.clamp(torch.abs(x), 0.0, float(g[-1]))
    n = pos.shape[0]
    lo_idx = torch.clamp(torch.searchsorted(pos, a.contiguous(), right=True) - 1, 0, n - 1)
    hi_idx = torch.clamp(lo_idx + 1, 0, n - 1)
    lo, hi = pos[lo_idx], pos[hi_idx]
    gap = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    p_up = torch.clamp((a - lo) / gap, 0.0, 1.0)
    return _sign(x) * torch.where(u < p_up, hi, lo)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: ±1, ±0 kept with its sign, NaN kept (``torch.sign``
    maps NaN to 0)."""
    one = torch.ones_like(x)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


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
    """[..., K] → [..., K // block, block] (block 0: [..., 1, K])."""
    k = x.shape[-1]
    if block <= 0:
        return x.reshape(*x.shape[:-1], 1, k)
    if k % block != 0:
        raise ValueError(f"last dim {k} not divisible by block {block}")
    return x.reshape(*x.shape[:-1], k // block, block)


def from_blocks(xb: torch.Tensor) -> torch.Tensor:
    return xb.reshape(*xb.shape[:-2], xb.shape[-2] * xb.shape[-1])


@functools.lru_cache(maxsize=None)
def gaussian_optimal_clip(fmt_name: str) -> float:
    """Clip multiplier c* minimising E[(x − Q(clip(x)))²] for x ~ N(0, 1),
    by numeric integration on the host (QuEST's RMS-fit scale = c*·std);
    any format with a grid."""
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
