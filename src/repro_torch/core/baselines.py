"""Fully-quantized training baselines compared against Quartet (Table 3).

Port of ``repro.core.baselines``.  Each baseline is a linear layer whose
three GEMMs take 4-bit operands, in the reference's adaptation of the
original method to FP4/INT4, computed as the reference's code computes it:

* ``luq_int4`` / ``luq_fp4`` (LUQ): the forward is block-32 INT4 RTN
  (``luq_int4``) or RTN onto LUQ's per-tensor log grid {0, 2⁻⁶..2⁰}·absmax
  (``luq_fp4``); the backward quantizes the output gradient onto the log
  grid, stochastically (stochastic underflow below 2⁻⁶, log-scale SR
  between neighbouring powers of two), once for dx and once, under another
  key, for dW.
* ``jetfire_fp4`` (Jetfire): RTN onto E2M1 with one AbsMax scale per 32×32
  tile, in all three GEMMs.
* ``halo_fp4`` (HALO-2): a Hadamard along each GEMM's contraction dim on
  both operands (groups of up to 128), then per-tensor AbsMax E2M1 RTN.
  The backward's dx stays in the forward's rotated basis, as there.
* ``lss_int4`` (LSS): the forward is a block Hadamard then block-32 INT4
  RTN; the backward INT4-quantizes the gradient and, for dW, samples the
  token rows by leverage score (kept with probability ∝ row norm, kept
  rows scaled by 1/p).

Everything is plain PyTorch with f32 products (``core.quartet._gemm``), as
the reference computes these outside its kernels.  Every function takes a
leading expert axis E: a 2-d linear is E = 1, and a MoE layer's experts
(the reference's ``jax.vmap`` of ``dense``) quantize per expert, one
per-tensor scale and one draw of keys each.  The backward's keys are
``split(fold_in(PRNGKey(0xB5), seed), 3)`` per expert, hashed on the
seeds' device (``core.threefry``), so the experts' keys need no host sync.

Two points keep the port equal to the reference on the CPU:

* LUQ's exponents are read from the bits (``floor(log2 a)`` the exponent
  field, ``round(log2 a)`` the E8M0-nearest rule), exact where the
  reference's f32 ``log2`` misrounds just below 2^k and near √2·2^k
  (ROADMAP C2, C8).
* :class:`_BaselineLinear` takes the weight before the compute-dtype cast
  and casts it itself.  The reference's backward returns dW in f32 (the
  dtype of its quantized weight), and ``jax.grad`` through the model's
  f32→bf16 cast hands the master that f32 dW unrounded; PyTorch's autograd
  would round a Function's gradient to the dtype of the input it belongs
  to, the bf16 weight.  ``train.steps`` passes these weights uncast
  (:func:`models.layers.takes_master_weight`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from repro_torch.core import formats as F
from repro_torch.core import threefry
from repro_torch.core.hadamard import hadamard_transform
from repro_torch.core.quartet import _gemm

BASELINE_METHODS = ("luq_int4", "luq_fp4", "jetfire_fp4", "halo_fp4", "lss_int4")

_LUQ_VMIN = 2.0**-6  # LUQ's smallest normal: the grid is {0, 2^-6 .. 2^0}
_BWD_KEY = threefry.prng_key(0xB5)
_MASK = 0xFFFFFFFF


def _tensor_absmax(x: torch.Tensor) -> torch.Tensor:
    """max|x| over all but the leading expert axis, keepdim."""
    a = torch.amax(torch.abs(x).reshape(x.shape[0], -1), dim=1)
    return a.reshape(-1, *([1] * (x.dim() - 1)))


# ---------------------------------------------------------------------------
# LUQ: logarithmic unbiased quantization
# ---------------------------------------------------------------------------


def _luq_quantize(x: torch.Tensor, keys, stochastic: bool) -> torch.Tensor:
    """x [E, ...] onto the signed log grid with a per-tensor (per-expert)
    absmax scale.  ``stochastic`` (the backward): stochastic underflow below
    2^-6 (2^-6 with probability a / 2^-6, else 0) and SR between the
    neighbouring powers of two (up with probability a / 2^e − 1), under
    ``split(key)``'s two subkeys; else RTN (round(log2 a), 0 below 2^-7).
    ``keys``: two word tensors [E]."""
    x = x.to(torch.float32)
    s = torch.clamp_min(_tensor_absmax(x), 1e-30)
    a = torch.abs(x) / s
    sign = F._sign(x)
    if stochastic:
        k1, k2 = threefry.split_many(keys, 2)
        u = threefry.uniform_many(k1, x.shape[1:])
        under_val = torch.where(u < a / _LUQ_VMIN, _LUQ_VMIN, 0.0)
        m = torch.clamp_min(a, _LUQ_VMIN)
        lo = F.exp2i((m.view(torch.int32) >> 23) - 127)  # 2^floor(log2 m), m normal
        frac = torch.clamp(a / lo - 1.0, 0.0, 1.0)
        u2 = threefry.uniform_many(k2, x.shape[1:])
        norm_val = torch.where(u2 < frac, 2.0 * lo, lo)
        q = torch.where(a < _LUQ_VMIN, under_val, torch.clamp_max(norm_val, 1.0))
    else:
        e = F.e8m0_nearest_exponent(torch.clamp_min(a, _LUQ_VMIN / 2))
        q = torch.where(a < _LUQ_VMIN / 2, 0.0, F.exp2i(torch.clamp(e, -6, 0)))
    return sign * q * s


# ---------------------------------------------------------------------------
# Jetfire: 2-D (32×32) block AbsMax RTN
# ---------------------------------------------------------------------------


def _block2d_rtn(x: torch.Tensor, fmt: F.Format, block: int = 32) -> torch.Tensor:
    """x [E, m, n]: RTN with one AbsMax scale per block × block tile (the
    edges zero-padded)."""
    x = x.to(torch.float32)
    E, m, n = x.shape
    pm, pn = (-m) % block, (-n) % block
    t = Fn.pad(x, (0, pn, 0, pm)).reshape(E, (m + pm) // block, block, (n + pn) // block, block)
    amax = torch.amax(torch.abs(t), dim=(2, 4), keepdim=True)
    s = torch.clamp_min(amax, 1e-30) * F.recip(fmt.max_value)
    if fmt.name == "mxfp4":
        q = F.rtn_e2m1(t / s)
    else:
        q = F.rtn_to_grid(torch.clamp(t / s, -fmt.max_value, fmt.max_value), fmt.grid_array)
    return (q * s).reshape(E, m + pm, n + pn)[:, :m, :n]


# ---------------------------------------------------------------------------
# HALO-2: per-tensor scale + Hadamard on both operands of every GEMM
# ---------------------------------------------------------------------------


def _halo_quantize(x: torch.Tensor, fmt: F.Format) -> torch.Tensor:
    """x [E, ...]: E2M1 RTN with a per-tensor (per-expert) AbsMax scale."""
    x = x.to(torch.float32)
    s = torch.clamp_min(_tensor_absmax(x), 1e-30) * F.recip(fmt.max_value)
    return F.rtn_e2m1(x / s) * s


def _halo_group(k: int) -> int:
    """The largest power of two ≤ 128 that divides k."""
    g = 1
    while k % (g * 2) == 0 and g < 128:
        g *= 2
    return g


# ---------------------------------------------------------------------------
# LSS: leverage-score sampled INT4 backward
# ---------------------------------------------------------------------------


def _lss_sample(g: torch.Tensor, other: torch.Tensor, keys, keep: float = 0.5) -> torch.Tensor:
    """g [E, B, N], other [E, B, K] → [E, B]: row i kept with probability
    p_i ∝ ‖g_i‖·‖other_i‖ (keep·B rows expected, p clipped to [1e-4, 1]),
    kept rows weighted 1/p (unbiased), dropped rows 0."""
    norms = torch.sqrt((g * g).sum(-1)) * torch.sqrt((other * other).sum(-1))
    b = norms.shape[1]
    total = torch.clamp_min(norms.sum(-1, keepdim=True), 1e-30)
    p = torch.clamp(norms / total * (keep * b), 1e-4, 1.0)
    u = threefry.uniform_many(keys, (b,))
    return (u < p).to(torch.float32) / p


def _int4_rtn(x: torch.Tensor, block: int = 32) -> torch.Tensor:
    """INT4 RTN (round half to even, ±7) with one AbsMax scale per block of
    the last axis."""
    fmt = F.INT4
    xb = F.to_blocks(x.to(torch.float32), block)
    amax = torch.amax(torch.abs(xb), dim=-1, keepdim=True)
    s = torch.clamp_min(amax, 1e-30) * F.recip(fmt.max_value)
    return F.from_blocks(torch.round(torch.clamp(xb / s, -7, 7)) * s)


# ---------------------------------------------------------------------------
# the baseline linear layers
# ---------------------------------------------------------------------------


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _bl_fwd(xf: torch.Tensor, wf: torch.Tensor, method: str):
    """xf [E, M, K], wf [E, K, N] (f32) → (y f32 [E, M, N], xq, wq)."""
    if method in ("luq_int4", "luq_fp4"):
        if method == "luq_int4":
            xq, wq = _int4_rtn(xf), _t(_int4_rtn(_t(wf)))
        else:
            xq, wq = _luq_quantize(xf, None, False), _luq_quantize(wf, None, False)
    elif method == "jetfire_fp4":
        xq, wq = _block2d_rtn(xf, F.MXFP4), _block2d_rtn(wf, F.MXFP4)
    elif method in ("halo_fp4", "lss_int4"):
        g = _halo_group(xf.shape[-1])
        xh = hadamard_transform(xf, g=g, dim=-1)
        wh = hadamard_transform(wf, g=g, dim=1)
        if method == "halo_fp4":
            xq, wq = _halo_quantize(xh, F.MXFP4), _halo_quantize(wh, F.MXFP4)
        else:
            xq, wq = _int4_rtn(xh), _t(_int4_rtn(_t(wh)))
    else:
        raise ValueError(f"unknown baseline method {method!r}")
    return _gemm(xq, wq), xq, wq


def _bl_bwd(method: str, xq: torch.Tensor, wq: torch.Tensor, seeds: torch.Tensor,
            dy: torch.Tensor):
    """dy [E, M, N] (f32) → (dx [E, M, K], dW [E, K, N]), f32; expert e's
    keys ``split(fold_in(PRNGKey(0xB5), seeds[e]), 3)``."""
    k1, k2, k3 = threefry.split_many(threefry.fold_in_many(_BWD_KEY, seeds), 3)
    if method in ("luq_int4", "luq_fp4"):
        dx = _gemm(_luq_quantize(dy, k1, True), _t(wq))
        dw = _gemm(_t(xq), _luq_quantize(dy, k2, True))
    elif method == "jetfire_fp4":
        gq = _block2d_rtn(dy, F.MXFP4)
        dx = _gemm(gq, _t(wq))
        dw = _gemm(_t(xq), gq)
    elif method == "halo_fp4":
        gn = _halo_group(dy.shape[-1])
        gh = hadamard_transform(dy, g=gn, dim=-1)
        wth = hadamard_transform(wq, g=gn, dim=-1)
        dx = _gemm(_halo_quantize(gh, F.MXFP4), _t(_halo_quantize(wth, F.MXFP4)))
        gb = _halo_group(dy.shape[1])
        g2 = hadamard_transform(dy, g=gb, dim=1)
        x2 = hadamard_transform(xq, g=gb, dim=1)
        dw = _gemm(_t(_halo_quantize(x2, F.MXFP4)), _halo_quantize(g2, F.MXFP4))
    elif method == "lss_int4":
        dx = _gemm(_int4_rtn(dy), _t(wq))
        sel = _lss_sample(dy, xq, k3)  # leverage-score row sampling over the tokens
        dw = _gemm(_t(_int4_rtn(xq * sel[..., None])), _int4_rtn(dy))
    else:
        raise ValueError(method)
    return dx, dw


class _BaselineLinear(torch.autograd.Function):
    """y[e] = Q(x[e]) @ Q(w[e]) with the method's quantized backward.  The
    weight arrives before the compute-dtype cast (x's dtype) and is cast
    here, so dW (f32, as the reference's) reaches an f32 weight unrounded."""

    @staticmethod
    def forward(ctx, x, w, seeds, method):
        wf = w.to(x.dtype).to(torch.float32)
        y, xq, wq = _bl_fwd(x.to(torch.float32), wf, method)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            ctx.save_for_backward(xq, wq, seeds)
        ctx.method = method
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        xq, wq, seeds = ctx.saved_tensors
        dx, dw = _bl_bwd(ctx.method, xq, wq, seeds, dy.to(torch.float32))
        return dx.to(dy.dtype), dw, None, None


def _check(method: str) -> None:
    if method not in BASELINE_METHODS:
        raise ValueError(f"unknown baseline method {method!r}; have {BASELINE_METHODS}")


def baseline_linear(x: torch.Tensor, w: torch.Tensor, seed: int, method: str) -> torch.Tensor:
    """y = Q(x) @ Q(w) under ``method`` for x [..., K], w [K, N] (f32 or the
    compute dtype; cast to x's dtype inside), ``seed`` a uint32 that keys
    the backward."""
    _check(method)
    K, N = w.shape
    seeds = torch.full((1,), seed & _MASK, dtype=torch.int64, device=x.device)
    y = _BaselineLinear.apply(x.reshape(1, -1, K), w.unsqueeze(0), seeds, method)
    return y.reshape(*x.shape[:-1], N)


def baseline_linear_experts(x: torch.Tensor, w: torch.Tensor, seeds: torch.Tensor,
                            method: str) -> torch.Tensor:
    """y [E, T, N] = Q(x[e]) @ Q(w[e]) for x [E, T, K], w [E, K, N]: the
    reference's ``jax.vmap`` of :func:`baseline_linear` over the experts
    (per-expert scales and samples; ``seeds`` [E], uint32 values in int64)."""
    _check(method)
    return _BaselineLinear.apply(x, w, seeds, method)
