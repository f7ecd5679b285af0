"""Quartet (Algorithm 1): all three linear-layer GEMMs in MXFP4.

Forward:  fixed block-32 Hadamard on X and on W along the contraction dim K
          → QuEST (RMSE clip + RTN, E8M0 nearest scales) → MXFP4 GEMM with
          f32 accumulation.
Backward: randomized block-32 Hadamard Ĥ(·, ξ) along each backward GEMM's
          contraction dim (N for dx, the token dim B for dW), with signs ξ
          shared by the two operands → stochastic rounding of ¾·(·) (E8M0
          ceil scales, so no clipping and no bias) → MXFP4 GEMMs → ×16/9 →
          ⊙ QuEST masks → H⁻¹ (= H).

:class:`_QuartetLinear` is the ``torch.autograd.Function``.  With
``use_kernels=True`` both passes run on the Hopper kernels: forward Stage 1
``kernels.hadamard_quant`` on x and on Wᵀ, then ``kernels.mxfp4_matmul``;
backward Stage 1 ``kernels.sr_hadamard_quant`` on dy, Wq, xqᵀ and dyᵀ (salts
1–4; the transposes are strided views, read in place), then
``kernels.mxfp4_matmul`` for dx and dW.  The forward saves the 4-bit payload
(codes, scales) and both masks.  With ``use_kernels=False`` it runs the
reference's dequantize-then-multiply formulation in PyTorch and saves the
QDQ values and masks.  Both mirror ``repro.core.quartet`` step for step, with
the same seeds and salts, so on the CPU they agree with the reference.

:func:`quartet_linear_experts` is the forward of a stack of E independent
linears (a MoE layer's experts: x [E, T, K], w [E, K, N]), the port's
counterpart of the reference's ``jax.vmap`` of ``quartet_linear``: on the
kernels one expert-axis launch per Stage, on the plain path the same
arithmetic batched.  Its backward (MoE training) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import fastrng
from repro_torch.core import formats as F
from repro_torch.core import quantizers as Q
from repro_torch.core.hadamard import hadamard_transform, randomized_hadamard_transform

SR_PRESCALE = 0.75  # the ¾ factor of Algorithm 1
SR_POSTSCALE = 16.0 / 9.0  # undoes (¾)² on the GEMM product


@dataclasses.dataclass(frozen=True)
class QuartetConfig:
    """Static configuration of the Quartet linear layer."""

    fwd_format: str = "mxfp4"
    bwd_format: str = "mxfp4"
    group: int = 32  # Hadamard group == MXFP4 scale block
    fwd_quantizer: str = "quest"  # "quest" | "none" (bf16 passthrough)
    use_kernels: bool = False

    @property
    def fwd_fmt(self) -> F.Format:
        return F.get_format(self.fwd_format)

    @property
    def bwd_fmt(self) -> F.Format:
        return F.get_format(self.bwd_format)


BF16_CONFIG = QuartetConfig(fwd_quantizer="none")
QUARTET_CONFIG = QuartetConfig()


def _gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ b [K, N] with f32 accumulation (f32 operands: bf16
    inputs are exact in f32, and the f32 product is what the reference's
    ``preferred_element_type=f32`` contraction returns)."""
    return a.to(torch.float32) @ b.to(torch.float32)


def _pad32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Zero-pad ``dim`` up to a multiple of 32.  Exact for the backward
    GEMMs: padded positions quantize to zero and add nothing."""
    pad = (-x.shape[dim]) % 32
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _dequant_codes(codes: torch.Tensor, scales: torch.Tensor, group: int) -> torch.Tensor:
    """Half-codes + per-group scales → f32 values (code · ½ · scale)."""
    shape = codes.shape
    c = codes.to(torch.float32).reshape(*shape[:-1], shape[-1] // group, group)
    return (c * (0.5 * scales)[..., None]).reshape(shape)


def _check(cfg: QuartetConfig) -> None:
    if cfg.fwd_quantizer not in ("quest", "none"):
        raise NotImplementedError(f"fwd_quantizer {cfg.fwd_quantizer!r} is not ported yet")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _kernel_ops(ops):
    if ops is None:
        from repro_torch.kernels import ops
    return ops


def _forward_kernels(x, w, cfg, ops=None):
    """Forward on the kernels (``ops``: the shape-flexible wrappers of
    ``kernels.ops``, or a stand-in with their signatures)."""
    K = _kernel_ops(ops)
    # Stage 1 (fused Hadamard + QuEST) on x and on Wᵀ (a strided view: the
    # kernel reads it in place), then Stage 2 (block-scaled GEMM)
    xc, xs, xm = K.hadamard_quest_quantize(x, group=cfg.group)
    wtc, wts, wtm = K.hadamard_quest_quantize(w.t(), group=cfg.group)
    y = K.mxfp4_matmul(xc, xs, wtc.t(), wts.t())
    # the 4-bit payload and both masks, as the reference's residuals
    return y, (xc, xs, wtc, wts, xm, wtm.t())


def _forward_plain(x, w, cfg):
    xh = hadamard_transform(x.to(torch.float32), g=cfg.group, dim=-1)
    wh = hadamard_transform(w.to(torch.float32), g=cfg.group, dim=0)
    xq = Q.quest(xh, cfg.fwd_fmt)
    wq = Q.quest(wh.t(), cfg.fwd_fmt)  # blocks along K
    # QDQ values are bf16-exact (≤ 2 mantissa bits × a power-of-two scale):
    # saved as bf16, as the reference saves them
    xv = xq.values.to(torch.bfloat16)
    wv = wq.values.t().to(torch.bfloat16)
    y = _gemm(xq.values, wq.values.t())
    return y, (xv, wv, xq.mask, wq.mask.t())


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def _bwd_quantize(gh: torch.Tensor, cfg: QuartetConfig, seed: int, salt: int) -> torch.Tensor:
    """SR of ¾·(an operand already rotated, blocks on the last axis)."""
    v = Q.sr_absmax_fast(gh * SR_PRESCALE, seed, cfg.bwd_fmt, "ceil", salt).values
    return v.to(torch.bfloat16)  # bf16-exact


def _backward_plain(cfg, seed, res, dy):
    """``_bwd_rotate_quantize_gemms`` + the weight mask and H⁻¹ of the
    reference's ``_quartet_bwd``."""
    xq_v, wq_v, m_x, m_w = res
    K, N = wq_v.shape
    dyf = dy.to(torch.float32)
    lead = dy.shape[:-1]
    Bflat = dyf.numel() // N

    # dx = H⁻¹( 16/9 · (SR(¾·Ĥ_N dy) @ SR(¾·Ĥ_N Wᵀ)ᵀ) ⊙ M_x )
    dy_p = _pad32(dyf, -1)
    wq_p = _pad32(wq_v.to(torch.float32), -1)
    Np = dy_p.shape[-1]
    signs_n = fastrng.rademacher(seed, Np, salt=11, device=dy.device)
    g_h = randomized_hadamard_transform(dy_p, signs_n, g=cfg.group, dim=-1)
    wt_h = randomized_hadamard_transform(wq_p, signs_n, g=cfg.group, dim=-1)
    g_q = _bwd_quantize(g_h, cfg, seed, salt=1)
    wt_q = _bwd_quantize(wt_h, cfg, seed, salt=2)  # blocks along N
    dx_rot = SR_POSTSCALE * _gemm(g_q, wt_q.t())
    dx = hadamard_transform(dx_rot * m_x, g=cfg.group, dim=-1)  # H⁻¹ = H

    # dW_rot = 16/9 · SR(¾·Ĥ_B Xᵀ)ᵀ @ SR(¾·Ĥ_B dy)
    xf = _pad32(xq_v.to(torch.float32).reshape(Bflat, K), 0)
    gf = _pad32(dyf.reshape(Bflat, N), 0)
    Bp = xf.shape[0]
    signs_b = fastrng.rademacher(seed, Bp, salt=12, device=dy.device)
    x2 = randomized_hadamard_transform(xf, signs_b, g=cfg.group, dim=0)
    g2 = randomized_hadamard_transform(gf, signs_b, g=cfg.group, dim=0)
    x2_q = _bwd_quantize(x2.t(), cfg, seed, salt=3)  # [K, Bp]
    g2_q = _bwd_quantize(g2.t(), cfg, seed, salt=4)  # [N, Bp]
    dw_rot = SR_POSTSCALE * _gemm(x2_q, g2_q.t())
    dw = hadamard_transform(dw_rot * m_w, g=cfg.group, dim=0)  # H⁻¹ along K
    return dx.reshape(*lead, K), dw


def _backward_kernels(cfg, seed, res, dy, ops=None):
    """The reference's ``_quartet_bwd_kernels``: backward Stage 1 on the
    four operands, the MXFP4 GEMM for dx and dW."""
    K = _kernel_ops(ops)

    xc, xs, wtc, wts, m_x, m_w = res
    g = cfg.group
    wq_v = _dequant_codes(wtc, wts, g).t()  # [K, N]
    Kdim, N = wq_v.shape
    lead = dy.shape[:-1]
    dy2 = dy.reshape(-1, N)  # bf16 or f32: the kernel reads either exactly
    Bflat = dy2.shape[0]

    # dx: Stage 1 on dy [B, Np] and on Wq [K, Np] along N; the GEMM's B is
    # the transposed view of the Wq codes
    dy_p = _pad32(dy2, -1)
    wq_p = _pad32(wq_v, -1)
    Np = dy_p.shape[-1]
    signs_n = fastrng.rademacher(seed, Np, salt=11, device=dy.device)
    gc, gs = K.sr_hadamard_quantize(dy_p, signs_n, seed, salt=1)
    wtc2, wts2 = K.sr_hadamard_quantize(wq_p, signs_n, seed, salt=2)
    dx_rot = SR_POSTSCALE * K.mxfp4_matmul(gc, gs, wtc2.t(), wts2.t())
    dx = hadamard_transform(dx_rot * m_x.reshape(Bflat, Kdim), g=g, dim=-1)

    # dW: Stage 1 on xqᵀ [K, Bp] and dyᵀ [N, Bp] (transposed views) along
    # the token dim; the GEMM's B is the transposed view of the dy codes
    xq_v = _pad32(_dequant_codes(xc, xs, g).reshape(Bflat, Kdim), 0)
    gf = _pad32(dy2, 0)
    Bp = xq_v.shape[0]
    signs_b = fastrng.rademacher(seed, Bp, salt=12, device=dy.device)
    x2c, x2s = K.sr_hadamard_quantize(xq_v.t(), signs_b, seed, salt=3)
    g2c, g2s = K.sr_hadamard_quantize(gf.t(), signs_b, seed, salt=4)
    dw_rot = SR_POSTSCALE * K.mxfp4_matmul(x2c, x2s, g2c.t(), g2s.t())
    dw = hadamard_transform(dw_rot * m_w, g=g, dim=0)
    return dx.reshape(*lead, Kdim), dw


class _QuartetLinear(torch.autograd.Function):
    """y = Quartet(x) @ Quartet(w) with the Algorithm-1 backward."""

    @staticmethod
    def forward(ctx, x, w, seed, cfg):
        if cfg.fwd_quantizer == "none":  # bf16 passthrough
            ctx.save_for_backward(x, w)
            y = _gemm(x, w)
        else:
            fwd = _forward_kernels if cfg.use_kernels else _forward_plain
            y, res = fwd(x, w, cfg)
            if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
                ctx.save_for_backward(*res)
        ctx.seed, ctx.cfg = seed, cfg
        ctx.dtypes = (x.dtype, w.dtype)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        cfg, seed = ctx.cfg, ctx.seed
        res = ctx.saved_tensors
        if cfg.fwd_quantizer == "none":
            x, w = res
            dyf = dy.to(torch.float32)
            dx = _gemm(dyf, w.t())
            dw = _gemm(x.reshape(-1, x.shape[-1]).t(), dyf.reshape(-1, dy.shape[-1]))
        else:
            bwd = _backward_kernels if cfg.use_kernels else _backward_plain
            dx, dw = bwd(cfg, seed, res, dy)
        return dx.to(ctx.dtypes[0]), dw.to(ctx.dtypes[1]), None, None


def quartet_linear(x: torch.Tensor, w: torch.Tensor, seed: int,
                   cfg: QuartetConfig) -> torch.Tensor:
    """y = Quartet(x) @ Quartet(w).  x [..., K], w [K, N], ``seed`` a uint32
    (Python int) that drives the backward's stochastic rounding."""
    _check(cfg)
    return _QuartetLinear.apply(x, w, seed & 0xFFFFFFFF, cfg)


# ---------------------------------------------------------------------------
# stacked experts (forward only)
# ---------------------------------------------------------------------------


def _forward_experts_kernels(x, w, cfg, ops=None):
    """Stage 1 on x [E, T, K] and on the weights' transposed view [E, N, K]
    (read in place), then the block-scaled GEMM: three launches for all E
    experts."""
    K = _kernel_ops(ops)
    xc, xs, _ = K.hadamard_quest_quantize_experts(x, group=cfg.group)
    wtc, wts, _ = K.hadamard_quest_quantize_experts(w.transpose(-1, -2), group=cfg.group)
    return K.mxfp4_matmul_experts(xc, xs, wtc.transpose(-1, -2), wts.transpose(-1, -2))


def _forward_experts_plain(x, w, cfg):
    xh = hadamard_transform(x.to(torch.float32), g=cfg.group, dim=-1)
    wh = hadamard_transform(w.to(torch.float32), g=cfg.group, dim=-2)
    xq = Q.quest(xh, cfg.fwd_fmt)
    wq = Q.quest(wh.transpose(-1, -2), cfg.fwd_fmt)  # blocks along K
    return torch.bmm(xq.values, wq.values.transpose(-1, -2))


class _QuartetLinearExperts(torch.autograd.Function):
    """y[e] = Quartet(x[e]) @ Quartet(w[e]) for every expert; forward only."""

    @staticmethod
    def forward(ctx, x, w, seeds, cfg):
        if cfg.fwd_quantizer == "none":
            y = torch.bmm(x.to(torch.float32), w.to(torch.float32))
        elif cfg.use_kernels:
            y = _forward_experts_kernels(x, w, cfg)
        else:
            y = _forward_experts_plain(x, w, cfg)
        ctx.seeds = seeds
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        raise NotImplementedError(
            "the backward of the stacked-expert Quartet linear (MoE training) is not ported "
            "yet: ROADMAP A5b")


def quartet_linear_experts(x: torch.Tensor, w: torch.Tensor, seeds: torch.Tensor,
                           cfg: QuartetConfig) -> torch.Tensor:
    """y [E, T, N] = Quartet(x[e]) @ Quartet(w[e]) for x [E, T, K], w
    [E, K, N].  ``seeds`` [E] (uint32 values in int64) are the experts'
    stochastic-rounding seeds, folded as the reference folds them; they drive
    only the backward, which a later slice ports."""
    _check(cfg)
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"quartet_linear_experts: x {tuple(x.shape)}, w {tuple(w.shape)}")
    return _QuartetLinearExperts.apply(x, w, seeds, cfg)
