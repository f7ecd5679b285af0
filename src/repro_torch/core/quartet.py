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

:func:`quartet_linear_experts` is a stack of E independent linears (a MoE
layer's experts: x [E, T, K], w [E, K, N], one seed an expert), the port's
counterpart of the reference's ``jax.vmap`` of ``quartet_linear``, forward
and Algorithm-1 backward: on the kernels one expert-axis launch per Stage
and per operand (B1 twice and B3 once forward; B2 four times and B3 twice
backward), on the plain path the same arithmetic batched, expert e's
signs and uniforms drawn at its own seed.

The reference's variants (Table 3's ablations and the FP8 baseline) run on
the plain path, as there: ``fwd_quantizer`` QuEST, RTN-AbsMax or SR-AbsMax
(uniforms of ``fold_in(PRNGKey(0), seed)``, one key for x and Wᵀ), any
format for either pass, ``bwd_rounding`` SR, RTN or none (unquantized
backward GEMMs), ``bwd_hadamard`` random, fixed or none.  The kernels
compute Quartet alone (MXFP4 both ways, group 32, QuEST, SR, the random
Hadamard, f32 accumulation): with ``use_kernels=True`` any other
configuration raises (:func:`check_kernel_config`), where the reference's
kernel path would compute Quartet in its place.

Data-parallel training (``distributed.context``'s plan): a rank holds block
r of n equal blocks of the microbatch's tokens, and the backward's
token-axis draws take that block's window of the logical microbatch (dy's
SR at salt 1, the dW operands xqᵀ and dyᵀ at salts 3 and 4, and the signs
ξ_B at salt 12), so every stochastic rounding draws the bits one device
draws at those elements.  dW leaves a rank as its f32 partial sum over its
tokens; the caller's gather reduces it across ranks.

With ``fp4_allgather`` (the reference's beyond-paper option) a weight
crosses the data ranks as MXFP4 codes: :func:`quest_qdq_gathered` rotates
and QuEST-quantizes the rank's shard of Wᵀ (B1 on the card; shard-local,
since the Hadamard and scale blocks lie along K), all-gathers its int8
codes and f32 scales (1.125 B a weight against bf16's 2), and hands them
to :func:`quartet_linear_pq`, Quartet with the weight operand already
rotated and quantized (B3 on x's codes and the gathered ones).  Its
backward returns dW in the rotated space; :func:`quest_qdq_gathered`'s
reduce-scatters that f32 sum to the shard before the mask ⊙ and H⁻¹,
which are shard-local too.  Both take a stack of experts [E, K, N] (B1's
and B3's expert axes on the card), as the reference quantizes a MoE
layer's stacks before its vmap.  A data-parallel rank's expert linears
run over its block of each expert's slots: ``quartet_linear_experts``'s
``window`` (offset, row length) places them on the logical slot axis, and
the backward's slot-axis draws (dy's SR, the signs ξ_B, xqᵀ's and dyᵀ's SR)
take that window.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import fastrng, threefry
from repro_torch.core import formats as F
from repro_torch.core import quantizers as Q
from repro_torch.core.hadamard import hadamard_transform, randomized_hadamard_transform
from repro_torch.distributed import context as C

SR_PRESCALE = 0.75  # the ¾ factor of Algorithm 1
SR_POSTSCALE = 16.0 / 9.0  # undoes (¾)² on the GEMM product


FWD_QUANTIZERS = ("quest", "rtn_absmax", "sr_absmax", "none")
BWD_ROUNDINGS = ("sr", "rtn", "none")
BWD_HADAMARDS = ("random", "fixed", "none")


@dataclasses.dataclass(frozen=True)
class QuartetConfig:
    """Static configuration of the Quartet linear layer."""

    fwd_format: str = "mxfp4"
    bwd_format: str = "mxfp4"
    group: int = 32  # Hadamard group == MXFP4 scale block
    fwd_quantizer: str = "quest"  # FWD_QUANTIZERS; "none" = bf16 passthrough
    bwd_rounding: str = "sr"  # BWD_ROUNDINGS; "none" = unquantized backward GEMMs
    bwd_hadamard: str = "random"  # BWD_HADAMARDS
    use_kernels: bool = False
    accum_dtype: str = "float32"
    # beyond-paper: FSDP-sharded weights cross the data ranks as MXFP4 codes
    # (quantize shard-local, all-gather codes and scales, dequantize); the
    # paper's forward, with a cheaper gather (quest_qdq_gathered)
    fp4_allgather: bool = False

    @property
    def fwd_fmt(self) -> F.Format:
        return F.get_format(self.fwd_format)

    @property
    def bwd_fmt(self) -> F.Format:
        return F.get_format(self.bwd_format)


BF16_CONFIG = QuartetConfig(fwd_quantizer="none", bwd_rounding="none", bwd_hadamard="none")
FP8_CONFIG = QuartetConfig(
    fwd_format="mxfp8", bwd_format="mxfp8", fwd_quantizer="rtn_absmax",
    bwd_rounding="rtn", bwd_hadamard="none",
)
QUARTET_CONFIG = QuartetConfig()


def _gemm(a: torch.Tensor, b: torch.Tensor, accum_dtype: str = "float32") -> torch.Tensor:
    """a [..., K] @ b [K, N] (or a batch of them, [E, ., K] @ [E, K, N]): the
    f32 product (bf16 inputs are exact in f32, and it is what the
    reference's ``preferred_element_type`` contraction returns), rounded to
    ``accum_dtype`` as the reference's is."""
    return (a.to(torch.float32) @ b.to(torch.float32)).to(getattr(torch, accum_dtype))


def _pad32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Zero-pad ``dim`` up to a multiple of 32.  Exact for the backward
    GEMMs: padded positions quantize to zero and add nothing."""
    pad = (-x.shape[dim]) % 32
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _dequant_codes(codes: torch.Tensor, scales: torch.Tensor, group: int,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Half-codes + per-group scales → values (code · ½ · scale) in ``dtype``.
    The values are exact in bf16 too (≤ 2 significant bits times a power of
    two), so a bf16 result holds the f32 one's values at half the bytes."""
    shape = codes.shape
    c = codes.to(dtype).reshape(*shape[:-1], shape[-1] // group, group)
    return (c * (0.5 * scales).to(dtype)[..., None]).reshape(shape)


def kernels_compute(cfg: QuartetConfig) -> bool:
    """Whether the Hopper kernels compute ``cfg``: Quartet itself (MXFP4
    forward and backward, group 32, QuEST, SR, the random Hadamard, f32
    accumulation), or the bf16 passthrough, which needs no kernel."""
    if cfg.fwd_quantizer == "none":
        return True
    return ((cfg.fwd_format, cfg.bwd_format, cfg.group, cfg.fwd_quantizer, cfg.bwd_rounding,
             cfg.bwd_hadamard, cfg.accum_dtype)
            == ("mxfp4", "mxfp4", 32, "quest", "sr", "random", "float32"))


def check_kernel_config(cfg: QuartetConfig) -> None:
    """Raise on ``use_kernels=True`` with a configuration the kernels do not
    compute (the reference's kernel path computes Quartet in its place;
    the port never substitutes it silently)."""
    if cfg.use_kernels and not kernels_compute(cfg):
        raise ValueError(f"the kernels compute Quartet only (mxfp4/mxfp4, group 32, quest, "
                         f"sr, random Hadamard, float32): {cfg} runs on the plain path "
                         f"(use_kernels=False)")


def _check(cfg: QuartetConfig) -> None:
    for name, value, allowed in (("fwd_quantizer", cfg.fwd_quantizer, FWD_QUANTIZERS),
                                 ("bwd_rounding", cfg.bwd_rounding, BWD_ROUNDINGS),
                                 ("bwd_hadamard", cfg.bwd_hadamard, BWD_HADAMARDS)):
        if value not in allowed:
            raise ValueError(f"{name} {value!r} not in {allowed}")
    check_kernel_config(cfg)


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


def _forward_key(seed: int) -> tuple[int, int]:
    """SR-AbsMax's key in the forward: ``fold_in(PRNGKey(0), seed)``."""
    return threefry.fold_in(threefry.prng_key(0), seed)


def _fwd_quantize(xh: torch.Tensor, cfg: QuartetConfig, key) -> Q.QuantResult:
    fmt = cfg.fwd_fmt
    if cfg.fwd_quantizer == "quest":
        return Q.quest(xh, fmt)
    if cfg.fwd_quantizer == "rtn_absmax":
        return Q.rtn_absmax(xh, fmt)
    if cfg.fwd_quantizer == "sr_absmax":
        return Q.sr_absmax(xh, key, fmt)
    raise ValueError(cfg.fwd_quantizer)


def _forward_plain(x, w, cfg, seed: int):
    key = _forward_key(seed)
    xh = hadamard_transform(x.to(torch.float32), g=cfg.group, dim=-1)
    wh = hadamard_transform(w.to(torch.float32), g=cfg.group, dim=0)
    xq = _fwd_quantize(xh, cfg, key)
    wq = _fwd_quantize(wh.t(), cfg, key)  # blocks along K, the same key
    # the QDQ values go to bf16, as the reference's GEMM operands and
    # residuals (exact for MXFP4, whose values have ≤ 2 significant bits
    # times a power of two; a rounding for fp32-scaled formats)
    xv = xq.values.to(torch.bfloat16)
    wv = wq.values.t().to(torch.bfloat16)
    y = _gemm(xv, wv, cfg.accum_dtype)
    return y, (xv, wv, xq.mask, wq.mask.t())


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def _bwd_quantize(gh: torch.Tensor, cfg: QuartetConfig, seed, salt: int,
                  window=(0, None)) -> torch.Tensor:
    """SR (or RTN) of ¾·(an operand already rotated, blocks on the last
    axis) with ceil scales; ``seed`` an int, or a tensor [E] of per-expert
    seeds for gh [E, ...]; ``window`` (offset, row length) of the logical
    operand that the SR's uniforms are drawn from."""
    fmt = cfg.bwd_fmt
    if cfg.bwd_rounding == "sr":
        v = Q.sr_absmax_fast(gh * SR_PRESCALE, seed, fmt, "ceil", salt, *window).values
    elif cfg.bwd_rounding == "rtn":
        v = Q.rtn_absmax(gh * SR_PRESCALE, fmt, scale_mode="ceil").values
    else:
        raise ValueError(cfg.bwd_rounding)
    return v.to(torch.bfloat16)  # bf16-exact for MXFP4


def _maybe_rht(x: torch.Tensor, signs: torch.Tensor, cfg: QuartetConfig,
               dim: int) -> torch.Tensor:
    if cfg.bwd_hadamard == "random":
        return randomized_hadamard_transform(x, signs, g=cfg.group, dim=dim)
    if cfg.bwd_hadamard == "fixed":
        return hadamard_transform(x, g=cfg.group, dim=dim)
    return x


def _bwd_gemm(a: torch.Tensor, b: torch.Tensor, cfg: QuartetConfig, seed, salts,
              windows=((0, None), (0, None))) -> torch.Tensor:
    """a [..., L] @ bᵀ for b [..., M, L] (L the contraction, blocks along it;
    a leading expert axis on both with a tensor of seeds): both quantized
    (each drawing its uniforms in its window) and the product times 16/9,
    or with ``bwd_rounding`` "none" the unquantized f32 product."""
    if cfg.bwd_rounding == "none":
        return _gemm(a, b.transpose(-1, -2), cfg.accum_dtype)
    aq = _bwd_quantize(a, cfg, seed, salts[0], windows[0])
    bq = _bwd_quantize(b, cfg, seed, salts[1], windows[1])
    return SR_POSTSCALE * _gemm(aq, bq.transpose(-1, -2), cfg.accum_dtype)


def _token_window(bflat: int, window) -> tuple[int, int | None]:
    """(offset, row length) of a rank's ``bflat`` tokens in the logical
    microbatch's token axis, ``window`` = (rank, ranks): (0, None) on one
    rank.  Across ranks no rank pads (the logical axis pads only at its
    end), so a rank's token count must be a multiple of the group."""
    r, n = window
    if n == 1:
        return 0, None
    if bflat % 32:
        raise ValueError(f"a data rank's {bflat} tokens are not a multiple of 32: the "
                         f"logical microbatch's padding would fall inside the ranks")
    return r * bflat, n * bflat


def _bwd_plain_gemms(cfg, seed, xq_v, wq_v, m_x, dy, window=(0, 1)):
    """The reference's ``_bwd_rotate_quantize_gemms`` on the plain path →
    (dx [..., K] with the activation mask and H⁻¹ applied, dW_rot [K, N] f32
    in the rotated-quantized weight space)."""
    K, N = wq_v.shape
    dyf = dy.to(torch.float32)
    lead = dy.shape[:-1]
    Bflat = dyf.numel() // N
    off_b, row_b = _token_window(Bflat, window)

    # dx = H⁻¹( 16/9 · (SR(¾·Ĥ_N dy) @ SR(¾·Ĥ_N Wᵀ)ᵀ) ⊙ M_x )
    dy_p = _pad32(dyf, -1)
    wq_p = _pad32(wq_v.to(torch.float32), -1)
    Np = dy_p.shape[-1]
    signs_n = fastrng.rademacher(seed, Np, salt=11, device=dy.device)
    g_h = _maybe_rht(dy_p, signs_n, cfg, -1)
    wt_h = _maybe_rht(wq_p, signs_n, cfg, -1)  # blocks along N
    dx_rot = _bwd_gemm(g_h, wt_h, cfg, seed, (1, 2), ((off_b * Np, None), (0, None)))
    dx = hadamard_transform(dx_rot * m_x, g=cfg.group, dim=-1)  # H⁻¹ = H

    # dW_rot = 16/9 · SR(¾·Ĥ_B Xᵀ)ᵀ @ SR(¾·Ĥ_B dy)
    xf = _pad32(xq_v.to(torch.float32).reshape(Bflat, K), 0)
    gf = _pad32(dyf.reshape(Bflat, N), 0)
    Bp = xf.shape[0]
    signs_b = fastrng.rademacher(seed, Bp, salt=12, device=dy.device, offset=off_b)
    x2 = _maybe_rht(xf, signs_b, cfg, 0)
    g2 = _maybe_rht(gf, signs_b, cfg, 0)
    # [K, Bp] · [N, Bp]ᵀ
    dw_rot = _bwd_gemm(x2.t(), g2.t(), cfg, seed, (3, 4), ((off_b, row_b), (off_b, row_b)))
    return dx.reshape(*lead, K), dw_rot


def _backward_plain(cfg, seed, res, dy, window=(0, 1)):
    """``_bwd_plain_gemms`` + the weight mask and H⁻¹ of the reference's
    ``_quartet_bwd``."""
    xq_v, wq_v, m_x, m_w = res
    dx, dw_rot = _bwd_plain_gemms(cfg, seed, xq_v, wq_v, m_x, dy, window)
    return dx, hadamard_transform(dw_rot * m_w, g=cfg.group, dim=0)  # H⁻¹ along K


def _bwd_kernel_gemms(cfg, seed, xc, xs, wq_v, m_x, dy, window=(0, 1), ops=None):
    """:func:`_bwd_plain_gemms` on the kernels: backward Stage 1 on the four
    operands, the MXFP4 GEMM for dx and dW_rot (x's saved codes and scales,
    the weight's dequantized values wq_v [K, N])."""
    K = _kernel_ops(ops)
    g = cfg.group
    Kdim, N = wq_v.shape
    lead = dy.shape[:-1]
    dy2 = dy.reshape(-1, N)  # bf16 or f32: the kernel reads either exactly
    Bflat = dy2.shape[0]
    off_b, row_b = _token_window(Bflat, window)

    # dx: Stage 1 on dy [B, Np] and on Wq [K, Np] along N; the GEMM's B is
    # the transposed view of the Wq codes
    dy_p = _pad32(dy2, -1)
    wq_p = _pad32(wq_v, -1)
    Np = dy_p.shape[-1]
    signs_n = fastrng.rademacher(seed, Np, salt=11, device=dy.device)
    rows = {"offset": off_b * Np} if window[1] > 1 else {}
    gc, gs = K.sr_hadamard_quantize(dy_p, signs_n, seed, salt=1, **rows)
    wtc2, wts2 = K.sr_hadamard_quantize(wq_p, signs_n, seed, salt=2)
    dx_rot = SR_POSTSCALE * K.mxfp4_matmul(gc, gs, wtc2.t(), wts2.t())
    dx = hadamard_transform(dx_rot * m_x.reshape(Bflat, Kdim), g=g, dim=-1)

    # dW: Stage 1 on xqᵀ [K, Bp] and dyᵀ [N, Bp] (transposed views) along
    # the token dim; the GEMM's B is the transposed view of the dy codes
    xq_v = _pad32(_dequant_codes(xc, xs, g).reshape(Bflat, Kdim), 0)
    gf = _pad32(dy2, 0)
    Bp = xq_v.shape[0]
    signs_b = fastrng.rademacher(seed, Bp, salt=12, device=dy.device, offset=off_b)
    cols = {"offset": off_b, "row_len": row_b} if window[1] > 1 else {}
    x2c, x2s = K.sr_hadamard_quantize(xq_v.t(), signs_b, seed, salt=3, **cols)
    g2c, g2s = K.sr_hadamard_quantize(gf.t(), signs_b, seed, salt=4, **cols)
    dw_rot = SR_POSTSCALE * K.mxfp4_matmul(x2c, x2s, g2c.t(), g2s.t())
    return dx.reshape(*lead, Kdim), dw_rot


def _backward_kernels(cfg, seed, res, dy, ops=None, window=(0, 1)):
    """The reference's ``_quartet_bwd_kernels``: backward Stage 1 on the
    four operands, the MXFP4 GEMM for dx and dW, the weight mask and H⁻¹."""
    xc, xs, wtc, wts, m_x, m_w = res
    wq_v = _dequant_codes(wtc, wts, cfg.group).t()  # [K, N]
    dx, dw_rot = _bwd_kernel_gemms(cfg, seed, xc, xs, wq_v, m_x, dy, window, ops)
    return dx, hadamard_transform(dw_rot * m_w, g=cfg.group, dim=0)


class _QuartetLinear(torch.autograd.Function):
    """y = Quartet(x) @ Quartet(w) with the Algorithm-1 backward."""

    @staticmethod
    def forward(ctx, x, w, seed, cfg):
        if cfg.fwd_quantizer == "none":  # bf16 passthrough
            ctx.save_for_backward(x, w)
            y = _gemm(x, w, cfg.accum_dtype)
        else:
            y, res = (_forward_kernels(x, w, cfg) if cfg.use_kernels
                      else _forward_plain(x, w, cfg, seed))
            if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
                ctx.save_for_backward(*res)
        ctx.seed, ctx.cfg, ctx.window = seed, cfg, C.token_window()
        ctx.dtypes = (x.dtype, w.dtype)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        cfg, seed = ctx.cfg, ctx.seed
        res = ctx.saved_tensors
        if cfg.fwd_quantizer == "none":
            x, w = res
            dyf = dy.to(torch.float32)
            dx = _gemm(dyf, w.t(), cfg.accum_dtype)
            dw = _gemm(x.reshape(-1, x.shape[-1]).t(), dyf.reshape(-1, dy.shape[-1]),
                       cfg.accum_dtype)
        elif cfg.use_kernels:
            dx, dw = _backward_kernels(cfg, seed, res, dy, window=ctx.window)
        else:
            dx, dw = _backward_plain(cfg, seed, res, dy, ctx.window)
        return dx.to(ctx.dtypes[0]), dw.to(ctx.dtypes[1]), None, None


def quartet_linear(x: torch.Tensor, w: torch.Tensor, seed: int,
                   cfg: QuartetConfig) -> torch.Tensor:
    """y = Quartet(x) @ Quartet(w).  x [..., K], w [K, N], ``seed`` a uint32
    (Python int) that drives the backward's stochastic rounding."""
    _check(cfg)
    return _QuartetLinear.apply(x, w, seed & 0xFFFFFFFF, cfg)


# ---------------------------------------------------------------------------
# the FP4 all-gather (beyond-paper): FSDP weight shards cross as MXFP4 codes
# ---------------------------------------------------------------------------


class _QuestQDQGathered(torch.autograd.Function):
    """w (a rank's shard [K/n, N] or [K, N/n], or a whole [K, N]; or a stack
    of experts' [E, ., .]) → (values f32 [(E,) K, N], mask [shard], codes
    int8 [(E,) N, K], scales f32 [(E,) N, K/32]): H₃₂ and QuEST on the
    shard's Wᵀ (B1 on the card, its expert axis for a stack), the codes and
    scales all-gathered over the data ranks, dequantized.  Only the values
    carry a gradient: the backward reduce-scatters the f32 dW_rot to the
    shard, then applies the shard's mask and H⁻¹ along K."""

    @staticmethod
    def forward(ctx, w, cfg, dim):
        plan = C.current_plan() if dim is not None else None
        if cfg.use_kernels:
            K = _kernel_ops(None)
            quant = K.hadamard_quest_quantize_experts if w.dim() == 3 else \
                K.hadamard_quest_quantize
            codes, scales, mask_t = quant(w.transpose(-1, -2), group=cfg.group)
        else:
            wh = hadamard_transform(w.to(torch.float32), g=cfg.group, dim=-2)
            q = Q.quest(wh.transpose(-1, -2), cfg.fwd_fmt)  # blocks along K
            codes, scales, mask_t = q.codes, q.scales, q.mask
        if plan is not None:
            # W's dim ↔ Wᵀ's other one of its last two; contiguous [., N, K]
            # as B1 writes it
            tdim = 2 * w.dim() - 3 - dim
            codes = C.gather_data(codes, tdim, plan.mesh).contiguous()
            scales = C.gather_data(scales, tdim, plan.mesh).contiguous()
        # f32 [(E,) K, N], bf16-exact
        vals = _dequant_codes(codes, scales, cfg.group).transpose(-1, -2)
        mask = mask_t.transpose(-1, -2)
        ctx.save_for_backward(mask)
        ctx.plan, ctx.dim, ctx.group, ctx.dtype = plan, dim, cfg.group, w.dtype
        ctx.mark_non_differentiable(mask, codes, scales)
        return vals, mask, codes, scales

    @staticmethod
    def backward(ctx, dvals, *_):
        (mask,) = ctx.saved_tensors
        d = dvals.to(torch.float32)
        plan = ctx.plan
        if plan is not None:
            # the f32 sum over the ranks, scattered to this rank's shard before
            # the mask ⊙ and H⁻¹ (both block-local along K)
            d = C.reduce_scatter_data(d, ctx.dim, plan.mesh)
        dw = hadamard_transform(d * mask, g=ctx.group, dim=-2)
        return dw.to(ctx.dtype), None, None


def quest_qdq_gathered(w: torch.Tensor, cfg: QuartetConfig):
    """The reference's ``quest_qdq_gathered``: → (w_vals f32 [K, N], w_mask,
    codes int8 [N, K], scales f32 [N, K/32]), the rotated-quantized weight
    whole on every data rank; a stack of experts [E, K, N] gives each with
    its leading E.  ``w`` is a rank's shard when the train step's anchors
    left it sharded (``distributed.context.fsdp_dim``), else the whole
    weight; the mask stays the shard's."""
    _check(cfg)
    return _QuestQDQGathered.apply(w, cfg, C.fsdp_dim(w))


class _QuartetLinearPQ(torch.autograd.Function):
    """Quartet with the weight operand pre-rotated and pre-quantized: the
    forward quantizes x alone (B1, then B3 on the gathered codes on the
    card; their expert axes for a stack of experts); the backward is
    Algorithm 1's, returning dW_rot in the rotated space for
    :class:`_QuestQDQGathered` to finish."""

    @staticmethod
    def forward(ctx, x, w_vals, w_mask, seed, cfg, codes, scales, window):
        experts = w_vals.dim() == 3
        if cfg.use_kernels:
            K = _kernel_ops(None)
            if experts:
                xc, xs, xm = K.hadamard_quest_quantize_experts(x, group=cfg.group)
                y = K.mxfp4_matmul_experts(xc, xs, codes.transpose(-1, -2),
                                           scales.transpose(-1, -2))
            else:
                xc, xs, xm = K.hadamard_quest_quantize(x, group=cfg.group)
                y = K.mxfp4_matmul(xc, xs, codes.t(), scales.t())
            res = (xc, xs, xm, codes, scales)
        else:
            xh = hadamard_transform(x.to(torch.float32), g=cfg.group, dim=-1)
            xq = (_fwd_quantize_experts(xh, cfg, seed) if experts
                  else _fwd_quantize(xh, cfg, _forward_key(seed)))
            xv = xq.values.to(torch.bfloat16)
            wv = w_vals.to(torch.bfloat16)  # exact
            y = _gemm(xv, wv, cfg.accum_dtype)
            res = (xv, wv, xq.mask)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            ctx.save_for_backward(*res, *([seed] if experts else []))
        ctx.seed, ctx.cfg, ctx.dtype, ctx.experts = seed, cfg, x.dtype, experts
        ctx.window = window if experts else C.token_window()
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        cfg, seed = ctx.cfg, ctx.seed
        saved = ctx.saved_tensors
        if ctx.experts:
            *saved, seed = saved
        if cfg.use_kernels:
            xc, xs, xm, codes, scales = saved
            wq_v = _dequant_codes(codes, scales, cfg.group,
                                  torch.bfloat16 if ctx.experts else torch.float32)
            wq_v = wq_v.transpose(-1, -2)
            gemms = _bwd_experts_kernel_gemms if ctx.experts else _bwd_kernel_gemms
            dx, dw_rot = gemms(cfg, seed, xc, xs, wq_v, xm, dy, ctx.window)
        else:
            xv, wv, xm = saved
            gemms = _bwd_experts_plain_gemms if ctx.experts else _bwd_plain_gemms
            dx, dw_rot = gemms(cfg, seed, xv, wv, xm, dy, ctx.window)
        return dx.to(ctx.dtype), dw_rot, None, None, None, None, None, None


def quartet_linear_pq(x: torch.Tensor, w_vals: torch.Tensor, w_mask: torch.Tensor, seed,
                      cfg: QuartetConfig, codes: torch.Tensor | None = None,
                      scales: torch.Tensor | None = None, window=(0, None)) -> torch.Tensor:
    """The reference's ``quartet_linear_pq``: y = Quartet(x) @ w_vals for the
    rotated-quantized weight of :func:`quest_qdq_gathered` (whose codes and
    scales the kernels multiply by; the plain path takes the values).  For
    a stack of experts (x [E, T, K], w_vals [E, K, N]) ``seed`` is the
    experts' seeds [E] and ``window`` the tokens' place on an expert's
    logical token axis, as :func:`quartet_linear_experts` takes them."""
    _check(cfg)
    if cfg.fwd_quantizer == "none" or cfg.fwd_format != "mxfp4":
        raise ValueError(f"fp4_allgather gathers MXFP4 QuEST codes: {cfg}")
    if cfg.use_kernels and (codes is None or scales is None):
        raise ValueError("quartet_linear_pq on the kernels needs the gathered codes and scales")
    if w_vals.dim() == 3:
        _check_experts(x, w_vals, window)
    else:
        seed &= 0xFFFFFFFF
    return _QuartetLinearPQ.apply(x, w_vals, w_mask, seed, cfg, codes, scales, window)


# ---------------------------------------------------------------------------
# stacked experts
# ---------------------------------------------------------------------------


def _forward_experts_kernels(x, w, cfg, ops=None):
    """Stage 1 on x [E, T, K] and on the weights' transposed view [E, N, K]
    (read in place), then the block-scaled GEMM: three launches for all E
    experts.  The residuals are the 4-bit payload and both masks, as the
    2-d forward's."""
    K = _kernel_ops(ops)
    xc, xs, xm = K.hadamard_quest_quantize_experts(x, group=cfg.group)
    wtc, wts, wtm = K.hadamard_quest_quantize_experts(w.transpose(-1, -2), group=cfg.group)
    y = K.mxfp4_matmul_experts(xc, xs, wtc.transpose(-1, -2), wts.transpose(-1, -2))
    return y, (xc, xs, wtc, wts, xm, wtm.transpose(-1, -2))


def _fwd_quantize_experts(xh: torch.Tensor, cfg: QuartetConfig, seeds: torch.Tensor):
    """:func:`_fwd_quantize` of xh [E, ...]; SR-AbsMax draws expert e's
    uniforms under its own key, ``fold_in(PRNGKey(0), seeds[e])``, as the
    reference's vmap does."""
    if cfg.fwd_quantizer != "sr_absmax":
        return _fwd_quantize(xh, cfg, None)
    parts = [_fwd_quantize(xh[e], cfg, _forward_key(s)) for e, s in enumerate(seeds.tolist())]
    return Q.QuantResult(*(torch.stack(field) for field in zip(*parts)))


def _forward_experts_plain(x, w, cfg, seeds):
    xh = hadamard_transform(x.to(torch.float32), g=cfg.group, dim=-1)
    wh = hadamard_transform(w.to(torch.float32), g=cfg.group, dim=-2)
    xq = _fwd_quantize_experts(xh, cfg, seeds)
    wq = _fwd_quantize_experts(wh.transpose(-1, -2), cfg, seeds)  # blocks along K
    xv = xq.values.to(torch.bfloat16)  # as the 2-d forward
    wv = wq.values.transpose(-1, -2).to(torch.bfloat16)
    return _gemm(xv, wv, cfg.accum_dtype), (xv, wv, xq.mask, wq.mask.transpose(-1, -2))


def _signed(x: torch.Tensor, signs: torch.Tensor, dim: int) -> torch.Tensor:
    """x [E, ...] ⊙ signs [E, n] along ``dim`` (each expert its own row)."""
    shape = [x.shape[0]] + [1] * (x.dim() - 1)
    shape[dim] = x.shape[dim]
    return x * signs.reshape(shape).to(x.dtype)


def _maybe_rht_experts(x: torch.Tensor, signs: torch.Tensor, cfg: QuartetConfig,
                       dim: int) -> torch.Tensor:
    """:func:`_maybe_rht` of x [E, ...], expert e's signs its own row."""
    if cfg.bwd_hadamard == "random":
        x = _signed(x, signs, dim)
    if cfg.bwd_hadamard == "none":
        return x
    return hadamard_transform(x, g=cfg.group, dim=dim)


def _bwd_experts_plain_gemms(cfg, seeds, xq_v, wq_v, m_x, dy, window=(0, None)):
    """:func:`_bwd_plain_gemms` for every expert at once → (dx [E, T, K],
    dW_rot [E, K, N]): expert e's signs and uniforms at seeds[e], over its
    own [T, K] / [K, N] operands; ``window`` (offset, row length) places
    the T tokens on an expert's logical token axis, for the token-axis
    draws (dy's SR, the signs ξ_B, xqᵀ's and dyᵀ's SR)."""
    off, row = window
    dyf = dy.to(torch.float32)

    # dx = H⁻¹( 16/9 · (SR(¾·Ĥ_N dy) @ SR(¾·Ĥ_N Wᵀ)ᵀ) ⊙ M_x )
    dy_p = _pad32(dyf, -1)
    wq_p = _pad32(wq_v.to(torch.float32), -1)
    Np = dy_p.shape[-1]
    signs_n = fastrng.rademacher(seeds, Np, salt=11, device=dy.device)
    g_h = _maybe_rht_experts(dy_p, signs_n, cfg, 2)
    wt_h = _maybe_rht_experts(wq_p, signs_n, cfg, 2)  # blocks along N
    dx_rot = _bwd_gemm(g_h, wt_h, cfg, seeds, (1, 2), ((off * Np, None), (0, None)))
    dx = hadamard_transform(dx_rot * m_x, g=cfg.group, dim=-1)  # H⁻¹ = H

    # dW_rot = 16/9 · SR(¾·Ĥ_B Xᵀ)ᵀ @ SR(¾·Ĥ_B dy), B the token axis
    xf = _pad32(xq_v.to(torch.float32), 1)
    gf = _pad32(dyf, 1)
    signs_b = fastrng.rademacher(seeds, xf.shape[1], salt=12, device=dy.device, offset=off)
    x2 = _maybe_rht_experts(xf, signs_b, cfg, 1)
    g2 = _maybe_rht_experts(gf, signs_b, cfg, 1)
    dw_rot = _bwd_gemm(x2.transpose(-1, -2), g2.transpose(-1, -2), cfg, seeds, (3, 4),
                       ((off, row), (off, row)))
    return dx, dw_rot


def _backward_experts_plain(cfg, seeds, res, dy, window=(0, None)):
    """:func:`_backward_plain` for every expert at once (the weight mask and
    H⁻¹ after :func:`_bwd_experts_plain_gemms`)."""
    xq_v, wq_v, m_x, m_w = res
    dx, dw_rot = _bwd_experts_plain_gemms(cfg, seeds, xq_v, wq_v, m_x, dy, window)
    return dx, hadamard_transform(dw_rot * m_w, g=cfg.group, dim=-2)  # H⁻¹ along K


def _bwd_experts_kernel_gemms(cfg, seeds, xc, xs, wq_v, m_x, dy, window=(0, None), ops=None):
    """:func:`_bwd_experts_plain_gemms` on the kernels: backward Stage 1 on
    the four operands dy [E, T, Np], Wq [E, K, Np], xqᵀ [E, K, Bp] and dyᵀ
    [E, N, Bp] (the last three views with unit stride along their rows,
    read in place; the token-axis draws through ``window``), then the GEMMs
    for dx and dW_rot: six launches for all E experts, no host sync."""
    K = _kernel_ops(ops)
    g = cfg.group
    off, row = window
    dy = dy.contiguous()  # bf16 or f32: the kernel reads either exactly

    # dx: Stage 1 along N on dy and Wq; the GEMM's B is the transposed view
    # of the Wq codes
    dy_p = _pad32(dy, -1)
    wq_p = _pad32(wq_v, -1)
    Np = dy_p.shape[-1]
    signs_n = fastrng.rademacher(seeds, Np, salt=11, device=dy.device)
    rows = {"offset": off * Np} if off else {}
    gc, gs = K.sr_hadamard_quantize_experts(dy_p, signs_n, seeds, salt=1, **rows)
    wtc2, wts2 = K.sr_hadamard_quantize_experts(wq_p, signs_n, seeds, salt=2)
    dx_rot = SR_POSTSCALE * K.mxfp4_matmul_experts(gc, gs, wtc2.transpose(-1, -2),
                                                   wts2.transpose(-1, -2))
    dx = hadamard_transform(dx_rot * m_x, g=g, dim=-1)

    # dW: Stage 1 along the token axis on the transposed views xqᵀ and dyᵀ;
    # the GEMM's B is the transposed view of the dy codes
    xq_v = _pad32(_dequant_codes(xc, xs, g, torch.bfloat16), 1)
    gf = _pad32(dy, 1)
    signs_b = fastrng.rademacher(seeds, xq_v.shape[1], salt=12, device=dy.device, offset=off)
    cols = {"offset": off, "row_len": row} if row is not None else {}
    x2c, x2s = K.sr_hadamard_quantize_experts(xq_v.transpose(-1, -2), signs_b, seeds, salt=3,
                                              **cols)
    g2c, g2s = K.sr_hadamard_quantize_experts(gf.transpose(-1, -2), signs_b, seeds, salt=4,
                                              **cols)
    dw_rot = SR_POSTSCALE * K.mxfp4_matmul_experts(x2c, x2s, g2c.transpose(-1, -2),
                                                   g2s.transpose(-1, -2))
    return dx, dw_rot


def _backward_experts_kernels(cfg, seeds, res, dy, ops=None, window=(0, None)):
    """:func:`_backward_kernels` for every expert at once: backward Stage 1
    on the four operands, the GEMMs for dx and dW
    (:func:`_bwd_experts_kernel_gemms`), the weight mask and H⁻¹.  The
    saved codes are dequantized to bf16 (exact, and half an f32 copy's
    bytes)."""
    xc, xs, wtc, wts, m_x, m_w = res
    wq_v = _dequant_codes(wtc, wts, cfg.group, torch.bfloat16).transpose(-1, -2)  # [E, K, N]
    dx, dw_rot = _bwd_experts_kernel_gemms(cfg, seeds, xc, xs, wq_v, m_x, dy, window, ops)
    return dx, hadamard_transform(dw_rot * m_w, g=cfg.group, dim=-2)


class _QuartetLinearExperts(torch.autograd.Function):
    """y[e] = Quartet(x[e]) @ Quartet(w[e]) for every expert, with the
    Algorithm-1 backward at each expert's seed."""

    @staticmethod
    def forward(ctx, x, w, seeds, cfg, window):
        grad = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        if cfg.fwd_quantizer == "none":
            y = _gemm(x, w, cfg.accum_dtype)
            res = (x, w)
        else:
            y, res = (_forward_experts_kernels(x, w, cfg) if cfg.use_kernels
                      else _forward_experts_plain(x, w, cfg, seeds))
        if grad:  # serving keeps nothing
            ctx.save_for_backward(seeds, *res)
        ctx.cfg, ctx.window = cfg, window
        ctx.dtypes = (x.dtype, w.dtype)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        cfg = ctx.cfg
        seeds, *res = ctx.saved_tensors
        if cfg.fwd_quantizer == "none":
            x, w = res
            dx = _gemm(dy, w.transpose(-1, -2), cfg.accum_dtype)
            dw = _gemm(x.transpose(-1, -2), dy, cfg.accum_dtype)
        elif cfg.use_kernels:
            dx, dw = _backward_experts_kernels(cfg, seeds, res, dy, window=ctx.window)
        else:
            dx, dw = _backward_experts_plain(cfg, seeds, res, dy, ctx.window)
        return dx.to(ctx.dtypes[0]), dw.to(ctx.dtypes[1]), None, None, None


def _check_experts(x: torch.Tensor, w: torch.Tensor, window) -> None:
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"quartet_linear_experts: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if window[1] is not None and x.shape[1] % 32:
        raise ValueError(f"{x.shape[1]} tokens an expert in a window of {window[1]} are not "
                         f"a multiple of 32: the logical axis's padding would fall inside it")


def quartet_linear_experts(x: torch.Tensor, w: torch.Tensor, seeds: torch.Tensor,
                           cfg: QuartetConfig, window=(0, None)) -> torch.Tensor:
    """y [E, T, N] = Quartet(x[e]) @ Quartet(w[e]) for x [E, T, K], w
    [E, K, N].  ``seeds`` [E] (uint32 values in int64) are the experts'
    stochastic-rounding seeds, folded as the reference folds them; they
    drive the backward.  ``window`` (offset, row length): the T tokens are
    an expert's slots offset .. offset + T − 1 of a logical axis of that
    length (a data-parallel rank's block of a MoE layer's slots), whose
    draws the backward takes; (0, None) is x's own axis."""
    _check(cfg)
    _check_experts(x, w, window)
    return _QuartetLinearExperts.apply(x, w, seeds, cfg, window)
