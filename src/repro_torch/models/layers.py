"""Shared layers: norms, the Quartet-wired dense, embeddings, RoPE.

Port of ``repro.models.layers``.  Functional style: parameters are nested
dicts of tensors with the reference's tree paths, so a JAX checkpoint maps
onto them leaf by leaf (``repro_torch.convert``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch.core import formats as F
from repro_torch.core.baselines import baseline_linear, baseline_linear_experts
from repro_torch.core.quartet import (QuartetConfig, quartet_linear, quartet_linear_experts,
                                     quartet_linear_pq, quest_qdq_gathered)
from repro_torch.distributed.context import weight_operand, widened


def trunc_normal(shape, std: float, dtype: torch.dtype, generator: torch.Generator,
                 device) -> torch.Tensor:
    """std · N(0, 1) truncated to ±3 (drawn in f32, then cast)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return (t * std).to(dtype)


def init_dense(d_in: int, d_out: int, dtype, generator, device,
               use_bias: bool = False) -> dict:
    p = {"w": trunc_normal((d_in, d_out), 1.0 / np.sqrt(d_in), dtype, generator, device)}
    if use_bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


class _HeadProduct(torch.autograd.Function):
    """x [..., S, D] @ w [D, V] in f32, the LM head's product, whose
    backward computes dx a [S, V] block of rows at a time and dW in one
    product over every row.  On the card cuBLAS splits dx's
    V-long contraction by the call's row count, so dx of a whole [B·S, V]
    gradient would round a row by B: a data-parallel rank (B/n rows) would
    then feed its layers other bits than one device, and their stochastic
    roundings would part.  A block of S rows rounds alike in any batch."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        wt = w.t()
        blocks = g.reshape(-1, *g.shape[-2:]) if g.dim() > 2 else g[None]
        dx = torch.stack([gb @ wt for gb in blocks]).reshape(x.shape)
        dw = x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        return dx, dw


def head_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 x [..., S, D] @ f32 w [D, V] (:class:`_HeadProduct` under
    autograd, the plain product otherwise)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _HeadProduct.apply(x, w)
    return x @ w


def dense(params: dict, x: torch.Tensor, seed: int, qcfg: QuartetConfig,
          method: str = "quartet", head: bool = False) -> torch.Tensor:
    """The one entry point of every model matmul; ``method`` selects Quartet,
    the bf16 baseline or one of the paper's baselines
    (``core.baselines.BASELINE_METHODS``).  In training under a baseline
    method the weight arrives in its master dtype (:func:`takes_master_weight`)
    and is cast to x's dtype here, or inside ``baseline_linear``.  With
    ``qcfg.fp4_allgather`` Quartet takes the weight as MXFP4 codes, gathered
    from the data ranks' shards when the train step's anchors left ``w`` a
    shard (``core.quartet.quest_qdq_gathered``).  ``head``: the LM head,
    whose bf16 product takes :func:`head_product`."""
    w = params["w"]
    if w.shape[0] % 32 != 0:
        # contraction dim not divisible by the MXFP4 group: keep bf16
        method = "bf16"
    if method == "quartet" and qcfg.fp4_allgather:
        w_vals, w_mask, codes, scales = quest_qdq_gathered(w, qcfg)
        y = quartet_linear_pq(x, w_vals, w_mask, seed, qcfg, codes, scales)
    elif method == "quartet":
        y = quartet_linear(x, w, seed, qcfg)
    elif method == "bf16":
        xf, wf = x.to(torch.float32), weight_operand(w, x.dtype).to(torch.float32)
        y = (head_product(xf, wf) if head else xf @ wf).to(x.dtype)
    else:
        y = baseline_linear(x, w, seed, method)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def dense_experts(w: torch.Tensor, x: torch.Tensor, seeds: torch.Tensor, qcfg: QuartetConfig,
                  method: str = "quartet", window=(0, None)) -> torch.Tensor:
    """E stacked linears at once, y[e] = x[e] @ w[e] for x [E, T, K], w
    [E, K, N]: the counterpart of the reference's ``jax.vmap`` of
    :func:`dense` over a MoE layer's experts (``seeds`` [E], one per expert,
    as the vmap carries them; a baseline quantizes and samples per expert).
    ``window``: the T tokens' place on an expert's logical token axis
    (``core.quartet.quartet_linear_experts``)."""
    if w.shape[1] % 32 != 0:
        method = "bf16"
    if method == "quartet":
        return quartet_linear_experts(x, w, seeds, qcfg, window)
    if method == "bf16":
        wf = weight_operand(w, x.dtype).to(torch.float32)
        return torch.bmm(x.to(torch.float32), wf).to(x.dtype)
    return baseline_linear_experts(x, w, seeds, method)


def takes_master_weight(path: tuple[str, ...]) -> bool:
    """Whether the parameter at ``path`` (its keys in the param tree) is a
    weight that :func:`dense` or :func:`dense_experts` hands to a baseline
    method: every dense ``w`` but the MoE router's (a bf16 dense there) and
    the MoE layer's expert stacks.  Under a baseline method the train step
    passes these to the model in their master dtype (f32 leaves), as the
    reference's ``jax.grad`` hands the master the baselines' f32 dW
    unrounded (``core.baselines``)."""
    name, parent = path[-1], (path[-2] if len(path) > 1 else None)
    if name == "w":
        return parent != "router"
    return parent == "moe" and name in ("gate", "up", "down")


def init_rmsnorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def _tree_sum(s: torch.Tensor) -> torch.Tensor:
    """The last dim summed pairwise, keepdim: padded with +0 to a power of
    two P, then halves added elementwise (element i + element i + P/2) until
    one is left.  Elementwise adds round alike on every device, so the sum
    has one order, fixed by the row length alone."""
    n = s.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p > n:  # the first level: the upper part added to the lower, the rest + 0
        h = p // 2
        t = s[..., :h].clone()
        t[..., :n - h] += s[..., h:]
        s = t
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = s[..., :h] + s[..., h:]
    return s


class _RowSoftmax(torch.autograd.Function):
    """softmax over the last dim in one order on every device and for any
    number of rows: the max (exact in any order), exp, the sum
    :func:`_tree_sum`; the backward p ⊙ (g − Σ g ⊙ p), its sum the same
    tree.  A library softmax (and its backward's sum) picks its reduction
    order on the card from the call's row count."""

    @staticmethod
    def forward(ctx, x):
        e = torch.exp(x - x.amax(dim=-1, keepdim=True))
        p = e / _tree_sum(e)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        return p * (g - _tree_sum(g * p))


class _RowLogSumExp(torch.autograd.Function):
    """logsumexp over the last dim in :class:`_RowSoftmax`'s order; the
    backward g ⊙ exp(x − lse), elementwise."""

    @staticmethod
    def forward(ctx, x):
        m = x.amax(dim=-1, keepdim=True)
        lse = m + torch.log(_tree_sum(torch.exp(x - m)))
        ctx.save_for_backward(x, lse)
        return lse.squeeze(-1)

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(x - lse)


def row_softmax(x: torch.Tensor) -> torch.Tensor:
    """softmax over the last dim; on the card in one order for any number of
    rows (:class:`_RowSoftmax`), on the CPU torch's (which rounds a row alike
    in any call)."""
    return _RowSoftmax.apply(x) if x.is_cuda else torch.softmax(x, dim=-1)


def row_logsumexp(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last dim, as :func:`row_softmax` takes it."""
    return _RowLogSumExp.apply(x) if x.is_cuda else torch.logsumexp(x, dim=-1)


class _MeanSquare(torch.autograd.Function):
    """Mean of squares over the last dim, keepdim, in one summation order on
    every device (:func:`_tree_sum`).  A library reduction picks its order
    per device and, on the card, from the call's row count, so a row's bits
    would depend on where it runs (card against CPU) and on the call's
    shape (a speculative verify's [B, k+1] rows against a decode's [B, 1]).
    The backward is autograd's for ``sum(x · x) / d``, (g / d)·x added twice,
    written out: through the tree autograd would take ~5 launches a level."""

    @staticmethod
    def forward(ctx, xf):
        ctx.save_for_backward(xf)
        return F.div_exact(_tree_sum(xf * xf), xf.shape[-1])

    @staticmethod
    def backward(ctx, g):
        (xf,) = ctx.saved_tensors
        gx = F.div_exact(g, xf.shape[-1]) * xf
        return gx + gx


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x / √(mean(x²) + eps) · scale.  The mean sums in one order on every
    device and the root is 1/√ in float64 rounded once to f32 (correctly
    rounded on both; the card's f32 ``rsqrt`` is approximate), so a row
    normalizes to the same bits on the card and on the CPU."""
    xf = x.to(torch.float32)
    var = _MeanSquare.apply(xf) + eps
    inv = (1.0 / torch.sqrt(var.to(torch.float64))).to(torch.float32)
    return (xf * inv * params["scale"].to(torch.float32)).to(x.dtype)


def init_layernorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(x − mean(x)) / √(mean((x − mean(x))²) + eps) · scale + bias.  Both
    means sum in :func:`rmsnorm`'s fixed pairwise order and divide exactly,
    and the root is 1/√ in float64 rounded once to f32, so a row normalizes
    to the same bits on the card and on the CPU."""
    xf = x.to(torch.float32)
    d = xf.shape[-1]
    xc = xf - F.div_exact(_tree_sum(xf), d)
    var = F.div_exact(_tree_sum(xc * xc), d) + eps
    inv = (1.0 / torch.sqrt(var.to(torch.float64))).to(torch.float32)
    out = xc * inv * params["scale"].to(torch.float32)
    return (out + params["bias"].to(torch.float32)).to(x.dtype)


def make_norm(kind: str):
    """The ``(init, apply)`` pair of ``cfg.norm``: rmsnorm or layernorm."""
    return (init_rmsnorm, rmsnorm) if kind == "rmsnorm" else (init_layernorm, layernorm)


@functools.lru_cache(maxsize=None)
def _inv_freq_host(head_dim: int, theta: float) -> np.ndarray:
    """1 / θ^(2i / hd), the reference's formula, in float64 on the host and
    rounded once to f32: the same bits whatever device the model runs on
    (a device's f32 ``pow`` rounds per library; XLA:CPU's is within 1 ulp
    of this)."""
    exps = np.arange(0, head_dim, 2, dtype=np.float64) / head_dim
    return (1.0 / np.power(np.float64(theta), exps)).astype(np.float32)


_INV_FREQ: dict = {}


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """The f32 inverse frequencies [hd/2] on ``device`` (copied there once)."""
    key = (head_dim, float(theta), torch.device(device))
    if key not in _INV_FREQ:
        with torch.inference_mode(False):  # a normal tensor, usable under autograd too
            _INV_FREQ[key] = torch.from_numpy(_inv_freq_host(head_dim, float(theta))).to(device)
    return _INV_FREQ[key]


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [B, S] → (cos, sin), each [B, S, 1, hd/2] f32.  Each angle is
    one f32 product of the position and the inverse frequency (IEEE, so the
    same on every device); its cos and sin are taken in float64 and rounded
    once to f32, correctly rounded but for ties beyond float64's reach, where
    the card's f32 ``sin``/``cos`` and the CPU's differ in the last bit.  A
    forward builds the table once and hands it to every layer."""
    ang = positions[..., None].to(torch.float32) * rope_freqs(head_dim, theta,
                                                              positions.device)
    ang = ang.to(torch.float64)[:, :, None, :]
    return torch.cos(ang).to(torch.float32), torch.sin(ang).to(torch.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, hd] rotated by a :func:`rope_table` of its positions (per
    row: serving rows sit at genuinely different offsets)."""
    hd = x.shape[-1]
    x1 = x[..., : hd // 2].to(torch.float32)
    x2 = x[..., hd // 2:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sinusoidal_host(max_len: int, d: int) -> np.ndarray:
    pos = np.arange(max_len)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / np.power(10000.0, dim / d)
    out = np.zeros((max_len, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


_SINUSOIDAL: dict = {}


def sinusoidal_positions(max_len: int, d: int, device="cpu") -> torch.Tensor:
    """The absolute position table [max_len, d] f32 (sin on even columns,
    cos on odd), the reference's numpy float64 computation rounded once to
    f32: the same bits on every device.  Built once a (shape, device)."""
    key = (max_len, d, torch.device(device))
    if key not in _SINUSOIDAL:
        with torch.inference_mode(False):
            _SINUSOIDAL[key] = torch.from_numpy(_sinusoidal_host(max_len, d)).to(device)
    return _SINUSOIDAL[key]


def add_absolute_positions(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] plus the rows of the absolute position table (max(4096,
    S) rows, positions clamped into it) in x's dtype, as the reference
    adds them."""
    pe = sinusoidal_positions(max(4096, x.shape[1]), x.shape[-1], x.device)
    return x + pe[torch.clamp(positions.long(), 0, pe.shape[0] - 1)].to(x.dtype)


def init_embedding(vocab: int, d: int, dtype, generator, device) -> dict:
    # 1/√d keeps tied-unembedding logits O(1) at init
    return {"table": trunc_normal((vocab, d), 1.0 / np.sqrt(d), dtype, generator, device)}


def embed(params: dict, tokens: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """The table's rows (``F.embedding``: on the card its backward sums a
    row's gradients in f32 and rounds once, where an index's rounds each
    add to a bf16 table), back in the compute ``dtype`` when the
    data-parallel anchors widened the table to f32 (``distributed.context.
    widened``)."""
    rows = Fn.embedding(tokens.long(), params["table"])
    return rows.to(dtype) if dtype is not None and widened() else rows


def unembed(params: dict, x: torch.Tensor, seed: int, qcfg: QuartetConfig,
            quantize: bool, method: str = "quartet") -> torch.Tensor:
    """Logits head; the tied path multiplies by the embedding table's
    transpose (f32 accumulation, as the reference's contraction)."""
    table = params["table"]
    if quantize and method == "quartet":
        return quartet_linear(x, table.t(), seed, qcfg)
    return head_product(x.to(torch.float32), table.to(torch.float32).t())


def seed_fold(seed, salt: int):
    """Per-site seed derivation in uint32 arithmetic (seed · 1000003 + salt),
    of a Python int or, elementwise, of an int64 tensor of uint32 values."""
    return (seed * 1000003 + salt) & 0xFFFFFFFF
