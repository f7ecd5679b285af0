"""Shared layers: norms, the Quartet-wired dense, embeddings, RoPE.

Port of ``repro.models.layers``.  Functional style: parameters are nested
dicts of tensors with the reference's tree paths, so a JAX checkpoint maps
onto them leaf by leaf (``repro_torch.convert``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quartet import QuartetConfig, quartet_linear, quartet_linear_experts


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


def dense(params: dict, x: torch.Tensor, seed: int, qcfg: QuartetConfig,
          method: str = "quartet") -> torch.Tensor:
    """The one entry point of every model matmul; ``method`` selects Quartet
    or the bf16 baseline (the paper's other baselines arrive in a later
    slice)."""
    w = params["w"]
    if w.shape[0] % 32 != 0:
        # contraction dim not divisible by the MXFP4 group: keep bf16
        method = "bf16"
    if method == "quartet":
        y = quartet_linear(x, w, seed, qcfg)
    elif method == "bf16":
        y = (x.to(torch.float32) @ w.to(torch.float32)).to(x.dtype)
    else:
        raise NotImplementedError(f"dense method {method!r} is not ported yet")
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def dense_experts(w: torch.Tensor, x: torch.Tensor, seeds: torch.Tensor, qcfg: QuartetConfig,
                  method: str = "quartet") -> torch.Tensor:
    """E stacked linears at once, y[e] = x[e] @ w[e] for x [E, T, K], w
    [E, K, N]: the counterpart of the reference's ``jax.vmap`` of
    :func:`dense` over a MoE layer's experts (``seeds`` [E], one per expert,
    as the vmap carries them)."""
    if w.shape[1] % 32 != 0:
        method = "bf16"
    if method == "quartet":
        return quartet_linear_experts(x, w, seeds, qcfg)
    if method == "bf16":
        return torch.bmm(x.to(torch.float32), w.to(torch.float32)).to(x.dtype)
    raise NotImplementedError(f"dense method {method!r} is not ported yet")


def init_rmsnorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def _mean_square(xf: torch.Tensor) -> torch.Tensor:
    """Mean of squares over the last dim, keepdim.  On the card a single
    reduction over the row picks its split across threads from the number of
    rows in the call, so a row's bits would depend on the call's shape (a
    speculative verify's [B, k+1] rows against a decode's [B, 1]); there the
    row is summed in 32-wide partials and then their sum, an order fixed by
    the row length alone."""
    d = xf.shape[-1]
    if xf.is_cuda and d % 32 == 0:
        part = (xf * xf).reshape(*xf.shape[:-1], d // 32, 32).sum(-1)
        return part.sum(-1, keepdim=True) / d
    return torch.mean(xf * xf, dim=-1, keepdim=True)


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = _mean_square(xf)
    out = xf * torch.rsqrt(var + eps)
    return (out * params["scale"].to(torch.float32)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, hd]; positions [B, S] absolute token positions (per row:
    serving rows sit at genuinely different offsets)."""
    hd = x.shape[-1]
    ang = positions[..., None].to(torch.float32) * rope_freqs(hd, theta, x.device)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1 = x[..., : hd // 2].to(torch.float32)
    x2 = x[..., hd // 2:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def init_embedding(vocab: int, d: int, dtype, generator, device) -> dict:
    # 1/√d keeps tied-unembedding logits O(1) at init
    return {"table": trunc_normal((vocab, d), 1.0 / np.sqrt(d), dtype, generator, device)}


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def unembed(params: dict, x: torch.Tensor, seed: int, qcfg: QuartetConfig,
            quantize: bool, method: str = "quartet") -> torch.Tensor:
    """Logits head; the tied path multiplies by the embedding table's
    transpose (f32 accumulation, as the reference's contraction)."""
    table = params["table"]
    if quantize and method == "quartet":
        return quartet_linear(x, table.t(), seed, qcfg)
    return x.to(torch.float32) @ table.to(torch.float32).t()


def seed_fold(seed, salt: int):
    """Per-site seed derivation in uint32 arithmetic (seed · 1000003 + salt),
    of a Python int or, elementwise, of an int64 tensor of uint32 values."""
    return (seed * 1000003 + salt) & 0xFFFFFFFF
