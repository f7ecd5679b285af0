"""GQA attention: the blocked plain-PyTorch path and the paged serving path.

Port of ``repro.models.attention`` for the dense family.  A forward
without a cache (training, teacher-forced scoring) runs
:func:`blocked_attention`, plain PyTorch that autograd differentiates; a
forward whose cache is a :class:`~repro_torch.kernels.paged_attention.
PagedKV` quantize-scatters the new tokens' K/V into the pool and attends
over it with the paged-attention kernel (:func:`_paged_decode`).  The flash backend and the cached dense /
cross-attention variants arrive with later slices.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention import PagedKV, paged_attention, scatter_token
from repro_torch.models import layers as L

NEG_INF = -1e30


def init_attention(cfg: ModelConfig, dtype, generator, device) -> dict:
    d, hd = cfg.d_model, cfg.head_dim_
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    args = (dtype, generator, device, cfg.use_bias)
    p = {
        "wq": L.init_dense(d, nq * hd, *args),
        "wk": L.init_dense(d, nkv * hd, *args),
        "wv": L.init_dense(d, nkv * hd, *args),
        "wo": L.init_dense(nq * hd, d, *args),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.init_rmsnorm(hd, dtype, device)
        p["k_norm"] = L.init_rmsnorm(hd, dtype, device)
    return p


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_positions: torch.Tensor, causal: bool,
                      kv_chunk: int) -> torch.Tensor:
    """Online-softmax GQA attention over KV chunks (f32 state).

    q [B, S, Hq, hd], k/v [B, T, Hkv, hd], q_positions [B, S] absolute
    positions (per row); key t sits at position t."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    ck = min(kv_chunk, T)
    qf = (q.to(torch.float32) * scale).reshape(B, S, Hkv, group, hd)
    m = torch.full((B, S, Hkv, group), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, S, Hkv, group, hd), dtype=torch.float32, device=q.device)
    for t0 in range(0, T, ck):
        kj = k[:, t0:t0 + ck].to(torch.float32)
        vj = v[:, t0:t0 + ck].to(torch.float32)
        s = torch.einsum("bskgd,bckd->bskgc", qf, kj)
        if causal:
            kv_pos = torch.arange(t0, t0 + kj.shape[1], device=q.device)
            mask = q_positions[:, :, None, None, None] >= kv_pos
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bskgc,bckd->bskgd", p, vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, S, Hq, hd).to(q.dtype)


def dispatch_attention(q, k, v, q_positions, *, causal: bool, cfg: ModelConfig) -> torch.Tensor:
    """Dense (cache-free) attention call site.  ``"paged"`` concerns
    attention over the pool only, so dense call sites run ``"blocked"``."""
    if cfg.attn_backend not in ("blocked", "paged"):
        raise NotImplementedError(f"attention backend {cfg.attn_backend!r} is not ported yet")
    return blocked_attention(q, k, v, q_positions, causal=causal, kv_chunk=cfg.attn_kv_chunk)


def _paged_decode(params: dict, x: torch.Tensor, q: torch.Tensor, positions: torch.Tensor,
                  seed: int, cfg: ModelConfig, paged: PagedKV, method: str):
    """Decode / batched prefill directly over the pool: quantize-scatter the
    S new tokens' K/V (``positions[b, s]`` picks page and offset), then run
    the paged-attention kernel with per-row causal bounds.  Padding tokens
    are positioned on a scratch page by the caller, so no mask is needed."""
    hd, nkv = cfg.head_dim_, cfg.num_kv_heads
    qc = cfg.quartet
    k = _split_heads(L.dense(params["wk"], x, L.seed_fold(seed, 2), qc, method), nkv, hd)
    v = _split_heads(L.dense(params["wv"], x, L.seed_fold(seed, 3), qc, method), nkv, hd)
    if cfg.qk_norm:
        k = L.rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if cfg.pos_embed == "rope":
        k = L.apply_rope(k, positions, cfg.rope_theta)
    ps = next(iter(paged.pool.values())).shape[1]
    B = x.shape[0]
    bidx = torch.arange(B, device=x.device)[:, None]
    page_ids = paged.tables[bidx, (positions // ps).long()]
    scatter_token(paged.pool, page_ids, positions % ps, k, v)
    lengths = (positions[:, 0] + 1).to(torch.int32)
    out = paged_attention(q.contiguous(), paged.pool, paged.tables, lengths)
    return out


def attention(params: dict, x: torch.Tensor, positions: torch.Tensor, seed: int,
              cfg: ModelConfig, *, causal: bool = True, kv_cache: PagedKV | None = None,
              method: str = "quartet"):
    """x [B, S, D], positions [B, S] → (out [B, S, D], kv_cache).  With a
    ``PagedKV`` cache its pool is updated in place."""
    hd, nq, nkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
    qc = cfg.quartet
    q = _split_heads(L.dense(params["wq"], x, L.seed_fold(seed, 1), qc, method), nq, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(params["q_norm"], q, cfg.norm_eps)
    if cfg.pos_embed == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)

    if kv_cache is not None:
        out = _paged_decode(params, x, q, positions, seed, cfg, kv_cache, method)
    else:
        k = _split_heads(L.dense(params["wk"], x, L.seed_fold(seed, 2), qc, method), nkv, hd)
        v = _split_heads(L.dense(params["wv"], x, L.seed_fold(seed, 3), qc, method), nkv, hd)
        if cfg.qk_norm:
            k = L.rmsnorm(params["k_norm"], k, cfg.norm_eps)
        if cfg.pos_embed == "rope":
            k = L.apply_rope(k, positions, cfg.rope_theta)
        out = dispatch_attention(q, k, v, positions, causal=causal, cfg=cfg)
    out = out.reshape(*x.shape[:-1], nq * hd)
    return L.dense(params["wo"], out, L.seed_fold(seed, 4), qc, method), kv_cache
