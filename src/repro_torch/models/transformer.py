"""Decoder-only LM (Llama/Qwen style): GQA + SwiGLU MLP (or a MoE layer,
``models.moe``), RMSNorm, Quartet linears, a Python loop over stacked
[L, ...] layer parameters.

Port of ``repro.models.transformer`` for the dense and MoE families.  With a
:class:`PagedKV` cache (the pool's leaves carry the leading [L] axis; the
page table is shared by every layer) each layer quantize-scatters its new
K/V into its pool slice in place and attends with the paged kernel.  With
dense caches ``(K, V)`` [L, B, T, Hkv, hd] and ``cache_index`` [B], each
layer writes its new K/V into its slice in place and attends over it.  When
training (grad enabled, no cache) with ``cfg.remat``, each layer runs under
``torch.utils.checkpoint``: only its input is kept, and the backward
recomputes its forward, as the reference checkpoints its layer-scan
body.  The per-layer seeds are deterministic, so the recompute
quantizes to the same bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention import PagedKV
from repro_torch.models import layers as L
from repro_torch.models.attention import attention, init_attention

LAYER_SEED_STRIDE = 2654435761  # Knuth multiplicative hash increment


def init_mlp(cfg: ModelConfig, dtype, generator, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    args = (dtype, generator, device, cfg.use_bias)
    if cfg.mlp != "swiglu":
        raise NotImplementedError(f"mlp {cfg.mlp!r} is not ported yet")
    return {"gate": L.init_dense(d, f, *args), "up": L.init_dense(d, f, *args),
            "down": L.init_dense(f, d, *args)}


def mlp(params: dict, x: torch.Tensor, seed: int, cfg: ModelConfig,
        method: str = "quartet") -> torch.Tensor:
    qc = cfg.quartet
    g = L.dense(params["gate"], x, L.seed_fold(seed, 11), qc, method)
    u = L.dense(params["up"], x, L.seed_fold(seed, 12), qc, method)
    h = Fn.silu(g.to(torch.float32)).to(x.dtype) * u
    return L.dense(params["down"], h, L.seed_fold(seed, 13), qc, method)


def init_dense_block(cfg: ModelConfig, dtype, generator, device) -> dict:
    return {
        "attn_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
        "attn": init_attention(cfg, dtype, generator, device),
        "mlp_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
        "mlp": init_mlp(cfg, dtype, generator, device),
    }


def dense_block(params: dict, x: torch.Tensor, positions: torch.Tensor, seed: int,
                cfg: ModelConfig, cache, method: str,
                cache_index: torch.Tensor | None = None, token_valid=None) -> torch.Tensor:
    # token_valid is the MoE block's (padding lanes must not compete for
    # expert capacity); a dense block has no cross-token competition
    h, _ = attention(params["attn"], L.rmsnorm(params["attn_norm"], x, cfg.norm_eps),
                     positions, L.seed_fold(seed, 100), cfg, causal=cfg.is_causal_lm,
                     kv_cache=cache, cache_index=cache_index, method=method)
    x = x + h
    return x + mlp(params["mlp"], L.rmsnorm(params["mlp_norm"], x, cfg.norm_eps),
                   L.seed_fold(seed, 200), cfg, method)


def _stacked_init(block_init, n: int) -> dict:
    """n draws of ``block_init()`` (in order) → one dict with [n, ...]
    leaves.  The stacked leaves are allocated once and each layer is copied
    in as it is drawn, so a full-width MoE stack never exists twice."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)

    def put(dst, src, i):
        if isinstance(src, dict):
            for k in src:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    out = None
    for i in range(n):
        layer = block_init()
        out = alloc(layer) if out is None else out
        put(out, layer, i)
    return out


def _blocks(cfg: ModelConfig):
    """The family's (init, apply) pair."""
    if cfg.family == "dense":
        return init_dense_block, dense_block
    if cfg.family == "moe":
        from repro_torch.models.moe import init_moe_block, moe_block

        return init_moe_block, moe_block
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet")


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked [L, ...] param (or pool) tree, as views."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def init_lm(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random weights with the reference's tree paths and init laws (the
    draws differ from the reference's: torch and jax generators differ)."""
    dtype = getattr(torch, cfg.dtype)
    block_init, _ = _blocks(cfg)
    params = {
        "embed": L.init_embedding(cfg.vocab_size, cfg.d_model, dtype, generator, device),
        "layers": _stacked_init(lambda: block_init(cfg, dtype, generator, device),
                                cfg.num_layers),
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_dense(cfg.d_model, cfg.vocab_size, dtype, generator, device)
    return params


def lm_head_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, seed: int,
                  method: str = "quartet") -> torch.Tensor:
    """Final norm + unembedding → f32 logits."""
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = L.unembed(params["embed"], x, L.seed_fold(seed, 999), cfg.quartet,
                           cfg.quantize_lm_head, method)
    else:
        logits = L.dense(params["lm_head"], x, L.seed_fold(seed, 999), cfg.quartet,
                         method if cfg.quantize_lm_head else "bf16")
    logits = logits.to(torch.float32)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def lm_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, seed: int, *,
               positions: torch.Tensor | None = None, caches=None,
               cache_index: torch.Tensor | None = None, method: str = "quartet",
               features_only: bool = False, token_valid: torch.Tensor | None = None):
    """tokens [B, S] → (logits [B, S, V] f32, or features [B, S, D], caches).

    ``caches`` is a :class:`PagedKV` over the whole [L, ...] pool, dense
    ``(K, V)`` [L, B, T, Hkv, hd] written at ``cache_index`` [B] (both
    updated in place), or None for a cache-free causal forward.
    ``token_valid`` [B, S] bool marks the lanes that carry real tokens (the
    MoE block keeps the others out of expert capacity).  The MoE block's aux
    loss belongs to training, which is not ported for MoE (ROADMAP A5b), so
    it is not returned."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    if cfg.pos_embed != "rope":
        raise NotImplementedError(f"pos_embed {cfg.pos_embed!r} is not ported yet")
    x = L.embed(params["embed"], tokens)
    _, block = _blocks(cfg)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
        seed_l = (seed + i * LAYER_SEED_STRIDE) & 0xFFFFFFFF
        layer = layer_slice(params["layers"], i)
        if remat:
            x = checkpoint(block, layer, x, positions, seed_l, cfg, None, method, None,
                           token_valid, use_reentrant=False)
            continue
        if caches is None:
            cache = None
        elif isinstance(caches, PagedKV):
            cache = PagedKV(layer_slice(caches.pool, i), caches.tables)
        else:
            cache = (caches[0][i], caches[1][i])
        x = block(layer, x, positions, seed_l, cfg, cache, method, cache_index, token_valid)
    if features_only:
        return x, caches
    return lm_head_apply(params, x, cfg, seed, method), caches
