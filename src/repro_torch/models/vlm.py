"""Llama-3.2-Vision-style VLM backbone: a dense decoder with a gated
cross-attention block to image patch embeddings before every
``cross_attn_every`` dense layers (40 layers, every 5: 8 cross blocks).

Port of ``repro.models.vlm``.  The vision frontend is a stub:
``image_embeds`` [B, n_img, D] arrive precomputed.  A cross block's two
residuals are tanh-gated by f32 scalars initialised to zero (as in Llama
3.2 and Flamingo), so an initialised model's cross path adds nothing until
the gates are set.  Structure: 8 super-blocks of [cross block → 5 dense
blocks].  Seeds follow the reference's, mod 2³²: cross block ``sp`` takes
``seed + sp·7919``; layer ``i`` of group ``sp`` takes ``seed +
sp·((per·LAYER_SEED_STRIDE) mod 2³²) + i·LAYER_SEED_STRIDE``.  A forward
builds the rope table of its positions once.

The decode cache is ``{"self": (K, V) [L, B, T, Hkv, hd], "cross": (K, V)
[n_super, B, n_img, Hkv, hd]}``, updated in place.  With ``image_embeds``
and a cache, each cross block recomputes its K/V from the image and writes
them into the cache (prefill); without ``image_embeds`` it reads the
cached cross-KV (decode), and then, as in the reference, its queries are
rotated (attention ropes q iff it has no ``kv_source``).

When training (grad enabled, no cache) with ``cfg.remat`` the remat is the
reference's hierarchical one: each super-block runs under
``torch.utils.checkpoint``, and inside it each dense layer again, so the
backward keeps a super-block's input and, while it runs that super-block,
its layers' inputs.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import constrain_layer_params, constrain_tokens
from repro_torch.models import layers as L
from repro_torch.models.attention import attention, init_attention
from repro_torch.models.transformer import (
    LAYER_SEED_STRIDE,
    _stacked_init,
    anchored,
    dense_block,
    init_dense_block,
    init_mlp,
    layer_slice,
    lm_head_apply,
    mlp,
)

_U32 = 0xFFFFFFFF


def split_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(super-blocks, dense layers a super-block)."""
    n_super = cfg.num_layers // cfg.cross_attn_every
    if n_super * cfg.cross_attn_every != cfg.num_layers:
        raise ValueError(f"num_layers {cfg.num_layers} must divide by cross_attn_every "
                         f"{cfg.cross_attn_every}")
    return n_super, cfg.cross_attn_every


def init_cross_block(cfg: ModelConfig, dtype, generator, device) -> dict:
    return {
        "attn_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
        "attn": init_attention(cfg, dtype, generator, device),
        "mlp_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
        "mlp": init_mlp(cfg, dtype, generator, device),
        "gate_attn": torch.zeros((), dtype=torch.float32, device=device),
        "gate_mlp": torch.zeros((), dtype=torch.float32, device=device),
    }


def cross_block(params: dict, x: torch.Tensor, image_embeds, positions: torch.Tensor,
                seed: int, cfg: ModelConfig, cache, method: str, rope=None) -> torch.Tensor:
    """One gated cross block; ``cache`` is the block's cross (k, v) or None
    (a cache-free forward)."""
    h, _ = attention(params["attn"], L.rmsnorm(params["attn_norm"], x, cfg.norm_eps),
                     positions, L.seed_fold(seed, 100), cfg, causal=False,
                     kv_source=image_embeds, kv_cache=cache,
                     write_kv=cache is not None and image_embeds is not None, method=method,
                     rope=rope)
    x = x + torch.tanh(params["gate_attn"]).to(x.dtype) * h
    h = mlp(params["mlp"], L.rmsnorm(params["mlp_norm"], x, cfg.norm_eps),
            L.seed_fold(seed, 200), cfg, method)
    return x + torch.tanh(params["gate_mlp"]).to(x.dtype) * h


def encode_cross_kv(params: dict, image_embeds: torch.Tensor, cfg: ModelConfig, seed: int,
                    method: str = "quartet"):
    """Every cross block's (k, v) over the image tokens, computed once:
    [B, n_img, D] → stacked (k, v) [n_super, B, n_img, Hkv, hd].

    The same values a prefill with ``image_embeds`` writes into its cross
    cache: each block's seed (``seed + sp·7919`` then fold 100), the wk/wv
    folds (2/3), the optional k-norm, no rope.  The serving engine runs this
    at admission to fill the pool's cross-KV plane that decode steps read."""
    hd, nkv, qc = cfg.head_dim_, cfg.num_kv_heads, cfg.quartet
    n_super, _ = split_counts(cfg)
    ks, vs = [], []
    for sp in range(n_super):
        ca = layer_slice(params["cross_layers"], sp)["attn"]
        sa = L.seed_fold((seed + sp * 7919) & _U32, 100)
        k = L.dense(ca["wk"], image_embeds, L.seed_fold(sa, 2), qc, method)
        v = L.dense(ca["wv"], image_embeds, L.seed_fold(sa, 3), qc, method)
        k = k.reshape(*k.shape[:-1], nkv, hd)
        if cfg.qk_norm:
            k = L.rmsnorm(ca["k_norm"], k, cfg.norm_eps)
        ks.append(k)
        vs.append(v.reshape(*v.shape[:-1], nkv, hd))
    return torch.stack(ks), torch.stack(vs)


def init_vlm_lm(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random weights with the reference's tree paths and init laws (not its
    draws): ``layers`` (dense blocks) stacked [L, ...], ``cross_layers``
    stacked [n_super, ...] with zero gates, an untied head."""
    dtype = getattr(torch, cfg.dtype)
    n_super, _ = split_counts(cfg)
    params = {
        "embed": L.init_embedding(cfg.vocab_size, cfg.d_model, dtype, generator, device),
        "layers": _stacked_init(lambda: init_dense_block(cfg, dtype, generator, device),
                                cfg.num_layers),
        "cross_layers": _stacked_init(lambda: init_cross_block(cfg, dtype, generator, device),
                                      n_super),
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_dense(cfg.d_model, cfg.vocab_size, dtype, generator, device)
    return params


def vlm_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, seed: int, *,
                positions: torch.Tensor | None = None,
                image_embeds: torch.Tensor | None = None, caches=None,
                cache_index: torch.Tensor | None = None, method: str = "quartet",
                features_only: bool = False):
    """tokens [B, S] → (logits [B, S, V] f32, or features [B, S, D],
    caches); ``caches`` is :func:`vlm_cache_spec`'s tree or None."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    x = constrain_tokens(L.embed(params["embed"], tokens))
    n_super, per = split_counts(cfg)
    block = anchored(dense_block)
    rope = L.rope_table(positions, cfg.head_dim_, cfg.rope_theta)  # one table, every layer
    remat = cfg.remat and caches is None and torch.is_grad_enabled()

    def dense(x, j, s):
        if remat:
            return checkpoint(block, layer_slice(params["layers"], j), x, positions, s,
                              cfg, None, method, None, None, rope, use_reentrant=False)[0]
        cache = None if caches is None else (caches["self"][0][j], caches["self"][1][j])
        return block(layer_slice(params["layers"], j), x, positions, s, cfg, cache,
                     method, cache_index, None, rope)[0]

    def super_block(x, sp):
        cache = None if caches is None else (caches["cross"][0][sp], caches["cross"][1][sp])
        lp = constrain_layer_params(layer_slice(params["cross_layers"], sp), "cross_layers")
        x = cross_block(lp, x, image_embeds, positions, (seed + sp * 7919) & _U32, cfg, cache,
                        method, rope)
        seed0 = (seed + sp * ((per * LAYER_SEED_STRIDE) % 2**32)) & _U32
        for i in range(per):
            x = dense(x, sp * per + i, (seed0 + i * LAYER_SEED_STRIDE) & _U32)
        return x

    for sp in range(n_super):
        x = checkpoint(super_block, x, sp, use_reentrant=False) if remat else super_block(x, sp)
    out = x if features_only else lm_head_apply(params, x, cfg, seed, method)
    return out, caches


def vlm_cache_spec(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """``{"self": ((shape, dtype),) * 2, "cross": ((shape, dtype),) * 2}``:
    K and V [L, B, max_len, Hkv, hd] and [n_super, B, num_image_tokens, Hkv,
    hd] in the compute dtype."""
    n_super, _ = split_counts(cfg)
    dtype = getattr(torch, cfg.dtype)
    hkv = (cfg.num_kv_heads, cfg.head_dim_)
    self_kv = ((cfg.num_layers, batch, max_len, *hkv), dtype)
    cross = ((n_super, batch, cfg.num_image_tokens, *hkv), dtype)
    return {"self": (self_kv, self_kv), "cross": (cross, cross)}
