"""Zamba2-style hybrid: a stack of Mamba2 blocks with a *shared* attention
block (one parameter set, reused) applied every ``attn_every`` layers.

Port of ``repro.models.hybrid``.  Structure (L = 81, attn_every = 6): 13
super-blocks of [shared attention → 6 Mamba2 layers], then a 3-layer Mamba2
tail.  The shared block's 13 applications share its weights but each has
its own KV cache.  A forward builds the rope table of its positions once
and hands it to every application.  Seeds follow the reference's, mod 2³²:
application ``sp`` takes ``seed + sp·7919``; layer ``i`` of group ``sp``
takes ``seed + sp·((per·LAYER_SEED_STRIDE) mod 2³²) + i·LAYER_SEED_STRIDE``;
tail layer ``i`` takes ``seed_fold(seed, 4242) + i·LAYER_SEED_STRIDE``.

The decode cache is a tree, ``{"attn": (K, V) [n_super, B, T, Hkv, hd],
"mamba": (conv [L, B, K-1, Di + 2N], h [L, B, nh, hd, N])}``, updated in
place.  When training (grad enabled, no cache) with ``cfg.remat`` the
remat is the reference's hierarchical one: each super-block (the shared
block's application and its group of Mamba2 layers) runs under
``torch.utils.checkpoint``, and inside it each Mamba2 layer again, as does
each tail layer.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import constrain_tokens
from repro_torch.models import layers as L
from repro_torch.models.ssm import init_mamba2_block, mamba2_block, mamba2_cache_spec
from repro_torch.models.transformer import (
    LAYER_SEED_STRIDE,
    _stacked_init,
    anchored,
    dense_block,
    init_dense_block,
    layer_slice,
    lm_head_apply,
)

_U32 = 0xFFFFFFFF


def split_counts(cfg: ModelConfig) -> tuple[int, int, int]:
    """(super-blocks, Mamba2 layers a super-block, tail layers)."""
    n_super = cfg.num_layers // cfg.attn_every
    return n_super, cfg.attn_every, cfg.num_layers - n_super * cfg.attn_every


def init_hybrid_lm(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random weights with the reference's tree paths and init laws (not
    its draws): ``mamba_layers`` stacked [L, ...], one unstacked
    ``shared_attn`` dense block."""
    dtype = getattr(torch, cfg.dtype)
    params = {
        "embed": L.init_embedding(cfg.vocab_size, cfg.d_model, dtype, generator, device),
        "mamba_layers": _stacked_init(lambda: init_mamba2_block(cfg, dtype, generator, device),
                                      cfg.num_layers),
        "shared_attn": init_dense_block(cfg, dtype, generator, device),
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_dense(cfg.d_model, cfg.vocab_size, dtype, generator, device)
    return params


def hybrid_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, seed: int, *,
                   positions: torch.Tensor | None = None, caches=None,
                   cache_index: torch.Tensor | None = None, method: str = "quartet",
                   features_only: bool = False, token_valid=None, return_aux: bool = False):
    """tokens [B, S] → (logits [B, S, V] f32, or features [B, S, D], caches),
    and with ``return_aux`` also an f32 0 (no router).  ``caches`` is the
    tree of :func:`hybrid_cache_spec`'s shapes, written at ``cache_index``
    [B] and updated in place, or None.  ``token_valid`` is the MoE block's;
    a hybrid has none."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    x = constrain_tokens(L.embed(params["embed"], tokens))
    n_super, per, tail = split_counts(cfg)
    block = anchored(mamba2_block, "mamba_layers")
    rope = L.rope_table(positions, cfg.head_dim_, cfg.rope_theta)  # one table, 13 readers
    remat = cfg.remat and caches is None and torch.is_grad_enabled()

    def mamba(x, j, s):
        p = layer_slice(params["mamba_layers"], j)
        if remat:
            return checkpoint(block, p, x, positions, s, cfg, None, method, None, None,
                              rope, use_reentrant=False)[0]
        cache = None if caches is None else (caches["mamba"][0][j], caches["mamba"][1][j])
        return block(p, x, positions, s, cfg, cache, method, cache_index, None, rope)[0]

    def super_block(x, sp):
        a_cache = None if caches is None else (caches["attn"][0][sp], caches["attn"][1][sp])
        x = dense_block(params["shared_attn"], x, positions, (seed + sp * 7919) & _U32, cfg,
                        a_cache, method, cache_index, None, rope)[0]
        seed0 = (seed + sp * ((per * LAYER_SEED_STRIDE) % 2**32)) & _U32
        for i in range(per):
            x = mamba(x, sp * per + i, (seed0 + i * LAYER_SEED_STRIDE) & _U32)
        return x

    for sp in range(n_super):
        x = checkpoint(super_block, x, sp, use_reentrant=False) if remat else super_block(x, sp)
    seed0 = L.seed_fold(seed, 4242)
    for i in range(tail):
        x = mamba(x, n_super * per + i, (seed0 + i * LAYER_SEED_STRIDE) & _U32)
    out = x if features_only else lm_head_apply(params, x, cfg, seed, method)
    if return_aux:
        return out, caches, torch.zeros((), dtype=torch.float32, device=x.device)
    return out, caches


def hybrid_cache_spec(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """``{"attn": ((shape, dtype),) * 2, "mamba": (conv, h)}``, each stacked:
    K and V [n_super, B, max_len, Hkv, hd] in the compute dtype, conv [L, B,
    K-1, Di + 2N] in the compute dtype, h [L, B, nh, hd, N] in f32."""
    n_super, _, _ = split_counts(cfg)
    kv = ((n_super, batch, max_len, cfg.num_kv_heads, cfg.head_dim_), getattr(torch, cfg.dtype))
    return {"attn": (kv, kv),
            "mamba": tuple(((cfg.num_layers, *shape), dtype)
                           for shape, dtype in mamba2_cache_spec(cfg, batch))}
