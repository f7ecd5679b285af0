"""Decoder-only LM (Llama/Qwen/StarCoder2 style): GQA + SwiGLU or GELU MLP
(or a MoE layer, ``models.moe``; or a Mamba1 block, ``models.ssm``),
RMSNorm, Quartet linears, a Python loop over stacked [L, ...] layer
parameters.

Port of ``repro.models.transformer`` for the dense, MoE and SSM families.
A forward builds the rope table of its positions once
(``layers.rope_table``) and hands it to every layer's attention.  With a
:class:`PagedKV` cache (the pool's leaves carry the leading [L] axis; the
page table is shared by every layer) each layer quantize-scatters its new
K/V into its pool slice in place and attends with the paged kernel.  With
dense caches ``(K, V)`` [L, B, T, Hkv, hd] and ``cache_index`` [B], each
layer writes its new K/V into its slice in place and attends over it.  When
training (grad enabled, no cache) with ``cfg.remat``, each layer runs under
``torch.utils.checkpoint``: only its input is kept, and the backward
recomputes its forward, as the reference checkpoints its layer-scan
body.  The per-layer seeds are deterministic, so the recompute
quantizes to the same bits.  The reference's anchors sit where its layer
scan has them (``distributed.context``): a layer's parameters gathered at
the top of the checkpointed body (so the backward's recompute gathers
again, as FSDP does), the activations' rows checked after the embedding
and after each layer, the logits after the head; outside a train step's
plan they return their input.  Every block returns ``(x, aux)``: a MoE
layer's router loss (an f32 scalar), a dense layer's 0.0;
``lm_forward(..., return_aux=True)`` (the train step) also returns their
f32 sum in layer order, as the reference's layer scan carries it; under a
data-parallel plan each layer's is the rank's share of one device's
(``models.moe``), so the sum is too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import (constrain_layer_params, constrain_logits,
                                             constrain_tokens)
from repro_torch.kernels.paged_attention import PagedKV
from repro_torch.models import layers as L
from repro_torch.models.attention import attention, init_attention

LAYER_SEED_STRIDE = 2654435761  # Knuth multiplicative hash increment


def init_mlp(cfg: ModelConfig, dtype, generator, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    args = (dtype, generator, device, cfg.use_bias)
    if cfg.mlp == "swiglu":
        return {"gate": L.init_dense(d, f, *args), "up": L.init_dense(d, f, *args),
                "down": L.init_dense(f, d, *args)}
    if cfg.mlp != "gelu":
        raise ValueError(f"mlp must be 'swiglu' or 'gelu', got {cfg.mlp!r}")
    return {"up": L.init_dense(d, f, *args), "down": L.init_dense(f, d, *args)}


def mlp(params: dict, x: torch.Tensor, seed: int, cfg: ModelConfig,
        method: str = "quartet") -> torch.Tensor:
    """SwiGLU, or up → GELU → down (``jax.nn.gelu``'s default, the tanh form,
    in f32), with biases where the config has them."""
    qc = cfg.quartet
    u = L.dense(params["up"], x, L.seed_fold(seed, 12), qc, method)
    if cfg.mlp == "swiglu":
        g = L.dense(params["gate"], x, L.seed_fold(seed, 11), qc, method)
        h = Fn.silu(g.to(torch.float32)).to(x.dtype) * u
    else:
        h = Fn.gelu(u.to(torch.float32), approximate="tanh").to(x.dtype)
    return L.dense(params["down"], h, L.seed_fold(seed, 13), qc, method)


def init_dense_block(cfg: ModelConfig, dtype, generator, device) -> dict:
    init_norm, _ = L.make_norm(cfg.norm)
    return {
        "attn_norm": init_norm(cfg.d_model, dtype, device),
        "attn": init_attention(cfg, dtype, generator, device),
        "mlp_norm": init_norm(cfg.d_model, dtype, device),
        "mlp": init_mlp(cfg, dtype, generator, device),
    }


def dense_block(params: dict, x: torch.Tensor, positions: torch.Tensor, seed: int,
                cfg: ModelConfig, cache, method: str,
                cache_index: torch.Tensor | None = None, token_valid=None, rope=None):
    """→ (x [B, S, D], 0.0: a dense layer has no router loss).  ``rope`` is
    the forward's rope table (``layers.rope_table``)."""
    # token_valid is the MoE block's (padding lanes must not compete for
    # expert capacity); a dense block has no cross-token competition
    _, norm = L.make_norm(cfg.norm)
    h, _ = attention(params["attn"], norm(params["attn_norm"], x, cfg.norm_eps),
                     positions, L.seed_fold(seed, 100), cfg, causal=cfg.is_causal_lm,
                     kv_cache=cache, cache_index=cache_index, method=method, rope=rope)
    x = x + h
    return x + mlp(params["mlp"], norm(params["mlp_norm"], x, cfg.norm_eps),
                   L.seed_fold(seed, 200), cfg, method), 0.0


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


def anchored(block, path: str = "layers"):
    """``block`` under the reference's layer-scan anchors: its parameters
    (a slice of the stack at ``path``) gathered on entry, its output rows
    checked on exit."""
    def run(params, x, *args):
        x, aux = block(constrain_layer_params(params, path), x, *args)
        return constrain_tokens(x), aux

    return run


def _blocks(cfg: ModelConfig):
    """The family's (init, apply) pair."""
    if cfg.family == "dense":
        return init_dense_block, dense_block
    if cfg.family == "moe":
        from repro_torch.models.moe import init_moe_block, moe_block

        return init_moe_block, moe_block
    if cfg.family == "ssm":
        from repro_torch.models.ssm import init_mamba1_block, mamba1_block

        return init_mamba1_block, mamba1_block
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
        "final_norm": L.make_norm(cfg.norm)[0](cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_dense(cfg.d_model, cfg.vocab_size, dtype, generator, device)
    return params


def lm_head_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, seed: int,
                  method: str = "quartet") -> torch.Tensor:
    """Final norm + unembedding → f32 logits."""
    x = L.make_norm(cfg.norm)[1](params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = L.unembed(params["embed"], x, L.seed_fold(seed, 999), cfg.quartet,
                           cfg.quantize_lm_head, method)
    else:
        logits = L.dense(params["lm_head"], x, L.seed_fold(seed, 999), cfg.quartet,
                         method if cfg.quantize_lm_head else "bf16", head=True)
    logits = constrain_logits(logits.to(torch.float32))
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def lm_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, seed: int, *,
               positions: torch.Tensor | None = None, caches=None,
               cache_index: torch.Tensor | None = None, method: str = "quartet",
               features_only: bool = False, token_valid: torch.Tensor | None = None,
               return_aux: bool = False):
    """tokens [B, S] → (logits [B, S, V] f32, or features [B, S, D], caches),
    and with ``return_aux`` also the aux loss: the layers' router losses
    summed in f32 in layer order (exactly 0 for a dense model).

    ``caches`` is a :class:`PagedKV` over the whole [L, ...] pool, dense
    ``(K, V)`` [L, B, T, Hkv, hd] written at ``cache_index`` [B], an SSM's
    ``(conv, h)`` [L, B, K-1, Di] / [L, B, Di, N] (each updated in place),
    or None for a cache-free causal forward.
    ``token_valid`` [B, S] bool marks the lanes that carry real tokens (the
    MoE block keeps the others out of expert capacity)."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    x = L.embed(params["embed"], tokens, getattr(torch, cfg.dtype))
    x = constrain_tokens(x)
    if cfg.pos_embed == "absolute":
        x = L.add_absolute_positions(x, positions)
    block = anchored(_blocks(cfg)[1])
    # the rope table depends on the positions alone: built once, read by
    # every layer's attention (an SSM has none)
    rope = (L.rope_table(positions, cfg.head_dim_, cfg.rope_theta)
            if cfg.family in ("dense", "moe") and cfg.pos_embed == "rope" else None)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device) if return_aux else None
    for i in range(cfg.num_layers):
        seed_l = (seed + i * LAYER_SEED_STRIDE) & 0xFFFFFFFF
        layer = layer_slice(params["layers"], i)
        if remat:  # the checkpoint carries the layer's aux out with x
            x, aux_l = checkpoint(block, layer, x, positions, seed_l, cfg, None, method, None,
                                  token_valid, rope, use_reentrant=False)
        else:
            if caches is None:
                cache = None
            elif isinstance(caches, PagedKV):
                cache = PagedKV(layer_slice(caches.pool, i), caches.tables)
            else:
                cache = (caches[0][i], caches[1][i])
            x, aux_l = block(layer, x, positions, seed_l, cfg, cache, method, cache_index,
                             token_valid, rope)
        if return_aux:
            aux = aux + aux_l
    out = x if features_only else lm_head_apply(params, x, cfg, seed, method)
    return (out, caches, aux) if return_aux else (out, caches)
