"""Whisper-style encoder-decoder backbone.

Port of ``repro.models.encdec``.  The conv audio frontend is a stub:
``source_embeds`` arrive as precomputed frame embeddings [B, T_src, D].
The encoder is a stack of bidirectional self-attention blocks; each
decoder layer is causal self-attention, cross attention to the encoder's
output and an MLP.  Whisper takes LayerNorm and absolute (sinusoidal)
positions, both from the config.  Seeds follow the reference's, mod 2³²:
encoder layer ``i`` takes ``seed_fold(seed, 7) + i·LAYER_SEED_STRIDE``,
decoder layer ``i`` takes ``seed + i·LAYER_SEED_STRIDE`` (its self
attention folded with 100, its cross attention with 150, its MLP with 200).

The decode cache is ``{"self": (K, V) [L, B, T, Hkv, hd], "cross": (K, V)
[L, B, T_src, Hkv, hd]}``, updated in place.  When training (grad enabled,
no cache) with ``cfg.remat`` each encoder and decoder layer runs under
``torch.utils.checkpoint``, as the reference checkpoints both layer scans.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import (constrain_layer_params, constrain_logits,
                                             constrain_tokens)
from repro_torch.models import layers as L
from repro_torch.models.attention import attention, init_attention
from repro_torch.models.transformer import (
    LAYER_SEED_STRIDE,
    _stacked_init,
    init_dense_block,
    init_mlp,
    layer_slice,
    mlp,
)

_U32 = 0xFFFFFFFF


def init_encdec_lm(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random weights with the reference's tree paths and init laws (not its
    draws): ``encoder.layers`` (dense blocks) and ``decoder.layers`` stacked
    [L, ...], each stack with its ``final_norm``; the embedding is tied."""
    dtype = getattr(torch, cfg.dtype)
    init_norm, _ = L.make_norm(cfg.norm)

    def dec_block():
        return {
            "self_norm": init_norm(cfg.d_model, dtype, device),
            "self_attn": init_attention(cfg, dtype, generator, device),
            "cross_norm": init_norm(cfg.d_model, dtype, device),
            "cross_attn": init_attention(cfg, dtype, generator, device),
            "mlp_norm": init_norm(cfg.d_model, dtype, device),
            "mlp": init_mlp(cfg, dtype, generator, device),
        }

    return {
        "embed": L.init_embedding(cfg.vocab_size, cfg.d_model, dtype, generator, device),
        "encoder": {
            "layers": _stacked_init(lambda: init_dense_block(cfg, dtype, generator, device),
                                    cfg.encoder_layers),
            "final_norm": init_norm(cfg.d_model, dtype, device),
        },
        "decoder": {
            "layers": _stacked_init(dec_block, cfg.num_layers),
            "final_norm": init_norm(cfg.d_model, dtype, device),
        },
    }


def _encoder_layer(lp: dict, x: torch.Tensor, pos: torch.Tensor, s: int, cfg: ModelConfig,
                   method: str) -> torch.Tensor:
    _, norm = L.make_norm(cfg.norm)
    lp = constrain_layer_params(lp, "encoder/layers")
    h, _ = attention(lp["attn"], norm(lp["attn_norm"], x, cfg.norm_eps), pos,
                     L.seed_fold(s, 100), cfg, causal=False, method=method)
    x = x + h
    return constrain_tokens(x + mlp(lp["mlp"], norm(lp["mlp_norm"], x, cfg.norm_eps),
                                    L.seed_fold(s, 200), cfg, method))


def encode(params: dict, source_embeds: torch.Tensor, cfg: ModelConfig, seed: int,
           method: str = "quartet") -> torch.Tensor:
    """source_embeds [B, T_src, D] → memory [B, T_src, D]: absolute
    positions added, then bidirectional self-attention blocks."""
    _, norm = L.make_norm(cfg.norm)
    B, T, _ = source_embeds.shape
    pos = torch.arange(T, dtype=torch.int32, device=source_embeds.device).expand(B, T)
    x = source_embeds + L.sinusoidal_positions(T, cfg.d_model,
                                               source_embeds.device)[None].to(source_embeds.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.encoder_layers):
        lp = layer_slice(params["encoder"]["layers"], i)
        s = (seed + i * LAYER_SEED_STRIDE) & _U32
        if remat:
            x = checkpoint(_encoder_layer, lp, x, pos, s, cfg, method, use_reentrant=False)
        else:
            x = _encoder_layer(lp, x, pos, s, cfg, method)
    return norm(params["encoder"]["final_norm"], x, cfg.norm_eps)


def encode_cross_kv(params: dict, source_embeds: torch.Tensor, cfg: ModelConfig, seed: int,
                    method: str = "quartet"):
    """Every decoder layer's cross-attention (k, v), computed once from the
    source: [B, T_src, D] → stacked (k, v) [L, B, T_src, Hkv, hd].

    The same values a ``build_cross=True`` forward writes into its cross
    cache: the encoder at ``seed_fold(seed, 7)``, each layer's seed and its
    cross-attention fold (150), the wk/wv folds (2/3) inside attention, the
    optional k-norm, no rope.  The serving engine runs this at admission and
    quantize-scatters the result into the pool's cross-KV plane."""
    memory = encode(params, source_embeds, cfg, L.seed_fold(seed, 7), method)
    hd, nkv, qc = cfg.head_dim_, cfg.num_kv_heads, cfg.quartet
    ks, vs = [], []
    for i in range(cfg.num_layers):
        ca = layer_slice(params["decoder"]["layers"], i)["cross_attn"]
        sc = L.seed_fold((seed + i * LAYER_SEED_STRIDE) & _U32, 150)
        k = L.dense(ca["wk"], memory, L.seed_fold(sc, 2), qc, method)
        v = L.dense(ca["wv"], memory, L.seed_fold(sc, 3), qc, method)
        k = k.reshape(*k.shape[:-1], nkv, hd)
        if cfg.qk_norm:
            k = L.rmsnorm(ca["k_norm"], k, cfg.norm_eps)
        ks.append(k)
        vs.append(v.reshape(*v.shape[:-1], nkv, hd))
    return torch.stack(ks), torch.stack(vs)


def encdec_head(params: dict, x: torch.Tensor, cfg: ModelConfig, seed: int,
                method: str = "quartet") -> torch.Tensor:
    """The decoder's final norm and the tied unembedding → f32 logits."""
    _, norm = L.make_norm(cfg.norm)
    x = norm(params["decoder"]["final_norm"], x, cfg.norm_eps)
    return constrain_logits(L.unembed(params["embed"], x, L.seed_fold(seed, 999), cfg.quartet,
                                      cfg.quantize_lm_head, method).to(torch.float32))


def encdec_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, seed: int, *,
                   positions: torch.Tensor | None = None, memory: torch.Tensor | None = None,
                   source_embeds: torch.Tensor | None = None, caches=None,
                   cache_index: torch.Tensor | None = None, build_cross: bool = False,
                   method: str = "quartet", features_only: bool = False):
    """The decoder, teacher-forced or incremental: tokens [B, S] → (logits
    [B, S, V] f32, or features [B, S, D], caches).

    Without caches, or with ``build_cross``, the encoder runs on
    ``source_embeds`` (unless ``memory`` is given); with ``build_cross`` each
    layer's cross K/V from it is written into ``caches["cross"]``.  With
    caches and no ``build_cross`` the cross attention reads the cached
    cross-KV and the encoder does not run."""
    _, norm = L.make_norm(cfg.norm)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    if memory is None and (caches is None or build_cross):
        if source_embeds is None:
            raise ValueError("the encoder needs memory or source_embeds")
        memory = encode(params, source_embeds, cfg, L.seed_fold(seed, 7), method)
    x = L.add_absolute_positions(constrain_tokens(L.embed(params["embed"], tokens)), positions)

    def layer(lp, x, memory, s, sc, cc):
        lp = constrain_layer_params(lp, "decoder/layers")
        h, _ = attention(lp["self_attn"], norm(lp["self_norm"], x, cfg.norm_eps), positions,
                         L.seed_fold(s, 100), cfg, causal=True, kv_cache=sc,
                         cache_index=cache_index, method=method)
        x = x + h
        h, _ = attention(lp["cross_attn"], norm(lp["cross_norm"], x, cfg.norm_eps), positions,
                         L.seed_fold(s, 150), cfg, causal=False, kv_source=memory,
                         kv_cache=cc, write_kv=build_cross, method=method)
        x = x + h
        return constrain_tokens(x + mlp(lp["mlp"], norm(lp["mlp_norm"], x, cfg.norm_eps),
                                        L.seed_fold(s, 200), cfg, method))

    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
        lp = layer_slice(params["decoder"]["layers"], i)
        s = (seed + i * LAYER_SEED_STRIDE) & _U32
        if remat:
            x = checkpoint(layer, lp, x, memory, s, None, None, use_reentrant=False)
        elif caches is None:
            x = layer(lp, x, memory, s, None, None)
        else:
            x = layer(lp, x, memory, s, (caches["self"][0][i], caches["self"][1][i]),
                      (caches["cross"][0][i], caches["cross"][1][i]))
    out = x if features_only else encdec_head(params, x, cfg, seed, method)
    return out, caches


def encdec_cache_spec(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """``{"self": ((shape, dtype),) * 2, "cross": ((shape, dtype),) * 2}``:
    K and V [L, B, max_len, Hkv, hd] and [L, B, max_source_len, Hkv, hd] in
    the compute dtype."""
    dtype = getattr(torch, cfg.dtype)
    hkv = (cfg.num_kv_heads, cfg.head_dim_)
    self_kv = ((cfg.num_layers, batch, max_len, *hkv), dtype)
    cross = ((cfg.num_layers, batch, cfg.max_source_len, *hkv), dtype)
    return {"self": (self_kv, self_kv), "cross": (cross, cross)}
