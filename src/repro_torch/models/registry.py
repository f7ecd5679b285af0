"""Uniform model API (the dense, MoE and SSM families in this slice).

``build_model(cfg, attn_backend=None)`` → ``Model(cfg, forward, head,
cache_spec)`` with

    forward(params, tokens, seed, *, positions=None, caches=None,
            cache_index=None, method="quartet", features_only=False,
            token_valid=None, return_aux=False)
        -> (logits | features, caches), and with return_aux also the f32
           aux loss (the MoE layers' router losses; 0 for a dense model)
    head(params, features, seed, method="quartet") -> f32 logits
    cache_spec(batch, max_len) -> the decode cache's leaves as
        ((shape, dtype), ...), stacked [L, ...]: dense and MoE (K, V)
        [L, B, max_len, Hkv, hd]; SSM (conv [L, B, K-1, Di], h [L, B, Di, N])

Weights come from ``repro_torch.convert`` (``init_params`` or
``params_from_jax``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import lm_forward, lm_head_apply


class Model(NamedTuple):
    cfg: ModelConfig
    forward: Callable
    head: Callable
    cache_spec: Callable = None


def _cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    if cfg.family == "ssm":
        from repro_torch.models.ssm import mamba1_cache_spec

        spec = mamba1_cache_spec(cfg, batch)
    else:
        shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
        spec = ((shape, getattr(torch, cfg.dtype)),) * 2
    return tuple(((cfg.num_layers, *shape), dtype) for shape, dtype in spec)


def build_model(cfg: ModelConfig, *, attn_backend: str | None = None) -> Model:
    """``attn_backend`` overrides ``cfg.attn_backend`` ("blocked" / "flash" /
    "paged"), so callers pick the attention backend without editing the
    config (evaluation with the flash kernel: ``attn_backend="flash"``)."""
    if attn_backend is not None:
        cfg = dataclasses.replace(cfg, attn_backend=attn_backend)
    if cfg.family not in ("dense", "moe", "ssm"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    if cfg.family == "ssm" and cfg.ssm_variant != "mamba1":
        raise NotImplementedError(f"ssm variant {cfg.ssm_variant!r} is not ported yet")

    def forward(params, tokens, seed, *, positions=None, caches=None, cache_index=None,
                method="quartet", features_only=False, token_valid=None, return_aux=False):
        return lm_forward(params, tokens, cfg, seed, positions=positions, caches=caches,
                          cache_index=cache_index, method=method,
                          features_only=features_only, token_valid=token_valid,
                          return_aux=return_aux)

    def head(params, x, seed, method="quartet"):
        return lm_head_apply(params, x, cfg, seed, method)

    def cache_spec(batch, max_len):
        return _cache_spec(cfg, batch, max_len)

    return Model(cfg, forward, head, cache_spec)
