"""Uniform model API over the six families.

``build_model(cfg, attn_backend=None)`` → ``Model(cfg, forward, head,
cache_spec)`` with

    forward(params, tokens, seed, *, positions=None, caches=None,
            cache_index=None, extra=None, build_cross=False,
            method="quartet", features_only=False, token_valid=None,
            return_aux=False)
        -> (logits | features, caches), and with return_aux also the f32
           aux loss (the MoE layers' router losses; 0 for a dense model)
    head(params, features, seed, method="quartet") -> f32 logits

``extra`` carries the enc-dec family's ``source_embeds`` (or ``memory``)
and the VLM's ``image_embeds``; ``build_cross`` makes an enc-dec forward
with caches run the encoder and write its cross-KV cache (a VLM writes it
whenever it gets ``image_embeds`` and a cache).  The enc-dec head is the
decoder's final norm and the tied unembedding.
    cache_spec(batch, max_len) -> the decode cache as a tree of (shape,
        dtype) leaves, stacked [L, ...]: dense and MoE (K, V)
        [L, B, max_len, Hkv, hd]; SSM (conv [L, B, K-1, Di], h [L, B, Di,
        N]); hybrid {"attn": (K, V) [n_super, B, max_len, Hkv, hd],
        "mamba": (conv [L, B, K-1, Di + 2N], h [L, B, nh, hd, N])};
        enc-dec and VLM {"self": (K, V) [L, B, max_len, Hkv, hd],
        "cross": (K, V) [L | n_super, B, T_src | n_img, Hkv, hd]}

:func:`cache_map` and :func:`cache_leaves` walk such a tree (dict keys
sorted, tuples in order: the reference's ``jax.tree`` order).  Weights come
from ``repro_torch.convert`` (``init_params`` or ``params_from_jax``).
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


def _is_leaf(t) -> bool:
    """A cache tree's leaf: a tensor, or a ``(shape, dtype)`` spec."""
    return not isinstance(t, (dict, tuple, list)) or (
        len(t) == 2 and isinstance(t[1], torch.dtype))


def cache_map(fn, tree, *rest):
    """``fn`` over the leaves of a cache tree (and the matching leaves of
    ``rest``, which share its structure): dicts with sorted keys, tuples."""
    if isinstance(tree, dict):
        return {k: cache_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if not _is_leaf(tree):
        return tuple(cache_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def cache_leaves(tree) -> list:
    """A cache tree's leaves in :func:`cache_map`'s order."""
    out = []
    cache_map(out.append, tree)
    return out


def _cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    if cfg.family == "encdec":
        from repro_torch.models.encdec import encdec_cache_spec

        return encdec_cache_spec(cfg, batch, max_len)
    if cfg.family == "vlm":
        from repro_torch.models.vlm import vlm_cache_spec

        return vlm_cache_spec(cfg, batch, max_len)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import hybrid_cache_spec

        return hybrid_cache_spec(cfg, batch, max_len)
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
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "encdec", "vlm"):
        raise ValueError(f"unknown family {cfg.family!r}")
    want = {"ssm": "mamba1", "hybrid": "mamba2"}.get(cfg.family)
    if want is not None and cfg.ssm_variant != want:
        raise NotImplementedError(f"ssm variant {cfg.ssm_variant!r} in family {cfg.family!r} "
                                  f"is not ported")
    head_fn, body = lm_head_apply, lm_forward
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import hybrid_forward as body
    elif cfg.family == "encdec":
        from repro_torch.models.encdec import encdec_forward, encdec_head as head_fn
    elif cfg.family == "vlm":
        from repro_torch.models.vlm import vlm_forward

    def forward(params, tokens, seed, *, positions=None, caches=None, cache_index=None,
                extra=None, build_cross=False, method="quartet", features_only=False,
                token_valid=None, return_aux=False):
        kw = dict(positions=positions, caches=caches, cache_index=cache_index, method=method,
                  features_only=features_only)
        extra = extra or {}
        if cfg.family == "encdec":
            out = encdec_forward(params, tokens, cfg, seed, memory=extra.get("memory"),
                                 source_embeds=extra.get("source_embeds"),
                                 build_cross=build_cross, **kw)
        elif cfg.family == "vlm":
            out = vlm_forward(params, tokens, cfg, seed, image_embeds=extra.get("image_embeds"),
                              **kw)
        else:
            return body(params, tokens, cfg, seed, token_valid=token_valid,
                        return_aux=return_aux, **kw)
        if return_aux:  # no router: the aux loss is 0
            return (*out, torch.zeros((), dtype=torch.float32, device=tokens.device))
        return out

    def head(params, x, seed, method="quartet"):
        return head_fn(params, x, cfg, seed, method)

    def cache_spec(batch, max_len):
        return _cache_spec(cfg, batch, max_len)

    return Model(cfg, forward, head, cache_spec)
