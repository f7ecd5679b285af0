"""Uniform model API (dense family in this slice).

``build_model(cfg, attn_backend=None)`` → ``Model(cfg, forward, head)`` with

    forward(params, tokens, seed, *, positions=None, caches=None,
            cache_index=None, method="quartet", features_only=False)
        -> (logits | features, caches)
    head(params, features, seed, method="quartet") -> f32 logits

Weights come from ``repro_torch.convert`` (``init_params`` or
``params_from_jax``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import lm_forward, lm_head_apply


class Model(NamedTuple):
    cfg: ModelConfig
    forward: Callable
    head: Callable


def build_model(cfg: ModelConfig, *, attn_backend: str | None = None) -> Model:
    """``attn_backend`` overrides ``cfg.attn_backend`` ("blocked" / "flash" /
    "paged"), so callers pick the attention backend without editing the
    config (evaluation with the flash kernel: ``attn_backend="flash"``)."""
    if attn_backend is not None:
        cfg = dataclasses.replace(cfg, attn_backend=attn_backend)
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")

    def forward(params, tokens, seed, *, positions=None, caches=None, cache_index=None,
                method="quartet", features_only=False):
        return lm_forward(params, tokens, cfg, seed, positions=positions, caches=caches,
                          cache_index=cache_index, method=method,
                          features_only=features_only)

    def head(params, x, seed, method="quartet"):
        return lm_head_apply(params, x, cfg, seed, method)

    return Model(cfg, forward, head)
