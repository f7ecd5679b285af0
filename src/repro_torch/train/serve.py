"""Serving steps over the model forward: prefill, decode and multi-token.

Port of ``init_cache``, ``make_chunk_prefill_step``, ``make_prefill_step``,
``make_decode_step`` and ``make_verify_step`` from ``repro.train.serve``.
Each step runs the model forward with explicit per-token positions over a
cache that it updates in place: dense caches ``(K, V)`` [L, B, T, Hkv, hd]
written at ``cache_index`` (the gather serving backend and whole-prompt
prefill), or a :class:`~repro_torch.kernels.paged_attention.PagedKV` pool.
The reference builds the multi-token step on a model with
``attn_rows_shared=False``; the port always computes causal bounds and rope
angles per row, so no second model exists.  Seeds are 0, as in the
reference's serving steps.  The steps run under ``torch.inference_mode``:
serving never differentiates.  ``greedy_generate`` is not ported: it is no
token oracle (ROADMAP C1), and it arrives with sampled decoding.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.registry import Model


def init_cache(model: Model, batch: int, max_len: int, device) -> tuple:
    """Zero dense caches ``(K, V)`` [L, batch, max_len, Hkv, hd] in the
    model's compute dtype."""
    cfg = model.cfg
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
    dtype = getattr(torch, cfg.dtype)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def make_chunk_prefill_step(model: Model, *, method: str = "quartet") -> Callable:
    """Chunked prefill over dense caches: ``tokens [B, C]`` at absolute
    positions ``start [B] + 0..C-1``, writing K/V there."""

    @torch.inference_mode()
    def prefill_chunk(params, tokens, start, caches):
        """tokens [B, C], start [B] → (last-token logits [B, V], caches,
        start + C).  The head runs on the last row only."""
        C = tokens.shape[1]
        positions = start[:, None] + torch.arange(C, dtype=torch.int32,
                                                  device=tokens.device)[None, :]
        feats, caches = model.forward(params, tokens, 0, positions=positions, caches=caches,
                                      cache_index=start, method=method, features_only=True)
        return model.head(params, feats[:, -1:], 0, method)[:, 0], caches, start + C

    return prefill_chunk


def make_prefill_step(model: Model, *, method: str = "quartet") -> Callable:
    chunk = make_chunk_prefill_step(model, method=method)

    def prefill(params, tokens, caches):
        """tokens [B, S] → (next-token logits [B, V], caches, next_pos [B])."""
        start = torch.zeros((tokens.shape[0],), dtype=torch.int32, device=tokens.device)
        return chunk(params, tokens, start, caches)

    return prefill


def make_decode_step(model: Model, *, method: str = "quartet") -> Callable:
    @torch.inference_mode()
    def decode(params, token, position, caches):
        """token [B, 1], position [B] → (logits [B, V], caches, position + 1)."""
        logits, caches = model.forward(params, token, 0, positions=position[:, None],
                                       caches=caches, cache_index=position, method=method)
        return logits[:, -1, :], caches, position + 1

    return decode


def make_verify_step(model: Model, *, method: str = "quartet") -> Callable:
    """Score ``tokens [B, S]`` per slot at ``start .. start + S`` (or at the
    given ``positions``, which the batched prefill uses to park padding on
    the scratch sentinel column) in one call.  Returns the ``[B, S, V]``
    logits, or with ``features_only`` the final hidden states, so a caller
    that reads one row per slot applies the head to that row only."""

    @torch.inference_mode()
    def verify(params, tokens, start, caches, positions=None, features_only=False):
        S = tokens.shape[1]
        if positions is None:
            positions = start[:, None] + torch.arange(S, dtype=torch.int32,
                                                      device=tokens.device)[None, :]
        out, caches = model.forward(params, tokens, 0, positions=positions, caches=caches,
                                    cache_index=start, method=method,
                                    features_only=features_only)
        return out, caches

    return verify
