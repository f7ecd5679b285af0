"""Serving steps over the model forward: prefill, decode and multi-token.

Port of ``init_cache``, ``make_chunk_prefill_step``, ``make_prefill_step``,
``make_decode_step``, ``make_verify_step`` and ``greedy_generate`` from
``repro.train.serve``.
Each step runs the model forward with explicit per-token positions over a
cache that it updates in place: dense caches ``(K, V)`` [L, B, T, Hkv, hd]
written at ``cache_index`` (the gather serving backend and whole-prompt
prefill), or a :class:`~repro_torch.kernels.paged_attention.PagedKV` pool.
The reference builds the multi-token step on a model with
``attn_rows_shared=False``; the port always computes causal bounds and rope
angles per row, so no second model exists.  Seeds are 0, as in the
reference's serving steps.  The steps run under ``torch.inference_mode``:
serving never differentiates.  The reference's ``greedy_generate`` is no
token oracle on jax 0.9.0 (ROADMAP C1); the port's is held against the
argmax of its own teacher-forced forward.
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


def greedy_generate(model: Model, params, prompt: torch.Tensor, max_new: int, max_len: int,
                    method: str = "quartet", sampling=None) -> torch.Tensor:
    """Reference generation loop: prefill ``prompt`` [B, P] into dense
    caches of ``max_len`` positions, then ``max_new − 1`` decode steps →
    int32 tokens [B, max_new].  ``sampling`` (a
    :class:`~repro_torch.serve.sampling.SamplingParams`; None or temperature
    0 is greedy argmax) draws token t of batch row b with
    ``row_key(seed, b, t)``, the engine's keys, so a one-row sampled
    generate equals an engine request with the same parameters."""
    if max_new < 1:
        raise ValueError(f"max_new must be >= 1, got {max_new}")
    B = prompt.shape[0]
    if sampling is not None and not sampling.greedy:
        from repro_torch.serve.sampling import sample_row

        def pick(logits, t):
            return torch.tensor([[sample_row(logits[b], sampling, b, t)] for b in range(B)],
                                dtype=torch.int32, device=logits.device)
    else:
        def pick(logits, t):
            return torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)

    prefill = make_prefill_step(model, method=method)
    decode = make_decode_step(model, method=method)
    caches = init_cache(model, B, max_len, prompt.device)
    logits, caches, pos = prefill(params, prompt, caches)
    out = [pick(logits, 0)]
    for t in range(1, max_new):
        logits, caches, pos = decode(params, out[-1], pos, caches)
        out.append(pick(logits, t))
    return torch.cat(out, dim=1)
