"""Serving steps over the model forward: prefill, decode and multi-token.

Port of ``init_cache``, ``make_chunk_prefill_step``, ``make_prefill_step``,
``make_decode_step``, ``make_verify_step`` and ``greedy_generate`` from
``repro.train.serve``.
Each step runs the model forward with explicit per-token positions over a
cache that it updates in place: dense caches ``(K, V)`` [L, B, T, Hkv, hd]
written at ``cache_index`` (the gather serving backend and whole-prompt
prefill), a :class:`~repro_torch.kernels.paged_attention.PagedKV` pool,
an SSM's ``(conv, h)`` state, a hybrid's tree of both, or an enc-dec or
VLM model's ``{"self", "cross"}`` tree (``Model.cache_spec``).  Each step
passes ``extra`` (the enc-dec family's ``source_embeds``, the VLM's
``image_embeds``) to the forward, as the reference's steps do.  Each casts the floating leaves of the params
to the compute dtype first, as the reference's steps do.
The reference builds the multi-token step on a model with
``attn_rows_shared=False``; the port always computes causal bounds and rope
angles per row, so no second model exists.  Seeds are 0, as in the
reference's serving steps.  Each step takes ``token_valid`` ([B, S] bool,
the lanes that carry real tokens) for the MoE block's capacity selection,
as the reference's steps do.  The steps run under ``torch.inference_mode``:
serving never differentiates.  The reference's ``greedy_generate`` is no
token oracle on jax 0.9.0 (ROADMAP C1); the port's is held against the
argmax of its own teacher-forced forward.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.registry import Model, cache_map


def init_cache(model: Model, batch: int, max_len: int, device):
    """Zero decode caches of ``model.cache_spec``, a tree of its shape:
    dense ``(K, V)`` [L, batch, max_len, Hkv, hd] in the compute dtype, an
    SSM's ``(conv, h)`` [L, batch, K-1, Di] / [L, batch, Di, N], or a
    hybrid's ``{"attn": (K, V), "mamba": (conv, h)}``."""
    return cache_map(lambda spec: torch.zeros(spec[0], dtype=spec[1], device=device),
                     model.cache_spec(batch, max_len))


def cast_params(params, dtype: torch.dtype):
    """Every floating leaf of the nested param tree in the compute dtype, as
    the reference's serving steps cast the tree (an SSM's f32 ``A_log``,
    ``dt_bias`` and ``D`` become bf16 there).
    A leaf already in ``dtype`` is the same tensor, so a tree with nothing
    to cast costs no copy."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params


def make_chunk_prefill_step(model: Model, *, method: str = "quartet",
                            build_cross: bool = True) -> Callable:
    """Chunked prefill over dense caches: ``tokens [B, C]`` at absolute
    positions ``start [B] + 0..C-1``, writing K/V there.  With
    ``build_cross`` (the default) an enc-dec model runs its encoder on
    ``extra`` and writes its cross caches on every chunk (the same values
    each time); ``build_cross=False`` attends over cross caches already
    written (the state pool writes them once, at admission)."""

    dtype = getattr(torch, model.cfg.dtype)

    @torch.inference_mode()
    def prefill_chunk(params, tokens, start, caches, extra=None, token_valid=None):
        """tokens [B, C], start [B] → (last-token logits [B, V], caches,
        start + C).  The head runs on the last row only."""
        params = cast_params(params, dtype)
        C = tokens.shape[1]
        positions = start[:, None] + torch.arange(C, dtype=torch.int32,
                                                  device=tokens.device)[None, :]
        feats, caches = model.forward(params, tokens, 0, positions=positions, caches=caches,
                                      cache_index=start, extra=extra, build_cross=build_cross,
                                      method=method, features_only=True,
                                      token_valid=token_valid)
        return model.head(params, feats[:, -1:], 0, method)[:, 0], caches, start + C

    return prefill_chunk


def make_prefill_step(model: Model, *, method: str = "quartet") -> Callable:
    chunk = make_chunk_prefill_step(model, method=method)

    def prefill(params, tokens, caches, extra=None):
        """tokens [B, S] → (next-token logits [B, V], caches, next_pos [B])."""
        start = torch.zeros((tokens.shape[0],), dtype=torch.int32, device=tokens.device)
        return chunk(params, tokens, start, caches, extra)

    return prefill


def make_decode_step(model: Model, *, method: str = "quartet") -> Callable:
    dtype = getattr(torch, model.cfg.dtype)

    @torch.inference_mode()
    def decode(params, token, position, caches, extra=None, token_valid=None):
        """token [B, 1], position [B] → (logits [B, V], caches, position + 1)."""
        params = cast_params(params, dtype)
        logits, caches = model.forward(params, token, 0, positions=position[:, None],
                                       caches=caches, cache_index=position, extra=extra,
                                       method=method, token_valid=token_valid)
        return logits[:, -1, :], caches, position + 1

    return decode


def make_verify_step(model: Model, *, method: str = "quartet") -> Callable:
    """Score ``tokens [B, S]`` per slot at ``start .. start + S`` (or at the
    given ``positions``, which the batched prefill uses to park padding on
    the scratch sentinel column) in one call.  Returns the ``[B, S, V]``
    logits, or with ``features_only`` the final hidden states, so a caller
    that reads one row per slot applies the head to that row only."""

    dtype = getattr(torch, model.cfg.dtype)

    @torch.inference_mode()
    def verify(params, tokens, start, caches, positions=None, features_only=False,
               token_valid=None, extra=None):
        params = cast_params(params, dtype)
        S = tokens.shape[1]
        if positions is None:
            positions = start[:, None] + torch.arange(S, dtype=torch.int32,
                                                      device=tokens.device)[None, :]
        out, caches = model.forward(params, tokens, 0, positions=positions, caches=caches,
                                    cache_index=start, extra=extra, method=method,
                                    features_only=features_only, token_valid=token_valid)
        return out, caches

    return verify


def greedy_generate(model: Model, params, prompt: torch.Tensor, max_new: int, max_len: int,
                    extra=None, method: str = "quartet", sampling=None) -> torch.Tensor:
    """Reference generation loop: prefill ``prompt`` [B, P] into dense
    caches of ``max_len`` positions, then ``max_new − 1`` decode steps, each
    given ``extra`` as the reference's are (so a VLM's decode steps
    recompute the cross K/V from the image, unrotated queries) → int32
    tokens [B, max_new].  ``sampling`` (a
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
    logits, caches, pos = prefill(params, prompt, caches, extra)
    out = [pick(logits, 0)]
    for t in range(1, max_new):
        logits, caches, pos = decode(params, out[-1], pos, caches, extra)
        out.append(pick(logits, t))
    return torch.cat(out, dim=1)
