"""Serving steps over the model forward (decode and multi-token).

Port of ``make_decode_step`` and ``make_verify_step`` from
``repro.train.serve``.  Each step runs the model forward with explicit
per-token positions over a :class:`~repro_torch.kernels.paged_attention.
PagedKV` cache, whose pool is updated in place.  The reference builds the
multi-token step on a model with ``attn_rows_shared=False``; the port always
computes causal bounds and rope angles per row, so no second model exists.
Seeds are 0, as in the reference's serving steps.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.registry import Model


def make_decode_step(model: Model, *, method: str = "quartet") -> Callable:
    def decode(params, token, position, caches):
        """token [B, 1], position [B] → (logits [B, V], caches, position + 1)."""
        logits, caches = model.forward(params, token, 0, positions=position[:, None],
                                       caches=caches, method=method)
        return logits[:, -1, :], caches, position + 1

    return decode


def make_verify_step(model: Model, *, method: str = "quartet") -> Callable:
    """Score ``tokens [B, S]`` per slot at ``start .. start + S`` (or at the
    given ``positions``, which the batched prefill uses to park padding on
    the scratch sentinel column) in one call.  Returns the ``[B, S, V]``
    logits, or with ``features_only`` the final hidden states, so a caller
    that reads one row per slot applies the head to that row only."""

    def verify(params, tokens, start, caches, positions=None, features_only=False):
        S = tokens.shape[1]
        if positions is None:
            positions = start[:, None] + torch.arange(S, dtype=torch.int32,
                                                      device=tokens.device)[None, :]
        out, caches = model.forward(params, tokens, 0, positions=positions, caches=caches,
                                    method=method, features_only=features_only)
        return out, caches

    return verify
