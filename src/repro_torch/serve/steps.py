"""Device steps for paged-KV serving.

Port of ``repro.serve.steps.build_paged_steps`` for the paged backend.  Two
step kinds, both attending directly over the packed pool (no dense gather):

* ``decode_all``  — one token for every slot in one call (S == 1);
* ``prefill_all`` — one ``[n_slots, C]`` chunk for every prefilling slot in
  one call: each slot's tokens are quantize-scattered into its own pages at
  its own start offset, ragged tails are padded and parked on the scratch
  sentinel column (``kernels.paged_attention.prefill_chunk_layout``), and
  the multi-query paged kernel applies per-row causal bounds.

Masked lanes follow the engine invariants: positions are clamped to 0 and
table rows zeroed, so their writes land on the scratch page and their
logits are garbage the host never reads.  The pool is updated in place.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.models.registry import Model
from repro_torch.serve.paged_cache import PagedKV, prefill_chunk_layout
from repro_torch.train.serve import make_decode_step, make_verify_step


def marshal_prefill_batch(n_slots: int, chunk: int, items):
    """Host-side operands of one ``prefill_all`` call.  ``items`` yields
    ``(slot, start, tokens_np)`` with ``1 <= len(tokens_np) <= chunk``;
    returns numpy ``(tokens [n_slots, chunk], start, n_valid, mask)``."""
    tokens = np.zeros((n_slots, chunk), np.int32)
    start = np.zeros((n_slots,), np.int32)
    n_valid = np.zeros((n_slots,), np.int32)
    mask = np.zeros((n_slots,), bool)
    for slot, s0, toks in items:
        n = len(toks)
        tokens[slot, :n] = toks
        start[slot], n_valid[slot], mask[slot] = s0, n, True
    return tokens, start, n_valid, mask


class PagedSteps(NamedTuple):
    # (params, tokens [B,1], positions [B], pool, tables, mask) -> logits [B,V]
    decode_all: Callable
    # (params, tokens [B,C], start [B], n_valid [B], pool, tables, mask)
    #   -> last-valid-token logits [B,V]
    prefill_all: Callable


def build_paged_steps(model: Model, *, method: str, page_size: int) -> PagedSteps:
    decode = make_decode_step(model, method=method)
    verify = make_verify_step(model, method=method)
    ps = page_size

    def _masked(tables, mask):
        return torch.where(mask[:, None], tables, torch.zeros_like(tables))

    def decode_all(params, tokens, positions, pool, tables, mask):
        """One decode step for every slot over the packed pool."""
        pos_safe = torch.where(mask, positions, torch.zeros_like(positions))
        logits, _, _ = decode(params, tokens, pos_safe, PagedKV(pool, _masked(tables, mask)))
        return logits

    def prefill_all(params, tokens, start, n_valid, pool, tables, mask):
        """Advance every prefilling slot by one ragged [B, C] chunk in one
        call.  Returns each row's last valid token's logits — the only row
        the engine reads — applying the head to that row alone."""
        B, C = tokens.shape
        tbl_ext, positions = prefill_chunk_layout(_masked(tables, mask), start, n_valid,
                                                  C, ps, mask)
        pos_safe = torch.where(mask, start, torch.zeros_like(start))
        feats, _ = verify(params, tokens, pos_safe, PagedKV(pool, tbl_ext),
                          positions=positions, features_only=True)
        rows = torch.arange(B, device=tokens.device)
        last = feats[rows, torch.clamp(n_valid.long() - 1, 0, C - 1)]
        return model.head(params, last[:, None], 0, method)[:, 0]

    return PagedSteps(decode_all, prefill_all)
