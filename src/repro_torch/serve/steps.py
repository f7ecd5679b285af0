"""Device steps for paged-KV serving.

Port of ``repro.serve.steps.build_paged_steps``.  On the ``"paged"``
backend (the default) every step attends directly over the packed pool:

* ``decode_all``  — one token for every slot in one call (S == 1);
* ``prefill_all`` — one ``[n_slots, C]`` chunk for every prefilling slot in
  one call: each slot's tokens are quantize-scattered into its own pages at
  its own start offset, ragged tails are padded and parked on the scratch
  sentinel column (``kernels.paged_attention.prefill_chunk_layout``), and
  the multi-query paged kernel applies per-row causal bounds.

On the ``"gather"`` backend (the reference's parity oracle) each step
gather-dequantizes the slots' pages into dense ``[L, B, T, Hkv, hd]``
caches (B4b), runs the dense-cache forward, and quantize-scatters the new
tokens' K/V back into the pool (B4a): ``decode_all`` for every slot, and a
per-slot ``prefill_chunk`` (``[1, C]`` chunks, then ``[1, 1]`` remainders;
``prefill_all`` is None).  ``prefill_chunk`` exists on both backends.  The
gather ``verify_all`` arrives with speculative decoding.

Masked lanes follow the engine invariants: positions are clamped to 0 and
table rows zeroed, so their writes land on the scratch page and their
logits are garbage the host never reads.  The pool is updated in place.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.models.registry import Model
from repro_torch.serve import paged_cache as P
from repro_torch.serve.paged_cache import PagedKV, prefill_chunk_layout
from repro_torch.train.serve import make_chunk_prefill_step, make_decode_step, make_verify_step


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
    #   -> last-valid-token logits [B,V]; None on the gather backend
    prefill_all: Callable | None
    # (params, tokens [1,C], start: int, table_row [P], pool) -> logits [1,V]
    prefill_chunk: Callable


def build_paged_steps(model: Model, *, method: str, page_size: int,
                      decode_backend: str = "paged") -> PagedSteps:
    if decode_backend not in ("paged", "gather"):
        raise ValueError(f"decode_backend must be 'paged' or 'gather', got {decode_backend!r}")
    decode = make_decode_step(model, method=method)
    verify = make_verify_step(model, method=method)
    chunk = make_chunk_prefill_step(model, method=method)
    dtype = getattr(torch, model.cfg.dtype)
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

    def prefill_chunk(params, tokens, start, table_row, pool):
        """tokens [1, C] at positions start .. start + C − 1 of the slot
        mapped by ``table_row``: gather the slot's pages, run the dense-cache
        chunk, scatter the C new tokens' K/V → last-token logits [1, V]."""
        kv = P.gather_pages(pool, table_row[None], dtype)
        C = tokens.shape[1]
        start_t = torch.full((1,), start, dtype=torch.int32, device=tokens.device)
        logits, (k2, v2), _ = chunk(params, tokens, start_t, kv)
        s0 = min(start, k2.shape[2] - C)  # a dynamic slice clamps its start
        pos = start + torch.arange(C, device=tokens.device)
        P.scatter_tokens(pool, table_row[pos // ps], pos % ps, k2[:, 0, s0:s0 + C],
                         v2[:, 0, s0:s0 + C])
        return logits

    if decode_backend == "paged":
        return PagedSteps(decode_all, prefill_all, prefill_chunk)

    def gather_decode_all(params, tokens, positions, pool, tables, mask):
        """One decode step for every slot over the gathered dense view; the
        new column is scattered back (masked lanes to the scratch page)."""
        pos_safe = torch.where(mask, positions, torch.zeros_like(positions))
        kv = P.gather_pages(pool, tables, dtype)
        logits, (k2, v2), _ = decode(params, tokens, pos_safe, kv)
        bidx = torch.arange(tokens.shape[0], device=tokens.device)
        pos = pos_safe.long()
        page_ids = torch.where(mask, tables[bidx, pos // ps], torch.zeros_like(pos_safe))
        P.scatter_tokens(pool, page_ids, pos_safe % ps, k2[:, bidx, pos], v2[:, bidx, pos])
        return logits

    return PagedSteps(gather_decode_all, None, prefill_chunk)
