"""Device steps for paged-KV serving, and for the state pool.

Port of ``repro.serve.steps.build_paged_steps`` and ``build_state_steps``
(the state pool of the SSM, hybrid, enc-dec and VLM families;
:class:`StateSteps`).  On the ``"paged"``
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
``prefill_all`` is None).  ``prefill_chunk`` exists on both backends.

``verify_all`` scores S = k + 1 tokens for every slot in one call (the
speculative verify) and returns all ``[B, S, V]`` logits: on the paged
backend directly over the pool through the multi-query paged kernel (per-row
causal bounds), on the gather backend over the gathered dense view, its S
new tokens' K/V scattered back.  ``prefill_all`` and the paged
``verify_all`` are the same device computation at different S.  The verify
applies the head to one column of rows at a time, ``[B, 1]`` as a decode
step does: on the card the head's f32 GEMM rounds a row otherwise at
``B·S`` rows than at ``B`` (rmsnorm's row sum is kept shape-free there by
``models.layers``, and the kernels' rows are independent of S), so a
verify row's logits equal, bit for bit, those of a decode step over the
same prefix, and speculation never changes a greedy token.

Masked lanes follow the engine invariants: positions are clamped to 0 and
table rows zeroed, so their writes land on the scratch page and their
logits are garbage the host never reads.  Every batched step passes
``token_valid`` (the unmasked slots' lanes; in ``prefill_all`` also only a
row's first ``n_valid`` tokens) to the model, exactly as the reference's
steps build it, so padding lanes never compete for MoE expert capacity.  The pool is updated in place.

Each step is a :class:`Step`: it records the operand-shape signatures it
has been called with, the port's counterpart of the reference's compiled
variants (``compile_counts``, the telemetry's ``jit_compiled_*`` gauges: a
fixed-shape engine reads 1 for each step it used), and hands its calls to
an attached profiler, which costs the first call of each signature.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.models.registry import Model
from repro_torch.serve import paged_cache as P
from repro_torch.serve.paged_cache import PagedKV, prefill_chunk_layout
from repro_torch.train.serve import (
    cast_params,
    make_chunk_prefill_step,
    make_decode_step,
    make_verify_step,
)


def _signature(x):
    """The operand-shape signature of one argument: shapes and dtypes of its
    tensors (through dicts, tuples and lists), the type of anything else."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in x.items())
    if isinstance(x, (tuple, list)):
        return tuple(_signature(v) for v in x)
    return None if x is None else type(x).__name__


class Step:
    """A step function that records the distinct operand-shape signatures it
    has been called with (the weights, its first argument, are fixed for an
    engine's lifetime and left out).  With a ``profiler`` attached
    (``serve.telemetry.profiling.EngineProfiler``) every call goes through
    it, which costs the first call of each signature."""

    def __init__(self, name: str, fn: Callable):
        self.name, self.fn = name, fn
        self.signatures: set = set()
        self.profiler = None

    def __call__(self, *args, **kwargs):
        sig = _signature((args[1:], kwargs))
        self.signatures.add(sig)
        if self.profiler is not None:
            return self.profiler.call(self, sig, args, kwargs)
        return self.fn(*args, **kwargs)


def n_signatures(fn) -> int:
    """Distinct signatures a :class:`Step` has seen (0 for None)."""
    return len(getattr(fn, "signatures", ()))


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
    # (params, tokens [B,S], start [B], pool, tables, mask) -> logits [B,S,V]
    verify_all: Callable

    def compile_counts(self) -> dict[str, int]:
        """Distinct operand-shape signatures per step, the counterpart of the
        reference's compiled variants (a shape storm shows as a count > 1 on
        a fixed-shape step)."""
        return {name: n_signatures(fn) for name, fn in zip(self._fields, self)}


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

    def _head_by_column(params, feats):
        """[B, S, D] features → [B, S, V] logits, one [B, 1] column at a time."""
        return torch.cat([model.head(params, feats[:, s:s + 1], 0, method)
                          for s in range(feats.shape[1])], dim=1)

    def decode_all(params, tokens, positions, pool, tables, mask):
        """One decode step for every slot over the packed pool."""
        pos_safe = torch.where(mask, positions, torch.zeros_like(positions))
        logits, _, _ = decode(params, tokens, pos_safe, PagedKV(pool, _masked(tables, mask)),
                              token_valid=mask[:, None])
        return logits

    def verify_all(params, tokens, start, pool, tables, mask):
        """Score S = k + 1 tokens per slot (the last accepted token and the
        drafts) at ``start .. start + S − 1`` in one call over the pool; row
        s sees positions ≤ start + s.  Positions past a slot's mapped pages
        fall on zero table columns, so their writes land on the scratch
        page."""
        pos_safe = torch.where(mask, start, torch.zeros_like(start))
        feats, _ = verify(params, tokens, pos_safe, PagedKV(pool, _masked(tables, mask)),
                          features_only=True, token_valid=mask[:, None].expand(tokens.shape))
        return _head_by_column(params, feats)

    def prefill_all(params, tokens, start, n_valid, pool, tables, mask):
        """Advance every prefilling slot by one ragged [B, C] chunk in one
        call.  Returns each row's last valid token's logits — the only row
        the engine reads — applying the head to that row alone."""
        B, C = tokens.shape
        tbl_ext, positions = prefill_chunk_layout(_masked(tables, mask), start, n_valid,
                                                  C, ps, mask)
        pos_safe = torch.where(mask, start, torch.zeros_like(start))
        valid = mask[:, None] & (torch.arange(C, device=tokens.device)[None, :]
                                 < n_valid[:, None])
        feats, _ = verify(params, tokens, pos_safe, PagedKV(pool, tbl_ext),
                          positions=positions, features_only=True, token_valid=valid)
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
        return _paged_steps(decode_all, prefill_all, prefill_chunk, verify_all)

    def gather_decode_all(params, tokens, positions, pool, tables, mask):
        """One decode step for every slot over the gathered dense view; the
        new column is scattered back (masked lanes to the scratch page)."""
        pos_safe = torch.where(mask, positions, torch.zeros_like(positions))
        kv = P.gather_pages(pool, tables, dtype)
        logits, (k2, v2), _ = decode(params, tokens, pos_safe, kv, token_valid=mask[:, None])
        bidx = torch.arange(tokens.shape[0], device=tokens.device)
        pos = pos_safe.long()
        page_ids = torch.where(mask, tables[bidx, pos // ps], torch.zeros_like(pos_safe))
        P.scatter_tokens(pool, page_ids, pos_safe % ps, k2[:, bidx, pos], v2[:, bidx, pos])
        return logits

    def gather_verify_all(params, tokens, start, pool, tables, mask):
        """Gather-backend verify: the dense view in, the S new tokens' K/V
        of every slot scattered back (masked lanes to the scratch page)."""
        B, S = tokens.shape
        pos_safe = torch.where(mask, start, torch.zeros_like(start))
        kv = P.gather_pages(pool, tables, dtype)
        feats, (k2, v2) = verify(params, tokens, pos_safe, kv, features_only=True,
                                 token_valid=mask[:, None].expand(tokens.shape))
        bidx = torch.arange(B, device=tokens.device)[:, None]
        pos = (pos_safe[:, None] + torch.arange(S, device=tokens.device)[None, :]).long()
        page_ids = torch.where(mask[:, None], tables[bidx, pos // ps],
                               torch.zeros_like(pos, dtype=tables.dtype))
        L = k2.shape[0]
        k_new = k2[:, bidx, pos].reshape(L, B * S, *k2.shape[3:])
        v_new = v2[:, bidx, pos].reshape(L, B * S, *v2.shape[3:])
        P.scatter_tokens(pool, page_ids.reshape(-1), (pos % ps).reshape(-1), k_new, v_new)
        return _head_by_column(params, feats)

    return _paged_steps(gather_decode_all, None, prefill_chunk, gather_verify_all)


def _paged_steps(*fns) -> PagedSteps:
    return PagedSteps(*(None if f is None else Step(name, f)
                        for name, f in zip(PagedSteps._fields, fns)))


class StateSteps(NamedTuple):
    """Steps of :class:`~repro_torch.serve.state_pool.StatePool` serving, the
    non-paged families' counterpart of :class:`PagedSteps`."""

    # (params, tokens [B,1], positions [B], kv_tables [B,P] | None,
    #  cross_tables [B,Pc] | None, ring_read [B], ring_write [B], mask [B])
    #   -> logits [B,V]
    decode_all: Callable
    # (params, tokens [1,C], start: int, kv_row [P] | None, cross_row [Pc] |
    #  None, ring_read [1], ring_write [1], extra) -> last-token logits [1,V]
    prefill_chunk: Callable
    # (params, embeds [1,T,D], cross_row [Pc]) -> None: one request's
    # cross-KV into its cross pages; None without a cross plane
    encode_cross: Callable | None = None

    def compile_counts(self) -> dict[str, int]:
        """The key set of :meth:`PagedSteps.compile_counts`, as the
        reference keeps it: no verify step, and the once-per-admission
        encode under the otherwise unused ``prefill_all`` key."""
        return {"decode_all": n_signatures(self.decode_all),
                "prefill_chunk": n_signatures(self.prefill_chunk), "verify_all": 0,
                "prefill_all": n_signatures(self.encode_cross)}


def build_state_steps(model: Model, *, method: str, pool) -> StateSteps:
    """Steps over a :class:`~repro_torch.serve.state_pool.StatePool`.  Each
    assembles the family's dense cache tree from the planes (the KV plane's
    pages gathered and dequantized, B4b, and sliced to ``max_len``; the
    cross plane's likewise, sliced to ``cross_tokens``: cross attention is
    not causal, so a page's tail would be attended; the ring read pages
    gathered, B4b on packed rings), runs the unmodified ``train.serve``
    decode or chunk step on it, then writes back: the new tokens' K/V
    quantized into their pages (B4a, K and V in one launch; masked lanes
    write page 0), each lane's whole new recurrent state into its ring
    write page (B4a).  The cross plane is written only by
    ``encode_cross``, at admission.  With ``kv_dtype="dense"`` the planes
    hold the values bit for bit, so the tokens equal the dense-slot
    oracle's.

    As in the reference, an enc-dec prefill runs ``build_cross=False`` and
    reads the pooled cross-KV, while a VLM prefill passes ``extra`` through,
    so its cross blocks recompute their K/V from the image (the oracle's
    path: a cross attention that reads a cache rotates its queries, one
    built from the source does not) and the pooled cross-KV it was handed
    is not read; decode steps read the pooled cross-KV."""
    decode = make_decode_step(model, method=method)
    chunk = make_chunk_prefill_step(model, method=method, build_cross=False)
    dtype = getattr(torch, model.cfg.dtype)
    family = model.cfg.family
    rings, kv, cross = pool.rings, pool.kv, pool.cross
    ps, max_len, n_src = pool.page_size, pool.max_len, pool.cross_tokens
    kv_key = pool.kv_key

    def assemble(tables, cross_tables, read):
        state = tuple(r.gather(read) for r in rings)
        if family == "ssm":
            return state
        k, v = P.gather_pages(kv.pool, tables, dtype)
        caches = {kv_key: (k[:, :, :max_len], v[:, :, :max_len])}
        if cross is None:
            caches["mamba"] = state
        else:
            k, v = P.gather_pages(cross.pool, cross_tables, dtype)
            caches["cross"] = (k[:, :, :n_src], v[:, :, :n_src])
        return caches

    def write_back(caches, page_ids, offsets, k_new, v_new, write):
        """The step updated the gathered tree in place: its new tokens' K/V
        (when there is a KV plane) and every ring leaf go back."""
        if kv is not None:
            P.scatter_tokens(kv.pool, page_ids, offsets, k_new, v_new)
        for r, leaf in zip(rings, caches if family == "ssm" else caches.get("mamba", ())):
            r.scatter(write, leaf)

    def decode_all(params, tokens, positions, kv_tables, cross_tables, ring_read, ring_write,
                   mask):
        """One token for every slot.  Masked lanes read the zero ring sentinel
        (and their stale tables) and write page 0 of every plane; the host
        does not advance their ring cursor, so their state is untouched (the
        dense oracle's masked merge)."""
        pos_safe = torch.where(mask, positions, torch.zeros_like(positions))
        caches = assemble(kv_tables, cross_tables, ring_read)
        logits = decode(params, tokens, pos_safe, caches)[0]
        page_ids = offsets = k_new = v_new = None
        if kv is not None:
            k2, v2 = caches[kv_key]
            bidx = torch.arange(tokens.shape[0], device=tokens.device)
            pos = pos_safe.long()
            page_ids = torch.where(mask, kv_tables[bidx, pos // ps], torch.zeros_like(pos_safe))
            offsets, k_new, v_new = pos_safe % ps, k2[:, bidx, pos], v2[:, bidx, pos]
        write_back(caches, page_ids, offsets, k_new, v_new, ring_write)
        return logits

    def prefill_chunk(params, tokens, start, kv_row, cross_row, ring_read, ring_write,
                      extra=None):
        """One slot's [1, C] prompt chunk: its K/V at positions start .. start
        + C − 1 into the slot's pages, its whole new state from its read page
        into its write page; a cross cache the step rewrote is dropped."""
        start_t = torch.full((1,), start, dtype=torch.int32, device=tokens.device)
        caches = assemble(None if kv_row is None else kv_row[None],
                          None if cross_row is None else cross_row[None], ring_read)
        logits = chunk(params, tokens, start_t, caches, extra)[0]
        page_ids = offsets = k_new = v_new = None
        if kv is not None:
            k2, v2 = caches[kv_key]
            C = tokens.shape[1]
            s0 = min(start, k2.shape[2] - C)  # a dynamic slice clamps its start
            pos = start + torch.arange(C, device=tokens.device)
            page_ids, offsets = kv_row[pos // ps], pos % ps
            k_new, v_new = k2[:, 0, s0:s0 + C], v2[:, 0, s0:s0 + C]
        write_back(caches, page_ids, offsets, k_new, v_new, ring_write)
        return logits

    if cross is None:
        return StateSteps(Step("decode_all", decode_all), Step("prefill_chunk", prefill_chunk))
    if family == "encdec":
        from repro_torch.models.encdec import encode_cross_kv
    else:
        from repro_torch.models.vlm import encode_cross_kv

    @torch.inference_mode()
    def encode_cross(params, embeds, cross_row):
        """One request's cross-KV, written once (at admission): [1, T_src, D]
        conditioning → every layer's (k, v) → all T_src tokens
        quantize-scattered over the slot's cross pages (B4a, K and V of
        every layer in one launch).  The params are cast as the chunk and
        decode steps cast them, so a dense plane holds, bit for bit, what a
        ``build_cross=True`` prefill attends over."""
        ks, vs = encode_cross_kv(cast_params(params, dtype), embeds, model.cfg, 0, method)
        pos = torch.arange(ks.shape[2], device=embeds.device)
        P.scatter_tokens(cross.pool, cross_row[pos // ps], pos % ps, ks[:, 0], vs[:, 0])

    return StateSteps(Step("decode_all", decode_all), Step("prefill_chunk", prefill_chunk),
                      Step("encode_cross", encode_cross))
