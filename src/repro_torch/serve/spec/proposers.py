"""Pluggable draft proposers for speculative decoding.

Port of ``repro.serve.spec.proposers``.  Each spec tick a proposer returns
``k`` drafted continuation tokens for every decoding slot; the engine then
scores all drafts (plus the last accepted token) in one verify call and
accepts the longest prefix the target model agrees with.

Three built-ins behind a string registry (``SpecConfig.proposer``):

* ``"self"``  — the target model drafts for itself with k sequential
  batched decode steps over the engine's own paged cache.  It costs what
  plain decoding costs plus the verify, so it is no speedup: it is the
  oracle that pins the verify / rollback / accounting machinery.
* ``"ngram"`` — suffix match over the request's own prompt + generation:
  the continuation of the most recent earlier occurrence of the trailing
  ``ngram`` tokens.  No weights, no device work.
* ``"draft"`` — a separate registry model with its own
  :class:`~repro_torch.serve.paged_cache.PagedCache`, sized by the same
  ``reservation_sizing``; it drafts with k sequential decode steps on that
  cache.  The draft cache mirrors the target's slot lifecycle: admit →
  alloc (the prompt + max_new reservation), accept → logical rollback of
  the synced length, retire → free.  A slot's context is prefilled lazily
  on its first spec tick, all behind slots together through the draft
  model's ``prefill_all`` (per-slot chunks on the gather backend).  With the
  target's weights the draft cache then holds the target cache's bits at
  every accepted position, on the card too: a row's arithmetic does not
  depend on the shape of the call that writes it (the paged kernel splits
  every call alike; ``tools/draft_sync_probe.py``).

Custom proposers: subclass :class:`Proposer` and decorate with
``@register_proposer("name")``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.serve.spec.config import SpecConfig

PROPOSERS: dict[str, type] = {}


def register_proposer(name: str):
    def deco(cls):
        PROPOSERS[name] = cls
        cls.name = name
        return cls
    return deco


def build_proposer(engine, spec: SpecConfig) -> "Proposer":
    if spec.proposer not in PROPOSERS:
        raise ValueError(f"unknown proposer {spec.proposer!r}; registered: {sorted(PROPOSERS)}")
    return PROPOSERS[spec.proposer](engine, spec)


class Proposer:
    """Base class: slot-lifecycle hooks + the propose call.

    ``propose`` returns an int32 ``[n_slots, k]`` array; only rows of
    decoding slots are read.  The engine calls ``on_admit`` when a request
    takes a slot, ``on_accept`` after each verify tick's acceptance (request
    still running) and ``on_retire`` when the slot is released."""

    def __init__(self, engine, spec: SpecConfig):
        self.engine, self.spec = engine, spec

    def on_admit(self, req) -> None:
        pass

    def on_accept(self, req) -> None:
        pass

    def on_retire(self, req) -> None:
        pass

    def propose(self, decoding: list) -> np.ndarray:
        raise NotImplementedError


def _draft_loop(engine, decoding, k, *, steps, pool, params, tables):
    """k sequential batched decode steps over ``pool`` → drafts [n_slots, k].
    Draft draws use each request's sampler at the token indices the verifier
    will re-draw, so a draft from equal logits is always accepted."""
    B = engine.config.n_slots
    drafts = np.zeros((B, k), np.int32)
    cur = np.zeros((B, 1), np.int32)
    pos = np.zeros((B,), np.int32)
    mask = np.zeros((B,), bool)
    for r in decoding:
        cur[r.slot, 0] = r.tokens[-1]
        pos[r.slot] = r.prompt_len + len(r.tokens) - 1
        mask[r.slot] = True
    tables_t, mask_t = engine._tensor(tables), engine._tensor(mask)
    for j in range(k):
        logits = steps.decode_all(params, engine._tensor(cur), engine._tensor(pos + j), pool,
                                  tables_t, mask_t)
        picks = torch.argmax(logits, dim=-1).tolist()
        for r in decoding:
            tok = engine._sample(r, logits[r.slot], len(r.tokens) + j, picks[r.slot])
            drafts[r.slot, j] = tok
            cur[r.slot, 0] = tok
    engine.telemetry.registry.counter("draft_decode_calls").inc(k)
    return drafts


@register_proposer("self")
class SelfProposer(Proposer):
    """Target-model self-drafting, the acceptance oracle.  Drafting writes
    KV at positions p0 .. p0+k-1 of the engine's own cache; the verify
    rewrites them before attending."""

    def propose(self, decoding):
        eng = self.engine
        return _draft_loop(eng, decoding, self.spec.k, steps=eng._steps, pool=eng.cache.pool,
                           params=eng.params, tables=eng.cache.tables)


@register_proposer("ngram")
class NGramProposer(Proposer):
    """Self-prompt speculation: the continuation of the most recent earlier
    occurrence of the trailing n-gram in the request's own history, or the
    last token repeated when there is none."""

    def propose(self, decoding):
        k = self.spec.k
        drafts = np.zeros((self.engine.config.n_slots, k), np.int32)
        for r in decoding:
            ctx = np.concatenate([r.prompt, np.asarray(r.tokens, np.int32)])
            drafts[r.slot] = self._match(ctx, self.spec.ngram, k)
        return drafts

    @staticmethod
    def _match(ctx: np.ndarray, n: int, k: int) -> np.ndarray:
        out = np.full((k,), ctx[-1], np.int32)
        T = len(ctx)
        n = min(n, T - 1)
        if n < 1:
            return out
        suffix = ctx[T - n:]
        for s in range(T - n - 1, -1, -1):  # most recent match wins
            if np.array_equal(ctx[s:s + n], suffix):
                cont = ctx[s + n:s + n + k]
                out[:len(cont)] = cont
                break
        return out


@register_proposer("draft")
class DraftModelProposer(Proposer):
    """A registry model drafts; it owns a full paged cache.

    Its weights come from the port's ``init_params`` at ``draft_seed``, on
    the engine's device, with the target's kernel routing.  ``synced[slot]``
    counts the context positions with valid KV in the draft cache; after
    each verify tick ``on_accept`` shrinks it to the target's accepted
    length, so rejected draft KV is rewritten before a later proposal can
    see it.  Pages are mapped once at admission and never beyond: draft
    writes past the budget go to the scratch page, as in the target cache."""

    def __init__(self, engine, spec):
        super().__init__(engine, spec)
        if spec.draft_arch is None:
            raise ValueError("SpecConfig.draft_arch is required for the 'draft' proposer")
        from repro_torch.configs import get_config, get_reduced_config
        from repro_torch.convert import init_params
        from repro_torch.models import build_model
        from repro_torch.serve.paged_cache import PagedCache, reservation_sizing
        from repro_torch.serve.steps import build_paged_steps

        dcfg = (get_reduced_config(spec.draft_arch) if spec.draft_reduced
                else get_config(spec.draft_arch))
        if dcfg.family != "dense":
            raise ValueError(f"draft model must be a dense family, got {dcfg.family!r}")
        dcfg = dataclasses.replace(dcfg, quartet=dataclasses.replace(
            dcfg.quartet, use_kernels=engine.model.cfg.quartet.use_kernels))
        self.model = build_model(dcfg)
        dev = engine.device
        self.params = init_params(dcfg, torch.Generator(device=dev).manual_seed(spec.draft_seed),
                                  dev)
        ecfg = engine.config
        pages_per_slot, n_pages = reservation_sizing(ecfg.n_slots, ecfg.max_len,
                                                     ecfg.page_size, spec.k)
        self.cache = PagedCache(dcfg, n_slots=ecfg.n_slots, pages_per_slot=pages_per_slot,
                                page_size=ecfg.page_size, n_pages=n_pages,
                                kv_dtype=spec.draft_kv_dtype, device=dev)
        self._steps = build_paged_steps(
            self.model, method=spec.draft_method, page_size=ecfg.page_size,
            decode_backend="paged" if dcfg.attn_backend == "paged" else "gather")
        self.synced = np.zeros((ecfg.n_slots,), np.int64)

    # -- slot lifecycle (mirrors the target cache) --------------------------

    def on_admit(self, req):
        self.cache.alloc(req.slot, req.prompt_len + req.max_new)
        self.synced[req.slot] = 0

    def on_accept(self, req):
        logical = req.prompt_len + len(req.tokens) - 1
        self.synced[req.slot] = min(int(self.synced[req.slot]), logical)

    def on_retire(self, req):
        self.cache.free(req.slot)
        self.synced[req.slot] = 0

    # -- drafting -----------------------------------------------------------

    def _sync_all(self, decoding) -> None:
        """Catch every behind slot's draft cache up to its context minus its
        last token (which the draft loop feeds itself): one ``prefill_all``
        call per chunk advances all behind slots together."""
        from repro_torch.serve.steps import marshal_prefill_batch

        eng = self.engine
        targets = {r.slot: r.prompt_len + len(r.tokens) - 1 for r in decoding}
        behind = [r for r in decoding if int(self.synced[r.slot]) < targets[r.slot]]
        if not behind:
            return
        ctxs = {r.slot: np.concatenate([r.prompt, np.asarray(r.tokens, np.int32)])
                for r in behind}
        C, B = eng.config.prefill_chunk, eng.config.n_slots
        if self._steps.prefill_all is None:  # gather backend: per-slot chunks
            for r in behind:
                table_row = eng._tensor(self.cache.tables[r.slot])
                have, p0 = int(self.synced[r.slot]), targets[r.slot]
                while have < p0:
                    step = C if p0 - have >= C else 1
                    toks = eng._tensor(ctxs[r.slot][None, have:have + step])
                    self._steps.prefill_chunk(self.params, toks, have, table_row,
                                              self.cache.pool)
                    eng.telemetry.registry.counter("draft_prefill_calls").inc()
                    have += step
                self.synced[r.slot] = have
            return
        while True:
            items = []
            for r in behind:
                have, p0 = int(self.synced[r.slot]), targets[r.slot]
                if have < p0:
                    items.append((r.slot, have, ctxs[r.slot][have:have + min(C, p0 - have)]))
            if not items:
                return
            tokens, start, n_valid, mask = marshal_prefill_batch(B, C, items)
            self._steps.prefill_all(self.params, eng._tensor(tokens), eng._tensor(start),
                                    eng._tensor(n_valid), self.cache.pool,
                                    eng._tensor(self.cache.tables), eng._tensor(mask))
            eng.telemetry.registry.counter("draft_prefill_calls").inc()
            for r in behind:
                self.synced[r.slot] = min(self.synced[r.slot] + n_valid[r.slot],
                                          targets[r.slot])

    def propose(self, decoding):
        k = self.spec.k
        self._sync_all(decoding)
        drafts = _draft_loop(self.engine, decoding, k, steps=self._steps, pool=self.cache.pool,
                             params=self.params, tables=self.cache.tables)
        for r in decoding:  # the draft loop fed k tokens from p0 onward
            self.synced[r.slot] = r.prompt_len + len(r.tokens) - 1 + k
        return drafts
