"""Continuous-batching inference engine over the paged MXFP4 KV pool.

Port of ``repro.serve.engine`` for the dense and MoE families.  ``Engine``
multiplexes requests over a fixed set of decode slots:

* ``submit(prompt, max_new, sampling=...) -> Request`` queues work
  (``.tokens`` fills in as the engine runs);
* ``step()`` admits queued requests into free slots (reserving pages for
  prompt + max_new), advances the prefilling slots, then steps every
  decoding slot in one batched call (or, with speculation, drafts,
  verifies and accepts);
* ``drain()`` steps until nothing is queued or active.

``EngineConfig.decode_backend`` picks the steps.  ``"paged"`` (the default
for a model whose ``attn_backend`` is ``"paged"``) advances every
prefilling slot by one chunk in one batched call, and its steps attend
directly over the pool through the paged-attention kernel.  ``"gather"``
(the reference's parity oracle, the default for other models) advances each
prefilling slot on its own, one ``[1, C]`` chunk or all of its ``[1, 1]``
remainder tokens per tick, and its steps gather-dequantize the pool into
dense caches and scatter the new tokens back.  Quantize-on-write happens
once per token on both.

**Sampling** is per request (:class:`~repro_torch.serve.sampling.
SamplingParams`): greedy argmax by default, temperature / top-k / top-p
draws with stateless per-token keys.  :meth:`Engine._sample` is the one
call site for prefill, decode, drafting and verification.

**Prefix sharing** (``EngineConfig(prefix_cache=True)``): admission matches
the prompt against a radix index of full pages
(:class:`~repro_torch.serve.prefix_cache.PrefixIndex`), aliases every
matched page into the slot's table (refcounted) and prefills only the
tail; a page is copied before a slot writes into a shared one, and cached
prefixes are LRU-evicted when admission needs their pages.

**Speculative decoding** (``EngineConfig(spec=SpecConfig(...))``): each
decode tick becomes draft → verify → accept.  A proposer
(``serve.spec.proposers``) drafts ``k`` tokens per slot; one verify call
scores all ``k + 1`` tokens per slot; the host accepts the longest draft
prefix that the target's own draws reproduce and emits 1..k+1 tokens.
Rollback is logical: the slot's length shrinks on the host and the pages
stay mapped within the admission reservation; draft positions past the
budget write to the scratch page.

The reference keeps its prefix and speculation counts in a telemetry
registry; until telemetry is ported the engine keeps the same names in the
plain dict ``Engine.counters``.  The state pool (other families) and
multi-device serving are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models.registry import Model
from repro_torch.serve import paged_cache as P
from repro_torch.serve.prefix_cache import PrefixIndex
from repro_torch.serve.sampling import GREEDY, SamplingParams, get_sampler
from repro_torch.serve.scheduler import Request, RequestState, Scheduler
from repro_torch.serve.spec.config import SpecConfig
from repro_torch.serve.spec.proposers import build_proposer
from repro_torch.serve.spec.verify import accept_tokens
from repro_torch.serve.steps import build_paged_steps, marshal_prefill_batch

PAGED_FAMILIES = ("dense", "moe")
COUNTERS = ("prefix_lookups", "prefix_hit_requests", "prefix_shared_tokens",
            "prefix_inserted_pages", "prefix_evicted_pages", "prefix_cow_pages",
            "spec_acceptance_rate")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 4
    max_len: int = 128  # per-slot token capacity (prompt + generation)
    page_size: int = 16
    kv_dtype: str = "mxfp4"  # "mxfp4" | "dense"
    prefill_chunk: int = 16
    method: str = "quartet"
    eos_id: int | None = None
    keep_logits: bool = False  # record per-step logits on each Request (tests)
    # None follows ModelConfig.attn_backend ("paged" for a paged model, else
    # "gather"); "paged" attends over the pool; "gather" is the dense oracle
    decode_backend: str | None = None
    # pool size (pages incl. the scratch page); None → one full reservation
    # (ceil(max_len / page_size) pages) per slot + scratch
    n_pages: int | None = None
    # radix-index prompt prefixes, alias cached full pages into new slots
    # (refcounted, copy-on-write), prefill only the tail, LRU-evict under
    # pool pressure
    prefix_cache: bool = False
    # run PagedCache.check_invariants after every allocator mutation
    debug_cache: bool = False
    # speculative decoding; None → plain decode
    spec: SpecConfig | None = None


class Engine:
    def __init__(self, model: Model, params: dict, config: EngineConfig | None = None):
        self.config = cfg = config or EngineConfig()
        family = model.cfg.family
        if cfg.spec is not None and family not in PAGED_FAMILIES:
            raise ValueError(
                f"speculative decoding needs a paged family (dense/moe): {family!r} serving "
                f"has no multi-token verify step")
        if cfg.prefix_cache and family not in PAGED_FAMILIES:
            raise ValueError(
                f"prefix caching needs shareable pages (a paged family, dense/moe); "
                f"{family!r} has none")
        if family not in PAGED_FAMILIES:
            raise NotImplementedError(
                f"serving family {family!r} is not ported yet (the state-pool families are "
                f"ROADMAP A7)")
        self.model, self.params = model, params
        self.spec = cfg.spec
        self.device = params["embed"]["table"].device
        self.sched = Scheduler(cfg.n_slots, cfg.max_len, cfg.prefill_chunk)
        self.completed: list[Request] = []
        self.steps = 0
        self.counters = dict.fromkeys(COUNTERS, 0)
        pages_per_slot, n_pages = P.reservation_sizing(
            cfg.n_slots, cfg.max_len, cfg.page_size, self.spec.k if self.spec else 0)
        if cfg.n_pages is not None:
            # a pool that cannot hold one maximal reservation would wedge
            # admission forever instead of raising
            min_pages = 1 + (-(-cfg.max_len // cfg.page_size))
            if cfg.n_pages < min_pages:
                raise ValueError(f"n_pages={cfg.n_pages} cannot hold one max_len={cfg.max_len} "
                                 f"reservation plus the scratch page (need >= {min_pages})")
            n_pages = cfg.n_pages
        self.cache = P.PagedCache(model.cfg, n_slots=cfg.n_slots,
                                  pages_per_slot=pages_per_slot, page_size=cfg.page_size,
                                  n_pages=n_pages, kv_dtype=cfg.kv_dtype,
                                  device=self.device, debug=cfg.debug_cache)
        self.decode_backend = cfg.decode_backend or (
            "paged" if model.cfg.attn_backend == "paged" else "gather")
        self._steps = build_paged_steps(model, method=cfg.method, page_size=cfg.page_size,
                                        decode_backend=self.decode_backend)
        self.prefix = PrefixIndex(cfg.page_size) if cfg.prefix_cache else None
        self._admit_plan: dict[int, list[int]] = {}  # rid -> matched page ids
        self.proposer = build_proposer(self, self.spec) if self.spec is not None else None

    # ------------------------------------------------------------------ API

    def submit(self, prompt, max_new: int, arrival_time: float | None = None,
               sampling: SamplingParams | None = None) -> Request:
        now = time.monotonic() if arrival_time is None else arrival_time
        return self.sched.submit(prompt, max_new, arrival_time=now, sampling=sampling)

    @torch.inference_mode()
    def step(self, now: float | None = None) -> dict:
        """One scheduler tick: admit → chunked prefill (batched on the paged
        backend, per slot on the gather backend) → batched decode (or draft,
        verify and accept) → retire.  Returns counts for the caller's loop."""
        now = time.monotonic() if now is None else now

        def can_admit(req: Request) -> bool:
            total = req.prompt_len + req.max_new
            if self.prefix is None:
                return self.cache.can_alloc(total)
            match = self.prefix.match(req.prompt, now)
            ok = self._fresh_pages_needed(req, match) <= (
                self.cache.free_pages + self.prefix.evictable_pages(self.cache, exclude=match))
            if ok:
                self._admit_plan[req.rid] = match
            return ok

        admitted = self.sched.admit(can_admit, on_admit=lambda req: self._on_admit(req, now))
        if self.proposer is not None:
            for req in admitted:
                self.proposer.on_admit(req)
        if self._steps.prefill_all is not None:
            batch = self.sched.prefill_batch()
            if batch:
                self._prefill_tick(batch, now)
        else:
            for req in self.sched.prefilling():
                self._advance_prefill(req, now)
        decoding = self.sched.decoding()
        if decoding:
            if self.spec is not None:
                self._spec_tick(decoding, now)
            else:
                self._decode_tick(decoding, now)
        self.steps += 1
        return {"admitted": len(admitted), "prefilling": len(self.sched.prefilling()),
                "decoding": len(self.sched.decoding()),
                "queued": len(self.sched.queue), "step": self.steps}

    def drain(self, max_steps: int = 100_000) -> list[Request]:
        """Step until every submitted request has finished."""
        while self.sched.pending:
            self.step()
            if self.steps > max_steps:
                raise RuntimeError("drain exceeded max_steps — engine wedged?")
        return self.completed

    def cache_bytes(self) -> int:
        return self.cache.cache_bytes()

    # ------------------------------------------------------------- internals

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _sample(self, req: Request, logits_row: torch.Tensor, token_idx: int,
                argmax: int | None = None) -> int:
        """One token draw for ``req`` — greedy argmax (``argmax`` when the
        caller already has it) unless the request set ``SamplingParams`` —
        for prefill, decode, drafting and verification, keyed by the
        generated-token index."""
        sp = req.sampling if req.sampling is not None else GREEDY
        if sp.greedy:
            return int(torch.argmax(logits_row)) if argmax is None else argmax
        return get_sampler(sp)(logits_row, token_idx)

    def _emit(self, req: Request, logits_row: torch.Tensor, token: int) -> None:
        if self.config.keep_logits:
            req.logits_trace.append(logits_row.float().cpu().numpy())
        req.tokens.append(token)

    # -- prefix sharing ------------------------------------------------------

    def _fresh_pages_needed(self, req: Request, match: list[int]) -> int:
        """Free-list pages this admission needs beyond the aliased prefix
        ``match``: the reservation's uncovered tail, plus one copy-on-write
        target when the hit covers the whole prompt (the last prompt token
        is then prefilled again into the shared tail page)."""
        need = self.cache.pages_needed(req.prompt_len + req.max_new)
        full = len(match) * self.config.page_size == req.prompt_len
        return need - len(match) + (1 if full else 0)

    def _on_admit(self, req: Request, now: float) -> None:
        """The cache side of one admission, run inside ``Scheduler.admit``
        before the next head is judged: page allocation, prefix aliasing,
        eviction, and the full-hit copy-on-write."""
        total = req.prompt_len + req.max_new
        if self.prefix is None:
            self.cache.alloc(req.slot, total)
            return
        c = self.counters
        match = self._admit_plan.pop(req.rid, [])
        shortfall = self._fresh_pages_needed(req, match) - self.cache.free_pages
        if shortfall > 0:
            c["prefix_evicted_pages"] += self.prefix.evict(self.cache, shortfall, exclude=match)
        self.cache.alloc(req.slot, total, shared=match)
        c["prefix_lookups"] += 1
        if not match:
            return
        c["prefix_hit_requests"] += 1
        covered = len(match) * self.config.page_size
        if covered == req.prompt_len:
            # full-prefix hit: only the last prompt token is prefilled again
            # (its logits give the first token); it rewrites, with the same
            # bits, into the last shared page, which is detached now
            req.prefill_pos = req.prompt_len - 1
            c["prefix_cow_pages"] += self.cache.cow_range(req.slot, req.prefill_pos, 1)
            covered -= 1
        else:
            req.prefill_pos = covered
        c["prefix_shared_tokens"] += covered

    def _cow_guard(self, spans) -> None:
        """Before a write phase, detach every still-shared page in each
        ``(slot, start_tok, n_tokens)`` span about to be written.  Normally a
        no-op: slots write past their aliased prefix, and the full-hit case
        is copied at admission."""
        if self.prefix is None:
            return
        for slot, start, n in spans:
            self.counters["prefix_cow_pages"] += self.cache.cow_range(slot, start, n)

    def _prefix_insert(self, req: Request, tokens: np.ndarray, now: float) -> None:
        """Publish ``req``'s fully written pages under the token chain
        ``tokens`` (partial tail pages are never published)."""
        if self.prefix is None:
            return
        self.counters["prefix_inserted_pages"] += self.prefix.insert(
            self.cache, tokens, self.cache.tables[req.slot], now)

    # -- prefill -------------------------------------------------------------

    def _first_token(self, req: Request, logits_row: torch.Tensor, now: float,
                     argmax: int | None = None) -> None:
        self._emit(req, logits_row, self._sample(req, logits_row, 0, argmax))
        req.first_token_time = now
        req.state = RequestState.DECODE
        self._prefix_insert(req, req.prompt, now)
        self._maybe_finish(req, now)

    def _prefill_tick(self, batch, now: float) -> None:
        """Advance every prefilling slot by one chunk in one call; slots that
        consumed their whole prompt take their first token."""
        self._cow_guard([(req.slot, pos, n) for req, pos, n in batch])
        tokens, start, n_valid, mask = marshal_prefill_batch(
            self.config.n_slots, self.config.prefill_chunk,
            ((req.slot, pos, req.prompt[pos:pos + n]) for req, pos, n in batch))
        logits = self._steps.prefill_all(
            self.params, self._tensor(tokens), self._tensor(start), self._tensor(n_valid),
            self.cache.pool, self._tensor(self.cache.tables), self._tensor(mask))
        picks = torch.argmax(logits, dim=-1).tolist()  # first maximum wins
        for req, pos, n in batch:
            req.prefill_pos = pos + n
            if req.prefill_pos == req.prompt_len:
                self._first_token(req, logits[req.slot], now, picks[req.slot])

    def _advance_prefill(self, req: Request, now: float) -> None:
        """Per-slot prefill (gather backend): one ``[1, C]`` chunk, or, when
        fewer than C prompt tokens remain, every one of them as a ``[1, 1]``
        call, never padded."""
        C = self.config.prefill_chunk
        remaining = req.prompt_len - req.prefill_pos
        calls = [C] if remaining >= C else [1] * remaining
        for n in calls:
            self._cow_guard([(req.slot, req.prefill_pos, n)])
            tokens = self._tensor(req.prompt[None, req.prefill_pos:req.prefill_pos + n])
            logits = self._steps.prefill_chunk(
                self.params, tokens, req.prefill_pos,
                self._tensor(self.cache.tables[req.slot]), self.cache.pool)
            req.prefill_pos += n
        if req.prefill_pos == req.prompt_len:
            self._first_token(req, logits[0], now)

    # -- decode --------------------------------------------------------------

    def _decode_tick(self, decoding: list[Request], now: float) -> None:
        B = self.config.n_slots
        tokens = np.zeros((B, 1), np.int32)
        positions = np.zeros((B,), np.int32)
        mask = np.zeros((B,), bool)
        for req in decoding:
            tokens[req.slot, 0] = req.tokens[-1]
            positions[req.slot] = req.prompt_len + len(req.tokens) - 1
            mask[req.slot] = True
        self._cow_guard([(r.slot, int(positions[r.slot]), 1) for r in decoding])
        logits = self._steps.decode_all(
            self.params, self._tensor(tokens), self._tensor(positions), self.cache.pool,
            self._tensor(self.cache.tables), self._tensor(mask))
        picks = torch.argmax(logits, dim=-1).tolist()
        for req in decoding:
            row = logits[req.slot]
            self._emit(req, row, self._sample(req, row, len(req.tokens), picks[req.slot]))
            req.decode_calls += 1
            self._maybe_finish(req, now)

    def _spec_tick(self, decoding: list[Request], now: float) -> None:
        """Draft → one batched verify → accept / roll back.

        A slot with last accepted token t at position p0 and drafts d1..dk
        feeds [t, d1..dk] at positions p0..p0+k (writing all k + 1 tokens'
        KV before attending) and gets k + 1 logit rows; row i is the
        target's distribution after token i.  No page is mapped for the
        burst: positions past the reservation fall on unmapped table columns
        and write to the scratch page, and every row whose draw can be
        emitted attends only to reserved, written positions.  Rollback is
        logical: the slot's length shrinks on the host."""
        k = self.spec.k
        B = self.config.n_slots
        eos = self.config.eos_id
        drafts = self.proposer.propose(decoding)  # [n_slots, k] int32
        tokens = np.zeros((B, k + 1), np.int32)
        start = np.zeros((B,), np.int32)
        mask = np.zeros((B,), bool)
        for req in decoding:
            tokens[req.slot, 0] = req.tokens[-1]
            tokens[req.slot, 1:] = drafts[req.slot]
            start[req.slot] = req.prompt_len + len(req.tokens) - 1
            mask[req.slot] = True
        self._cow_guard([(r.slot, int(start[r.slot]), k + 1) for r in decoding])
        logits = self._steps.verify_all(
            self.params, self._tensor(tokens), self._tensor(start), self.cache.pool,
            self._tensor(self.cache.tables), self._tensor(mask))
        picks = torch.argmax(logits, dim=-1).tolist()  # [B][k + 1]
        for req in decoding:
            base = len(req.tokens)
            target = [self._sample(req, logits[req.slot, i], base + i, picks[req.slot][i])
                      for i in range(k + 1)]
            n_acc, emitted = accept_tokens(drafts[req.slot].tolist(), target)
            req.decode_calls += 1
            n_emit, stopped = 0, False
            for i, tok in enumerate(emitted):
                self._emit(req, logits[req.slot, i], tok)
                n_emit += 1
                if (eos is not None and tok == eos) or len(req.tokens) >= req.max_new:
                    stopped = True
                    break  # emission stops at EOS / budget even mid-burst
            # only drafts at emittable positions count: a burst cut by EOS or
            # the budget counts the drafts it could have emitted, a burst
            # ended by a rejection counts all k
            proposed = min(n_emit if stopped else k, k)
            req.draft_proposed += proposed
            req.draft_accepted += min(n_acc, proposed)
            self._maybe_finish(req, now)
            if not req.done:
                self.proposer.on_accept(req)
        reqs = self.completed + list(self.sched.active.values())
        proposed = sum(r.draft_proposed for r in reqs)
        if proposed:
            self.counters["spec_acceptance_rate"] = (
                sum(r.draft_accepted for r in reqs) / proposed)

    def _maybe_finish(self, req: Request, now: float) -> None:
        eos = self.config.eos_id
        if eos is not None and req.tokens[-1] == eos:
            reason = "eos"
        elif len(req.tokens) >= req.max_new:
            reason = "max_tokens"
        else:
            return
        self.sched.retire(req, reason, now)
        if self.prefix is not None:
            # publish the whole conversation before the slot is released; the
            # final token was emitted but never consumed, so its KV was never
            # written and it is left out
            chain = np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int32)])
            self._prefix_insert(req, chain, now)
        self.cache.free(req.slot)
        if self.proposer is not None:
            self.proposer.on_retire(req)
        self.completed.append(req)
