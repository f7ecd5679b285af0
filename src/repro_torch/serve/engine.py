"""Continuous-batching inference engine over the paged MXFP4 KV pool.

Port of ``repro.serve.engine``.  ``Engine`` multiplexes requests over a
fixed set of decode slots:

* ``submit(prompt, max_new, extra=..., sampling=...) -> Request`` queues
  work (``.tokens`` fills in as the engine runs; ``extra`` holds an
  enc-dec request's ``source_embeds``, a VLM request's ``image_embeds``);
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

**The state pool** (the SSM, hybrid, enc-dec and VLM families):
``decode_backend=None`` or ``"statepool"`` keeps each slot's recurrent
state in the quantized double-buffer rings of
:class:`~repro_torch.serve.state_pool.StatePool`, the hybrid's attention KV
and the enc-dec and VLM families' self-attention KV in its paged KV plane
(admission reserves prompt + max_new positions there), and their
cross-attention KV in its cross plane, encoded once at admission;
``"dense_slots"`` keeps per-slot dense caches
(:class:`~repro_torch.serve.paged_cache.DenseSlotCache`), the parity
oracle.  Both prefill one slot at a time, one ``[1, C]`` chunk or all of
its ``[1, 1]`` remainder tokens per tick: a recurrence must never consume a
padding token.  Speculation needs a paged family and raises for these
backends.  The prefix cache does too, but for the enc-dec and VLM families
on ``statepool``, where it turns on cross-KV sharing: requests whose
conditioning is byte-identical alias one encoded set of cross pages
(:class:`~repro_torch.serve.state_pool.CrossIndex`) and skip the encode;
warm is token-exact against cold, both reading the same pages.

**Telemetry** (``EngineConfig(telemetry=TelemetryConfig(...))``, see
:mod:`repro_torch.serve.telemetry`): every engine carries an
:class:`~repro_torch.serve.telemetry.EngineTelemetry` hub, as the
reference's does.  Its registry holds the counters (requests, tokens, step
calls, prefix and speculation counts), the scheduler and pool gauges and
the latency histograms; its tracer derives TTFT, TPOT, queue wait and
latency from each request's spans; each tick's prefill, decode and verify
sections are timed on the host clock (``*_tick_s``), and the tick ends in
``end_tick``.  Read a count as ``engine.telemetry.registry.counter(name)
.value``.  The default configuration adds no device synchronisation to a
tick; sinks, pool-health sampling and the profiler are opt-in.
Multi-device serving is not ported yet.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models.registry import Model, cache_map
from repro_torch.serve import paged_cache as P
from repro_torch.serve.prefix_cache import PrefixIndex
from repro_torch.serve.sampling import GREEDY, SamplingParams, get_sampler
from repro_torch.serve.scheduler import Request, RequestState, Scheduler
from repro_torch.serve.spec.config import SpecConfig
from repro_torch.serve.spec.proposers import build_proposer
from repro_torch.serve.spec.verify import accept_tokens
from repro_torch.serve.state_pool import StatePool, cross_key
from repro_torch.serve.steps import (Step, build_paged_steps, build_state_steps,
                                     marshal_prefill_batch, n_signatures)
from repro_torch.serve.telemetry import EngineTelemetry, TelemetryConfig
from repro_torch.train.serve import make_chunk_prefill_step, make_decode_step

PAGED_FAMILIES = ("dense", "moe")
# the conditioning a state-pool cross family encodes at admission
EMBED_KEY = {"encdec": "source_embeds", "vlm": "image_embeds"}


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
    # paged families: None follows ModelConfig.attn_backend ("paged" for a
    # paged model, else "gather"); "paged" attends over the pool; "gather" is
    # the dense oracle.  State families (ssm, hybrid, encdec, vlm): None or
    # "statepool" (the quantized state rings, KV plane and cross plane),
    # "dense_slots" (per-slot dense caches, the oracle)
    decode_backend: str | None = None
    # pool size (pages incl. the scratch page); None → one full reservation
    # (ceil(max_len / page_size) pages) per slot + scratch
    n_pages: int | None = None
    # radix-index prompt prefixes, alias cached full pages into new slots
    # (refcounted, copy-on-write), prefill only the tail, LRU-evict under
    # pool pressure; on a state-pool enc-dec or VLM engine, alias the cross
    # pages of byte-identical conditioning instead and skip its encode
    prefix_cache: bool = False
    # run PagedCache.check_invariants after every allocator mutation
    debug_cache: bool = False
    # speculative decoding; None → plain decode
    spec: SpecConfig | None = None
    # observability (serve.telemetry).  None → metrics and tracing still
    # collected in memory (host dicts, no sinks, no device sampling); a
    # TelemetryConfig streams JSONL metrics and traces, writes Prometheus
    # text, samples pool quantization health at a tick stride, or profiles
    telemetry: TelemetryConfig | None = None


class Engine:
    def __init__(self, model: Model, params: dict, config: EngineConfig | None = None):
        self.config = cfg = config or EngineConfig()
        family = model.cfg.family
        self.paged = family in PAGED_FAMILIES
        if self.paged:
            self.backend = "paged"
        elif cfg.decode_backend in (None, "statepool"):
            self.backend = "statepool"
        elif cfg.decode_backend == "dense_slots":
            self.backend = "dense_slots"
        else:
            raise ValueError(f"decode_backend for {family!r} must be 'statepool' (default) or "
                             f"'dense_slots' (parity oracle), got {cfg.decode_backend!r}")
        if cfg.spec is not None and not self.paged:
            raise ValueError(
                f"speculative decoding needs a paged family (dense/moe): {family!r} serving "
                f"has no multi-token verify step (a recurrence scores one token per state "
                f"transition, and the state rings hold no history to roll back)")
        if cfg.prefix_cache and not self.paged and (self.backend != "statepool"
                                                    or family not in EMBED_KEY):
            raise ValueError(
                f"prefix caching needs shareable pages: a paged family (dense/moe, prompt "
                f"prefixes) or a statepool enc-dec/VLM engine (cross-KV sharing); "
                f"{family!r} on {self.backend!r} has neither")
        self.model, self.params = model, params
        self.spec = cfg.spec
        self.device = params["embed"]["table"].device
        self.telemetry = EngineTelemetry(cfg.telemetry)
        self.sched = Scheduler(cfg.n_slots, cfg.max_len, cfg.prefill_chunk,
                               tracer=self.telemetry.tracer)
        self.completed: list[Request] = []
        self.steps = 0
        self.prefix = self.proposer = None
        self.cross_share = False  # cross-KV sharing (a statepool cross family's prefix cache)
        self._cross_keys: dict[int, str | None] = {}  # rid -> conditioning's content key
        self._cross_plan: dict[int, list[int]] = {}  # rid -> matched cross pages
        if self.paged:
            self._init_paged_backend(model, cfg)
        else:
            self._init_state_backend(model, cfg)
        self.telemetry.attach(self)

    def _init_paged_backend(self, model: Model, cfg: EngineConfig) -> None:
        """The paged pool, its steps, the prefix index and the proposer."""
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

    def _init_state_backend(self, model: Model, cfg: EngineConfig) -> None:
        """The state pool's rings and their steps, or the dense-slot oracle's
        caches and the unmodified ``train.serve`` steps."""
        self.decode_backend = self.backend
        self._steps = None
        if self.backend == "statepool":
            self.cache = StatePool(model, n_slots=cfg.n_slots, max_len=cfg.max_len,
                                   page_size=cfg.page_size, kv_dtype=cfg.kv_dtype,
                                   device=self.device, debug=cfg.debug_cache)
            self._state_steps = build_state_steps(model, method=cfg.method, pool=self.cache)
            self.cross_share = cfg.prefix_cache and self.cache.cross is not None
            return
        self.cache = P.DenseSlotCache(model, n_slots=cfg.n_slots, max_len=cfg.max_len,
                                      device=self.device)
        self._dense_decode = Step("decode_all", make_decode_step(model, method=cfg.method))
        self._dense_chunk = Step("prefill_chunk", make_chunk_prefill_step(model, method=cfg.method))

    # ------------------------------------------------------------------ API

    def submit(self, prompt, max_new: int, extra: dict | None = None,
               arrival_time: float | None = None,
               sampling: SamplingParams | None = None) -> Request:
        """Queue a request.  ``extra`` holds its conditioning tensors (moved
        to the engine's device); a statepool enc-dec or VLM engine encodes
        them at admission, so there they must come with the request."""
        now = time.monotonic() if arrival_time is None else arrival_time
        embed = EMBED_KEY.get(self.model.cfg.family)
        if self.backend == "statepool" and embed is not None and (
                extra is None or extra.get(embed) is None):
            raise ValueError(f"statepool {self.model.cfg.family!r} serving encodes the cross-KV "
                             f"once at admission: submit() needs extra[{embed!r}]")
        key = cross_key(extra) if self.cross_share else None  # hashed once, on the host
        if extra is not None:
            extra = {k: None if v is None else torch.as_tensor(v).to(self.device)
                     for k, v in extra.items()}
        req = self.sched.submit(prompt, max_new, extra=extra, arrival_time=now,
                                sampling=sampling)
        if self.cross_share:
            self._cross_keys[req.rid] = key
        self.telemetry.registry.counter("requests_submitted").inc()
        return req

    @torch.inference_mode()
    def step(self, now: float | None = None) -> dict:
        """One scheduler tick: admit → chunked prefill (batched on the paged
        backend, per slot on the gather backend) → batched decode (or draft,
        verify and accept) → retire.  Returns counts for the caller's loop.
        Each section is timed on the host clock for the telemetry; a section
        ends at the host read of its logits where it has one (see
        ``serve.telemetry``)."""
        now = time.monotonic() if now is None else now
        reg = self.telemetry.registry
        t_tick = time.perf_counter()

        def can_admit(req: Request) -> bool:
            total = req.prompt_len + req.max_new
            if self.backend == "statepool":
                match = self.cache.cross_match(self._cross_keys.get(req.rid), now)
                ok = self.cache.can_admit(total, cross_shared=bool(match))
                if ok and match:
                    self._cross_plan[req.rid] = match
                return ok
            if self.backend == "dense_slots":  # mapped statically
                return True
            if self.prefix is None:
                return self.cache.can_alloc(total)
            match = self.prefix.match(req.prompt, now)
            ok = self._fresh_pages_needed(req, match) <= (
                self.cache.free_pages + self.prefix.evictable_pages(self.cache, exclude=match))
            if ok:
                self._admit_plan[req.rid] = match
            return ok

        admitted = self.sched.admit(can_admit, on_admit=lambda req: self._on_admit(req, now))
        for req in admitted:
            if self.proposer is not None:
                self.proposer.on_admit(req)
            self.telemetry.tracer.event(req.rid, "admit", now)
        reg.counter("requests_admitted").inc(len(admitted))
        if self.sched.queue and self.sched.free_slots:
            # a slot is free but the FIFO head did not fit: page pressure
            reg.counter("admission_blocked_pages").inc()

        t0 = time.perf_counter()
        did_prefill = False
        if self._steps is not None and self._steps.prefill_all is not None:
            batch = self.sched.prefill_batch()
            if batch:
                self._prefill_tick(batch, now)
                did_prefill = True
        else:
            for req in self.sched.prefilling():
                self._advance_prefill(req, now)
                did_prefill = True
        if did_prefill:
            self.telemetry.phase("prefill", now, t_tick, t0, time.perf_counter())
        decoding = self.sched.decoding()
        if decoding:
            t0 = time.perf_counter()
            if self.spec is not None:
                self._spec_tick(decoding, now)
                self.telemetry.phase("verify", now, t_tick, t0, time.perf_counter())
            else:
                self._decode_tick(decoding, now)
                self.telemetry.phase("decode", now, t_tick, t0, time.perf_counter())
        self.steps += 1
        self.telemetry.end_tick(self, now, time.perf_counter() - t_tick)
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

    def compile_counts(self) -> dict[str, int]:
        """Distinct operand-shape signatures per step (the reference's
        compiled variants; the telemetry's ``jit_compiled_*`` gauges)."""
        if self.backend == "paged":
            return self._steps.compile_counts()
        if self.backend == "statepool":
            return self._state_steps.compile_counts()
        return {"decode_all": n_signatures(self._dense_decode),
                "prefill_chunk": n_signatures(self._dense_chunk), "verify_all": 0,
                "prefill_all": 0}

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
        eviction, and the full-hit copy-on-write.  A dense slot is zeroed; a
        state-pool slot's ring cursor is reset."""
        total = req.prompt_len + req.max_new
        if self.backend == "dense_slots":
            self.cache.reset_slot(req.slot)
            return
        if self.backend == "statepool":
            self._state_admit(req, total, now)
            return
        if self.prefix is None:
            self.cache.alloc(req.slot, total)
            return
        c = self.telemetry.registry.counter
        match = self._admit_plan.pop(req.rid, [])
        shortfall = self._fresh_pages_needed(req, match) - self.cache.free_pages
        if shortfall > 0:
            c("prefix_evicted_pages").inc(self.prefix.evict(self.cache, shortfall, exclude=match))
        self.cache.alloc(req.slot, total, shared=match)
        c("prefix_lookups").inc()
        if not match:
            return
        c("prefix_hit_requests").inc()
        covered = len(match) * self.config.page_size
        if covered == req.prompt_len:
            # full-prefix hit: only the last prompt token is prefilled again
            # (its logits give the first token); it rewrites, with the same
            # bits, into the last shared page, which is detached now
            req.prefill_pos = req.prompt_len - 1
            c("prefix_cow_pages").inc(self.cache.cow_range(req.slot, req.prefill_pos, 1))
            covered -= 1
        else:
            req.prefill_pos = covered
        c("prefix_shared_tokens").inc(covered)

    def _state_admit(self, req: Request, total: int, now: float) -> None:
        """A state-pool admission: the planes' pages, and for a cross family
        the request's cross-KV, aliased from the cross index (warm: no
        encode) or encoded once into its cross pages (cold), then
        published when sharing is on."""
        c = self.telemetry.registry.counter
        match, key = self._cross_plan.pop(req.rid, []), self._cross_keys.pop(req.rid, None)
        self.cache.alloc(req.slot, total, cross_shared=match)
        if self.cache.cross is None:
            return
        if self.cross_share:
            c("prefix_lookups").inc()
        if match:
            c("prefix_hit_requests").inc()
            c("prefix_shared_tokens").inc(self.cache.cross_tokens)
            return
        embeds = req.extra[EMBED_KEY[self.model.cfg.family]]
        self._state_steps.encode_cross(self.params, embeds,
                                       self._tensor(self.cache.cross.tables[req.slot]))
        c("cross_encode_calls").inc()
        if self.cross_share:
            c("prefix_inserted_pages").inc(self.cache.cross_publish(key, req.slot, now))

    def _cow_guard(self, spans) -> None:
        """Before a write phase, detach every still-shared page in each
        ``(slot, start_tok, n_tokens)`` span about to be written.  Normally a
        no-op: slots write past their aliased prefix, and the full-hit case
        is copied at admission."""
        if self.prefix is None:
            return
        cow = self.telemetry.registry.counter("prefix_cow_pages")
        for slot, start, n in spans:
            cow.inc(self.cache.cow_range(slot, start, n))

    def _prefix_insert(self, req: Request, tokens: np.ndarray, now: float) -> None:
        """Publish ``req``'s fully written pages under the token chain
        ``tokens`` (partial tail pages are never published)."""
        if self.prefix is None:
            return
        self.telemetry.registry.counter("prefix_inserted_pages").inc(self.prefix.insert(
            self.cache, tokens, self.cache.tables[req.slot], now))

    # -- prefill -------------------------------------------------------------

    def _first_token(self, req: Request, logits_row: torch.Tensor, now: float,
                     argmax: int | None = None) -> None:
        self._emit(req, logits_row, self._sample(req, logits_row, 0, argmax))
        req.first_token_time = now
        req.state = RequestState.DECODE
        self._prefix_insert(req, req.prompt, now)
        # the first token rides on a prefill call: it counts toward
        # tokens_generated, not decode_tokens
        self.telemetry.tracer.event(req.rid, "first_token", now)
        self.telemetry.tracer.tokens(req.rid, now, 1)
        self.telemetry.registry.counter("tokens_generated").inc()
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
        reg = self.telemetry.registry
        reg.counter("prefill_calls").inc()
        reg.counter("prompt_tokens_prefilled").inc(sum(n for _, _, n in batch))
        picks = torch.argmax(logits, dim=-1).tolist()  # first maximum wins
        for req, pos, n in batch:
            req.prefill_pos = pos + n
            if req.prefill_pos == req.prompt_len:
                self._first_token(req, logits[req.slot], now, picks[req.slot])

    def _advance_prefill(self, req: Request, now: float) -> None:
        """Per-slot prefill (the gather backend and the state backends): one
        ``[1, C]`` chunk, or, when fewer than C prompt tokens remain, every
        one of them as a ``[1, 1]`` call, never padded."""
        C = self.config.prefill_chunk
        remaining = req.prompt_len - req.prefill_pos
        calls = [C] if remaining >= C else [1] * remaining
        for n in calls:
            tokens = self._tensor(req.prompt[None, req.prefill_pos:req.prefill_pos + n])
            if self.backend == "statepool":
                logits = self._state_prefill(req, tokens)
            elif self.backend == "dense_slots":
                start = torch.full((1,), req.prefill_pos, dtype=torch.int32, device=self.device)
                logits = self._dense_chunk(self.params, tokens, start,
                                           self.cache.slot(req.slot), req.extra)[0]
            else:
                self._cow_guard([(req.slot, req.prefill_pos, n)])
                logits = self._steps.prefill_chunk(
                    self.params, tokens, req.prefill_pos,
                    self._tensor(self.cache.tables[req.slot]), self.cache.pool)
            req.prefill_pos += n
            self.telemetry.registry.counter("prefill_calls").inc()
            self.telemetry.registry.counter("prompt_tokens_prefilled").inc(n)
        if req.prefill_pos == req.prompt_len:
            self._first_token(req, logits[0], now)

    def _state_prefill(self, req: Request, tokens: torch.Tensor) -> torch.Tensor:
        """One state-pool prefill call: the slot's read page in, its write
        page out, then its ring cursor advanced."""
        sp = self.cache
        kv_row = None if sp.kv is None else self._tensor(sp.kv.tables[req.slot])
        cross_row = None if sp.cross is None else self._tensor(sp.cross.tables[req.slot])
        read = np.array([sp.ring_read[req.slot]], np.int32)
        write = np.array([sp.ring_write_id(req.slot)], np.int32)
        logits = self._state_steps.prefill_chunk(self.params, tokens, req.prefill_pos, kv_row,
                                                 cross_row, self._tensor(read),
                                                 self._tensor(write), req.extra)
        one = np.zeros((self.config.n_slots,), bool)
        one[req.slot] = True
        sp.ring_advance(one)
        return logits

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
        args = (self.params, self._tensor(tokens), self._tensor(positions))
        if self.backend == "statepool":
            read, write = self.cache.ring_ids(mask)
            kv, cross = self.cache.kv, self.cache.cross
            logits = self._state_steps.decode_all(
                *args, None if kv is None else self._tensor(kv.tables),
                None if cross is None else self._tensor(cross.tables), self._tensor(read),
                self._tensor(write), self._tensor(mask))
            self.cache.ring_advance(mask)
        elif self.backend == "dense_slots":
            mask_t = self._tensor(mask)
            pos_safe = torch.where(mask_t, args[2], torch.zeros_like(args[2]))
            new = cache_map(torch.clone, self.cache.caches)
            logits = self._dense_decode(self.params, args[1], pos_safe, new)[0]
            self.cache.merge_masked(new, mask_t)
        else:
            self._cow_guard([(r.slot, int(positions[r.slot]), 1) for r in decoding])
            logits = self._steps.decode_all(*args, self.cache.pool,
                                            self._tensor(self.cache.tables), self._tensor(mask))
        picks = torch.argmax(logits, dim=-1).tolist()
        reg = self.telemetry.registry
        reg.counter("decode_calls").inc()
        for req in decoding:
            row = logits[req.slot]
            self._emit(req, row, self._sample(req, row, len(req.tokens), picks[req.slot]))
            req.decode_calls += 1
            self.telemetry.tracer.tokens(req.rid, now, 1)
            self._maybe_finish(req, now)
        reg.counter("tokens_generated").inc(len(decoding))
        reg.counter("decode_tokens").inc(len(decoding))

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
        reg = self.telemetry.registry
        reg.counter("verify_calls").inc()
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
            reg.counter("tokens_generated").inc(n_emit)
            reg.counter("decode_tokens").inc(n_emit)
            reg.counter("drafts_proposed").inc(proposed)
            reg.counter("drafts_accepted").inc(min(n_acc, proposed))
            self.telemetry.tracer.tokens(req.rid, now, n_emit)
            self._maybe_finish(req, now)
            if not req.done:
                self.proposer.on_accept(req)
        if (total := reg.counter("drafts_proposed").value):
            reg.gauge("spec_acceptance_rate").set(reg.counter("drafts_accepted").value / total)

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
        if self.backend != "dense_slots":  # a dense slot is zeroed at its next admission
            self.cache.free(req.slot)
        if self.proposer is not None:
            self.proposer.on_retire(req)
        self.completed.append(req)
        reg = self.telemetry.registry
        reg.counter(f"requests_retired_{reason}").inc()
        if (tpc := req.tokens_per_decode_call()) is not None:
            reg.histogram("tokens_per_decode_call").observe(tpc)
