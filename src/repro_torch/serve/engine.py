"""Continuous-batching inference engine over the paged MXFP4 KV pool.

Port of ``repro.serve.engine`` for the dense family, greedy decoding.
``Engine`` multiplexes requests over a fixed set of decode slots:

* ``submit(prompt, max_new) -> Request`` queues work (``.tokens`` fills in
  as the engine runs);
* ``step()`` admits queued requests into free slots (reserving pages for
  prompt + max_new), advances the prefilling slots, then steps every
  decoding slot in one batched call;
* ``drain()`` steps until nothing is queued or active.

``EngineConfig.decode_backend`` picks the steps.  ``"paged"`` (the default
for a model whose ``attn_backend`` is ``"paged"``) advances every
prefilling slot by one chunk in one batched call, and both calls attend
directly over the pool through the paged-attention kernel.  ``"gather"``
(the reference's parity oracle, the default for other models) advances each
prefilling slot on its own, one ``[1, C]`` chunk or all of its ``[1, 1]``
remainder tokens per tick, and its steps gather-dequantize the pool into
dense caches and scatter the new tokens back.  Quantize-on-write happens
once per token on both.  Speculative decoding, prefix sharing, sampling, the
state pool and multi-device serving are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models.registry import Model
from repro_torch.serve import paged_cache as P
from repro_torch.serve.scheduler import Request, RequestState, Scheduler
from repro_torch.serve.steps import build_paged_steps, marshal_prefill_batch


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


class Engine:
    def __init__(self, model: Model, params: dict, config: EngineConfig | None = None):
        if model.cfg.family != "dense":
            raise NotImplementedError(f"serving family {model.cfg.family!r} is not ported yet")
        self.model, self.params = model, params
        self.config = cfg = config or EngineConfig()
        self.device = params["embed"]["table"].device
        self.sched = Scheduler(cfg.n_slots, cfg.max_len, cfg.prefill_chunk)
        self.completed: list[Request] = []
        self.steps = 0
        pages_per_slot, n_pages = P.reservation_sizing(cfg.n_slots, cfg.max_len,
                                                       cfg.page_size)
        self.cache = P.PagedCache(model.cfg, n_slots=cfg.n_slots,
                                  pages_per_slot=pages_per_slot, page_size=cfg.page_size,
                                  n_pages=n_pages, kv_dtype=cfg.kv_dtype,
                                  device=self.device)
        self.decode_backend = cfg.decode_backend or (
            "paged" if model.cfg.attn_backend == "paged" else "gather")
        self._steps = build_paged_steps(model, method=cfg.method, page_size=cfg.page_size,
                                        decode_backend=self.decode_backend)

    # ------------------------------------------------------------------ API

    def submit(self, prompt, max_new: int, arrival_time: float | None = None) -> Request:
        now = time.monotonic() if arrival_time is None else arrival_time
        return self.sched.submit(prompt, max_new, arrival_time=now)

    @torch.inference_mode()
    def step(self, now: float | None = None) -> dict:
        """One scheduler tick: admit → chunked prefill (batched on the paged
        backend, per slot on the gather backend) → batched decode → retire.
        Returns counts for the caller's loop."""
        now = time.monotonic() if now is None else now
        admitted = self.sched.admit(
            lambda req: self.cache.can_alloc(req.prompt_len + req.max_new),
            on_admit=lambda req: self.cache.alloc(req.slot, req.prompt_len + req.max_new))
        if self._steps.prefill_all is not None:
            batch = self.sched.prefill_batch()
            if batch:
                self._prefill_tick(batch, now)
        else:
            for req in self.sched.prefilling():
                self._advance_prefill(req, now)
        decoding = self.sched.decoding()
        if decoding:
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

    def _emit(self, req: Request, logits: torch.Tensor, token: int) -> None:
        if self.config.keep_logits:
            req.logits_trace.append(logits.float().cpu().numpy())
        req.tokens.append(token)

    def _prefill_tick(self, batch, now: float) -> None:
        """Advance every prefilling slot by one chunk in one call; slots that
        consumed their whole prompt take their first token (greedy)."""
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
                self._emit(req, logits[req.slot], picks[req.slot])
                req.first_token_time = now
                req.state = RequestState.DECODE
                self._maybe_finish(req, now)

    def _advance_prefill(self, req: Request, now: float) -> None:
        """Per-slot prefill (gather backend): one ``[1, C]`` chunk, or, when
        fewer than C prompt tokens remain, every one of them as a ``[1, 1]``
        call, never padded."""
        C = self.config.prefill_chunk
        remaining = req.prompt_len - req.prefill_pos
        calls = [C] if remaining >= C else [1] * remaining
        for n in calls:
            tokens = self._tensor(req.prompt[None, req.prefill_pos:req.prefill_pos + n])
            logits = self._steps.prefill_chunk(
                self.params, tokens, req.prefill_pos,
                self._tensor(self.cache.tables[req.slot]), self.cache.pool)
            req.prefill_pos += n
        if req.prefill_pos == req.prompt_len:
            self._emit(req, logits[0], int(torch.argmax(logits[0])))
            req.first_token_time = now
            req.state = RequestState.DECODE
            self._maybe_finish(req, now)

    def _decode_tick(self, decoding: list[Request], now: float) -> None:
        B = self.config.n_slots
        tokens = np.zeros((B, 1), np.int32)
        positions = np.zeros((B,), np.int32)
        mask = np.zeros((B,), bool)
        for req in decoding:
            tokens[req.slot, 0] = req.tokens[-1]
            positions[req.slot] = req.prompt_len + len(req.tokens) - 1
            mask[req.slot] = True
        logits = self._steps.decode_all(
            self.params, self._tensor(tokens), self._tensor(positions), self.cache.pool,
            self._tensor(self.cache.tables), self._tensor(mask))
        picks = torch.argmax(logits, dim=-1).tolist()
        for req in decoding:
            self._emit(req, logits[req.slot], picks[req.slot])
            req.decode_calls += 1
            self._maybe_finish(req, now)

    def _maybe_finish(self, req: Request, now: float) -> None:
        eos = self.config.eos_id
        if eos is not None and req.tokens[-1] == eos:
            reason = "eos"
        elif len(req.tokens) >= req.max_new:
            reason = "max_tokens"
        else:
            return
        self.sched.retire(req, reason, now)
        self.cache.free(req.slot)
        self.completed.append(req)
