"""Request lifecycle + slot admission for the continuous-batching engine.

Port of ``repro.serve.scheduler`` (plain Python and numpy, copied).  State
machine per request::

    QUEUED ──admit──▶ PREFILL ──prompt consumed──▶ DECODE ──EOS/max──▶ DONE
              ▲ needs a free slot and enough free pages for prompt + max_new
                (reserved up front so decode never runs out of pages)

The scheduler decides *which* slots prefill/decode each step and tracks
timing; the engine owns the device state.  Prefill is chunked: each engine
step advances every PREFILL request by at most ``prefill_chunk`` tokens, in
one batched call over all prefilling slots (``prefill_batch``).
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from enum import Enum
from typing import Any

import numpy as np


class RequestState(Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


@dataclasses.dataclass
class Request:
    """One generation request; doubles as the user-facing handle."""

    rid: int
    prompt: np.ndarray  # [P] int32
    max_new: int
    extra: Any = None  # per-request conditioning (source or image embeddings)
    sampling: Any = None  # SamplingParams | None (None → greedy argmax)
    state: RequestState = RequestState.QUEUED
    slot: int = -1
    prefill_pos: int = 0  # prompt tokens consumed so far
    tokens: list[int] = dataclasses.field(default_factory=list)  # generated
    logits_trace: list[np.ndarray] = dataclasses.field(default_factory=list)
    arrival_time: float = 0.0
    first_token_time: float | None = None
    finish_time: float | None = None
    finish_reason: str = ""
    # decode-phase accounting (speculative decoding emits a variable number
    # of tokens per batched call; these make that visible)
    decode_calls: int = 0  # batched decode/verify invocations that fed this slot
    draft_proposed: int = 0  # drafted tokens scored on this request's behalf
    draft_accepted: int = 0  # drafted tokens the target model agreed with
    replica: int | None = None  # the data-parallel replica serving it (None: one engine)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return self.state is RequestState.DONE

    def latency(self) -> float | None:
        return None if self.finish_time is None else self.finish_time - self.arrival_time

    def ttft(self) -> float | None:
        return (None if self.first_token_time is None
                else self.first_token_time - self.arrival_time)

    def acceptance_rate(self) -> float | None:
        """Fraction of drafted tokens accepted (None without speculation)."""
        return (self.draft_accepted / self.draft_proposed
                if self.draft_proposed else None)

    def tokens_per_decode_call(self) -> float | None:
        """Decode-phase tokens per batched call: 1.0 for plain decoding, up
        to k+1 with speculation (the prefill's token rides on a prefill
        call and is excluded)."""
        return (max(len(self.tokens) - 1, 0) / self.decode_calls
                if self.decode_calls else None)


class Scheduler:
    """Slot/queue bookkeeping.  ``can_admit`` is a callback the engine wires
    to the page allocator."""

    def __init__(self, n_slots: int, max_len: int, prefill_chunk: int = 16,
                 tracer: Any = None, ids=None):
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.n_slots, self.max_len = n_slots, max_len
        self.prefill_chunk = prefill_chunk
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}  # slot -> request
        self.free_slots = deque(range(n_slots))
        self.tracer = tracer  # telemetry.Tracer | None: the submit and retire spans
        # data-parallel replicas share one counter (``ids``), so rids stay
        # unique across them and their completions merge in submission order
        self._ids = ids if ids is not None else itertools.count()

    def check_request(self, prompt: np.ndarray, max_new: int) -> np.ndarray:
        """The prompt as int32 [P], or ValueError for a request this
        scheduler cannot take."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if prompt.size + max_new > self.max_len:
            raise ValueError(
                f"prompt({prompt.size}) + max_new({max_new}) exceeds max_len {self.max_len}")
        return prompt

    def submit(self, prompt: np.ndarray, max_new: int, extra: Any = None,
               arrival_time: float = 0.0, sampling: Any = None) -> Request:
        prompt = self.check_request(prompt, max_new)
        req = Request(rid=next(self._ids), prompt=prompt, max_new=max_new, extra=extra,
                      sampling=sampling, arrival_time=arrival_time)
        self.queue.append(req)
        if self.tracer is not None:
            self.tracer.event(req.rid, "submit", arrival_time)
        return req

    def admit(self, can_admit, on_admit=None) -> list[Request]:
        """Move queued requests into free slots, strictly FIFO: the head waits
        until it fits, so no request is starved by later, smaller arrivals.
        ``on_admit(req)`` runs inline per admission, before the next head is
        judged, so page allocation is transactional."""
        admitted = []
        while self.queue and self.free_slots:
            req = self.queue[0]
            if not can_admit(req):
                break
            self.queue.popleft()
            req.slot = self.free_slots.popleft()
            req.state = RequestState.PREFILL
            req.prefill_pos = 0
            self.active[req.slot] = req
            if on_admit is not None:
                on_admit(req)
            admitted.append(req)
        return admitted

    def prefilling(self) -> list[Request]:
        return [r for r in self.active.values() if r.state is RequestState.PREFILL]

    def prefill_batch(self) -> list[tuple[Request, int, int]]:
        """One ``(req, start, n_valid)`` chunk per PREFILL request for this
        tick, ``n_valid = min(prefill_chunk, remaining)``: the batched paged
        prefill pads rows to ``prefill_chunk`` and write-masks the tail."""
        return [
            (r, r.prefill_pos, min(self.prefill_chunk, r.prompt_len - r.prefill_pos))
            for r in self.prefilling()
        ]

    def decoding(self) -> list[Request]:
        return [r for r in self.active.values() if r.state is RequestState.DECODE]

    def retire(self, req: Request, reason: str, now: float) -> int:
        """Release the request's slot; returns the freed slot id."""
        req.state = RequestState.DONE
        req.finish_reason = reason
        req.finish_time = now
        slot = req.slot
        del self.active[slot]
        self.free_slots.append(slot)
        if self.tracer is not None:
            self.tracer.event(req.rid, "retire", now)
        return slot

    @property
    def pending(self) -> int:
        return len(self.queue) + len(self.active)
