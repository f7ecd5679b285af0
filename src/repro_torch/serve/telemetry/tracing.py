"""Request-lifecycle tracing: spans + first-class latency derivation.

Port of ``repro.serve.telemetry.tracing`` (pure Python, copied).

Every request leaves a :class:`RequestTrace` — the event timestamps
``submit → admit → first_token → retire`` plus per-tick token-emission
timestamps ``(t, n_tokens)``.  From those the tracer derives the serving
latencies as *first-class metrics* (fed straight into the registry's
histograms on retire, rather than recomputed by every benchmark):

* ``queue_wait_s``  = admit − submit,
* ``ttft_s``        = first_token − submit,
* ``tpot_s``        = (last_token_t − first_token_t) / (n_tokens − 1)
  (time-per-output-token over the decode phase; ``None`` for single-token
  requests),
* ``request_latency_s`` = retire − submit.

Timestamps are whatever clock the engine is driven on — wall time in live
serving, the virtual clock of ``launch.serve_engine`` — the
derivations only ever subtract them.  With a trace path configured, each
retired request is appended as one JSON line (rid, spans, events, token
timeline, derived latencies); the last ``keep`` completed traces stay
in memory for tests and post-run inspection.
"""

from __future__ import annotations

import dataclasses
import json
from collections import deque

SPAN_EVENTS = ("submit", "admit", "first_token", "retire")


@dataclasses.dataclass
class RequestTrace:
    rid: int
    events: list = dataclasses.field(default_factory=list)  # [(name, t)]
    token_times: list = dataclasses.field(default_factory=list)  # [(t, n)]

    def event_time(self, name: str) -> float | None:
        for n, t in self.events:
            if n == name:
                return t
        return None

    @property
    def n_tokens(self) -> int:
        return sum(n for _, n in self.token_times)

    def spans(self) -> list[tuple[str, float, float]]:
        """Derived (name, start, end) spans: queued → prefill → decode."""
        out = []
        for name, a, b in (("queued", "submit", "admit"),
                           ("prefill", "admit", "first_token"),
                           ("decode", "first_token", "retire")):
            ta, tb = self.event_time(a), self.event_time(b)
            if ta is not None and tb is not None:
                out.append((name, ta, tb))
        return out

    def derived(self) -> dict:
        sub, adm = self.event_time("submit"), self.event_time("admit")
        ft, ret = self.event_time("first_token"), self.event_time("retire")
        n = self.n_tokens
        tpot = None
        if n > 1 and ft is not None and self.token_times:
            tpot = (self.token_times[-1][0] - ft) / (n - 1)
        return {
            "queue_wait_s": adm - sub if None not in (adm, sub) else None,
            "ttft_s": ft - sub if None not in (ft, sub) else None,
            "tpot_s": tpot,
            "request_latency_s": ret - sub if None not in (ret, sub) else None,
            "n_tokens": n,
        }


class Tracer:
    """Collects per-request traces; feeds latency histograms on retire.

    The engine (and scheduler) report events by request id — the tracer owns
    no request objects.  ``registry`` may be ``None`` (tracing without
    metrics); ``path`` may be ``None`` (metrics without a trace file).
    """

    def __init__(self, registry=None, path: str | None = None, keep: int = 1024):
        self.registry = registry
        self._fh = open(path, "w") if path else None
        self.active: dict[int, RequestTrace] = {}
        self.completed: deque[RequestTrace] = deque(maxlen=max(keep, 1))

    def event(self, rid: int, name: str, t: float) -> None:
        tr = self.active.get(rid)
        if tr is None:
            tr = self.active[rid] = RequestTrace(rid)
        tr.events.append((name, t))
        if name == "retire":
            self._finish(tr)

    def tokens(self, rid: int, t: float, n: int) -> None:
        tr = self.active.get(rid)
        if tr is not None and n > 0:
            tr.token_times.append((t, n))

    def _finish(self, tr: RequestTrace) -> None:
        d = tr.derived()
        if self.registry is not None:
            for name in ("queue_wait_s", "ttft_s", "tpot_s", "request_latency_s"):
                if d[name] is not None:
                    self.registry.histogram(name).observe(d[name])
        if self._fh is not None:
            self._fh.write(json.dumps({
                "rid": tr.rid,
                "spans": [[n, a, b] for n, a, b in tr.spans()],
                "events": [[n, t] for n, t in tr.events],
                "tokens": [[t, n] for t, n in tr.token_times],
                "derived": d,
            }) + "\n")
            self._fh.flush()
        self.completed.append(tr)
        del self.active[tr.rid]

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
