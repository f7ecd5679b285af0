"""Pluggable sinks for registry snapshots.

Port of ``repro.serve.telemetry.sinks`` (pure Python, copied).

A sink consumes :meth:`MetricsRegistry.snapshot` dicts; the engine's
telemetry hub calls ``emit`` at a tick stride and once more on finalize.
All sinks are host-only and exception-tolerant writers — losing a metrics
line must never take the engine down with it.

* :class:`NullSink` — drops everything (the zero-overhead default).
* :class:`JsonlSink` — one JSON object per emit, appended to a file: the
  stream ``schema.validate_metrics_file`` validates.
* :class:`PrometheusTextSink` — full text exposition rewritten atomically
  on every emit (point a file scraper at it).
* :class:`ConsoleSink` — a compact human summary every N emits.
"""

from __future__ import annotations

import json
import os
import sys


class Sink:
    def emit(self, snapshot: dict, registry=None) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullSink(Sink):
    def emit(self, snapshot: dict, registry=None) -> None:
        pass


class JsonlSink(Sink):
    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "w")

    def emit(self, snapshot: dict, registry=None) -> None:
        self._fh.write(json.dumps(snapshot) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class PrometheusTextSink(Sink):
    def __init__(self, path: str):
        self.path = path

    def emit(self, snapshot: dict, registry=None) -> None:
        if registry is None:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(registry.prometheus_text())
        os.replace(tmp, self.path)


class ConsoleSink(Sink):
    def __init__(self, every: int = 1, stream=None):
        self.every = max(1, every)
        self.stream = stream if stream is not None else sys.stderr
        self._n = 0

    def emit(self, snapshot: dict, registry=None) -> None:
        self._n += 1
        if self._n % self.every:
            return
        print(render_summary(snapshot), file=self.stream)


def _fmt(v, unit: str = "") -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}{unit}"
    return f"{v}{unit}"


def render_summary(snapshot: dict) -> str:
    """Compact fixed-order console table of the serving metrics that matter
    at a glance — shared by :class:`ConsoleSink` and the launchers' final
    summaries (replacing their hand-rolled per-request prints)."""
    c, g, h, r = (snapshot.get(k, {}) for k in
                  ("counters", "gauges", "histograms", "rates"))

    def hp(name, q):
        s = h.get(name) or {}
        return s.get(q)

    meta = snapshot.get("meta", {})
    head = " ".join(f"{k}={v}" for k, v in meta.items() if v is not None)
    rows = [
        ("t", _fmt(snapshot.get("t"), "s"), "ticks", _fmt(c.get("engine_ticks"))),
        ("queue", _fmt(g.get("queue_depth")), "active",
         f"{_fmt(g.get('slots_prefilling'))}p/{_fmt(g.get('slots_decoding'))}d"),
        ("submitted", _fmt(c.get("requests_submitted")), "retired",
         _fmt((c.get("requests_retired_eos") or 0)
              + (c.get("requests_retired_max_tokens") or 0))),
        ("tokens", _fmt(c.get("tokens_generated")), "tok/s(ewma)",
         _fmt(r.get("tokens_per_sec_ewma"))),
        ("ttft p50/p95", f"{_fmt(hp('ttft_s', 'p50'), 's')}/"
                         f"{_fmt(hp('ttft_s', 'p95'), 's')}",
         "tpot p50", _fmt(hp("tpot_s", "p50"), "s")),
        ("decode tick p50", _fmt(hp("decode_tick_s", "p50"), "s"),
         "verify tick p50", _fmt(hp("verify_tick_s", "p50"), "s")),
        ("pool occ", _fmt(g.get("pool_occupancy")), "free low-wm",
         _fmt(g.get("pool_pages_free_watermark"))),
        # per-slot decode tokens per batched call (the speculative-decoding
        # gain), from the per-request histogram — the raw counter ratio
        # decode_tokens/calls would conflate batch width with spec gain
        ("tok/decode-call", _fmt(hp("tokens_per_decode_call", "p50")),
         "acceptance", _fmt(
            (c.get("drafts_accepted") or 0) / dp
            if (dp := c.get("drafts_proposed") or 0) else None)),
        ("kv clip k/v", f"{_fmt(g.get('kv_clip_fraction_k'))}/"
                        f"{_fmt(g.get('kv_clip_fraction_v'))}",
         "scale bins", _fmt((snapshot.get("binned", {})
                             .get("kv_scale_hist_k") or {}).get("nonzero_bins"))),
    ]
    width = max(len(a) for a, _, _, _ in rows)
    w2 = max(len(x) for _, _, x, _ in rows)
    body = "\n".join(f"  {a:<{width}} {b:>10}   {x:<{w2}} {y:>10}"
                     for a, b, x, y in rows)
    return f"[telemetry] {head}\n{body}"
