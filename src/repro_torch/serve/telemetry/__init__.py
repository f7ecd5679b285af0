"""Engine telemetry: metrics registry + request tracing + pool health.

Port of ``repro.serve.telemetry``: the same configuration, the same metric
catalog (names, kinds and snapshot sections; only the help strings of the
gauges the port computes otherwise say what it counts) and the same hub.

One :class:`EngineTelemetry` hub per engine wires together

* a :class:`~repro_torch.serve.telemetry.registry.MetricsRegistry` (counters /
  gauges / histograms / EWMA rates) pre-registered with the full metric
  catalog so the export schema is stable from tick 0,
* a :class:`~repro_torch.serve.telemetry.tracing.Tracer` deriving TTFT / TPOT /
  queue-wait / latency from request-lifecycle spans,
* pluggable sinks (JSON-lines stream, Prometheus text exposition, console
  snapshots — see ``telemetry.sinks``),
* quantization-health sampling of the packed MXFP4 pool at a configurable
  tick stride (``telemetry.quant_health``).

Everything here is host-side bookkeeping: instrumentation never changes
what the engine's steps compute, and at the default configuration (no
sinks, ``quant_stride=0``, no profiler) the cost is dict updates with no
device synchronisation — cheap enough to stay on by default.  A pool-health
sample reads the pool with one host read; the profiler costs one call of
each step shape (``telemetry.profiling``).  Values reach the registry as
Python numbers, never as tensors.

The metric catalog (``CATALOG``) is the contract consumers code against,
name → kind → meaning, shared with the reference so that snapshots of the
two packages compare name for name.
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.serve.telemetry.quant_health import (sample_pool_health,
                                                sample_state_health)
from repro_torch.serve.telemetry.registry import (
    METRICS_SCHEMA,
    BinnedHistogram,
    Counter,
    EwmaRate,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.serve.telemetry.sinks import (
    ConsoleSink,
    JsonlSink,
    NullSink,
    PrometheusTextSink,
    Sink,
    render_summary,
)
from repro_torch.serve.telemetry.tracing import RequestTrace, Tracer

__all__ = [
    "TelemetryConfig", "EngineTelemetry", "MetricsRegistry", "Tracer",
    "RequestTrace", "Counter", "Gauge", "Histogram", "BinnedHistogram",
    "EwmaRate", "Sink", "NullSink", "JsonlSink", "PrometheusTextSink",
    "ConsoleSink", "render_summary", "CATALOG", "METRICS_SCHEMA",
]


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Sink + sampling configuration (the registry/tracer are always on —
    they are host dicts; sinks and device sampling are the opt-ins)."""

    metrics_path: str | None = None      # JSON-lines snapshot stream
    trace_path: str | None = None        # JSON-lines per-request spans
    prometheus_path: str | None = None   # text exposition, rewritten per emit
    console_every: int = 0               # print a summary every N emits (0=off)
    emit_every_ticks: int = 25           # snapshot cadence (0 = finalize only)
    quant_stride: int = 0                # pool-health sample every N ticks (0=off)
    keep_traces: int = 1024              # completed traces retained in memory
    hist_max_samples: int = 4096         # percentile reservoir size
    profile: bool = False                # per-phase cost accounting + roofline gauges
    profile_trace_path: str | None = None  # Chrome trace-event JSON (implies profile)


# name → (kind, help).  Pre-registered so every snapshot carries the full
# catalog (schema stability) and so this module is the single source of
# truth the README table and the stability test both mirror.
CATALOG: dict[str, tuple[str, str]] = {
    # counters — engine lifecycle
    "engine_ticks": ("counter", "scheduler ticks executed"),
    "requests_submitted": ("counter", "requests entered the queue"),
    "requests_admitted": ("counter", "requests admitted into slots"),
    "requests_retired_eos": ("counter", "requests finished by EOS"),
    "requests_retired_max_tokens": ("counter", "requests finished by budget"),
    "admission_blocked_pages": ("counter",
                                "ticks the queue head had a slot but no pages"),
    # counters — device-call / token accounting
    "tokens_generated": ("counter", "tokens emitted (all phases)"),
    "decode_tokens": ("counter", "tokens emitted by decode/verify ticks"),
    "prompt_tokens_prefilled": ("counter", "prompt tokens consumed by prefill"),
    "prefill_calls": ("counter", "prefill step calls"),
    "decode_calls": ("counter", "batched decode step calls"),
    "cross_encode_calls": ("counter",
                           "cross-KV encode-at-admission calls (state pool)"),
    "verify_calls": ("counter", "speculative verify step calls"),
    "draft_decode_calls": ("counter", "proposer draft decode calls"),
    "draft_prefill_calls": ("counter", "proposer draft-cache sync prefill calls"),
    "drafts_proposed": ("counter", "drafted tokens at emittable positions"),
    "drafts_accepted": ("counter", "drafted tokens the target accepted"),
    "quant_health_samples": ("counter", "pool-health reductions fetched"),
    # counters — prefix sharing (zero unless EngineConfig.prefix_cache)
    "prefix_lookups": ("counter", "admissions that consulted the radix index"),
    "prefix_hit_requests": ("counter", "admissions that aliased >= 1 page"),
    "prefix_shared_tokens": ("counter",
                             "prompt tokens skipped via aliased pages"),
    "prefix_inserted_pages": ("counter", "pages published into the index"),
    "prefix_cow_pages": ("counter", "shared pages detached by copy-on-write"),
    "prefix_evicted_pages": ("counter",
                             "cached pages LRU-evicted under pool pressure"),
    # gauges — scheduler / pool pressure
    "queue_depth": ("gauge", "requests waiting for a slot"),
    "slots_active": ("gauge", "slots holding a live request"),
    "slots_prefilling": ("gauge", "slots in PREFILL"),
    "slots_decoding": ("gauge", "slots in DECODE"),
    "pool_pages_total": ("gauge", "allocatable pages (excl. scratch)"),
    "pool_pages_free": ("gauge", "free pages right now"),
    "pool_pages_free_watermark": ("gauge", "lowest free-page count seen"),
    "pool_occupancy": ("gauge", "mapped / allocatable pages"),
    "pool_occupancy_peak": ("gauge", "highest occupancy seen"),
    "kv_cache_bytes": ("gauge", "persistent KV bytes held by the cache"),
    # gauges — state-pool per-tenant-kind pressure (0 unless backend is
    # "statepool"; kinds: attn-KV plane / cross-KV plane / state rings)
    "pool_pages_total_attn_kv": ("gauge", "state pool: allocatable attn-KV pages"),
    "pool_pages_free_attn_kv": ("gauge", "state pool: free attn-KV pages"),
    "pool_occupancy_attn_kv": ("gauge", "state pool: attn-KV plane occupancy"),
    "pool_pages_total_cross_kv": ("gauge", "state pool: allocatable cross-KV pages"),
    "pool_pages_free_cross_kv": ("gauge", "state pool: free cross-KV pages"),
    "pool_occupancy_cross_kv": ("gauge", "state pool: cross-KV plane occupancy"),
    "pool_pages_total_state_ring": ("gauge", "state pool: ring pages (all planes)"),
    "pool_pages_free_state_ring": ("gauge", "state pool: inactive ring pages"),
    "pool_occupancy_state_ring": ("gauge", "state pool: active-slot ring fraction"),
    "spec_acceptance_rate": ("gauge", "cumulative accepted / proposed drafts"),
    "prefix_cached_pages": ("gauge", "pages pinned by the radix prefix index"),
    "prefix_hit_rate": ("gauge", "cumulative hit admissions / lookups"),
    # gauges — step shape counts (the reference's compiled variants: the port
    # has no jit, so it counts the distinct operand-shape signatures a step
    # was called with; the names stay for comparable snapshots)
    "jit_compiled_decode_all": ("gauge", "operand-shape signatures decode_all was called with"),
    "jit_compiled_prefill_all": ("gauge",
                                 "operand-shape signatures prefill_all was called with"),
    "jit_compiled_prefill_chunk": ("gauge",
                                   "operand-shape signatures prefill_chunk was called with"),
    "jit_compiled_verify_all": ("gauge", "operand-shape signatures verify_all was called with"),
    # gauges — profiler cost accounting (0 unless TelemetryConfig.profile;
    # per-call costs are counted once per step shape, util/bw refresh every
    # profiled tick)
    "profile_flops_per_call_prefill": ("gauge", "counted flops per prefill call"),
    "profile_flops_per_call_decode": ("gauge", "counted flops per decode call"),
    "profile_flops_per_call_verify": ("gauge", "counted flops per verify call"),
    "profile_hbm_bytes_per_call_prefill": ("gauge",
                                           "counted HBM-traffic proxy per prefill call"),
    "profile_hbm_bytes_per_call_decode": ("gauge",
                                          "counted HBM-traffic proxy per decode call"),
    "profile_hbm_bytes_per_call_verify": ("gauge",
                                          "counted HBM-traffic proxy per verify call"),
    "roofline_util_prefill": ("gauge",
                              "achieved/peak FLOP rate, last prefill section"),
    "roofline_util_decode": ("gauge",
                             "achieved/peak FLOP rate, last decode section"),
    "roofline_util_verify": ("gauge",
                             "achieved/peak FLOP rate, last verify section"),
    "effective_bw_prefill": ("gauge", "HBM-proxy bytes/s, last prefill section"),
    "effective_bw_decode": ("gauge", "HBM-proxy bytes/s, last decode section"),
    "effective_bw_verify": ("gauge", "HBM-proxy bytes/s, last verify section"),
    # gauges — quantization health (mxfp4 pools, sampled at quant_stride)
    "kv_clip_fraction_k": ("gauge", "E2M1 codes at |6.0| in mapped K pages"),
    "kv_clip_fraction_v": ("gauge", "E2M1 codes at |6.0| in mapped V pages"),
    "kv_zero_fraction_k": ("gauge", "E2M1 codes at 0 in mapped K pages"),
    "kv_zero_fraction_v": ("gauge", "E2M1 codes at 0 in mapped V pages"),
    "cross_clip_fraction_k": ("gauge", "E2M1 codes at |6.0| in mapped cross-K pages"),
    "cross_clip_fraction_v": ("gauge", "E2M1 codes at |6.0| in mapped cross-V pages"),
    "cross_zero_fraction_k": ("gauge", "E2M1 codes at 0 in mapped cross-K pages"),
    "cross_zero_fraction_v": ("gauge", "E2M1 codes at 0 in mapped cross-V pages"),
    "state_clip_fraction": ("gauge", "E2M1 codes at |6.0| in live state-ring pages"),
    "state_zero_fraction": ("gauge", "E2M1 codes at 0 in live state-ring pages"),
    # histograms — latencies and per-request shape
    "tick_s": ("histogram", "wall time of one engine tick"),
    "prefill_tick_s": ("histogram", "wall time of a tick's prefill section"),
    "decode_tick_s": ("histogram", "wall time of a tick's decode section"),
    "verify_tick_s": ("histogram", "wall time of a tick's draft+verify section"),
    "ttft_s": ("histogram", "first token latency (submit -> first token)"),
    "tpot_s": ("histogram", "time per output token over the decode phase"),
    "queue_wait_s": ("histogram", "submit -> admit"),
    "request_latency_s": ("histogram", "submit -> retire"),
    "tokens_per_decode_call": ("histogram",
                               "per retired request: decode tokens / calls"),
    # binned — E8M0 scale-code distribution of the mapped pool
    "kv_scale_hist_k": ("binned", "E8M0 scale codes in mapped K pages"),
    "kv_scale_hist_v": ("binned", "E8M0 scale codes in mapped V pages"),
    # rates
    "tokens_per_sec_ewma": ("ewma", "EWMA token emission rate (wall clock)"),
}


def _register_catalog(reg: MetricsRegistry) -> None:
    for name, (kind, help_) in CATALOG.items():
        if kind == "counter":
            reg.counter(name, help_)
        elif kind == "gauge":
            reg.gauge(name, help_)
        elif kind == "histogram":
            reg.histogram(name, help_)
        elif kind == "binned":
            reg.binned(name, 256, help_)
        elif kind == "ewma":
            reg.rate(name, help=help_)


class EngineTelemetry:
    """Per-engine telemetry hub.  The engine calls :meth:`end_tick` once per
    ``step()``; launchers call :meth:`finalize` when the run ends."""

    def __init__(self, cfg: TelemetryConfig | None = None):
        self.cfg = cfg or TelemetryConfig()
        self.registry = MetricsRegistry(hist_max_samples=self.cfg.hist_max_samples)
        _register_catalog(self.registry)
        self.tracer = Tracer(self.registry, path=self.cfg.trace_path,
                             keep=self.cfg.keep_traces)
        self.sinks: list[Sink] = []
        if self.cfg.metrics_path:
            self.sinks.append(JsonlSink(self.cfg.metrics_path))
        if self.cfg.prometheus_path:
            self.sinks.append(PrometheusTextSink(self.cfg.prometheus_path))
        if self.cfg.console_every:
            self.sinks.append(ConsoleSink(self.cfg.console_every))
        if not self.sinks:
            self.sinks.append(NullSink())
        self.profiler = None  # EngineProfiler, created at attach() when enabled
        self._last_now = 0.0
        self._last_tokens = 0
        self._finalized = False

    @property
    def profiling(self) -> bool:
        return bool(self.cfg.profile or self.cfg.profile_trace_path)

    # -- engine lifecycle ---------------------------------------------------

    def attach(self, engine) -> None:
        """Record static run context + seed the pool gauges.  Called by the
        engine at the end of construction and again after :meth:`reset`."""
        cfg = engine.config
        backend = getattr(engine, "backend", "paged" if engine.paged else "")
        self.registry.meta.update({
            "arch": engine.model.cfg.name,
            "family": engine.model.cfg.family,
            "kv_dtype": (cfg.kv_dtype if backend in ("paged", "statepool")
                         else "dense_slots"),
            "decode_backend": engine.decode_backend,
            "n_slots": cfg.n_slots,
            "spec_proposer": engine.spec.proposer if engine.spec else None,
            "spec_k": engine.spec.k if engine.spec else None,
        })
        g = self.registry.gauge
        g("kv_cache_bytes").set(engine.cache.cache_bytes())
        if engine.paged:
            total = engine.cache.n_pages - 1  # scratch page is not allocatable
            g("pool_pages_total").set(total)
            g("pool_pages_free").set(engine.cache.free_pages)
            g("pool_pages_free_watermark").set(engine.cache.free_pages)
        elif backend == "statepool":
            stats = engine.cache.plane_stats()
            total = sum(s["pages_total"] for s in stats.values())
            free = sum(s["pages_free"] for s in stats.values())
            g("pool_pages_total").set(total)
            g("pool_pages_free").set(free)
            g("pool_pages_free_watermark").set(free)
            for kind, s in stats.items():
                g(f"pool_pages_total_{kind}").set(s["pages_total"])
                g(f"pool_pages_free_{kind}").set(s["pages_free"])
        # seed compile-count gauges so the profiler's compile-event diffing
        # doesn't re-announce warmup compiles after a post-warmup reset
        for name, count in engine.compile_counts().items():
            g(f"jit_compiled_{name}").set(count)
        if self.profiling:
            from repro_torch.serve.telemetry.profiling import EngineProfiler
            old = self.profiler
            self.profiler = EngineProfiler(
                engine, self.registry, trace_path=self.cfg.profile_trace_path,
                pid=old.pid if old is not None else 0)
            if old is not None and old.engine is engine:
                # re-attach after reset(): drop the warmup trace but keep the
                # memoized step costs (functions of the step shapes)
                self.profiler._costs = old._costs

    def phase(self, name: str, now: float, tick_t0: float,
              t0: float, t1: float) -> None:
        """One phase section of a tick finished.  ``tick_t0``/``t0``/``t1``
        are ``perf_counter`` readings (tick entry / section start / section
        end); ``now`` is the engine clock at tick entry — the profiler places
        the span at ``now + (t0 - tick_t0)`` so traces and request spans
        share one clock.  With profiling off this is exactly the histogram
        observe the engine used to do inline."""
        self.registry.histogram(f"{name}_tick_s").observe(t1 - t0)
        if self.profiler is not None:
            self.profiler.on_phase(name, now + (t0 - tick_t0), t1 - t0)

    def end_tick(self, engine, now: float, wall_s: float) -> None:
        reg = self.registry
        reg.counter("engine_ticks").inc()
        reg.histogram("tick_s").observe(wall_s)
        sched = engine.sched
        g = reg.gauge
        g("queue_depth").set(len(sched.queue))
        g("slots_active").set(len(sched.active))
        g("slots_prefilling").set(len(sched.prefilling()))
        g("slots_decoding").set(len(sched.decoding()))
        if engine.paged:
            total = engine.cache.n_pages - 1
            free = engine.cache.free_pages
            g("pool_pages_free").set(free)
            g("pool_pages_free_watermark").set_min(free)
            occ = engine.cache.occupancy()
            g("pool_occupancy").set(occ)
            g("pool_occupancy_peak").set_max(occ)
            prefix = getattr(engine, "prefix", None)
            if prefix is not None:
                g("prefix_cached_pages").set(prefix.cached_pages())
                if (lookups := reg.counter("prefix_lookups").value):
                    g("prefix_hit_rate").set(
                        reg.counter("prefix_hit_requests").value / lookups)
        elif getattr(engine, "backend", "") == "statepool":
            stats = engine.cache.plane_stats()
            free = sum(s["pages_free"] for s in stats.values())
            g("pool_pages_free").set(free)
            g("pool_pages_free_watermark").set_min(free)
            occ = engine.cache.occupancy()
            g("pool_occupancy").set(occ)
            g("pool_occupancy_peak").set_max(occ)
            for kind, s in stats.items():
                g(f"pool_pages_free_{kind}").set(s["pages_free"])
                g(f"pool_occupancy_{kind}").set(s["occupancy"])
            if getattr(engine, "cross_share", False):
                g("prefix_cached_pages").set(
                    engine.cache.cross_index.cached_pages())
                if (lookups := reg.counter("prefix_lookups").value):
                    g("prefix_hit_rate").set(
                        reg.counter("prefix_hit_requests").value / lookups)
        for name, count in engine.compile_counts().items():
            gauge = g(f"jit_compiled_{name}")
            if self.profiler is not None and count > gauge.value:
                self.profiler.compile_event(name, now, count)
            gauge.set(count)
        if self.profiler is not None:
            self.profiler.on_tick(engine, now, wall_s)
        toks = reg.counter("tokens_generated").value
        reg.rate("tokens_per_sec_ewma").mark(toks - self._last_tokens,
                                             time.perf_counter())
        self._last_tokens = toks
        stride = self.cfg.quant_stride
        if stride and engine.steps % stride == 0:
            self.sample_quant_health(engine.cache)
        self._last_now = now
        every = self.cfg.emit_every_ticks
        if every and engine.steps % every == 0:
            self.emit(now)

    def sample_quant_health(self, cache) -> dict | None:
        """Fetch the pool reduction (one host read) and fold it into the
        registry (no-op on dense pools / empty tables).  A ``StatePool``
        routes per tenant kind: attn-KV and cross-KV planes through the
        paged reduction, state rings through the ring reduction."""
        from repro_torch.serve.state_pool import StatePool

        if isinstance(cache, StatePool):
            out = sample_state_health(cache)
            if out is None:
                return None
            g = self.registry.gauge
            if "kv" in out:
                for s in ("k", "v"):
                    g(f"kv_clip_fraction_{s}").set(float(out["kv"][s]["clip_frac"]))
                    g(f"kv_zero_fraction_{s}").set(float(out["kv"][s]["zero_frac"]))
                    self.registry.binned(f"kv_scale_hist_{s}", 256).set_counts(
                        out["kv"][s]["scale_hist"])
            if "cross" in out:
                for s in ("k", "v"):
                    g(f"cross_clip_fraction_{s}").set(
                        float(out["cross"][s]["clip_frac"]))
                    g(f"cross_zero_fraction_{s}").set(
                        float(out["cross"][s]["zero_frac"]))
            if "state" in out:
                g("state_clip_fraction").set(float(out["state"]["clip_frac"]))
                g("state_zero_fraction").set(float(out["state"]["zero_frac"]))
            self.registry.counter("quant_health_samples").inc()
            return out
        out = sample_pool_health(cache)
        if out is None:
            return None
        g = self.registry.gauge
        for s in ("k", "v"):
            g(f"kv_clip_fraction_{s}").set(float(out[s]["clip_frac"]))
            g(f"kv_zero_fraction_{s}").set(float(out[s]["zero_frac"]))
            self.registry.binned(f"kv_scale_hist_{s}", 256).set_counts(
                out[s]["scale_hist"])
        self.registry.counter("quant_health_samples").inc()
        return out

    # -- exports ------------------------------------------------------------

    def snapshot(self, t: float | None = None) -> dict:
        return self.registry.snapshot(self._last_now if t is None else t)

    def emit(self, t: float | None = None) -> dict:
        snap = self.snapshot(t)
        for sink in self.sinks:
            sink.emit(snap, self.registry)
        return snap

    def summary(self, t: float | None = None) -> str:
        return render_summary(self.snapshot(t))

    def finalize(self, t: float | None = None) -> dict:
        """Final emit + close sinks/trace file; idempotent."""
        if self._finalized:
            return self.snapshot(t)
        snap = self.emit(t)
        for sink in self.sinks:
            sink.close()
        if self.profiler is not None:
            self.profiler.finalize(self.tracer)
        self.tracer.close()
        self._finalized = True
        return snap

    def reset(self, engine=None) -> None:
        """Zero all metrics (schema survives) — drops warmup traffic from
        benchmark runs.  Pass the engine to re-seed the static gauges."""
        self.registry.reset()
        self._last_tokens = 0
        if engine is not None:
            self.attach(engine)
