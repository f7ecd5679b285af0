"""Engine performance profiler: step cost accounting + Chrome-trace export.

Port of ``repro.serve.telemetry.profiling``.  Both halves are opt-in via
:class:`~repro_torch.serve.telemetry.TelemetryConfig` (``profile=True`` /
``profile_trace_path=...``) and both are host-side: the profiler never
changes what the engine's steps compute, launches nothing of its own, never
runs a step on a copy of the pool and never draws from a sampler.

**Per-phase cost accounting** (:class:`EngineProfiler`).  The reference
lowers each jitted step at its operand shapes and reads the compiled HLO,
without calling it.  The port has no such program to read, so it costs the
*first live call* of each (step, operand-shape signature) under
``launch.roofline.StepCostCounter`` — PyTorch's products and output bytes
through a dispatch mode, each hand-written kernel's own operations and
bytes through its wrapper — and memoizes the result; every later call of
that signature adds the memoized cost.  Paired with the per-phase wall-time
sections the engine already measures (``decode_tick_s`` /
``prefill_tick_s`` / ``verify_tick_s``) this publishes, per phase:

* ``roofline_util_<phase>`` — counted FLOPs per second over the peak,
* ``effective_bw_<phase>`` — counted bytes per second (an HBM proxy),
* ``profile_flops_per_call_<phase>`` / ``profile_hbm_bytes_per_call_<phase>``
  — the counted cost per call.

A phase's cost is the sum over that section's calls of its own steps
(prefill: ``prefill_all`` or ``prefill_chunk``; decode: ``decode_all``;
verify: ``verify_all``, as the reference costs the verify alone).  The
dispatch mode slows the host side of the call it counts, so a tick that
counted a call is left out of the utilization and bandwidth gauges and
means.  Peaks are the H100 SXM's data-sheet numbers from
``launch.roofline`` unless overridden; on the CPU the utilizations are
relative numbers, not device readings.

**Chrome-trace export** (:class:`TraceEventSink`), copied from the
reference: engine ticks and their phase sections, request lifecycles
(``queued → prefill → decode`` spans from the
:class:`~repro_torch.serve.telemetry.tracing.Tracer`) and new step shapes
(``jit_compile:<step>``, the reference's name for a compile) on one clock,
the engine's ``now``.  ``pid`` is the engine (a replica's lane); within it
tid 0 is the tick/phase timeline and tid 2 + rid each request's lane.
"""

from __future__ import annotations

import dataclasses
import json
import math

from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS_BF16, StepCostCounter

PHASES = ("prefill", "decode", "verify")
_PHASE_COUNTERS = {"prefill": "prefill_calls", "decode": "decode_calls",
                   "verify": "verify_calls"}
# the steps whose calls make up each phase's device work
_PHASE_STEPS = {"prefill": ("prefill_all", "prefill_chunk"), "decode": ("decode_all",),
                "verify": ("verify_all",)}

# trace lanes (tid) inside one engine process (pid)
TID_ENGINE = 0
TID_REQ_BASE = 2


@dataclasses.dataclass(frozen=True)
class StepCost:
    """Per-call cost of one step at one operand-shape signature."""

    flops: float
    hbm_bytes: float
    collective_bytes: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def engine_steps(engine) -> list:
    """The :class:`~repro_torch.serve.steps.Step` objects of ``engine``'s
    backend (the paged steps, the state pool's, or the dense-slot oracle's)."""
    from repro_torch.serve.steps import Step

    if engine.backend == "paged":
        fns = engine._steps
    elif engine.backend == "statepool":
        fns = engine._state_steps
    else:
        fns = (engine._dense_decode, engine._dense_chunk)
    return [f for f in fns if isinstance(f, Step)]


class TraceEventSink:
    """Accumulates Chrome trace-event JSON objects for one engine process.

    Complete (``ph: "X"``) events carry microsecond ``ts``/``dur`` on the
    engine's clock; instant (``ph: "i"``) events mark point occurrences like
    new step shapes.  ``write_trace`` merges any number of sinks (one per
    replica) into one Perfetto-loadable document.
    """

    def __init__(self, pid: int = 0, process_name: str = "engine"):
        self.pid = pid
        self.process_name = process_name
        self._events: list[dict] = []
        self._thread_names: dict[int, str] = {TID_ENGINE: "engine ticks"}

    def complete(self, name: str, cat: str, ts_s: float, dur_s: float,
                 tid: int = TID_ENGINE, args: dict | None = None) -> None:
        ev = {"name": name, "cat": cat, "ph": "X", "pid": self.pid, "tid": tid,
              "ts": round(ts_s * 1e6, 3), "dur": round(max(dur_s, 0.0) * 1e6, 3)}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def instant(self, name: str, cat: str, ts_s: float,
                tid: int = TID_ENGINE, args: dict | None = None) -> None:
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t", "pid": self.pid,
              "tid": tid, "ts": round(ts_s * 1e6, 3)}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def thread_name(self, tid: int, name: str) -> None:
        self._thread_names.setdefault(tid, name)

    def trace_events(self) -> list[dict]:
        """Metadata events first, then payload sorted by timestamp (Perfetto
        tolerates unsorted input; sorted keeps the monotonicity testable)."""
        meta = [{"name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
                 "args": {"name": self.process_name}}]
        for tid, name in sorted(self._thread_names.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": self.pid,
                         "tid": tid, "args": {"name": name}})
        return meta + sorted(self._events, key=lambda e: (e["ts"], e["tid"]))


def write_trace(path: str, sinks) -> dict:
    """Merge sinks (one per replica) into one trace-event JSON document."""
    doc = {"traceEvents": [ev for s in sinks for ev in s.trace_events()],
           "displayTimeUnit": "ms"}
    with open(path, "w") as fh:
        json.dump(doc, fh)
        fh.write("\n")
    return doc


class EngineProfiler:
    """Per-engine performance profiler: step cost accounting, roofline /
    bandwidth gauges, and the tick/request/new-shape trace timeline.

    Created by :class:`~repro_torch.serve.telemetry.EngineTelemetry` when
    profiling is configured; it attaches itself to the engine's steps (each
    step then calls :meth:`call`), and the telemetry hub forwards phase
    sections (:meth:`on_phase`), tick boundaries (:meth:`on_tick`), new step
    shapes (:meth:`compile_event`) and finalization (:meth:`finalize`).
    """

    def __init__(self, engine, registry, *, trace_path: str | None = None,
                 pid: int = 0, peak_flops: float = PEAK_FLOPS_BF16,
                 peak_bw: float = HBM_BW):
        self.engine = engine
        self.registry = registry
        self.trace_path = trace_path
        self.peak_flops = peak_flops
        self.peak_bw = peak_bw
        self.sink = TraceEventSink(pid=pid)
        self._costs: dict[str, dict] = {}  # step name -> {signature: StepCost}
        self._pending: dict[str, list] = {}  # step name -> [flops, bytes, calls] this tick
        self._sections: list = []  # this tick's (phase, flops, bytes, calls, dur_s)
        self._counted_this_tick = False
        self._seen_calls: dict[str, int] = {}
        # accumulated (flops, bytes, wall_s, ticks, calls) per phase for run means
        self._accum: dict[str, list[float]] = {p: [0.0] * 5 for p in PHASES}
        self._finalized = False
        for step in engine_steps(engine):
            step.profiler = self

    @property
    def pid(self) -> int:
        return self.sink.pid

    @pid.setter
    def pid(self, value: int) -> None:
        self.sink.pid = int(value)

    # -- cost accounting ----------------------------------------------------

    def call(self, step, sig, args, kwargs):
        """Run one step call: under the cost counter when its (step,
        signature) has no cost yet, plainly otherwise; either way its cost
        joins this tick's pending work."""
        costs = self._costs.setdefault(step.name, {})
        cost = costs.get(sig)
        if cost is None:
            with StepCostCounter() as counter:
                out = step.fn(*args, **kwargs)
            cost = costs[sig] = StepCost(flops=float(counter.flops),
                                         hbm_bytes=float(counter.hbm_bytes),
                                         collective_bytes=0.0)
            self._counted_this_tick = True
        else:
            out = step.fn(*args, **kwargs)
        pending = self._pending.setdefault(step.name, [0.0, 0.0, 0])
        pending[0] += cost.flops
        pending[1] += cost.hbm_bytes
        pending[2] += 1
        return out

    def step_cost(self, name: str) -> StepCost | None:
        """Per-call cost of one step at the first signature it was costed at
        (``None`` when the step has not run under this profiler)."""
        costs = self._costs.get(name)
        return next(iter(costs.values())) if costs else None

    def phase_costs(self) -> dict[str, dict]:
        """Per-call cost of every step that has run, at its first signature
        — deterministic for a fixed engine config and workload (the counts
        are functions of the operand shapes and the data of a kernel whose
        work depends on it)."""
        return {name: c.to_dict() for name in self._costs
                if (c := self.step_cost(name)) is not None}

    # -- live hooks (called by EngineTelemetry) ------------------------------

    def on_phase(self, phase: str, start_t: float, dur_s: float) -> None:
        """One tick's phase section finished: trace it and hold its counted
        work until the tick ends (:meth:`on_tick` refreshes the gauges)."""
        flops = nbytes = calls = 0
        for step in _PHASE_STEPS[phase]:
            f, b, n = self._pending.pop(step, (0.0, 0.0, 0))
            flops, nbytes, calls = flops + f, nbytes + b, calls + n
        counter = self.registry.counter(_PHASE_COUNTERS[phase]).value
        ncalls = counter - self._seen_calls.get(phase, 0)
        self._seen_calls[phase] = counter
        args = {"calls": ncalls}
        if calls > 0 and dur_s > 0:
            g = self.registry.gauge
            g(f"profile_flops_per_call_{phase}").set(flops / calls)
            g(f"profile_hbm_bytes_per_call_{phase}").set(nbytes / calls)
            self._sections.append((phase, flops, nbytes, calls, dur_s))
            args.update(gflops=round(flops / 1e9, 3), mb=round(nbytes / 1e6, 3))
        self.sink.complete(phase, "phase", start_t, dur_s, TID_ENGINE, args)

    def on_tick(self, engine, now: float, wall_s: float) -> None:
        """The tick ended: unless it counted a step call (whose host side the
        counter slowed), its sections refresh the utilization and bandwidth
        gauges and join the run means."""
        if not self._counted_this_tick:
            g = self.registry.gauge
            for phase, flops, nbytes, calls, dur_s in self._sections:
                g(f"roofline_util_{phase}").set(flops / dur_s / self.peak_flops)
                g(f"effective_bw_{phase}").set(nbytes / dur_s)
                acc = self._accum[phase]
                acc[0] += flops
                acc[1] += nbytes
                acc[2] += dur_s
                acc[3] += 1
                acc[4] += calls
        self._sections.clear()
        self._pending.clear()  # work outside a phase (encodes, draft steps)
        self._counted_this_tick = False
        self.sink.complete("tick", "tick", now, wall_s, TID_ENGINE, {"step": engine.steps})

    def compile_event(self, step: str, t: float, count: int) -> None:
        self.sink.instant(f"jit_compile:{step}", "compile", t, TID_ENGINE,
                          {"compiled_variants": count})

    # -- summaries / export --------------------------------------------------

    def utilization_summary(self) -> dict:
        """Run-mean utilization per phase over the profiled ticks that
        counted no call (robust to per-tick jitter, unlike the last-tick
        gauges); ``None`` for a phase with no such tick."""
        out = {"peak_flops": self.peak_flops, "peak_bw": self.peak_bw}
        for phase in PHASES:
            flops, nbytes, wall, ticks, calls = self._accum[phase]
            if not ticks:
                out[phase] = None
                continue
            out[phase] = {
                "flops_per_call": flops / calls,
                "hbm_bytes_per_call": nbytes / calls,
                "calls": self._seen_calls.get(phase, 0),
                "wall_s": round(wall, 6),
                "roofline_util_mean": flops / wall / self.peak_flops if wall > 0 else None,
                "effective_bw_mean": nbytes / wall if wall > 0 else None,
            }
        return out

    def add_request_traces(self, traces) -> None:
        """Render retired requests' lifecycle spans into per-request lanes."""
        for tr in traces:
            tid = TID_REQ_BASE + tr.rid
            self.sink.thread_name(tid, f"req {tr.rid}")
            for name, a, b in tr.spans():
                self.sink.complete(name, "request", a, b - a, tid, {"rid": tr.rid})
            for t, n in tr.token_times:
                self.sink.instant("tokens", "request", t, tid, {"n": n})

    def finalize(self, tracer=None) -> str | None:
        """Fold completed request traces in and write the trace file (when a
        path is configured).  Idempotent."""
        if self._finalized:
            return self.trace_path
        self._finalized = True
        if tracer is not None:
            self.add_request_traces(tracer.completed)
        if self.trace_path:
            write_trace(self.trace_path, [self.sink])
            return self.trace_path
        return None


def validate_trace(doc: dict) -> list[str]:
    """Structural validation of a trace-event JSON document (the shape
    Perfetto's legacy-JSON importer requires).  Returns human-readable
    errors; empty means loadable."""
    errors: list[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["missing traceEvents"]
    evs = doc["traceEvents"]
    if not isinstance(evs, list) or not evs:
        return ["traceEvents must be a non-empty list"]
    last_ts: dict[tuple, float] = {}
    for i, ev in enumerate(evs):
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                errors.append(f"event {i}: missing {key}")
        ph = ev.get("ph")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i}: bad ts {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i}: complete event with bad dur {dur!r}")
        lane = (ev.get("pid"), ev.get("tid"))
        if ts < last_ts.get(lane, -math.inf):
            errors.append(f"event {i}: ts {ts} not monotonic on lane {lane}")
        last_ts[lane] = ts
    return errors


def validate_trace_file(path: str) -> dict:
    with open(path) as fh:
        doc = json.load(fh)
    errors = validate_trace(doc)
    if errors:
        raise ValueError(f"{path} failed trace validation:\n  " + "\n  ".join(errors))
    return doc


def profile_report(engine, snapshot: dict, *, peak_flops: float = PEAK_FLOPS_BF16,
                   peak_bw: float = HBM_BW) -> dict | None:
    """Post-hoc per-phase cost/utilization report from a finished run's
    telemetry snapshot: the per-call costs the engine's profiler counted
    during the run, paired with the measured phase wall-time histograms and
    call counters.

    Returns the ``profile`` block of the serving benchmark document (schema
    v4), or ``None`` for an engine that was not profiled (the port costs a
    step only by running it)."""
    prof = engine.telemetry.profiler
    if prof is None or not prof._costs:
        return None
    hists, counters = snapshot["histograms"], snapshot["counters"]
    out: dict = {"peak_flops": peak_flops, "peak_bw": peak_bw}
    for phase in PHASES:
        cost = next((c for s in _PHASE_STEPS[phase] if (c := prof.step_cost(s)) is not None),
                    None)
        wall = (hists.get(f"{phase}_tick_s") or {}).get("sum", 0.0)
        calls = counters.get(_PHASE_COUNTERS[phase], 0)
        if cost is None or not calls:
            out[phase] = None
            continue
        flops, hbm = cost.flops * calls, cost.hbm_bytes * calls
        out[phase] = {
            "flops_per_call": cost.flops,
            "hbm_bytes_per_call": cost.hbm_bytes,
            "calls": calls,
            "wall_s": round(wall, 6),
            "roofline_util_mean": flops / wall / peak_flops if wall > 0 else None,
            "effective_bw_mean": hbm / wall if wall > 0 else None,
        }
    return out
