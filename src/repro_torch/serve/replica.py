"""Data-parallel engine replicas over disjoint rank groups.

Port of ``repro.serve.replica`` in one process a rank (SPMD): a world of
``tp * dp`` ranks, replica ``r`` the ranks ``r*tp .. r*tp + tp - 1``, each
rank holding its replica's :class:`~repro_torch.serve.engine.Engine` (with
its tensor-parallel :class:`~repro_torch.serve.placement.Placement`).
Every rank runs the same serving loop: the same ``submit`` calls in the
same order, the same ``step`` / ``drain`` calls.  Replicas share no data-plane
traffic; the host-side machinery is the reference's:

* **placement** — on ``submit`` every rank all-gathers each replica's
  ``(free_pages, free_slots)`` (from its group's first rank) and runs the
  same :class:`~repro_torch.serve.placement.ReplicaPlacer`, so all ranks
  agree where the request goes; only that replica's ranks submit it;
* **identity** — every rank advances one request-id counter on every
  submit, its replica's scheduler draws from it (``Scheduler(ids=...)``),
  so rids are globally unique and ``completed`` merges in submission order;
* **accounting** — each replica's busy seconds accrue in ``busy_s``;
  replicas step concurrently, so aggregate throughput is total tokens over
  ``max(busy_s)``;
* **telemetry** — :meth:`ReplicatedEngine.aggregate_telemetry` merges the
  replicas' registries (``telemetry.registry.merge_registries``):
  counters sum, histograms pool their samples;
* **profiling** — with ``TelemetryConfig.profile_trace_path`` set, each
  replica records its own trace lane (``pid`` = replica index) and
  :meth:`ReplicatedEngine.write_profile` writes one document from rank 0.

The weights are the world's rank 0's: broadcast to every rank once, then to
each group from its first rank by the engine's placement.  Exactness: a
request's tokens depend only on its replica's engine, and each replica is
token-exact against one device, so the ensemble is too.

The gathers here (inventories, completions, telemetry) are world
collectives: every rank must call ``submit``, ``step``, ``drain``,
``completed``, ``sched.pending``, ``cache_bytes``, ``aggregate_telemetry``
and ``write_profile`` in the same order.
"""

from __future__ import annotations

import dataclasses
import itertools
import time

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import make_serve_meshes, rank_device, world_rank, world_size
from repro_torch.models.registry import Model
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.placement import (Placement, ReplicaPlacer, ShardingConfig,
                                         broadcast_tree)
from repro_torch.serve.scheduler import Request

_STEP_KEYS = ("admitted", "prefilling", "decoding", "queued")


def _gather_rows(values: list[int]) -> list[list[int]]:
    """Every world rank's int64 ``values`` (one length on every rank), in
    rank order."""
    t = torch.tensor(values, dtype=torch.int64, device=rank_device())
    parts = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t)
    return [p.tolist() for p in parts]


class _SchedView:
    """The scheduler facade that loops written against ``engine.sched`` read:
    ``pending`` over every replica (a world collective), ``queue`` and
    ``prefilling()`` of this rank's replica."""

    def __init__(self, rep: "ReplicatedEngine"):
        self._rep = rep

    @property
    def pending(self) -> int:
        return self._rep._replica_sum(self._rep.engine.sched.pending)

    @property
    def queue(self):
        return self._rep.engine.sched.queue

    def prefilling(self):
        return self._rep.engine.sched.prefilling()


class ReplicatedEngine:
    """``dp`` data-parallel Engine replicas behind the Engine's serving API
    (``submit`` / ``step`` / ``drain`` / ``completed`` / ``sched.pending``)."""

    def __init__(self, model: Model, params, config: EngineConfig | None = None,
                 sharding: ShardingConfig | None = None):
        config = config or EngineConfig()
        sharding = sharding or config.sharding or ShardingConfig()
        if sharding.dp < 2:
            raise ValueError("ReplicatedEngine needs dp >= 2; use Engine for dp=1")
        tp, dp = sharding.tp, sharding.dp
        meshes = make_serve_meshes(tp, dp)
        if world_size() != tp * dp:
            raise ValueError(f"tp={tp} x dp={dp} replicas need a world of {tp * dp} ranks, "
                             f"one process each; this world has {world_size()}")
        self.sharding, self.tp, self.dp = sharding, tp, dp
        self.replica = world_rank() // tp
        broadcast_tree(params, src=0)  # every replica serves rank 0's weights
        # replicas validate tp only; a shared profile trace path is kept here
        # (replicas would clobber one file) and write_profile() merges lanes
        rep_cfg = dataclasses.replace(config, sharding=None)
        self.profile_trace_path = None
        tel = rep_cfg.telemetry
        if tel is not None and tel.profile_trace_path:
            self.profile_trace_path = tel.profile_trace_path
            rep_cfg = dataclasses.replace(rep_cfg, telemetry=dataclasses.replace(
                tel, profile_trace_path=None, profile=True))
        self._ids = itertools.count()  # advanced on every rank by every submit
        self.engine = Engine(model, params, rep_cfg,
                             placement=Placement(tp, mesh=meshes[self.replica]), ids=self._ids)
        if self.engine.telemetry.profiler is not None:
            self.engine.telemetry.profiler.pid = self.replica
        self.placer = ReplicaPlacer(dp)
        self._busy = 0.0  # this replica's busy seconds
        self.sched = _SchedView(self)
        self.model, self.config = model, config
        self.paged = self.engine.paged
        self.decode_backend = self.engine.decode_backend
        self.steps = 0

    # -- world gathers over the replicas (each group's first rank) ----------

    def _per_replica(self, values: list[int]) -> list[list[int]]:
        rows = _gather_rows(values)
        return [rows[r * self.tp] for r in range(self.dp)]

    def _replica_sum(self, value: int) -> int:
        return sum(v[0] for v in self._per_replica([value]))

    def _objects(self, obj) -> list:
        """Each replica's ``obj`` (from its group's first rank), in replica
        order, on every rank."""
        out = [None] * world_size()
        dist.all_gather_object(out, obj)
        return [out[r * self.tp] for r in range(self.dp)]

    # ------------------------------------------------------------------ API

    def submit(self, prompt, max_new: int, extra=None, arrival_time: float | None = None,
               sampling=None) -> Request:
        """Place the request on the replica with most free pages (then
        slots, then round-robin); its ranks queue it, the others keep a
        record of it (``replica`` says where it went)."""
        eng = self.engine
        prompt = eng.sched.check_request(prompt, max_new)
        free = [eng.cache.free_pages if eng.paged else eng.config.n_slots,
                len(eng.sched.free_slots)]
        inv = self._per_replica(free)
        r = self.placer.place([p for p, _ in inv], [s for _, s in inv])
        if r == self.replica:
            req = eng.submit(prompt, max_new, extra=extra, arrival_time=arrival_time,
                             sampling=sampling)
        else:
            req = Request(rid=next(self._ids), prompt=prompt, max_new=max_new,
                          sampling=sampling)
        req.replica = r
        return req

    def step(self, now: float | None = None) -> dict:
        """Tick this rank's replica if it has work, on world rank 0's clock;
        returns the counts summed over replicas and each replica's busy
        seconds of this tick (``busy_s``)."""
        t = torch.tensor([time.monotonic() if now is None else now], dtype=torch.float64,
                         device=rank_device())
        dist.broadcast(t, src=0)
        info = dict.fromkeys(_STEP_KEYS, 0)
        dt = 0.0
        if self.engine.sched.pending:
            t0 = time.perf_counter()
            info = self.engine.step(now=float(t.item()))
            dt = time.perf_counter() - t0
            self._busy += dt
        self.steps += 1
        rows = self._per_replica([info[k] for k in _STEP_KEYS] + [int(dt * 1e9)])
        out = {k: sum(row[i] for row in rows) for i, k in enumerate(_STEP_KEYS)}
        out["step"] = self.steps
        out["busy_s"] = [row[-1] / 1e9 for row in rows]
        return out

    def drain(self, max_steps: int = 100_000) -> list[Request]:
        while self.sched.pending:
            self.step()
            if self.steps > max_steps:
                raise RuntimeError("drain exceeded max_steps — engine wedged?")
        return self.completed

    @property
    def completed(self) -> list[Request]:
        """Every replica's finished requests in submission (rid) order, on
        every rank (without their conditioning tensors)."""
        mine = [dataclasses.replace(r, extra=None) for r in self.engine.completed]
        for r in mine:
            r.replica = self.replica
        return sorted((r for reqs in self._objects(mine) for r in reqs), key=lambda r: r.rid)

    @property
    def busy_s(self) -> list[float]:
        """Each replica's busy seconds so far."""
        return [v[0] / 1e9 for v in self._per_replica([int(self._busy * 1e9)])]

    def cache_bytes(self) -> int:
        return self._replica_sum(self.engine.cache_bytes())

    def aggregate_telemetry(self) -> dict:
        """One merged snapshot over the replicas
        (``telemetry.registry.merge_registries``): counters sum; gauges ending
        ``_peak`` take the max, ``_watermark`` the min, others the mean;
        histograms pool their reservoirs and buckets, so the percentiles are
        over every replica's samples; binned counts add; EWMA rates sum."""
        from repro_torch.serve.telemetry.registry import merge_registries

        merged = merge_registries(self._objects(self.engine.telemetry.registry))
        agg = merged.snapshot()
        agg["replicas"] = self.dp
        return agg

    def write_profile(self, path: str | None = None) -> str | None:
        """Finalize every replica's profiler and write ONE Chrome-trace
        document (world rank 0 writes it), a process lane per replica.
        Returns the path, or None when profiling is off."""
        from repro_torch.serve.telemetry.profiling import write_trace

        path = path or self.profile_trace_path
        prof = self.engine.telemetry.profiler
        sink = None
        if prof is not None:
            prof.finalize(self.engine.telemetry.tracer)
            sink = prof.sink
        sinks = [s for s in self._objects(sink) if s is not None]
        if not sinks or path is None:
            return None
        if world_rank() == 0:
            write_trace(path, sinks)
        dist.barrier()
        return path


def make_engine(model: Model, params, config: EngineConfig | None = None):
    """The engine ``EngineConfig.sharding`` asks for: an :class:`Engine`
    (tensor-parallel when ``tp > 1``) for ``dp == 1``, a
    :class:`ReplicatedEngine` for ``dp > 1``."""
    config = config or EngineConfig()
    sh = config.sharding
    if sh is not None and sh.dp > 1:
        return ReplicatedEngine(model, params, config, sh)
    return Engine(model, params, config)
