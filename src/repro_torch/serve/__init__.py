"""Continuous-batching serving engine over a paged (optionally MXFP4) KV pool,
with per-request sampling, prefix sharing, speculative decoding, built-in
telemetry, and tensor- and data-parallel serving over torch.distributed."""

from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.paged_cache import DenseSlotCache, PagedCache, PagedKV
from repro_torch.serve.placement import Placement, ReplicaPlacer, ShardingConfig
from repro_torch.serve.prefix_cache import PrefixIndex
from repro_torch.serve.replica import ReplicatedEngine, make_engine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import Request, RequestState, Scheduler
from repro_torch.serve.spec import SpecConfig
from repro_torch.serve.state_pool import CrossIndex, StatePool
from repro_torch.serve.telemetry import EngineTelemetry, MetricsRegistry, TelemetryConfig

__all__ = ["CrossIndex", "DenseSlotCache", "Engine", "EngineConfig", "EngineTelemetry",
           "MetricsRegistry", "PagedCache", "PagedKV", "Placement", "PrefixIndex",
           "ReplicaPlacer", "ReplicatedEngine", "Request", "RequestState", "SamplingParams",
           "Scheduler", "ShardingConfig", "SpecConfig", "StatePool", "TelemetryConfig",
           "make_engine"]
