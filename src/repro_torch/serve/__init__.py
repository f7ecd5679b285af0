"""Continuous-batching serving engine over a paged (optionally MXFP4) KV pool,
with per-request sampling, prefix sharing, speculative decoding and built-in
telemetry."""

from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.paged_cache import PagedCache, PagedKV
from repro_torch.serve.prefix_cache import PrefixIndex
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import Request, RequestState, Scheduler
from repro_torch.serve.spec import SpecConfig
from repro_torch.serve.telemetry import EngineTelemetry, MetricsRegistry, TelemetryConfig

__all__ = ["Engine", "EngineConfig", "EngineTelemetry", "MetricsRegistry", "PagedCache",
           "PagedKV", "PrefixIndex", "Request", "RequestState", "SamplingParams", "Scheduler",
           "SpecConfig", "TelemetryConfig"]
