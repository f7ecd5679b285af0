"""Continuous-batching serving engine over a paged (optionally MXFP4) KV pool."""

from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.paged_cache import PagedCache, PagedKV
from repro_torch.serve.scheduler import Request, RequestState, Scheduler

__all__ = ["Engine", "EngineConfig", "PagedCache", "PagedKV", "Request", "RequestState",
           "Scheduler"]
