"""Serving runtime: KV caches, sampler, engine, scheduler and serve()."""
from .engine import Engine, EngineConfig
from .kv_cache import KVCache
from .paged_kv import PageAllocator, PagedKVCache
from .sampler import SamplingParams, sample
from .scheduler import Request, Scheduler
from .serving import serve

__all__ = ["Engine", "EngineConfig", "KVCache", "PageAllocator", "PagedKVCache", "Request",
           "SamplingParams", "Scheduler", "sample", "serve"]
