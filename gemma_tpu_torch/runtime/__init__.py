"""Serving runtime: KV caches, sampler, engine, scheduler, serve() and speculative decoding."""
from .engine import Engine, EngineConfig
from .kv_cache import KVCache
from .paged_kv import PageAllocator, PagedKVCache
from .sampler import SamplingParams, sample
from .scheduler import Request, Scheduler
from .serving import serve
from .speculative import SpecDecoder

__all__ = ["Engine", "EngineConfig", "KVCache", "PageAllocator", "PagedKVCache", "Request",
           "SamplingParams", "Scheduler", "SpecDecoder", "sample", "serve"]
