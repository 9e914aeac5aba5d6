"""Serving runtime: KV caches, sampler, engine, scheduler, serve() and speculative decoding.

The cross-process prefill -> decode hand-off is the submodule `kv_transfer`
(not imported here: `python -m gemma_tpu_torch.runtime.kv_transfer` runs it)."""
from .engine import Engine, EngineConfig
from .kv_cache import KVCache
from .paged_kv import PageAllocator, PagedKVCache
from .sampler import SamplingParams, sample
from .scheduler import Request, Scheduler
from .serving import serve
from .speculative import SpecDecoder

__all__ = ["Engine", "EngineConfig", "KVCache", "PageAllocator", "PagedKVCache", "Request",
           "SamplingParams", "Scheduler", "SpecDecoder", "sample", "serve"]
