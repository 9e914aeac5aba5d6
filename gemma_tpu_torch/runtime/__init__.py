"""Serving runtime: KV cache, sampler and engine."""
from .engine import Engine, EngineConfig
from .kv_cache import KVCache
from .sampler import SamplingParams, sample

__all__ = ["Engine", "EngineConfig", "KVCache", "SamplingParams", "sample"]
