"""Gemma model: configuration, parameters and forward pass."""
from .config import GEMMA_2B, GEMMA_7B, GemmaConfig
from .gemma import Gemma, forward
from .params import from_jax_params, load_params

__all__ = ["GEMMA_2B", "GEMMA_7B", "Gemma", "GemmaConfig", "forward", "from_jax_params", "load_params"]
