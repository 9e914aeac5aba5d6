"""Gemma model: configuration, parameters and forward pass.

The registry keys a decoder family by the GGUF `general.architecture`
string: `register_architecture(name, config_cls=, forward=)` adds one and
`get_architecture(name)` returns {"config_cls", "forward"}. "gemma" and
"gemma2" are registered, as in the reference.
"""
from __future__ import annotations

from typing import Callable

from . import gemma
from .config import GEMMA_2B, GEMMA_7B, GemmaConfig
from .gemma import Gemma, forward
from .params import from_jax_params, load_params

_REGISTRY: dict[str, dict] = {}


def register_architecture(name: str, *, config_cls, forward: Callable) -> None:
    _REGISTRY[name] = {"config_cls": config_cls, "forward": forward}


def get_architecture(name: str) -> dict:
    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


register_architecture("gemma", config_cls=GemmaConfig, forward=gemma.forward)
register_architecture("gemma2", config_cls=GemmaConfig, forward=gemma.forward)

__all__ = ["GEMMA_2B", "GEMMA_7B", "Gemma", "GemmaConfig", "forward", "from_jax_params", "get_architecture",
           "gemma", "load_params", "register_architecture"]
