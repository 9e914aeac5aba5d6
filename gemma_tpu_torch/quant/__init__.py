"""Quantized weights in the port's Hopper layout."""
from .qtensor import QTensor, dequant, from_ggml, gather_dequant

__all__ = ["QTensor", "dequant", "from_ggml", "gather_dequant"]
