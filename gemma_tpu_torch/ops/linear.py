"""Linear / matmul dispatch.

Counterpart of `gemma_tpu/ops/linear.py`. All model projections route
through `linear`:
* a `QTensor` goes to the op of its format (`ops.quant_matmul.quant_matmul`:
  q4_0, q8_0, q4_k or q6_k), whose wrapper runs the plain version for CPU tensors
  and the CUDA kernel for CUDA tensors — there is no dequant-and-dot
  fallback on CUDA;
* a dense [out, in] weight goes to `torch.matmul` in f32 (products of bf16
  values are exact in f32, so this is the reference's bf16 dot with f32
  accumulation).
"""
from __future__ import annotations

import torch

from ..quant.qtensor import QTensor
from .quant_matmul import quant_matmul


def linear(x: torch.Tensor, w, *, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y = x @ w.T for w a dense [out, in] tensor or a QTensor.

    x: [..., in]; returns [..., out] in x.dtype (or out_dtype)."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, QTensor):
        return quant_matmul(x, w).to(out_dtype)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32).T).to(out_dtype)
