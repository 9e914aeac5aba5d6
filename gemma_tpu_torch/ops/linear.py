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

While profiling is on, each distinct matmul shape is counted once as
`trace.matmul.{path}.{fmt}[NxK]xM{m}` (path: `cuda` for a kernel launch,
`plain` for a plain version, `dense` for `torch.matmul`). The reference
records it once per compiled graph, at trace time; eager PyTorch traces
nothing, so the port records it once per key.
"""
from __future__ import annotations

import torch

from ..quant.qtensor import QTensor
from ..utils import profiling
from . import quant_matmul as qmm


def _trace_count(x: torch.Tensor, w) -> None:
    """The op-shape histogram (one count per distinct key)."""
    if not profiling.is_enabled():
        return
    m = x.numel() // x.shape[-1]
    if isinstance(w, QTensor):
        shape, fmt = w.shape, w.fmt
        path = "plain" if x.device.type == "cpu" or qmm.forcing_plain() else "cuda"
    else:
        shape, fmt, path = tuple(w.shape), str(w.dtype).removeprefix("torch."), "dense"
    profiling.count_once(f"trace.matmul.{path}.{fmt}[{shape[0]}x{shape[1]}]xM{m}")


def linear(x: torch.Tensor, w, *, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y = x @ w.T for w a dense [out, in] tensor or a QTensor.

    x: [..., in]; returns [..., out] in x.dtype (or out_dtype)."""
    out_dtype = out_dtype or x.dtype
    _trace_count(x, w)
    if isinstance(w, QTensor):
        return qmm.quant_matmul(x, w).to(out_dtype)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32).T).to(out_dtype)
