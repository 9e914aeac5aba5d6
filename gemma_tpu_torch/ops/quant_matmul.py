"""q4_0 dequant-matmul: y = x @ dequant(W).T, returned in f32.

Counterpart of `gemma_tpu/ops/quant_matmul.py` `quant_matmul` for q4_0.
The kernel is `csrc/q4_0_matmul.cu` (it replaces `_q4_0_kernel`; its
header says what bounds it on the H100 and how the design answers that).

Numerics follow the reference kernel, which switches its dot dtype at
M = 8 (`quant_matmul.py:315`):
* M <= 8 (decode), or f32 activations (evaluation mode): weights and x in
  f32, f32 accumulation;
* M > 8 with bf16 activations (prefill): each dequantized weight rounded to
  bf16, bf16 x, f32 accumulation.
"""
from __future__ import annotations

import torch

from ..kernels import build
from ..quant.qtensor import QGROUP, QTensor, dequant

DECODE_MAX_M = 8  # largest M served by the GEMV launch shape (f32 weights)


def q4_0_matmul_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """The plain PyTorch version: x [..., K] -> [..., N] f32."""
    N, K = qt.shape
    x2 = x.reshape(-1, K)
    if x.dtype == torch.float32 or x2.shape[0] <= DECODE_MAX_M:
        w = dequant(qt, torch.float32)
        y = x2.to(torch.float32) @ w.T
    else:
        w = dequant(qt, torch.bfloat16).to(torch.float32)
        y = x2.to(torch.bfloat16).to(torch.float32) @ w.T
    return y.reshape(*x.shape[:-1], N)


def q4_0_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """y = x @ dequant(qt).T in f32; x [..., K] bf16 or f32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    N, K = qt.shape
    if x.shape[-1] != K:
        raise ValueError(f"q4_0 matmul: x has {x.shape[-1]} features, weight has {K}")
    if x.device.type == "cpu" and qt.device.type == "cpu":
        return q4_0_matmul_plain(x, qt)
    if x.device.type != "cuda" or qt.device != x.device:
        raise ValueError(f"q4_0 matmul: x on {x.device}, weight on {qt.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q4_0 matmul kernel takes bf16 or f32 activations, got {x.dtype}")
    if K % QGROUP:
        raise ValueError(f"q4_0 matmul kernel needs K % {QGROUP} == 0, got K={K}")
    if not (qt.qs.is_contiguous() and qt.scales.is_contiguous()) or qt.qs.data_ptr() % 16:
        raise ValueError("q4_0 matmul kernel needs contiguous buffers and 16-byte aligned qs")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    y = torch.empty(M, N, dtype=torch.float32, device=x.device)
    if M == 0:
        return y.reshape(*lead, N)
    lib = build.load()
    err = lib.gt_q4_0_matmul(
        x2.data_ptr(), build.DTYPE_CODES[x2.dtype], qt.qs.data_ptr(), qt.scales.data_ptr(),
        y.data_ptr(), M, N, K, build.stream_ptr(x.device),
    )
    build.check(err, f"q4_0 matmul M={M} N={N} K={K}")
    q4_0_matmul.launches += 1
    return y.reshape(*lead, N)


q4_0_matmul.launches = 0
