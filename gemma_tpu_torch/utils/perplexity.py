"""Perplexity evaluation: the Δppl quality gate.

Counterpart of `gemma_tpu/utils/perplexity.py`: scores a token stream with
the model's own forward over windows of `ctx` tokens, teacher-forced, as
the mean negative log-likelihood of the predicted positions. Each window
runs from position 0 in a fresh cache, computes every row's logits
(`logits_at=None`) and scores positions 1..real-1.

The reference pads a short tail window to `ctx` (one compiled shape) and
masks the padded positions out of the sum; the port runs the tail at its
own length (eager PyTorch compiles nothing). Attention is causal, so the
scored positions see what they see in the reference.

On the card, f32 activations (the default: ggml's evaluation arithmetic)
take the kernels' f32 routes at M = window, the tied head included: the
TF32 tensor-core tile of every format, and the TF32 flash kernel.
One window's logits are [T, vocab] f32 (524 MB at Gemma-2B's vocab and
512 tokens), and log-softmax takes as much again: only one window is
alive at a time.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class PerplexityResult:
    nll: float
    ppl: float
    n_tokens: int


@torch.no_grad()
def _window_nll(model, cfg, window: np.ndarray) -> float:
    """Sum of the NLL of window[1:] given their prefixes (window [T] token
    ids, T >= 2), from one forward at positions 0..T-1 into a fresh cache."""
    from ..models import gemma
    from ..runtime.kv_cache import KVCache, to_device

    dev = model.device
    T = len(window)
    toks = to_device(torch.from_numpy(np.asarray(window, np.int64))[None], dev)
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None]
    limit = to_device(torch.tensor([T], dtype=torch.int32), dev)
    cache = KVCache.create(cfg, 1, T, dtype=cfg.act_dtype, device=dev)
    logits = gemma.forward(model, cfg, toks, positions, cache, write_index=0, kv_limit=limit)
    del cache
    logp = torch.log_softmax(logits[0, :-1].to(torch.float32), dim=-1)
    del logits
    nll = -logp.gather(1, toks[0, 1:, None])[:, 0]
    return float(nll.sum())


def evaluate(
    model,
    cfg,
    tokens: list[int] | np.ndarray,
    ctx: int = 512,
    stride: int | None = None,
    precision: str = "float32",
) -> PerplexityResult:
    """Sliding-window perplexity (non-overlapping windows by default).

    `precision` sets the activation dtype: float32 (default) matches
    ggml's f32 evaluation arithmetic for the Δppl gate; "bfloat16" scores
    with the serving path's numerics. The model runs where its weights lie
    (the card, unless it was loaded onto the CPU)."""
    if precision != cfg.activation_dtype:
        cfg = dataclasses.replace(cfg, activation_dtype=precision)
    tokens = np.asarray(tokens, np.int64)
    stride = stride or ctx
    total_nll = 0.0
    total_n = 0
    for start in range(0, max(1, len(tokens) - 1), stride):
        window = tokens[start : start + ctx]
        if len(window) < 2:
            break
        total_nll += _window_nll(model, cfg, window)
        total_n += len(window) - 1
    nll = total_nll / max(total_n, 1)
    return PerplexityResult(nll=nll, ppl=math.exp(nll), n_tokens=total_n)
