"""Token samplers: greedy, temperature, top-k, top-p.

Counterpart of `gemma_tpu/runtime/sampler.py`. Randomness comes from an
explicit `torch.Generator`, so it cannot reproduce the reference's
`jax.random` streams; greedy is exact.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1 => disabled

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0


def sample(
    logits: torch.Tensor,  # [B, vocab] f32
    params: SamplingParams,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Returns sampled token ids [B] int32."""
    if params.is_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("non-greedy sampling needs a torch.Generator")
    logits = logits.to(torch.float32) / params.temperature

    if 0 < params.top_k < logits.shape[-1]:
        kth = torch.topk(logits, params.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)

    if params.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p (always
        # keeping the most probable token)
        keep = cum - probs < params.top_p
        threshold = torch.where(keep, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < threshold, -torch.inf, logits)

    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
