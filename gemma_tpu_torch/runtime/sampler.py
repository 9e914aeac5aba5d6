"""Token samplers: greedy, temperature, top-k, top-p.

Counterpart of `gemma_tpu/runtime/sampler.py`. Randomness comes from an
explicit `torch.Generator`, so it cannot reproduce the reference's
`jax.random` streams; greedy is exact.

A step draws one uniform per row of the whole batch, in one call, and
samples each row by inverse CDF over its filtered probabilities. A caller
that computes only some rows of the batch (`TPEngine`'s data groups) passes
the batch's logits and those `rows`: the generator advances by the whole
batch on every rank, so the ranks stay in step and every row gets its own
uniform, as the reference's one split key over the gathered [B, V] logits
gives every row its own noise.
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
    rows: slice = slice(None),
) -> torch.Tensor:
    """Returns the sampled token ids of `rows` of the batch, [len(rows)]
    int32. Non-greedy: B uniforms from `generator` whatever `rows` is;
    only `rows` of `logits` are read."""
    if params.is_greedy:
        return torch.argmax(logits[rows], dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("non-greedy sampling needs a torch.Generator")
    u = torch.rand(logits.shape[0], generator=generator, device=generator.device)[rows]
    logits = logits[rows].to(torch.float32) / params.temperature

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

    # inverse CDF: the first token whose cumulative probability exceeds
    # u * total; a filtered token (probability 0) never is that token, and
    # the clamp keeps u * total rounding up to the total on the last token
    # that has any probability
    probs = torch.softmax(logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    target = u.to(cum.device)[:, None] * cum[:, -1:]
    tok = torch.searchsorted(cum, target, right=True)[:, 0]
    last = probs.shape[-1] - 1 - torch.argmax((probs.flip(-1) > 0).to(torch.int8), dim=-1)
    return torch.minimum(tok, last).to(torch.int32)
