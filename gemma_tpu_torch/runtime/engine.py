"""Inference engine: prefill, decode steps and generation loops.

Counterpart of `gemma_tpu/runtime/engine.py` (dense cache, unchunked
prefill). PyTorch runs eagerly, so there is no jit and no power-of-two
bucketing: a batch of prompts is right-padded to its longest prompt and the
kernels see the true T. The cache is updated in place (the reference
donates it through jit). The host never waits on the device inside the
decode loop except to check EOS every `eos_check_every` tokens; CUDA graphs
are later work.

`EngineConfig.paged`, `kv_quantized` and `prefill_chunk` are not ported
yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..models import gemma
from ..models.config import GemmaConfig
from .kv_cache import KVCache
from .sampler import SamplingParams, sample


@dataclasses.dataclass
class EngineConfig:
    max_seq_len: int = 512
    max_batch: int = 1
    kv_dtype: torch.dtype = torch.bfloat16
    kv_quantized: bool = False  # int8 KV: ROADMAP queue 1, item 3
    paged: bool = False  # paged KV: ROADMAP queue 1, item 5
    prefill_chunk: int = 0  # chunked prefill: ROADMAP queue 1, item 4

    def __post_init__(self):
        for flag, item in (("kv_quantized", 3), ("paged", 5), ("prefill_chunk", 4)):
            if getattr(self, flag):
                raise NotImplementedError(
                    f"EngineConfig.{flag} is not ported to gemma_tpu_torch yet "
                    f"(ROADMAP queue 1, item {item})"
                )


class Engine:
    """Runs one model on its device with one dense-cache geometry."""

    def __init__(self, cfg: GemmaConfig, params: gemma.Gemma, engine_cfg: EngineConfig | None = None):
        self.cfg = cfg
        self.params = params
        self.ecfg = engine_cfg or EngineConfig()
        self.device = params.device

    def new_cache(self, batch: int | None = None) -> KVCache:
        return KVCache.create(
            self.cfg, batch or self.ecfg.max_batch, self.ecfg.max_seq_len,
            dtype=self.ecfg.kv_dtype, device=self.device,
        )

    # -- raw steps ---------------------------------------------------------
    @torch.no_grad()
    def prefill(self, prompts: list[list[int]], cache: KVCache | None = None):
        """Right-pad a batch of prompts to the longest and run one forward.

        Returns (logits at each prompt's last token [B, vocab] f32, cache)."""
        B = len(prompts)
        lengths = [len(p) for p in prompts]
        T = max(lengths)
        if min(lengths) < 1 or T > self.ecfg.max_seq_len:
            raise ValueError(
                f"prompt lengths {lengths} must be in [1, max_seq_len={self.ecfg.max_seq_len}]"
            )
        toks = torch.zeros(B, T, dtype=torch.int64)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = torch.tensor(p, dtype=torch.int64)
        toks = toks.to(self.device)
        lengths_t = torch.tensor(lengths, dtype=torch.int32, device=self.device)
        positions = torch.arange(T, dtype=torch.int32, device=self.device).expand(B, T)
        cache = cache if cache is not None else self.new_cache(B)
        logits = gemma.forward(
            self.params, self.cfg, toks, positions, cache,
            write_index=0, kv_limit=lengths_t, logits_at=lengths_t - 1,
        )
        cache.length = lengths_t
        return logits[:, 0], cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: KVCache):
        """tokens [B]: append one position per sequence. Returns (logits
        [B, vocab] f32, cache)."""
        positions = cache.length[:, None]
        logits = gemma.forward(
            self.params, self.cfg, tokens.to(self.device)[:, None], positions, cache,
            write_index=cache.length, kv_limit=cache.length + 1,
        )
        cache.advance(1)
        return logits[:, 0], cache

    # -- public API --------------------------------------------------------
    def generate(
        self,
        prompts: list[list[int]],
        max_new_tokens: int,
        sampling: SamplingParams = SamplingParams(),
        eos_id: int | None = None,
        seed: int = 0,
        on_token: Callable[[int, list[int]], None] | None = None,
        eos_check_every: int = 8,
    ) -> list[list[int]]:
        """Prefill, then decode with per-sequence EOS stopping."""
        if max_new_tokens <= 0:
            return [[] for _ in prompts]
        logits, cache = self.prefill(prompts)
        return self.generate_from(
            logits, cache, max_new_tokens, sampling=sampling, eos_id=eos_id, seed=seed,
            on_token=on_token, eos_check_every=eos_check_every,
        )

    @torch.no_grad()
    def generate_from(
        self,
        logits: torch.Tensor,
        cache: KVCache,
        max_new_tokens: int,
        sampling: SamplingParams = SamplingParams(),
        eos_id: int | None = None,
        seed: int = 0,
        on_token: Callable[[int, list[int]], None] | None = None,
        eos_check_every: int = 8,
    ) -> list[list[int]]:
        """Decode from already-prefilled (logits, cache), so callers can time
        prefill and decode apart. Syncs with the host only every
        `eos_check_every` tokens (every token when streaming via
        `on_token`)."""
        B = logits.shape[0]
        # each decode step writes the incoming token's K/V at slot `length`,
        # so exactly max_seq_len - prompt_len steps fit
        prompt_len = int(cache.length.max())
        budget = min(max_new_tokens, self.ecfg.max_seq_len - prompt_len)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        device_toks: list[torch.Tensor] = []
        out: list[list[int]] = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        emitted = 0

        def drain() -> bool:
            """Pull pending tokens to the host; True when every sequence hit EOS."""
            nonlocal emitted
            for t in device_toks[emitted:]:
                t_np = t.cpu().numpy()
                for b in range(B):
                    if not done[b]:
                        out[b].append(int(t_np[b]))
                        if eos_id is not None and t_np[b] == eos_id:
                            done[b] = True
                if on_token is not None:
                    on_token(emitted, [int(v) for v in t_np])
                emitted += 1
                if done.all():
                    return True
            return bool(done.all())

        check_every = 1 if on_token is not None else max(1, eos_check_every)
        for i in range(budget):
            tok = sample(logits, sampling, gen)
            logits, cache = self.decode_step(tok, cache)
            device_toks.append(tok)
            if (eos_id is not None or on_token is not None) and (i + 1) % check_every == 0:
                if drain():
                    break
        drain()
        return out

    @torch.no_grad()
    def generate_fused(
        self,
        prompts: list[list[int]],
        max_new_tokens: int,
        sampling: SamplingParams = SamplingParams(),
        seed: int = 0,
    ) -> np.ndarray:
        """Throughput path: no host sync until the end, no early EOS exit.
        Returns the [B, max_new_tokens] token matrix."""
        logits, cache = self.prefill(prompts)
        prompt_len = int(cache.length.max())
        if max_new_tokens > self.ecfg.max_seq_len - prompt_len:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} exceeds cache capacity "
                f"({self.ecfg.max_seq_len} - prompt {prompt_len})"
            )
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        toks = []
        for _ in range(max_new_tokens):
            tok = sample(logits, sampling, gen)
            logits, cache = self.decode_step(tok, cache)
            toks.append(tok)
        if not toks:
            return np.zeros((len(prompts), 0), np.int32)
        return torch.stack(toks, dim=1).cpu().numpy()
