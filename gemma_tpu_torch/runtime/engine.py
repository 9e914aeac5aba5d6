"""Inference engine: prefill, decode steps and generation loops.

Counterpart of `gemma_tpu/runtime/engine.py`. PyTorch runs eagerly, so
there is no jit and no power-of-two bucketing: a batch of prompts is
right-padded to its longest prompt and the kernels see the true T. The
cache, dense or paged, bf16/f32 or int8 (`EngineConfig`), is updated in
place (the reference donates it through jit). The host never waits on the
device inside the decode loop except to check EOS every `eos_check_every`
tokens; CUDA graphs are later work.

Prompts longer than `prefill_chunk` (when set) prefill in chunks of that
many tokens, carrying each sequence's last-token logits from chunk to
chunk on the device. `prefill_standalone` and `insert_sequence` are the
prefill -> serving-cache hand-off of the continuous-batching scheduler.

With `utils.profiling` enabled, the engine reports the reference's spans
(`prefill.dispatch[B=..,T=..]`, `prefill.chunk[B=..,C=..]`,
`decode.dispatch`, `decode.block[n=..]`), the `tokens.prefilled` and
`tokens.decoded` counters and the `decode.steps[B=..]` roofline entry
(weight bytes x steps, 2 x weight elements x steps x batch), and in the
sampled-synchronous mode synchronizes every Nth decode dispatch;
disabled, none of that touches a tensor. `capture_activations` runs one
forward under `utils.tensor_dump.capture` for golden diffs.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable

import numpy as np
import torch

from ..models import gemma
from ..models.config import GemmaConfig
from ..ops.attention import DECODE_SPLIT
from ..quant.qtensor import QTensor
from ..utils import profiling as prof
from .kv_cache import KVCache, to_device
from .paged_kv import PagedKVCache
from .sampler import SamplingParams, sample


@dataclasses.dataclass
class EngineConfig:
    max_seq_len: int = 512
    max_batch: int = 1
    kv_dtype: torch.dtype = torch.bfloat16
    kv_quantized: bool = False  # int8 K/V with per-(position, head) f32 scales
    paged: bool = False  # page tables over shared per-layer page pools
    # None resolves to DECODE_SPLIT (64). The reference's choice
    # (`engine.py:114-134`) encodes TPU measurements; the H100's is open
    # (ROADMAP section 3).
    page_size: int | None = None
    n_pages: int | None = None  # default: max_batch * max_seq_len / page_size + 1
    # prompts longer than this prefill in chunks of this many tokens; 0 = off
    prefill_chunk: int = 0

    def __post_init__(self):
        if self.page_size is None:
            self.page_size = DECODE_SPLIT


class Engine:
    """Runs one model on its device with one cache geometry."""

    def __init__(self, cfg: GemmaConfig, params: gemma.Gemma, engine_cfg: EngineConfig | None = None):
        self.cfg = cfg
        self.params = params
        self.ecfg = engine_cfg or EngineConfig()
        self.device = params.device

    @functools.cached_property
    def _weight_stats(self) -> tuple[int, int]:
        """(bytes, elements) of the model's weights, each counted once (a
        tied head is the embedding)."""
        nbytes = nelems = 0
        for mod in self.params.modules():
            if isinstance(mod, QTensor):
                nbytes += sum(b.numel() * b.element_size() for b in mod.arrays.values())
                nelems += mod.shape[0] * mod.shape[1]
                continue
            for b in mod.buffers(recurse=False):
                nbytes += b.numel() * b.element_size()
                nelems += b.numel()
        return nbytes, nelems

    def _record_decode_roofline(self, n_steps: int, batch: int, seconds: float) -> None:
        if not prof.is_enabled() or n_steps <= 0 or seconds <= 0:
            return
        nbytes, nelems = self._weight_stats
        prof.roofline(f"decode.steps[B={batch}]", seconds=seconds, bytes_moved=nbytes * n_steps,
                      flops=2 * nelems * n_steps * batch)
        prof.add_count("tokens.decoded", n_steps * batch)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def new_cache(self, batch: int | None = None, *, identity_pages: bool = True):
        """A zeroed cache of this engine's geometry. `identity_pages` (paged
        only): give each slot a private page range, so `prefill`/`generate`
        work without an allocator; the scheduler passes False and installs
        each admitted sequence's pages itself."""
        batch = batch or self.ecfg.max_batch
        e = self.ecfg
        if e.paged:
            n_pages = e.n_pages or batch * e.max_seq_len // e.page_size + 1  # +1: trash page 0
            return PagedKVCache.create(
                self.cfg, batch, n_pages, page_size=e.page_size, max_seq_len=e.max_seq_len,
                dtype=e.kv_dtype, device=self.device, quantized=e.kv_quantized,
                identity_layout=identity_pages,
            )
        return KVCache.create(self.cfg, batch, e.max_seq_len, dtype=e.kv_dtype,
                              device=self.device, quantized=e.kv_quantized)

    def pad_tokens(self, prompts: list[list[int]], T: int) -> torch.Tensor:
        """Prompts right-padded to [B, T] on the device."""
        toks = np.zeros((len(prompts), T), np.int64)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
        return to_device(torch.from_numpy(toks), self.device)

    # -- raw steps ---------------------------------------------------------
    @torch.no_grad()
    def prefill(self, prompts: list[list[int]], cache=None):
        """Right-pad a batch of prompts to the longest and run one forward
        (chunks of `prefill_chunk` tokens when the longest is longer).

        Returns (logits at each prompt's last token [B, vocab] f32, cache)."""
        B = len(prompts)
        lengths = [len(p) for p in prompts]
        T = max(lengths)
        if min(lengths) < 1 or T > self.ecfg.max_seq_len:
            raise ValueError(
                f"prompt lengths {lengths} must be in [1, max_seq_len={self.ecfg.max_seq_len}]"
            )
        chunk = self.ecfg.prefill_chunk
        if chunk and T > chunk:
            return self.prefill_chunked(prompts, chunk, cache)
        toks = self.pad_tokens(prompts, T)
        lengths_t = to_device(torch.tensor(lengths, dtype=torch.int32), self.device)
        positions = torch.arange(T, dtype=torch.int32, device=self.device).expand(B, T)
        cache = cache if cache is not None else self.new_cache(B)
        with prof.span(f"prefill.dispatch[B={B},T={T}]"):
            logits = gemma.forward(
                self.params, self.cfg, toks, positions, cache,
                write_index=0, kv_limit=lengths_t, logits_at=lengths_t - 1,
            )
        prof.add_count("tokens.prefilled", sum(lengths))
        cache.length = lengths_t
        return logits[:, 0], cache

    @torch.no_grad()
    def chunk_step(self, tokens: torch.Tensor, start: int, kv_limit: torch.Tensor, cache,
                   lengths: torch.Tensor, prev_last: torch.Tensor):
        """One chunk of a long prefill: tokens [B, C] at positions [start,
        start + C), kv_limit [B] = min(length, start + C). Returns (last
        [B, vocab], cache): each sequence's logits at its last token, taken
        from the chunk that holds it, else carried from `prev_last`, so the
        host never waits between chunks."""
        B, C = tokens.shape
        positions = start + torch.arange(C, dtype=torch.int32, device=self.device).expand(B, C)
        idx = torch.clamp(lengths - 1 - start, 0, C - 1)
        logits = gemma.forward(
            self.params, self.cfg, tokens, positions, cache,
            write_index=start, kv_limit=kv_limit, logits_at=idx,
        )
        cache.length = kv_limit
        in_chunk = (lengths - 1 >= start) & (lengths - 1 < start + C)
        return torch.where(in_chunk[:, None], logits[:, 0], prev_last), cache

    @torch.no_grad()
    def prefill_chunked(self, prompts: list[list[int]], chunk_size: int | None = None, cache=None):
        """Prefill in `chunk_size`-token pieces (the last one cut at the
        longest prompt). A paged cache needs chunk_size to be a multiple of
        the page size. Returns (last logits [B, vocab], cache)."""
        B = len(prompts)
        chunk = chunk_size or self.ecfg.prefill_chunk or 512
        if self.ecfg.paged and chunk % self.ecfg.page_size:
            raise ValueError(f"prefill_chunk ({chunk}) must be a multiple of page_size "
                             f"({self.ecfg.page_size})")
        lengths = np.array([len(p) for p in prompts], np.int32)
        maxlen = int(lengths.max())
        toks = self.pad_tokens(prompts, maxlen)
        cache = cache if cache is not None else self.new_cache(B)
        lengths_d = to_device(torch.from_numpy(lengths), self.device)
        last = torch.zeros(B, self.cfg.vocab_size, dtype=torch.float32, device=self.device)
        for start in range(0, maxlen, chunk):
            limit = to_device(torch.from_numpy(np.minimum(lengths, start + chunk)), self.device)
            with prof.span(f"prefill.chunk[B={B},C={chunk}]"):
                last, cache = self.chunk_step(toks[:, start : start + chunk], start, limit, cache,
                                              lengths_d, last)
        cache.length = lengths_d
        prof.add_count("tokens.prefilled", int(lengths.sum()))
        return last, cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache):
        """tokens [B]: append one position per sequence. Returns (logits
        [B, vocab] f32, cache).

        The write index is clamped to the cache's last slot on the device:
        only rows whose tokens are discarded reach it (idle scheduler slots,
        and the tail of a block past a slot's finish), where the reference's
        scatter drops the write."""
        positions = cache.length[:, None]
        logits = gemma.forward(
            self.params, self.cfg, tokens.to(self.device)[:, None], positions, cache,
            write_index=cache.length.clamp(max=cache.max_len - 1), kv_limit=cache.length + 1,
        )
        cache.advance(1)
        return logits[:, 0], cache

    @torch.no_grad()
    def step(self, logits: torch.Tensor, gen: torch.Generator | None, cache,
             sampling: SamplingParams = SamplingParams()):
        """Sample from `logits`, then decode the sampled tokens. Returns
        (tokens [B] i32, next logits [B, vocab], cache)."""
        tok = sample(logits, sampling, gen)
        logits, cache = self.decode_step(tok, cache)
        return tok, logits, cache

    @torch.no_grad()
    def block(self, logits: torch.Tensor, gen: torch.Generator | None, cache, n: int,
              sampling: SamplingParams = SamplingParams()):
        """n fused sample+decode steps with no host sync. Returns (tokens
        [B, n], next logits, cache)."""
        toks = []
        for _ in range(n):
            tok, logits, cache = self.step(logits, gen, cache, sampling)
            toks.append(tok)
        return torch.stack(toks, dim=1), logits, cache

    # -- prefill -> serving-cache hand-off ---------------------------------
    def prefill_len(self, prompt_len: int, pad_to: int | None = None) -> int:
        """Slots of the throwaway cache `prefill_standalone` fills: the
        prompt length, rounded up to a whole number of chunks when it
        chunks, then to this engine's page size when paged, then to
        `pad_to`."""
        chunk = self.ecfg.prefill_chunk
        T = -(-prompt_len // chunk) * chunk if chunk and prompt_len > chunk else prompt_len
        for m in (self.ecfg.page_size if self.ecfg.paged else None, pad_to):
            if m:
                T = -(-T // m) * m
        return T

    @torch.no_grad()
    def prefill_standalone(self, prompt: list[int], pad_to: int | None = None):
        """Prefill one sequence into a throwaway dense cache of
        `prefill_len(len(prompt), pad_to)` slots and return the insert tuple
        (logits [vocab], k_seq [L, H, T, D], v_seq, (k_scale, v_scale),
        length). `pad_to` is the decode side's page size when its cache is
        paged: the paged insert takes whole pages."""
        T = self.prefill_len(len(prompt), pad_to)
        tmp = KVCache.create(self.cfg, 1, T, dtype=self.ecfg.kv_dtype, device=self.device,
                             quantized=self.ecfg.kv_quantized)
        logits, tmp = self.prefill([prompt], cache=tmp)
        k_seq, v_seq, scales = tmp.extract_seq(0)
        return logits[0], k_seq, v_seq, scales, len(prompt)

    def insert_sequence(self, cache, slot: int, prefill_out, pages: list[int] | None = None):
        """Insert `prefill_standalone`'s output into `slot` of a serving
        cache, in place; `pages` are the allocator's pages for a paged cache."""
        _, k_seq, v_seq, (k_sc, v_sc), length = prefill_out
        if isinstance(cache, PagedKVCache):
            return cache.insert_sequence(slot, pages, k_seq, v_seq, length, k_sc, v_sc)
        return cache.insert_sequence(slot, k_seq, v_seq, length, k_sc, v_sc)

    @torch.no_grad()
    def capture_activations(self, prompt: list[int], patterns=("*",)):
        """Golden-diff hook: one prefill of `prompt` into a fresh cache while
        capturing the named activations (`utils.tensor_dump`). Returns
        (logits [T, vocab] f32, {name: array}); every row's logits are
        computed (logits_at=None). T is the prompt's length: the port does
        not bucket it, where the reference pads to a power of two."""
        from ..utils import tensor_dump

        T = len(prompt)
        toks = self.pad_tokens([prompt], T)
        positions = torch.arange(T, dtype=torch.int32, device=self.device)[None]
        limit = to_device(torch.tensor([T], dtype=torch.int32), self.device)
        with tensor_dump.capture(patterns) as cap:
            logits = gemma.forward(self.params, self.cfg, toks, positions, self.new_cache(1),
                                   write_index=0, kv_limit=limit)
        return logits[0].float().cpu().numpy(), cap.values

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
        cache,
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
        sync_k = prof.sync_every()  # profiled runs: make spans device-honest
        t_dec = time.perf_counter()
        for i in range(budget):
            with prof.span("decode.dispatch"):
                tok, logits, cache = self.step(logits, gen, cache, sampling)
                if sync_k and i % sync_k == sync_k - 1:
                    self._sync()
            device_toks.append(tok)
            if (eos_id is not None or on_token is not None) and (i + 1) % check_every == 0:
                if drain():
                    break
        drain()  # the copies to the host wait for the device: the wall time is real
        self._record_decode_roofline(emitted, B, time.perf_counter() - t_dec)
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
        if max_new_tokens <= 0:
            return np.zeros((len(prompts), 0), np.int32)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        t_dec = time.perf_counter()
        with prof.span(f"decode.block[n={max_new_tokens}]"):
            toks, _, _ = self.block(logits, gen, cache, max_new_tokens, sampling)
            out = toks.cpu().numpy()
        self._record_decode_roofline(max_new_tokens, len(prompts), time.perf_counter() - t_dec)
        return out
