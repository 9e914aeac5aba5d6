"""Continuous-batching scheduler.

Counterpart of `gemma_tpu/runtime/scheduler.py`: a fixed pool of decode
slots shares one batched KV cache (dense or paged, bf16/f32 or int8).
Requests are admitted into free slots by prefill -> insert (the prefill
runs alone at batch 1 into a throwaway cache, on `prefill_engine` when one
is given, and never touches the decode batch); every tick runs one batched
decode step for all slots, and a finished sequence frees its slot (and its
pages) for the next queued request.

Prompts longer than two chunks admit in overlapped chunks when the prefill
engine has `prefill_chunk` set: one chunk per decode tick, so a long
admission stalls the running batch by at most one chunk. `run(block=n)`
keeps two n-step decode blocks in flight: block N+1's launches are issued
before block N's tokens, copied to pinned host memory behind an event,
are read, so the host's wait overlaps the device's work.

Every batch row decodes on every tick, idle rows included;
`Engine.decode_step` keeps their writes inside the cache (ROADMAP section
3).

`speculative=True` (greedy sampling, dense cache): every tick drafts
`spec_k` tokens a slot from its token history and verifies them in one
batched (spec_k + 1)-row forward (`runtime/speculative.py`), so a slot
emits 1 to spec_k + 1 tokens a tick with its exact greedy stream;
`spec_block` ticks chain into one block, drained by one packed host copy,
and `run` keeps `spec_pipeline` blocks in flight. The slots' draft state
(current and previous token, token history, its length) stays on the
device. Adaptive k: while the rolling tokens a verify of the spec_k
decoder stay below `spec_min_accept`, blocks run a k = 1 decoder instead
(its 2-row verify costs about a plain step), with a spec_k probe every 8
blocks.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from .engine import Engine
from .kv_cache import KVCache, to_device
from .paged_kv import PageAllocator
from .sampler import SamplingParams


@dataclasses.dataclass
class Request:
    id: str
    prompt: list[int]
    max_new_tokens: int
    eos_id: int | None = None
    # filled by the scheduler:
    tokens: list[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: float | None = None
    finished_at: float | None = None
    slot: int | None = None

    @property
    def done(self) -> bool:
        return self.finished_at is not None

    @property
    def ttft(self) -> float | None:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at


@dataclasses.dataclass
class _Admission:
    """An overlapped admission in flight: the slot is reserved and the prompt
    prefills one chunk per decode tick into `cache`; the request activates
    when its last chunk lands."""

    req: Request
    slot: int
    pages: list[int] | None
    toks: torch.Tensor  # [1, L] prompt on the prefill engine's device
    lengths: torch.Tensor  # [1] i32 prompt length on the device
    cache: KVCache  # throwaway cache of prefill_len(L) slots
    last: torch.Tensor  # [1, vocab] carried last-token logits
    next_chunk: int
    n_chunks: int


class _HostCopy:
    """A device tensor's copy into pinned host memory, started without
    waiting; `numpy()` waits for that copy alone (a CUDA event), not for
    the launches queued after it."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class Scheduler:
    def __init__(
        self,
        engine: Engine,
        sampling: SamplingParams = SamplingParams(),
        seed: int = 0,
        on_token: Callable[[Request, int], None] | None = None,
        prefill_engine: Engine | None = None,
        admit_per_tick: int | None = None,
        overlap_admission: bool = True,
        speculative: bool = False,
        spec_k: int = 7,
        spec_pipeline: int = 2,
        spec_block: int = 4,
        spec_min_accept: float = 2.5,
    ):
        """`prefill_engine` runs admission prefills on another engine than
        the decode batch (prefill/decode disaggregation in one process); its
        output enters the decode cache through `insert_sequence`, so both
        must store K/V in one format.

        `admit_per_tick` caps the admissions a tick starts (None: every
        free slot). Admission prefills run inside the tick, so a burst of N
        admissions runs N prefills before the batch decodes its next token;
        a cap trades a slower ramp for the running requests' latency. An
        overlapped admission counts when it starts; a rejected request does
        not. `overlap_admission`: with the prefill engine's `prefill_chunk`
        set, prompts longer than two chunks admit one chunk per tick.

        `speculative` and the `spec_*` options: the module docstring.
        Finish decisions lag `spec_pipeline` blocks, so a finished slot may
        run a few discarded ticks (`tokens_discarded`); the streams do not
        change. `spec_min_accept` <= 1 pins k = spec_k."""
        self.engine = engine
        self.prefill_engine = prefill_engine or engine
        if prefill_engine is not None:
            pe, de = prefill_engine.ecfg, engine.ecfg
            if (pe.kv_quantized, pe.kv_dtype) != (de.kv_quantized, de.kv_dtype):
                raise ValueError(
                    "disaggregated prefill engine must match the decode engine's KV format "
                    f"(prefill kv_quantized={pe.kv_quantized} dtype={pe.kv_dtype}; decode "
                    f"kv_quantized={de.kv_quantized} dtype={de.kv_dtype})"
                )
        self.admit_per_tick = admit_per_tick
        self.overlap_admission = overlap_admission
        self._admitting: dict[int, _Admission] = {}  # slot -> in flight
        self._admit_order: collections.deque[int] = collections.deque()
        self.sampling = sampling
        self.on_token = on_token
        self.max_batch = engine.ecfg.max_batch
        # unadmitted slots point at the trash page until admission installs
        # the allocator's pages (an identity layout would alias them)
        self.cache = engine.new_cache(self.max_batch, identity_pages=False)
        if hasattr(engine, "place_cache"):  # sharded engines (TPEngine)
            self.cache = engine.place_cache(self.cache)
        self.allocator = PageAllocator(self.cache.n_pages) if engine.ecfg.paged else None
        self._pad_to = engine.ecfg.page_size if engine.ecfg.paged else None
        self._slot_pages: dict[int, list[int]] = {}
        self.pending: collections.deque[Request] = collections.deque()
        self.active: dict[int, Request] = {}  # slot -> request
        self.finished: list[Request] = []
        self.gen = torch.Generator(device=engine.device)
        self.gen.manual_seed(seed)
        # pipelined blocks: run(block) keeps two in flight
        self._plain_pending: collections.deque = collections.deque()
        self._plain_depth = 2
        # each slot's next-token logits, one [B, vocab] batch on the device
        self._logits = torch.zeros(self.max_batch, engine.cfg.vocab_size, dtype=torch.float32,
                                   device=engine.device)
        self._steps = 0
        self._tokens_discarded = 0
        self._spec_forwards = self._spec_lo_forwards = 0
        self.spec = None
        if speculative:
            if not sampling.is_greedy:
                raise ValueError("speculative scheduling requires greedy sampling")
            if engine.ecfg.paged:
                raise ValueError("speculative scheduling requires the dense cache")
            from .speculative import get_decoder

            spec_block = max(1, int(spec_block))
            self.spec = get_decoder(engine, k=spec_k, block=spec_block)
            self._spec_depth = max(1, int(spec_pipeline))
            self._spec_pending: collections.deque = collections.deque()
            self._spec_min_accept = float(spec_min_accept)
            self._spec_lo = (get_decoder(engine, k=1, block=spec_block)
                             if spec_k > 1 and self._spec_min_accept > 1 else None)
            self._accept_ema = float(spec_k + 1)  # optimistic start
            self._spec_probe_every = 8
            self._lo_blocks_since_probe = 0
            L = engine.ecfg.max_seq_len + spec_k + 2
            zeros = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=engine.device)
            # (t_cur, t_prev, history, hist_len) of every slot
            self._sp_carry = (zeros(self.max_batch), zeros(self.max_batch),
                              zeros(self.max_batch, L), zeros(self.max_batch))

    # -- request intake ----------------------------------------------------
    def submit(self, req: Request) -> None:
        req.submitted_at = time.monotonic()
        self.pending.append(req)

    def _free_slots(self) -> list[int]:
        return [b for b in range(self.max_batch)
                if b not in self.active and b not in self._admitting]

    def _reject(self, req: Request) -> None:
        req.tokens = []
        req.finished_at = time.monotonic()
        self.finished.append(req)

    def _overlaps(self, prompt_len: int) -> bool:
        # a prompt of <= 2 chunks stalls the batch no longer than the
        # overlapped path's per-tick budget; admitting it chunk by chunk
        # would only halve its admission rate
        chunk = self.prefill_engine.ecfg.prefill_chunk
        return bool(self.overlap_admission and chunk and prompt_len > 2 * chunk)

    def _prefill_T(self, prompt_len: int) -> int:
        """The KV slots the admission prefill hands over: the prefill
        engine's own rounding, then whole decode-side pages when paged. The
        page allocation is sized from it."""
        return self.prefill_engine.prefill_len(prompt_len, self._pad_to)

    def _admit(self) -> None:
        admitted = 0
        for slot in self._free_slots():
            if not self.pending:
                break
            if self.admit_per_tick is not None and admitted >= self.admit_per_tick:
                break
            req = self.pending.popleft()
            if len(req.prompt) >= self.engine.ecfg.max_seq_len:
                self._reject(req)
                continue
            pages = None
            if self.allocator is not None:
                ps = self.cache.page_size
                need = max(self._prefill_T(len(req.prompt)) // ps,
                           -(-(len(req.prompt) + req.max_new_tokens) // ps))
                pages = self.allocator.allocate(need)
                if pages is None:
                    if not self.active and self.allocator.free_pages == self.allocator.n_pages - 1:
                        self._reject(req)  # even the whole pool is too small
                        continue
                    self.pending.appendleft(req)  # pool exhausted: wait for a finish
                    break
                self._slot_pages[slot] = pages
            if self._overlaps(len(req.prompt)):
                self._start_admission(req, slot, pages)
            else:
                pre = self.prefill_engine.prefill_standalone(req.prompt, pad_to=self._pad_to)
                self.engine.insert_sequence(self.cache, slot, pre, pages)
                self._activate(slot, req, pre[0])
            admitted += 1

    def _activate(self, slot: int, req: Request, logits: torch.Tensor) -> None:
        self._logits[slot] = logits
        req.slot = slot
        self.active[slot] = req
        if self.spec is not None:
            self._seed_spec_slot(slot, req, logits)

    # -- overlapped (chunked) admission ------------------------------------
    def _start_admission(self, req: Request, slot: int, pages) -> None:
        eng = self.prefill_engine
        L = len(req.prompt)
        tmp = KVCache.create(eng.cfg, 1, self._prefill_T(L), dtype=eng.ecfg.kv_dtype,
                             device=eng.device, quantized=eng.ecfg.kv_quantized)
        self._admitting[slot] = _Admission(
            req=req, slot=slot, pages=pages, toks=eng.pad_tokens([req.prompt], L),
            lengths=to_device(torch.tensor([L], dtype=torch.int32), eng.device), cache=tmp,
            last=torch.zeros(1, eng.cfg.vocab_size, dtype=torch.float32, device=eng.device),
            next_chunk=0, n_chunks=-(-L // eng.ecfg.prefill_chunk),
        )
        self._admit_order.append(slot)

    def _advance_admissions(self) -> None:
        """Run one chunk of the oldest admission in flight per tick; with no
        request decoding there is nothing to stall, so chunks run back to
        back until an admission completes."""
        while self._admit_order:
            self._advance_one()
            if self.active or not self._admit_order:
                break

    def _advance_one(self) -> None:
        slot = self._admit_order[0]
        st = self._admitting[slot]
        eng = self.prefill_engine
        chunk = eng.ecfg.prefill_chunk
        s = st.next_chunk * chunk
        limit = to_device(torch.tensor([min(len(st.req.prompt), s + chunk)], dtype=torch.int32),
                          eng.device)
        st.last, st.cache = eng.chunk_step(st.toks[:, s : s + chunk], s, limit, st.cache,
                                           st.lengths, st.last)
        st.next_chunk += 1
        if st.next_chunk < st.n_chunks:
            return
        k_seq, v_seq, scales = st.cache.extract_seq(0)
        pre = (st.last[0], k_seq, v_seq, scales, len(st.req.prompt))
        self.engine.insert_sequence(self.cache, slot, pre, st.pages)
        self._admit_order.popleft()
        del self._admitting[slot]
        self._activate(slot, st.req, pre[0])

    # -- speculative ticks -------------------------------------------------
    def _seed_spec_slot(self, slot: int, req: Request, logits0: torch.Tensor) -> None:
        """A newly admitted slot's draft state: its history row is the prompt
        and the first greedy token, which is emitted here (the plain path
        samples it on the next tick: the same stream). One host read a
        request, at admission, not inside a block."""
        t0 = int(logits0.argmax())
        tc, tp, hist, hlen = self._sp_carry
        P = len(req.prompt)
        row = np.zeros(hist.shape[1], np.int32)
        row[:P] = req.prompt
        row[P] = t0
        tc[slot] = t0
        tp[slot] = req.prompt[-1] if req.prompt else 0
        hist[slot] = to_device(torch.from_numpy(row), hist.device)
        hlen[slot] = P + 1
        now = time.monotonic()
        self._emit(req, t0, now)
        if (req.eos_id is not None and t0 == req.eos_id) or req.max_new_tokens <= 1:
            self._finish(slot, req, now)

    def _spec_full_limit(self) -> int:
        # an active slot keeps write headroom: each in-flight tick writes
        # k + 1 rows past its length, and depth * block ticks land before the
        # host can stop it (the per-sequence write clamps, and a clamp on an
        # active slot would overwrite its valid rows)
        return self.engine.ecfg.max_seq_len - (self._spec_depth * self.spec.block + 1) * (
            self.spec.k + 1)

    def _pick_spec_decoder(self):
        """(decoder, is the spec_k one): spec_k while the rolling acceptance
        clears spec_min_accept; k = 1 below it, with a spec_k probe every
        `_spec_probe_every` blocks."""
        if self._spec_lo is None or self._accept_ema >= self._spec_min_accept:
            self._lo_blocks_since_probe = 0
            return self.spec, True
        self._lo_blocks_since_probe += 1
        if self._lo_blocks_since_probe >= self._spec_probe_every:
            self._lo_blocks_since_probe = 0
            return self.spec, True
        return self._spec_lo, False

    def _spec_issue(self) -> bool:
        """Admit, then issue one block of batched speculative ticks with no
        host sync; its packed [n, B, k + 2] tokens are copied to the host
        behind an event, queued with which request held each slot."""
        self._advance_admissions()
        self._admit()
        if not self.active:
            return False
        dec, is_hi = self._pick_spec_decoder()
        self._sp_carry, packed = dec.batch_block(self._sp_carry, self.cache)
        self._steps += dec.block
        self._spec_forwards += dec.block
        self._spec_lo_forwards += 0 if is_hi else dec.block
        self._spec_pending.append((_HostCopy(packed), is_hi, list(self.active.items())))
        return True

    def _spec_drain(self) -> list[tuple[str, int]]:
        """Emit the oldest block's tokens, tick by tick. A request that ended
        earlier (in an earlier drain or tick) discards its rows."""
        copy, is_hi, snapshot = self._spec_pending.popleft()
        p = copy.numpy()  # [n, B, k + 2]
        k1 = p.shape[2] - 1
        if is_hi and snapshot:
            # the rolling tokens a verify of spec_k blocks only (a k = 1
            # block tops out at 2 and says nothing of spec_k)
            live = [slot for slot, req in snapshot if not req.done]
            if live:
                self._accept_ema = 0.5 * self._accept_ema + 0.5 * float(p[:, live, k1].mean())
        now = time.monotonic()
        emitted: list[tuple[str, int]] = []
        headroom = self.engine.ecfg.max_seq_len - self._spec_full_limit()
        for i in range(p.shape[0]):
            for slot, req in snapshot:
                c = int(p[i, slot, k1])
                if req.done:
                    self._tokens_discarded += c
                    continue
                for j in range(c):
                    t = int(p[i, slot, j])
                    self._emit(req, t, now)
                    emitted.append((req.id, t))
                    if self._ends(req, t, headroom):
                        self._finish(slot, req, now)
                        self._tokens_discarded += c - 1 - j
                        break
        return emitted

    def step_spec(self) -> list[tuple[str, int]]:
        """One synchronous speculative block: admit, then `spec_block`
        ticks in which every active slot emits 1 to spec_k + 1 tokens.
        (`run` keeps `spec_pipeline` blocks in flight instead.)"""
        if not self._spec_issue():
            return []
        return self._spec_drain()

    # -- decode ticks ------------------------------------------------------
    def _emit(self, req: Request, t: int, now: float) -> None:
        if req.first_token_at is None:
            req.first_token_at = now
        req.tokens.append(t)
        if self.on_token is not None:
            self.on_token(req, t)

    def _ends(self, req: Request, t: int, headroom: int) -> bool:
        hit_eos = req.eos_id is not None and t == req.eos_id
        full = len(req.prompt) + len(req.tokens) >= self.engine.ecfg.max_seq_len - headroom
        return hit_eos or full or len(req.tokens) >= req.max_new_tokens

    def step(self) -> list[tuple[str, int]]:
        """Admit pending requests, run one batched decode step and emit one
        token per active request. Returns [(request id, token)]."""
        self._advance_admissions()
        self._admit()
        if not self.active:
            return []
        tok, self._logits, self.cache = self.engine.step(self._logits, self.gen, self.cache,
                                                         self.sampling)
        tok_np = tok.cpu().numpy()
        now = time.monotonic()
        emitted: list[tuple[str, int]] = []
        self._steps += 1
        for slot, req in list(self.active.items()):
            t = int(tok_np[slot])
            self._emit(req, t, now)
            emitted.append((req.id, t))
            if self._ends(req, t, 0):
                self._finish(slot, req, now)
        return emitted

    def step_block(self, n: int) -> list[tuple[str, int]]:
        """Admit, then run `n` decode steps with one host sync at the end.
        Slots free (and requests admit) every n tokens; a sequence that ends
        mid-block decodes the rest of the block, discarded."""
        if not self._plain_issue(n):
            return []
        return self._plain_drain(lag=0)

    def _plain_issue(self, n: int) -> bool:
        """Admit, then issue one n-step decode block without a host sync."""
        self._advance_admissions()
        self._admit()
        if not self.active:
            return False
        tb, self._logits, self.cache = self.engine.block(self._logits, self.gen, self.cache, n,
                                                         self.sampling)
        self._steps += n
        self._plain_pending.append((_HostCopy(tb), n, list(self.active.items())))
        return True

    def _plain_drain(self, lag: int) -> list[tuple[str, int]]:
        """Emit the oldest block's tokens. `lag` blocks may still be in
        flight past it: finish decisions lag that far, so a slot keeps
        lag * n rows of headroom to write into before its cache is full."""
        copy, n, snapshot = self._plain_pending.popleft()
        tok_np = copy.numpy()  # [B, n]
        now = time.monotonic()
        emitted: list[tuple[str, int]] = []
        for slot, req in snapshot:
            if req.done:
                self._tokens_discarded += n
                continue
            for j in range(n):
                t = int(tok_np[slot, j])
                self._emit(req, t, now)
                emitted.append((req.id, t))
                if self._ends(req, t, lag * n):
                    self._finish(slot, req, now)
                    self._tokens_discarded += n - 1 - j
                    break
        return emitted

    def _finish(self, slot: int, req: Request, now: float) -> None:
        req.finished_at = now
        self.finished.append(req)
        del self.active[slot]  # the slot's rows are overwritten on admission
        if self.allocator is not None and slot in self._slot_pages:
            # stale decode writes of this slot must not reach pages handed out
            # again: point its table at the trash page before releasing them
            self.cache.release_slot(slot)
            self.allocator.release(self._slot_pages.pop(slot))

    def run(self, max_steps: int | None = None, block: int = 1) -> list[Request]:
        """Drive until all submitted work completes; returns the finished
        requests. `block` > 1 decodes in pipelined n-step blocks, and a
        speculative Scheduler in pipelined blocks of `spec_block` ticks
        (`block` is then unused). `max_steps` bounds device decode steps (a
        block counts its steps or ticks)."""
        steps = 0

        def busy() -> bool:
            return bool(self.pending or self.active or self._admitting) and (
                max_steps is None or steps < max_steps)

        if self.spec is None and block <= 1:
            while busy():
                self.step()
                steps += 1
            return self.finished
        if self.spec is not None:
            pending, depth, n = self._spec_pending, self._spec_depth, self.spec.block
            issue, drain = self._spec_issue, self._spec_drain
        else:
            pending, depth, n = self._plain_pending, self._plain_depth, block
            issue, drain = (lambda: self._plain_issue(block)), (lambda: self._plain_drain(lag=depth))
        while busy():  # `depth` blocks in flight: each drain overlaps the next block
            issued = False
            if len(pending) < depth:
                issued = issue()
                steps += n if issued else 0
            if pending and (not issued or len(pending) >= depth):
                drain()
            elif not issued:
                break
        while pending:
            drain()
        return self.finished

    # -- metrics -----------------------------------------------------------
    def stats(self) -> dict:
        ttfts = sorted(r.ttft for r in self.finished if r.ttft is not None)
        out = {
            "requests": len(self.finished),
            "decode_steps": self._steps,
            "tokens_discarded": self._tokens_discarded,
            "total_tokens": sum(len(r.tokens) for r in self.finished),
            "p50_ttft_s": ttfts[len(ttfts) // 2] if ttfts else None,
            "p99_ttft_s": ttfts[min(len(ttfts) - 1, int(len(ttfts) * 0.99))] if ttfts else None,
        }
        if self.spec is not None:
            out["spec_forwards"] = self._spec_forwards
            out["spec_lo_forwards"] = self._spec_lo_forwards  # of them, by the k = 1 decoder
        return out
