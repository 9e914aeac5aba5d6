"""Prompt-lookup speculative decoding, on the device, without host syncs.

Counterpart of `gemma_tpu/runtime/speculative.py`. A greedy decode step
streams every weight byte to emit one token; a speculative step drafts k
tokens from the sequence's own token history (the continuation of the
most recent earlier occurrence of its last two tokens), runs one (k + 1)-row
verify forward over [t_cur, drafts], and emits every draft that equals the
greedy token before it plus the correcting token: 1 to k + 1 tokens for one
pass over the weights. The stream is exactly the greedy one, since
acceptance replays argmax over the verify forward's logits.

Every piece of a step (the bigram lookup over the history on the device,
the verify forward, acceptance, the cache length's advance, the history
append) is tensor ops on the device, so steps queue back to back and the
host reads one packed int32 tensor a block of `block` steps: [block, k + 2]
at batch 1, [block, B, k + 2] batched (k + 1 token columns, then the count).

An engine with a `spec_verify` (`parallel.shard_decode.TPEngine`) runs the
verify forward itself and returns the greedy token after each row; drafts,
acceptance and history stay here, replicated on every rank.

Cache: the verify forward writes all k + 1 rows at each sequence's own
length (`KVCache.write_chunk_per_seq`); the accepted prefix advances
`cache.length`, and the rejected tail is overwritten by the next step
(attention reads slots below `kv_limit` only). Speculation needs greedy
sampling and the dense cache.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..models import gemma
from .kv_cache import to_device
from .scheduler import _HostCopy


def get_decoder(engine, k: int = 7, block: int = 4) -> "SpecDecoder":
    """A SpecDecoder for `engine` (the reference's engine-cached name and
    key). Eager PyTorch traces nothing, so there is nothing to cache: this
    builds a new decoder each call."""
    return SpecDecoder(engine, k=int(k), block=int(block))


class SpecDecoder:
    """Speculative steps of one Engine: batch 1 (`generate`) or every slot
    of a serving batch (`batch_block`). Greedy, dense cache."""

    def __init__(self, engine, k: int = 7, block: int = 4):
        # k = 7: the verify forward is 8 rows, the serving step's M = 8
        # (the tensor-core GEMV of every format)
        if engine.ecfg.paged:
            raise ValueError("speculative decoding requires the dense cache")
        self.engine = engine
        self.k = int(k)
        self.block = int(block)
        self.steps = self.emitted = 0

    # -- one step, on the device -------------------------------------------
    def _draft(self, history, hist_len, t_prev, t_cur):
        """[B, k] drafts: for each row, the k tokens after the most recent
        match of the bigram (t_prev, t_cur) in history[:hist_len - 2] (the
        pair at hist_len - 2 is the one being continued); t_cur repeated
        where there is no match (they are verified like any draft).
        history [B, L], the rest [B]."""
        B, L = history.shape
        idx = torch.arange(L, device=history.device, dtype=torch.int32)
        nxt = torch.roll(history, -1, dims=1)
        match = ((history == t_prev[:, None]) & (nxt == t_cur[:, None])
                 & (idx[None] < (hist_len - 2)[:, None]))
        p = torch.where(match, idx[None], -1).amax(dim=1)
        start = (p + 2).clamp(0, L - self.k)
        cols = start[:, None].long() + torch.arange(self.k, device=history.device)
        drafts = torch.gather(history, 1, cols)
        return torch.where((p >= 0)[:, None], drafts, t_cur[:, None].expand(B, self.k))

    def _step(self, carry, cache):
        """One draft + verify step of every row. carry = (t_cur [B], t_prev
        [B], history [B, L], hist_len [B]), i32 on the device; history is
        appended in place. Returns (carry', emitted [B, k + 1], n_emit [B]):
        the first n_emit tokens of each row are its output."""
        eng, k = self.engine, self.k
        t_cur, t_prev, history, hist_len = carry
        drafts = self._draft(history, hist_len, t_prev, t_cur)
        toks = torch.cat([t_cur[:, None], drafts], dim=1)
        lengths = cache.length
        verify = getattr(eng, "spec_verify", None)
        if verify is not None:  # TPEngine: the sharded forward, greedy ids gathered
            g = verify(toks, cache)
        else:
            positions = lengths[:, None] + torch.arange(k + 1, dtype=torch.int32,
                                                        device=lengths.device)
            logits = gemma.forward(eng.params, eng.cfg, toks, positions, cache,
                                   write_index=lengths, kv_limit=lengths + k + 1)
            g = logits.argmax(dim=-1).to(torch.int32)  # [B, k + 1]: greedy after each row
        # drafts are accepted while each equals the greedy token before it
        a = torch.cumprod((drafts == g[:, :k]).to(torch.int32), dim=1).sum(dim=1)
        n_emit = (a + 1).to(torch.int32)  # [d_1 .. d_a, g_a] = g[0 .. a]
        cache.length = lengths + n_emit
        # g lands at hist_len, the start clamped in bounds (the reference's
        # dynamic_update_slice); only idle serving slots reach the clamp
        L = history.shape[1]
        start = hist_len.long().clamp(0, L - (k + 1))
        history.scatter_(1, start[:, None] + torch.arange(k + 1, device=history.device), g)
        a_ = a.long()[:, None]
        t_cur2 = torch.gather(g, 1, a_)[:, 0]
        t_prev2 = torch.where(a > 0, torch.gather(g, 1, (a_ - 1).clamp(min=0))[:, 0], t_cur)
        return (t_cur2, t_prev2, history, hist_len + n_emit), g, n_emit

    @torch.no_grad()
    def batch_block(self, carry, cache):
        """`self.block` chained steps with no host sync. Returns (carry',
        packed [block, B, k + 2] i32: each step's k + 1 tokens and count)."""
        packed = []
        for _ in range(self.block):
            carry, g, n_emit = self._step(carry, cache)
            packed.append(torch.cat([g, n_emit[:, None]], dim=1))
        return carry, torch.stack(packed)

    # -- batch 1 -----------------------------------------------------------
    @torch.no_grad()
    def start(self, prompt: list[int]):
        """Prefill `prompt` and seed the draft state: (first greedy token,
        carry of batch 1 on the device, cache). Reads the first token on the
        host once, before any block."""
        eng = self.engine
        logits, cache = eng.prefill([prompt])
        t0 = int(logits[0].argmax())
        history = np.zeros((1, eng.ecfg.max_seq_len + self.k + 2), np.int32)
        history[0, : len(prompt)] = prompt
        history[0, len(prompt)] = t0
        state = to_device(torch.tensor([[t0, prompt[-1] if prompt else 0, len(prompt) + 1]],
                                        dtype=torch.int32), eng.device)
        carry = (state[:, 0], state[:, 1], to_device(torch.from_numpy(history), eng.device),
                 state[:, 2])
        return t0, carry, cache

    @torch.no_grad()
    def generate(self, prompt: list[int], max_new_tokens: int) -> list[int]:
        """Greedy generation, token for token `Engine.generate_fused`'s greedy
        stream, 1 to k + 1 tokens a verify forward. Returns exactly
        `max_new_tokens` tokens (no early EOS exit, like generate_fused);
        `self.steps` counts the verify forwards issued and `self.emitted`
        the tokens they emitted, those past `max_new_tokens` included."""
        eng, k = self.engine, self.k
        S = eng.ecfg.max_seq_len
        # every step writes k + 1 rows past the length, and the two blocks
        # in flight may emit past what the host keeps before it stops: the
        # cache must hold prompt + max_new + (2 block + 1)(k + 1) rows (a
        # clamped write would overwrite valid rows)
        overshoot = (2 * self.block + 1) * (k + 1)
        if len(prompt) + max_new_tokens + overshoot > S:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"+ worst-case draft window ({overshoot}) exceeds max_seq_len {S}"
            )
        t0, carry, cache = self.start(prompt)
        out: list[int] = [t0]
        self.steps = 0
        pending: collections.deque[_HostCopy] = collections.deque()

        def issue():
            nonlocal carry
            carry, packed = self.batch_block(carry, cache)
            self.steps += self.block
            pending.append(_HostCopy(packed[:, 0]))  # [block, k + 2]

        def drain_one():
            p = pending.popleft().numpy()
            for row in p:
                out.extend(int(t) for t in row[: int(row[-1])])

        while len(out) < max_new_tokens:
            if len(pending) < 2:
                issue()  # two blocks in flight: the drain overlaps the next block
            if len(pending) >= 2:
                drain_one()
        while pending:
            drain_one()
        self.emitted = len(out) - 1
        return out[:max_new_tokens]
