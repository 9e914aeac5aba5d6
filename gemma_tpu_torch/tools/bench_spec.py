"""Speculative decoding throughput: plain greedy against prompt-lookup
speculation at batch 1, on two workloads, because the gain depends on the
content:

  repetitive  a prompt of one 29-token block seen 7 times (203 tokens); the
              run reports whether the greedy continuation really cycles
              (its last 32 tokens are periodic), and the tokens a verify
              forward emits say how much the drafts caught;
  random      a prompt of pseudo-random ids, with every draft forced to miss
              (t_cur + 1, which a model that repeats tokens never predicts
              next): each verify forward emits about one token, the worst
              case, where a (k + 1)-row verify replaces a 1-row decode step.

The counterpart of the reference's `tools/bench_spec.py`, on the port's
`Engine.generate_fused` and `SpecDecoder.generate` at full Gemma-2B width
(q4_0, random weights from a seed, `testing.make_params`), k = 7, blocks of
4. Each rate is the median over `reps` of the marginal tokens/s between
n and 2n tokens, each run timed by CUDA events around it (`_timing`'s
harness times kernels; these are whole generations, ended by the host's
read of the last block). On the CPU (`--device cpu`) a tiny config runs the
plain versions; its rates say nothing of the card.

    python -m gemma_tpu_torch.tools.bench_spec [--k 7] [--block 4] [--tokens 96] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..models import GEMMA_2B
from ..models.params import resolve_device
from ..ops import attention as att
from ..ops import quant_matmul as qmm
from ..runtime import Engine, EngineConfig, SpecDecoder
from ..testing import TINY_KERNEL_CONFIG, make_params
from . import _timing as T

BLOCK_LEN, BLOCK_REPEATS = 29, 7  # the repetitive prompt: 203 tokens


def prompts(vocab: int) -> dict[str, list[int]]:
    block = [2 + (i * 7919) % (vocab - 2) for i in range(BLOCK_LEN)]
    return {"repetitive": block * BLOCK_REPEATS,
            "random": [2 + (i * 104729 + 37) % (vocab - 2) for i in range(BLOCK_LEN * BLOCK_REPEATS)]}


class MissingDrafts(SpecDecoder):
    """Drafts t_cur + 1 repeated: the draft-hostile floor of `random`."""

    def _draft(self, history, hist_len, t_prev, t_cur):
        vocab = self.engine.cfg.vocab_size
        return ((t_cur + 1) % vocab)[:, None].expand(-1, self.k).contiguous()


def seconds(fn, dev: torch.device) -> float:
    """Wall seconds of fn() (CUDA events around it on the card)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def marginal(fn, n: int, dev: torch.device, reps: int) -> float:
    """Median over `reps` of n / (t(2n) - t(n)) tokens/s: the rate with the
    prefill and the fixed host cost cancelled."""
    rates = []
    for _ in range(reps):
        t1 = seconds(lambda: fn(n), dev)
        t2 = seconds(lambda: fn(2 * n), dev)
        rates.append(n / max(t2 - t1, 1e-9))
    return statistics.median(rates)


def run(dev: torch.device, k: int = 7, block: int = 4, tokens: int = 96, reps: int = 5) -> dict:
    """{workload: {plain_tok_s, spec_tok_s, speedup, tokens_per_verify,
    cycles}}, one line and one JSON line a workload printed."""
    card = T.card_line(dev)
    print(card, flush=True)
    cpu = dev.type != "cuda"
    cfg = TINY_KERNEL_CONFIG if cpu else GEMMA_2B
    tokens = min(tokens, 12) if cpu else tokens
    params = make_params(cfg, "q4_0", seed=0, device=dev)
    eng = Engine(cfg, params, EngineConfig(max_seq_len=512 if not cpu else 256, max_batch=1))
    out = {}
    for name, prompt in prompts(cfg.vocab_size).items():
        prompt = prompt[: 64 if cpu else None]
        dec = (SpecDecoder if name == "repetitive" else MissingDrafts)(eng, k=k, block=block)
        dec.generate(prompt, 8)  # warm-up: first launches, allocator
        eng.generate_fused([prompt], 8)
        for op in (*qmm.MATMULS.values(), att.flash_attention, att.decode_attention):
            op.launches = 0
        plain = marginal(lambda n: eng.generate_fused([prompt], n), tokens, dev, reps)
        spec = marginal(lambda n: dec.generate(prompt, n), tokens, dev, reps)
        stream = dec.generate(prompt, 2 * tokens)
        # bf16: the verify's M = 8 and flash round otherwise than decode's
        # M = 1 steps, so a near tie may resolve otherwise (chip_smoke.py
        # holds the stream to the plain logits); f32 on the CPU is exact
        want = eng.generate_fused([prompt], 2 * tokens)[0].tolist()
        first_diff = next((i for i, (a, b) in enumerate(zip(stream, want)) if a != b), None)
        if cpu and first_diff is not None:
            raise RuntimeError(f"{name}: the speculative stream differs from plain greedy")
        per_verify = dec.emitted / dec.steps
        tail = stream[-32:]
        cycles = any(tail[i:] == tail[: len(tail) - i] for i in range(1, 17))
        launches = {"flash_attention": att.flash_attention.launches,
                    "decode_attention": att.decode_attention.launches,
                    **{n_: op.launches for n_, op in qmm.MATMULS.items() if op.launches}}
        if not cpu and not launches["flash_attention"]:
            raise RuntimeError(f"{name}: no verify forward reached the flash kernel")
        out[name] = {"plain_tok_s": plain, "spec_tok_s": spec, "speedup": spec / plain,
                     "tokens_per_verify": per_verify, "cycles": cycles,
                     "first_token_unlike_plain": first_diff}
        print(f"{name}: plain {plain:.1f} spec {spec:.1f} tok/s ({spec / plain:.3f}x), "
              f"{per_verify:.2f} tokens a verify forward, the stream "
              f"{'cycles' if cycles else 'does not cycle'}, first token unlike plain greedy's: "
              f"{first_diff}{'' if not cpu else ' ' + T.CPU_NOTE}", flush=True)
        print(json.dumps({"metric": f"speculative_decode_{'tiny' if cpu else 'gemma2b'}_q4_0_{name}",
                          **out[name], "k": k, "block": block, "tokens": tokens,
                          "prompt_tokens": len(prompt), "device": card, "launches": launches}),
              flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--k", type=int, default=7)
    p.add_argument("--block", type=int, default=4)
    p.add_argument("--tokens", type=int, default=96)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(resolve_device(args.device), args.k, args.block, args.tokens)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
