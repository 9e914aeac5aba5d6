"""Long-context decode: tokens/s after a long prefill, over the dense and
the paged cache, bf16 and int8.

The counterpart of the reference's `tools/bench_longctx.py`, with its flags
and its JSON keys, on the port's `Engine` (weights from
`testing.make_params(fill="zeros")`). Each arm builds an engine of one
`--ctx`-slot sequence that prefills in `--chunk`-token chunks (flash
attention over the growing cache), then measures the marginal decode rate
of `Engine.generate_fused` between `--tokens` n and 2n new tokens, the
best of `--repeats` runs at each length after warm-up runs at 8, n and 2n
tokens: n / (t(2n) - t(n)), which cancels the prefill and the host's fixed
cost. Every decode step then attends over about `--prefill` keys. Arms:
dense, paged (`--page-size`; `page_size_resolved` is what the engine
took), dense_int8kv and paged_int8kv; `--arms` runs a subset (a page-size
sweep needs the paged arms only).

On this card the eager decode step is mostly the host's launches, whose
speed drifts between runs more than the cache layout moves a step, so
each arm also prints the device side of a decode step after the prefill
(torch.profiler over STEPS steps): busy ms a step, the decode attention
kernels' ms a step, and device kernels a step.

Before the JSON line it prints the card (name and power limit) and the
kernels the measured runs launched (`launches {...}`). On the CPU
(`--device cpu`, `--model tiny`) the plain versions run and the rates say
nothing of the card.

    python -m gemma_tpu_torch.tools.bench_longctx [--model gemma2b] [--fmt q4_0] [--ctx 8192]
        [--prefill 4096] [--tokens 64] [--page-size 64] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import time

import torch

from ..models.params import resolve_device
from ..runtime import Engine, EngineConfig
from ..testing import make_params
from . import _timing as T

ARMS = {"dense": (False, False), "paged": (True, False), "dense_int8kv": (False, True),
        "paged_int8kv": (True, True)}  # name -> (paged, int8 cache)
STEPS = 8  # decode steps of the device profile
ATTENTION = r"decode_tc_kernel|decode_g1_kernel|decode_split_kernel|paged_split_kernel|attend_combine"


def step_profile(eng: Engine, prompt: list[int], dev) -> str:
    """The device side of STEPS greedy decode steps after a prefill of
    `prompt`: busy ms, decode attention ms and device kernels, a step."""
    logits, cache = eng.prefill([prompt])
    tok = logits.argmax(-1)

    def steps():
        nonlocal tok, cache
        for _ in range(STEPS):
            logits, cache = eng.decode_step(tok, cache)
            tok = logits.argmax(-1)

    busy, kernels, attn = T.profile_busy(steps, dev, ATTENTION)
    if busy is None:
        return "device profile: none on the CPU"
    return (f"device, a decode step: busy {busy / STEPS:.4f} ms, decode attention "
            f"{attn / STEPS:.4f} ms, {kernels / STEPS:g} kernels")


def measure_decode(eng: Engine, prompt: list[int], n_tokens: int, repeats: int = 3) -> float:
    """Marginal decode tokens/s between n and 2n generated tokens, each the
    fastest of `repeats` runs (nan if 2n ran no slower than n)."""
    for n in (8, n_tokens, 2 * n_tokens):  # first launches, the allocator at both lengths
        eng.generate_fused([prompt], max_new_tokens=n)

    def best(n: int) -> float:
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            eng.generate_fused([prompt], max_new_tokens=n)  # ends with the host's read
            ts.append(time.perf_counter() - t0)
        return min(ts)

    dt = best(2 * n_tokens) - best(n_tokens)
    return n_tokens / dt if dt > 0 else math.nan


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="gemma2b", choices=T.MODELS)
    ap.add_argument("--fmt", default="q4_0", choices=("q4_0", "q8_0", "q4_k_m"))
    ap.add_argument("--ctx", type=int, default=8192)
    ap.add_argument("--prefill", type=int, default=4096)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=None,
                    help="paged KV page length (default: the engine's, 64)")
    ap.add_argument("--chunk", type=int, default=512, help="prefill chunk")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--arms", default=",".join(ARMS), help=f"a subset of {','.join(ARMS)}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    arms = args.arms.split(",")
    if not arms or set(arms) - set(ARMS):
        ap.error(f"--arms takes names of {list(ARMS)}, got {args.arms!r}")
    dev = resolve_device(args.device)
    print(T.card_line(dev), flush=True)
    cfg = T.model_config(args.model)
    t0 = time.time()
    params = make_params(cfg, args.fmt, seed=0, device=dev, fill="zeros")
    T.sync(dev)
    print(f"[+{time.time() - t0:.1f}s] {args.model} {args.fmt} on {dev}", flush=True)

    prompt = T.token_ids(args.prefill, cfg.vocab_size)
    results = {}
    T.reset_launches()
    for name in arms:
        paged, kvq = ARMS[name]
        eng = Engine(cfg, params, EngineConfig(max_seq_len=args.ctx, max_batch=1, paged=paged,
                                               page_size=args.page_size, kv_quantized=kvq,
                                               prefill_chunk=args.chunk))
        tps = measure_decode(eng, prompt, args.tokens, args.repeats)
        results[name] = round(tps, 2)
        if paged:
            results["page_size_resolved"] = eng.ecfg.page_size
        print(f"[+{time.time() - t0:.1f}s] {name}: {tps:.2f} tok/s; "
              f"{step_profile(eng, prompt, dev)}", flush=True)
        del eng
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(T.launches_line(dev), flush=True)
    print(json.dumps({
        "metric": f"longctx_decode_tokens_per_sec_{args.model}_{args.fmt}_ctx{args.ctx}",
        "prefill_tokens": args.prefill, **results, "page_size": args.page_size, "unit": "tokens/s",
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
