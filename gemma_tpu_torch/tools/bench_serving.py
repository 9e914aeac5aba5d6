"""Continuous-batching serving: aggregate tokens/s and TTFT percentiles of a
backlog of requests through the `Scheduler`.

The counterpart of the reference's `tools/bench_serving.py`, with its flags
and its JSON keys, on the port's `Engine` and `Scheduler` with weights
fabricated from a seed (`testing.make_params`, `--fill`). `--requests`
prompts of `--prompt-len` tokens, `--max-new` tokens each, go through
`--batch` decode slots in pipelined `--block`-token decode blocks (one host
read a block). One batch warms up first (first launches, the allocator);
then the whole backlog is submitted at t = 0 and served to the end.
`value` is the useful tokens (at most `max_new_tokens` a request) over the
wall time of that run, admissions included; TTFT runs from submission to
the host's read of a request's first token, so it includes the wait in the
queue.

`--admit-per-tick N` caps the admissions a tick starts (a burst of
prefills stalls the running batch); `--prefill-chunk C` admits prompts of
more than 2 C tokens one C-token chunk a tick; `--speculative` runs
batched speculative ticks (greedy, dense cache): every slot drafts
`--spec-k` tokens from its history and verifies them in one forward,
`--spec-block` ticks a host read, `--spec-pipeline` blocks in flight.
`--fill zeros` (zero payload bytes, scales as drawn) makes greedy streams
repeat, the speculative ceiling; so do `--fill random`'s q4_0 draws (their
nibbles share a mean); `--fill centred` takes random payloads with q4_0's
nibbles centred (`make_params(centred=True)`; other formats draw as
random), whose greedy streams differ from request to request (at full
Gemma-2B width each repeats its prompt's last token: the tied head reads
back the residual's embedding).

Before the JSON line it prints the card (name and power limit), the
kernels the measured run launched (`launches {...}`) and `streams <sha256>
distinct <n> fewest <m>`: a digest of every request's tokens by id (two
runs of one model and greedy sampling give equal streams whatever their
scheduling), the number of distinct streams, and the fewest distinct
tokens in one stream (a digest of streams that all repeat one token shows
little of the scheduling). On the CPU
(`--device cpu`) the plain versions run and the rates say nothing of the
card.

    python -m gemma_tpu_torch.tools.bench_serving [--model gemma2b] [--batch 8] [--requests 24]
        [--block 8] [--paged] [--kv-quant] [--admit-per-tick N] [--prefill-chunk C]
        [--speculative] [--fill zeros|random|centred] [--device cpu]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time

from ..models.params import resolve_device
from ..runtime import Engine, EngineConfig, Request, Scheduler
from ..testing import make_params
from . import _timing as T


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="gemma2b", choices=T.MODELS)
    ap.add_argument("--fmt", default="q4_0", choices=("q4_0", "q8_0", "q4_k_m"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=96)
    ap.add_argument("--block", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=512)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--kv-quant", action="store_true", help="int8 KV cache")
    ap.add_argument("--admit-per-tick", type=int, default=None,
                    help="cap admissions a decode tick (TTFT against ramp)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="overlapped admission: one prefill chunk a decode tick")
    ap.add_argument("--speculative", action="store_true",
                    help="batched speculative ticks (greedy, dense cache)")
    ap.add_argument("--spec-k", type=int, default=7)
    ap.add_argument("--spec-pipeline", type=int, default=2)
    ap.add_argument("--spec-block", type=int, default=4,
                    help="chained verify ticks a host read")
    ap.add_argument("--fill", default="zeros", choices=("zeros", "random", "centred"),
                    help="weight payloads: zeros (repetitive greedy streams), random, or "
                         "random with centred q4_0 nibbles")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def make_requests(args, vocab: int, request=Request) -> list:
    return [request(f"r{i}", T.token_ids(args.prompt_len, vocab, offset=i),
                    max_new_tokens=args.max_new) for i in range(args.requests)]


def measure(eng: Engine, args, label: str) -> tuple[dict, list]:
    """Warm up on one batch, then serve the backlog. Returns (the JSON
    record, the finished requests)."""
    spec_kw = dict(speculative=args.speculative, spec_k=args.spec_k,
                   spec_pipeline=args.spec_pipeline, spec_block=args.spec_block)
    vocab = eng.cfg.vocab_size
    sched = Scheduler(eng, **spec_kw)
    for r in make_requests(args, vocab)[: args.batch]:
        sched.submit(r)
    sched.run(block=args.block)

    T.reset_launches()
    sched = Scheduler(eng, admit_per_tick=args.admit_per_tick, **spec_kw)
    for r in make_requests(args, vocab):
        sched.submit(r)
    t1 = time.monotonic()
    finished = sched.run(block=args.block)
    wall = time.monotonic() - t1

    stats = sched.stats()
    useful = sum(min(len(r.tokens), r.max_new_tokens) for r in finished)
    out = {
        "metric": f"serving_tokens_per_sec_{label}_b{args.batch}",
        "value": round(useful / wall, 2),
        "unit": "tokens/s",
        "requests": stats["requests"],
        "decode_steps": stats["decode_steps"],
        "p50_ttft_s": round(stats["p50_ttft_s"], 4),
        "p99_ttft_s": round(stats["p99_ttft_s"], 4),
        "block": args.block,
        "wall_s": round(wall, 2),
        "admit_per_tick": args.admit_per_tick,
        "prefill_chunk": args.prefill_chunk,
        "kv_quant": args.kv_quant,
        "fill": args.fill,
    }
    if args.speculative:
        out["speculative"] = {
            "k": args.spec_k, "pipeline": args.spec_pipeline, "spec_block": args.spec_block,
            "spec_forwards": stats["spec_forwards"],
            "tokens_discarded": stats["tokens_discarded"],
            "accepted_tokens_per_verify": round(useful / max(stats["spec_forwards"], 1), 2),
        }
    return out, finished


def streams_line(finished) -> str:
    """`streams <sha256> distinct <n> fewest <m>` of the finished requests:
    the digest of their tokens by id, how many streams differ, and the
    fewest distinct tokens in one stream."""
    streams = {r.id: [int(t) for t in r.tokens] for r in finished}
    digest = hashlib.sha256(json.dumps(streams, sort_keys=True).encode()).hexdigest()
    distinct = len({tuple(s) for s in streams.values()})
    fewest = min((len(set(s)) for s in streams.values()), default=0)
    return f"streams {digest} distinct {distinct} fewest {fewest}"


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    print(T.card_line(dev), flush=True)
    cfg = T.model_config(args.model)
    t0 = time.time()
    centred = args.fill == "centred"
    params = make_params(cfg, args.fmt, seed=0, device=dev, centred=centred,
                         fill="random" if centred else args.fill)
    T.sync(dev)
    print(f"[+{time.time() - t0:.1f}s] {args.model} {args.fmt} fill={args.fill} on {dev}", flush=True)
    eng = Engine(cfg, params, EngineConfig(
        max_seq_len=args.max_seq_len, max_batch=args.batch, paged=args.paged,
        kv_quantized=args.kv_quant, prefill_chunk=args.prefill_chunk))
    out, finished = measure(eng, args, f"{args.model}_{args.fmt}")
    print(T.launches_line(dev), flush=True)
    print(streams_line(finished), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
