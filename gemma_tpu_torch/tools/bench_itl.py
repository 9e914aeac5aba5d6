"""Inter-token latency around a long admission: what overlapped admission
buys a running request.

The counterpart of the reference's `tools/bench_itl.py`, with its flags and
its JSON keys, on the port's `Scheduler`. Gemma-2B q4_0 (`fill="zeros"`,
scales as drawn) at 2 slots: a steady request decodes in `--block`-token
blocks; a `--prompt-len`-token prompt arrives in the middle of it. With
synchronous admission the whole prompt prefills inside one tick and the
steady request's stream stops for it; with overlapped admission
(`--chunk`-token chunks, one a tick) the stall is about one chunk. The
number is the steady request's largest gap between two emissions, in ms,
with `overlap_admission` off (`max_itl_ms_sync`) and on
(`max_itl_ms_overlap`), each the best of `--repeats` runs after a warm-up
run of both. Emissions are stamped in `on_token`, which fires when a
block's tokens reach the host: a gap is at least one block's decode time.

Before the JSON line it prints the card (name and power limit) and the
kernels the measured runs launched (`launches {...}`). On the CPU
(`--device cpu`, `--model tiny`) the plain versions run and the gaps say
nothing of the card.

    python -m gemma_tpu_torch.tools.bench_itl [--prompt-len 2048] [--chunk 256] [--block 8]
        [--device cpu --model tiny]
"""
from __future__ import annotations

import argparse
import json
import math
import time

from ..models.params import resolve_device
from ..runtime import Engine, EngineConfig, Request, Scheduler
from ..testing import make_params
from . import _timing as T

STEADY_PROMPT = 32  # tokens of the steady request's prompt
WARM_BLOCKS, BASELINE_BLOCKS = 6, 4  # blocks before the long prompt arrives


def run_case(eng: Engine, overlap: bool, long_prompt: list[int], block: int,
             steady_new: int) -> float:
    """The steady request's largest gap between emissions (ms) around the
    long prompt's admission (nan if it emitted fewer than two tokens)."""
    emissions: list[float] = []

    def on_token(req, tok):
        if req.id == "steady":
            emissions.append(time.monotonic())

    sched = Scheduler(eng, overlap_admission=overlap, on_token=on_token)
    sched.submit(Request("steady", [2 + i for i in range(STEADY_PROMPT)], max_new_tokens=steady_new))
    for _ in range(WARM_BLOCKS):  # steady is mid-decode
        sched.step_block(block)
    emissions.clear()
    for _ in range(BASELINE_BLOCKS):  # the gap without an admission
        sched.step_block(block)
    sched.submit(Request("late", long_prompt, max_new_tokens=8))
    while sched.active or sched.pending or sched._admitting:
        sched.step_block(block)
        if len(sched.finished) == 2:
            break
    gaps = [b - a for a, b in zip(emissions, emissions[1:])]
    return max(gaps) * 1e3 if gaps else math.nan


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="gemma2b", choices=T.MODELS)
    ap.add_argument("--fmt", default="q4_0", choices=("q4_0", "q8_0", "q4_k_m"))
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--block", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=4096)
    ap.add_argument("--steady-new", type=int, default=200,
                    help="tokens of the steady request (it must outlast the admission)")
    ap.add_argument("--repeats", type=int, default=3, help="runs a case; the best is kept")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(T.card_line(dev), flush=True)
    cfg = T.model_config(args.model)
    params = make_params(cfg, args.fmt, seed=0, device=dev, fill="zeros")
    eng = Engine(cfg, params, EngineConfig(max_seq_len=args.max_seq_len, max_batch=2,
                                           prefill_chunk=args.chunk))
    long_prompt = T.token_ids(args.prompt_len, cfg.vocab_size)
    case = (lambda overlap: run_case(eng, overlap, long_prompt, args.block, args.steady_new))
    case(True)  # warm both admission paths
    case(False)

    T.reset_launches()
    res = {}
    for name, overlap in (("sync", False), ("overlap", True)):
        gaps = [case(overlap) for _ in range(args.repeats)]
        res[f"max_itl_ms_{name}"] = round(min(gaps), 1)
        print(f"{name}: largest gap of each run {[round(g, 1) for g in gaps]} ms", flush=True)
    print(T.launches_line(dev), flush=True)
    print(json.dumps({"metric": "admission_stall_max_itl_ms", **res, "prompt_len": args.prompt_len,
                      "chunk": args.chunk, "block": args.block}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
