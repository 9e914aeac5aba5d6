"""How decode steps are dispatched: a host-chained loop with the argmax
outside the step, against `Engine.block` (sampling inside), which
`generate_fused` and the Scheduler run.

The counterpart of the reference's `tools/bench_scan.py`, on the port's
`Engine` at full Gemma-2B q4_0 width (`testing.make_params(fill="zeros")`):
a 64-token prefill, then N = 32 greedy steps a run, each run from the same
cache state (its length set back) with no host sync until its end, the
best of `--runs` runs after a warm-up run:

  chain   `Engine.decode_step` then `argmax` (the reference's chain arm);
  block   `Engine.block` (the sampler inside, greedy).

The reference's third arm, one `lax.scan` program of the N steps, has no
eager counterpart: its counterpart is a CUDA-graph capture of the same N
steps, which waits for the graphed decode block (ROADMAP item 12: the
kernels' shared workspace, `kernels/build.workspace`, still grows by
allocation, so a capture cannot size it yet). A line says so.

Before the JSON line it prints the card (name and power limit) and the
kernels the runs launched (`launches {...}`). On the CPU (`--device
cpu`, `--model tiny`) the plain versions run and the times say nothing of
the card.

    python -m gemma_tpu_torch.tools.bench_scan [--model gemma2b] [--steps 32] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time

from ..models.params import resolve_device
from ..runtime import Engine, EngineConfig
from ..testing import make_params
from . import _timing as T

PROMPT = 64


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="gemma2b", choices=T.MODELS)
    ap.add_argument("--fmt", default="q4_0", choices=("q4_0", "q8_0", "q4_k_m"))
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--runs", type=int, default=2, help="timed runs an arm, after a warm-up run")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(T.card_line(dev), flush=True)
    cfg = T.model_config(args.model)
    model = make_params(cfg, args.fmt, seed=0, device=dev, fill="zeros")
    eng = Engine(cfg, model, EngineConfig(max_seq_len=512, max_batch=1))
    logits0, cache = eng.prefill([list(range(2, 2 + PROMPT))])
    length0 = cache.length.clone()
    n = args.steps

    def chain():
        cache.length.copy_(length0)
        tok, toks = logits0.argmax(-1), []
        for _ in range(n):
            logits, _ = eng.decode_step(tok, cache)
            tok = logits.argmax(-1)
            toks.append(tok)
        return toks[-1]

    def block():
        cache.length.copy_(length0)
        toks, _, _ = eng.block(logits0, None, cache, n)
        return toks

    out = {}
    T.reset_launches()
    for name, fn in (("chain", chain), ("block", block)):
        fn()  # warm-up: first launches, the allocator
        T.sync(dev)
        times = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            fn().cpu()  # the host's read of the last token ends the run
            times.append(time.perf_counter() - t0)
            print(f"{name}: {times[-1] / n * 1e3:.3f} ms/token ({n / times[-1]:.1f} tok/s)", flush=True)
        out[f"{name}_ms"] = round(min(times) / n * 1e3, 4)
        out[f"{name}_tok_s"] = round(n / min(times), 2)
    print("graph (one CUDA-graph capture of the same steps, the reference's lax.scan arm): not "
          "run; it waits for the graphed decode block, ROADMAP item 12", flush=True)
    print(T.launches_line(dev), flush=True)
    print(json.dumps({"metric": f"decode_dispatch_ms_per_token_{args.model}_{args.fmt}", **out,
                      "scan_ms": None, "steps": n, "prompt": PROMPT}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
