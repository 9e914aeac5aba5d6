"""Prefill throughput (tokens/s): the marginal rate between two prompt
lengths, monolithic (1024 -> 2048 tokens) and chunked in 512-token pieces
(2048 -> 4096), for q4_0, q8_0 and q4_k_m.

The counterpart of the reference's `tools/bench_prefill.py`, on the port's
`Engine` at full Gemma-2B width with random weights from a seed
(`testing.make_params`): the wall time of `Engine.prefill` or
`Engine.prefill_chunked`, each run ended by a synchronize, the minimum of
`reps` runs after a warm-up run. The marginal rate (T2 - T1) / (t(T2) -
t(T1)) cancels what both lengths share: the host's fixed cost and the one
row of head logits. On the CPU (`--device cpu`) a tiny config at short
lengths runs the plain versions; its rates say nothing of the card.

    python -m gemma_tpu_torch.tools.bench_prefill [--fmt q4_k_m] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..models import GEMMA_2B
from ..models.params import resolve_device
from ..ops import quant_matmul as qmm
from ..runtime import Engine, EngineConfig
from ..testing import TINY_KERNEL_CONFIG, make_params
from . import _timing as T

FORMATS = ("q4_0", "q8_0", "q4_k_m")
# (name, chunk or 0, T1, T2): the reference's pairs on the card; on the CPU
# a tiny config at a sixteenth of the lengths
RUNS = (("mono", 0, 1024, 2048), ("chunked", 512, 2048, 4096))
CPU_SCALE = 16


def measure(eng: Engine, T_: int, chunk: int, reps: int) -> float:
    """Seconds of the fastest of `reps` prefills of a T_-token prompt (one
    warm-up run first)."""
    prompt = [2 + i % 1000 for i in range(T_)]

    def once():
        if chunk:
            eng.prefill_chunked([prompt], chunk)
        else:
            eng.prefill([prompt])
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)

    once()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    return min(times)


def run(dev: torch.device, fmts=FORMATS, reps: int = 5) -> dict:
    """{fmt: {"<name>_T<T1>_to_T<T2>": marginal tok/s, ...}}, with a line
    per length pair and one JSON line per format printed."""
    card = T.card_line(dev)
    print(card, flush=True)
    cpu = dev.type != "cuda"
    cfg = TINY_KERNEL_CONFIG if cpu else GEMMA_2B
    runs = [(name, chunk // CPU_SCALE, t1 // CPU_SCALE, t2 // CPU_SCALE) if cpu
            else (name, chunk, t1, t2) for name, chunk, t1, t2 in RUNS]
    max_len = max(t2 for *_, t2 in runs)
    out = {}
    for fmt in fmts:
        params = make_params(cfg, fmt, seed=0, device=dev)
        eng = Engine(cfg, params, EngineConfig(max_seq_len=max_len, max_batch=1))
        for op in qmm.MATMULS.values():
            op.launches = 0
        rates = {}
        for name, chunk, t1, t2 in runs:
            s1, s2 = measure(eng, t1, chunk, reps), measure(eng, t2, chunk, reps)
            rate = (t2 - t1) / max(s2 - s1, 1e-9)
            rates[f"{name}_T{t1}_to_T{t2}"] = rate
            print(f"{fmt} {name}: t({t1})={s1 * 1e3:.2f} ms t({t2})={s2 * 1e3:.2f} ms, marginal "
                  f"{rate:.1f} tok/s{'' if not cpu else ' ' + T.CPU_NOTE}", flush=True)
        launches = {name: op.launches for name, op in qmm.MATMULS.items() if op.launches}
        if not cpu and not launches:
            raise RuntimeError(f"{fmt}: no quantized-matmul kernel was launched")
        out[fmt] = rates
        print(json.dumps({"metric": f"prefill_tokens_per_sec_{'tiny' if cpu else 'gemma2b'}_{fmt}",
                          **rates, "unit": "tokens/s (marginal)", "device": card,
                          "launches": launches}), flush=True)
        del eng, params
        if not cpu:
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fmt", action="append", choices=FORMATS,
                   help="a weight format (repeatable); default: all three")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(resolve_device(args.device), tuple(args.fmt or FORMATS))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
