"""q4_0's production matmul at every Gemma-2B decode shape, M = 8.

The counterpart of the reference's `tools/bench_shapes.py`: `quant_matmul`
(the path `linear` takes for every quantized weight; at M = 8 the
tensor-core GEMV) on q4_0 weights of each matmul of a Gemma-2B decode step
(fused qkv, attn_out, fused gate|up, ffn_down) and the tied head at the
reference's vocabulary rows: `lm_head` [256128] and `lm_head_pad` [258048]
(2048-aligned). The port does not pad its vocabulary (its head has 256000
rows); the padded row measures how N's alignment moves the kernel, and no
model runs it. Each line gives device µs with L2 cold (`_timing.py`), GB/s
against the weight's own bytes, its MB and its count a step (the layers,
or one head); the last sums a step's matmuls (the raw head, not the
padded one) in ms a token. Every output is first held to the plain
version (1e-4 of the output's scale). `--model tiny` runs the same
structure at `testing.TINY_KERNEL_CONFIG`'s shapes, for the CPU (`--device
cpu`: the plain versions, times that say nothing of the card).

    python -m gemma_tpu_torch.tools.bench_shapes [--model gemma2b|tiny] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..models.params import resolve_device
from . import _timing as T
from .bench_fmt_kernels import M, measure

# (name, N, K, count a decode step): the reference's list at Gemma-2B's 18 layers
SHAPES = {
    "gemma2b": [("qkv", 2560, 2048, 18), ("attn_out", 2048, 2048, 18), ("gate_up", 32768, 2048, 18),
                ("ffn_down", 2048, 16384, 18), ("lm_head", 256128, 2048, 1),
                ("lm_head_pad", 258048, 2048, 1)],
    # TINY_KERNEL_CONFIG: q_dim 256 + 2 x 128, d_model 256, d_ff 512, vocab 512, 2 layers
    "tiny": [("qkv", 512, 256, 2), ("attn_out", 256, 256, 2), ("gate_up", 1024, 256, 2),
             ("ffn_down", 256, 512, 2), ("lm_head", 512, 256, 1), ("lm_head_pad", 2048, 256, 1)],
}


def run(model: str, dev: torch.device, reps: int = 5) -> float:
    """A line a shape, then the step's sum (ms a token), which it returns."""
    T.reset_launches()
    print(T.card_line(dev), flush=True)
    print(f"q4_0 quant_matmul at every {model} decode shape, M={M}: {T.clock(dev)} us L2 cold",
          flush=True)
    total_ms = 0.0
    for name, N, K, count in SHAPES[model]:
        r = measure("q4_0", N, K, dev, reps)
        if name != "lm_head_pad":
            total_ms += r["us"] * count / 1e3
        line = (f"  {name:12s} [{N:6d},{K:6d}] {r['us']:8.1f} us {r['gbs']:7.1f} GB/s  ({r['mb']:7.1f} MB) "
                f"x{count}")
        print(line if dev.type == "cuda" else f"{line} {T.CPU_NOTE}", flush=True)
    line = f"  sum over decode matmuls (raw lm_head): {total_ms:.3f} ms/token"
    print(line if dev.type == "cuda" else f"{line} {T.CPU_NOTE}", flush=True)
    print(T.launches_line(dev), flush=True)
    return total_ms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=sorted(SHAPES), default="gemma2b")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(args.model, resolve_device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
