"""Each format's production quantized matmul at the decode step's M = 8.

The counterpart of the reference's `tools/bench_fmt_kernels.py`: the
production path (`ops/quant_matmul.py quant_matmul`, which `linear` calls
for every quantized weight, to the format's kernel: at M = 8 the
tensor-core GEMV of `csrc/dq_gemv.cuh`) for
q4_0, q4_k, q6_k and q8_0 on the reference's hot shapes of Gemma-2B (`2b`:
ffn_down, gate_up, lm_head) or Gemma-7B (`7b`: qkv, attn_out, gate_up,
ffn_down, lm_head; `tiny`: small shapes for the CPU), against each
format's own bytes: the weight's payload and tables as the port stores
them. Weights are random payload bytes with scales sized for outputs near
1 (`_timing.random_qtensor`); x is bf16. Each line gives device µs with L2
cold (`_timing.py`), GB/s and the weight's MB; every output is first held
to the plain version (1e-4 of the output's scale); a `launches {...}`
line gives the kernels the run launched. The first argument picks the
shape list, the rest the formats. On the CPU (`--device cpu`) the plain
versions run and the times say nothing of the card.

    python -m gemma_tpu_torch.tools.bench_fmt_kernels [2b|7b|tiny] [q4_0 q4_k q6_k q8_0] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..models.params import resolve_device
from ..ops import quant_matmul as qmm
from . import _timing as T

M = 8
FORMATS = ("q4_0", "q4_k", "q6_k", "q8_0")
# the reference's lists; the port's vocabulary is unpadded (256000)
SHAPES = {
    "2b": [("ffn_down", 2048, 16384), ("gate_up", 32768, 2048), ("lm_head", 256000, 2048)],
    "7b": [("qkv", 12288, 3072), ("attn_out", 3072, 4096), ("gate_up", 49152, 3072),
           ("ffn_down", 3072, 24576), ("lm_head", 256000, 3072)],
    "tiny": [("ffn_down", 256, 512), ("gate_up", 1024, 256), ("lm_head", 512, 256)],
}
RTOL = 1e-4  # of the output's scale: f32 sums in another order than the plain version


def measure(fmt: str, N: int, K: int, dev: torch.device, reps: int = 5) -> dict:
    """{"us", "gbs", "mb"} of `quant_matmul` at [M, K] x [N, K]^T in `fmt`."""
    gen = T.generator(dev)
    qt = T.random_qtensor(fmt, N, K, gen, dev)
    x = T.bf16_x(M, K, gen, dev)
    T.check(f"{fmt} [{N}, {K}]", qmm.quant_matmul(x, qt), qmm.PLAIN[fmt](x, qt), RTOL)
    weight = T.nbytes(qt)
    sets = T.replicate((x, qt), T.copies_for(weight + T.nbytes(x), dev))
    us = T.time_us(qmm.quant_matmul, sets, dev, reps)
    return {"us": us, "gbs": weight / us / 1e3, "mb": weight / 1e6}


def run(model: str, fmts, dev: torch.device, reps: int = 5) -> dict:
    T.reset_launches()
    print(T.card_line(dev), flush=True)
    print(f"production quantized matmul (quant_matmul), {model}, M={M}: {T.clock(dev)} us L2 cold, "
          f"GB/s of each format's own bytes", flush=True)
    out = {}
    for name, N, K in SHAPES[model]:
        for fmt in fmts:
            r = out[(name, fmt)] = measure(fmt, N, K, dev, reps)
            line = f"{name:9s} {fmt:5s}  {r['us']:8.1f} us  {r['gbs']:7.1f} GB/s  ({r['mb']:.1f} MB)"
            print(line if dev.type == "cuda" else f"{line} {T.CPU_NOTE}", flush=True)
    print(T.launches_line(dev), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("model", nargs="?", choices=sorted(SHAPES), default="2b")
    p.add_argument("fmts", nargs="*", choices=FORMATS)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(args.model, args.fmts or FORMATS, resolve_device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
