"""Rows per block of q4_0's SIMT GEMV at decode M = 8: does a wider block
pay on the 256000-row head?

The counterpart of the reference's `tools/bench_bn_sweep.py`, which forced
the N tile (bn 2048, 4096, 8192) of its production kernel. Here the same
question is the rows (warps) per block of `q4_0_gemv_kernel`
(`csrc/q4_0_matmul.cu`; f32 x's at M <= 8): 4, 8 (shipped), 16 and 32, through
`gt_q4_0_gemv_warps`. Times are L2 cold (`_timing.py`); each line gives
GB/s at the weight's wire bytes plus x and y.

    python -m gemma_tpu_torch.tools.bench_bn_sweep [lm_head|gate_up|ffn_down] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..models.params import resolve_device
from ..ops import qmm_variants as qv
from ..ops.quant_matmul import q4_0_matmul_plain
from . import _timing as T

M = qv.GEMV_M
# the tied head at the port's unpadded vocab (the reference padded to 258048)
SHAPES = [("lm_head", 256000, 2048), ("gate_up", 32768, 2048), ("ffn_down", 2048, 16384)]
RTOL = 1e-4  # f32 products, sums in another order than the plain version


def measure(name: str, N: int, K: int, warps_list, dev, tally: T.Tally, reps: int = 5) -> dict:
    gen = T.generator(dev)
    qt = T.random_qtensor("q4_0", N, K, gen, dev)
    x = T.bf16_x(M, K, gen, dev)
    ref = q4_0_matmul_plain(x, qt)
    in_bytes = T.nbytes(x, qt)
    sets = T.replicate((x, qt), T.copies_for(in_bytes, dev))
    out = {}
    for warps in warps_list:
        kernel = tally.call("q4_0_gemv_warps", lambda x_, q_, w=warps: qv.q4_0_gemv_warps(x_, q_, w))
        diff = T.check(f"{name} {warps} warps", kernel(x, qt), ref, RTOL)
        us = T.time_us(kernel, sets, dev, reps)
        out[warps] = {"us": us, "bytes": in_bytes + M * N * 4, "flops": 2 * M * N * K, "diff": diff}
    return out


def run(shapes, dev: torch.device, reps: int = 5, warps_list=qv.WARPS) -> dict:
    tally = T.Tally()
    print(T.card_line(dev), flush=True)
    print(f"q4_0 GEMV rows per block, M={M} (the shipped kernel runs 8)", flush=True)
    out = {}
    for name, N, K in shapes:
        for warps, r in measure(name, N, K, warps_list, dev, tally, reps).items():
            out[(name, warps)] = r
            print(f"{name:9s} [{N}, {K}] warps={warps:2d} "
                  f"{T.rate_line(r['us'], r['bytes'], r['flops'], dev)}; {r['diff']}", flush=True)
    print(tally.report(dev), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("shape", nargs="?", choices=[s[0] for s in SHAPES])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run([s for s in SHAPES if args.shape in (None, s[0])], resolve_device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
