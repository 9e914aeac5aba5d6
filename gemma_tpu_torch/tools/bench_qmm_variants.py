"""Decode (M = 8) q4_0 GEMV variants on the card: what scale format, dequant
precision and dot form cost, against a stream of the same bytes.

The counterpart of the reference's `tools/bench_qmm_variants.py`, which
varied the reference's production q4_0 kernel, on the port's q4_0 layout
(qs u8 [N, K/2], scales [N, K/32]). The kernels are the main path's
tensor-core GEMV (`dq_gemv_kernel` of `csrc/dq_gemv.cuh`) in the dot forms
of `ops/qmm_variants.TC_FORMS` (`Q4_0Variant` of `csrc/q4_0_matmul.cu`;
gdot and f32dot on f16 scales are the main path's instance itself) and the
stream checksum (`csrc/qmm_variants.cu`). Each line: mode, scale dtype, µs
(L2 cold, `_timing.py`), GB/s at the variant's own bytes (payload + scales
+ x + y), its fraction of 3.35 TB/s, and the bound. Every variant is first
held against its plain version on the same inputs.

The TPU's (bk, bn) tile pairs have no counterpart here: every mode runs
the main path's plan (each block's K-slice of x copied once into shared
memory, 4 warps of 16 weight rows a block, K split where the rows alone do
not fill the card); `bench_bn_sweep` sweeps rows per block.

    python -m gemma_tpu_torch.tools.bench_qmm_variants [ffn_down|gate_up|attn_out] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..models.params import resolve_device
from ..ops import qmm_variants as qv
from . import _timing as T

M = qv.GEMV_M
SHAPES = [("ffn_down", 2048, 16384), ("gate_up", 32768, 2048), ("attn_out", 2048, 2048)]
# (mode, scale dtype, what the line answers); float16 is the tool's u16
CONFIGS = [
    ("stream", torch.float16, "every payload and scale byte read once, a checksum: "
                              "the byte floor of this kernel (HBM's is the bound)"),
    ("gdot", torch.float16, "#1's form, sc * sum(q x) a group, on the port's f16 scales: "
                            "the main path's instance"),
    ("f32dot", torch.float16, "f32 weights, exact f16 scales: #1's function, the main path's "
                              "instance again"),
    ("f32dot", torch.bfloat16, "the group-scaled form on bf16 scales (the TPU's production)"),
    ("f32dot", torch.float32, "the group-scaled form on f32 scales (4 bytes a group)"),
    ("rsc", torch.bfloat16, "A = bf16(q * sc), one accumulator, bf16 scales (= rsc)"),
    ("f32sc", torch.float32, "A = bf16(q * sc), f32 scales (= f32sc and rsc)"),
    ("u16sc", torch.float16, "A = bf16(q * sc), f16 bits decoded in the kernel"),
    ("bf16sc", torch.bfloat16, "A = bf16(bf16 q * bf16 sc) (= bf16sc and rscb)"),
    ("noscale", torch.float32, "A = q, no scale read: the scale's cost by difference"),
]
# the production form once more with one row of x: what M = 8 costs over M = 1
M1_CONFIG = ("gdot", torch.float16, "the same kernel at M = 1: the cost of the other 7 rows")
# float modes: f32 products, sums in another order than the plain version;
# the bf16-rounded ones round the same weights on both sides
RTOL = 1e-4


def inputs(N: int, K: int, sc_dtype: torch.dtype, dev, m: int = M, seed: int = 0):
    """(x bf16 [m, K], qs u8 [N, K/2], scales [N, K/32]) from a seed, scales
    sized as the main path's (exact in f16)."""
    gen = T.generator(dev, seed)
    qt = T.random_qtensor("q4_0", N, K, gen, dev)
    return T.bf16_x(m, K, gen, dev), qt.qs, qt.scales.to(sc_dtype)


def measure(name: str, N: int, K: int, mode: str, sc_dtype: torch.dtype, dev, tally: T.Tally,
            reps: int = 5, m: int = M) -> dict:
    """Hold `mode` against its plain version, then time it L2 cold."""
    x, qs, sc = inputs(N, K, sc_dtype, dev, m)
    if mode == "stream":
        kernel = tally.call("row_checksum", qv.row_checksum)
        got, ref = kernel(qs, sc), qv.row_checksum_plain(qs, sc)
        args, out_bytes, flops = (qs, sc), N * 4, 0
        diff = T.check(f"stream {name}", got, ref, None)
    else:
        kernel = tally.call("qmm_tc_variant", lambda *a: qv.qmm_tc_variant(mode, *a))
        got, ref = kernel(x, qs, sc), qv.qmm_variant_plain(mode, x, qs, sc)
        args, out_bytes, flops = (x, qs, sc), m * N * 4, 2 * m * N * K
        diff = T.check(f"{mode} {name}", got, ref, RTOL)
    del got, ref
    in_bytes = T.nbytes(*args)
    us = T.time_us(kernel, T.replicate(args, T.copies_for(in_bytes, dev)), dev, reps)
    return {"us": us, "bytes": in_bytes + out_bytes, "flops": flops, "diff": diff}


def run(shapes, dev: torch.device, reps: int = 5, configs=CONFIGS) -> dict:
    """Print every config's line on every shape; returns {(shape, mode,
    scale dtype): reading}."""
    tally = T.Tally()
    print(T.card_line(dev), flush=True)
    print(f"q4_0 GEMV variants, M={M}, on the main path's tensor-core GEMV and plan "
          f"(f32sc = rsc and bf16sc = rscb: one form each)", flush=True)
    out = {}
    for name, N, K in shapes:
        print(f"{name} [{N}, {K}]", flush=True)
        for mode, scd, note, m in [(*c, M) for c in configs] + [(*M1_CONFIG, 1)]:
            r = measure(name, N, K, mode, scd, dev, tally, reps, m)
            out[(name, mode, str(scd).removeprefix("torch."), m)] = r
            print(f"  {mode:8s} sc={str(scd).removeprefix('torch.'):8s} M={m} "
                  f"{T.rate_line(r['us'], r['bytes'], r['flops'], dev)}; {r['diff']}; {note}",
                  flush=True)
    print(tally.report(dev), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("shape", nargs="?", choices=[s[0] for s in SHAPES])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    run([s for s in SHAPES if args.shape in (None, s[0])], dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
