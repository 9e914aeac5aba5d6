"""q6_k at decode M = 8 on ffn_down [2048, 16384]: is the 6.5625-bpw plane
layout worth its 2-bit extraction against an int8 payload?

The counterpart of the reference's `tools/bench_q6k_variants.py` on the
port's q6_k layout (ggml's ql u8 [N, K/2], qh u8 [N, K/4], sc i8 [N, K/16],
d f16 [N, K/256]), through `gt_q6_k_variant` (`csrc/q6_k_matmul.cu`):

  prod       int8 payload q [N, K] with the same sc and d (8.5625 bpw)
  split_f32  the planes, low nibble + 16 * high bits - 32 in f32
  split_int  the planes combined in int32, one convert: the SIMT
             `q6_k_gemv_kernel` (an instrument only: bf16 and f32 x take
             the tensor-core GEMV of csrc/dq_gemv.cuh)
  stream     every byte of the planes read once (the checksum kernel)

Each mode is first held against its plain version; times are L2 cold
(`_timing.py`), GB/s at each mode's own bytes.

    python -m gemma_tpu_torch.tools.bench_q6k_variants [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..models.params import resolve_device
from ..ops import qmm_variants as qv
from . import _timing as T

M = qv.GEMV_M
N, K = 2048, 16384  # ffn_down (Gemma-2B)
MODES = ("prod", "split_f32", "split_int", "stream")
RTOL = 1e-4  # f32 products, sums reordered; exact for stream


def run(dev: torch.device, reps: int = 5, n: int = N, k: int = K, modes=MODES) -> dict:
    tally = T.Tally()
    print(T.card_line(dev), flush=True)
    print(f"q6_k GEMV layouts, ffn_down [{n}, {k}], M={M}", flush=True)
    gen = T.generator(dev)
    qt = T.random_qtensor("q6_k", n, k, gen, dev)
    x = T.bf16_x(M, k, gen, dev)
    out = {}
    for mode in modes:
        if mode == "stream":
            arrays = tuple(qt.arrays.values())
            kernel = tally.call("row_checksum", qv.row_checksum)
            diff = T.check("q6_k stream", kernel(*arrays), qv.row_checksum_plain(*arrays), None)
            args, wb, out_bytes, flops = arrays, T.nbytes(*arrays), n * 4, 0
        else:
            arrays = qv.q6_k_int8_payload(qt) if mode == "prod" else qt.arrays
            kernel = tally.call("q6_k_variant", lambda x_, a_, m=mode: qv.q6_k_variant(m, x_, a_))
            diff = T.check(f"q6_k {mode}", kernel(x, arrays),
                           qv.q6_k_variant_plain(mode, x, arrays), RTOL)
            args, wb, out_bytes, flops = (x, arrays), T.nbytes(arrays), M * n * 4, 2 * M * n * k
        total = T.nbytes(*args) + out_bytes
        us = T.time_us(kernel, T.replicate(args, T.copies_for(T.nbytes(*args), dev)), dev, reps)
        r = out[mode] = {"us": us, "bytes": total, "flops": flops, "diff": diff,
                         "bpw": wb * 8 / (n * k)}
        print(f"  {mode:10s} {r['bpw']:.4f} bpw {T.rate_line(us, total, flops, dev)}; {diff}",
              flush=True)
    print(tally.report(dev), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(resolve_device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
