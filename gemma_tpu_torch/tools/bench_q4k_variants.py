"""Where the q4_k GEMV's time goes beyond q4_0's, at decode M = 8 on
ffn_down [2048, 16384]: ablations of its metadata math.

The counterpart of the reference's `tools/bench_q4k_variants.py`, which
dropped terms from the reference's production q4_k kernel, on the port's
q4_k layout (qs u8 [N, K/2], the packed 12-byte 6-bit table, f16 d and
dmin). Every line runs the main path's tensor-core GEMV (`dq_gemv_kernel`
of `csrc/dq_gemv.cuh`) with its plan, through `gt_q4_k_ablation`
(`csrc/q4_k_matmul.cu`) and `gt_qmm_tc_variant`:

  prod      the main path's q4_k instance (`Q4KGemv`): each 32-group's
            fragment scaled by d*sc, the affine part (8 d*sc - dmin*mn) *
            sum(x) added from the block's per-32 sums of x
  nohilo    prod on d and dmin rounded to bf16. The reference stores them
            as an exact bf16 hi/lo pair and paid two adds for exactness;
            the port keeps exact f16, so that cost does not exist here and
            this line equals prod's work
  noaffine  d*sc * (q - 8) (`Q4KAblation<kNoAffine>`): no dmin*mn, no
            per-32 sums of x (one barrier where prod takes two), no affine
            add
  nosub     d * (q - 8) (`Q4KAblation<kNoSub>`): no 6-bit table copied or
            decoded, no affine part
  q4_0ref   the main path's q4_0 instance (`Q4_0Gemv`) on the same payload
            bytes with the 6-bit sub-scales as f16 scales: the floor

Times are L2 cold (`_timing.py`); GB/s at the bytes each mode reads.

    python -m gemma_tpu_torch.tools.bench_q4k_variants [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..models.params import resolve_device
from ..ops import qmm_variants as qv
from . import _timing as T

M = qv.GEMV_M
N, K = 2048, 16384  # ffn_down (Gemma-2B)
RTOL = 1e-4  # exact products of the integers and bf16 x, f32 sums in another order


def weights(mode: str, qt):
    """The weight `mode` runs on (see the module docstring)."""
    if mode == "nohilo":
        return qv.q4_k_hi_parts(qt)
    if mode == "q4_0ref":
        return qv.q4_0ref_weight(qt)
    return qt


def read_bytes(mode: str, w) -> int:
    """Bytes of the weight arrays the mode's kernel reads."""
    if mode == "nosub":
        return T.nbytes(w.qs, w.dm)
    return T.nbytes(w)


def run(dev: torch.device, reps: int = 5, n: int = N, k: int = K,
        modes=tuple(qv.Q4_K_MODES)) -> dict:
    tally = T.Tally()
    print(T.card_line(dev), flush=True)
    print(f"q4_k GEMV ablations, ffn_down [{n}, {k}], M={M}", flush=True)
    gen = T.generator(dev)
    qt = T.random_qtensor("q4_k", n, k, gen, dev)
    x = T.bf16_x(M, k, gen, dev)
    out = {}
    for mode in modes:
        w = weights(mode, qt)
        kernel = tally.call("q4_k_variant", lambda x_, w_, m=mode: qv.q4_k_variant(m, x_, w_))
        diff = T.check(f"q4_k {mode}", kernel(x, w), qv.q4_k_variant_plain(mode, x, w), RTOL)
        wb = read_bytes(mode, w)
        us = T.time_us(kernel, T.replicate((x, w), T.copies_for(T.nbytes(x, w), dev)), dev, reps)
        r = out[mode] = {"us": us, "bytes": wb + T.nbytes(x) + M * n * 4, "flops": 2 * M * n * k,
                         "diff": diff}
        print(f"  {mode:9s} {T.rate_line(r['us'], r['bytes'], r['flops'], dev)}; {diff}", flush=True)
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
