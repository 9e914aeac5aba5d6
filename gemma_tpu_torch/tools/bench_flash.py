"""Prefill flash attention's row warps at T = S = 2048, causal.

The counterpart of the reference's `tools/bench_flash.py`, which swept its
Pallas kernel's q and key tiles (block_q x block_s) at Gemma-2B's heads
(Hq 8, Hkv 1, D 256), T = S = 2048 causal (T from the first argument): the
attention of one layer inside a 2K prefill. Here the launch shape is how
the bf16 tensor-core kernel's 4 warps split a block (`gt_flash_attention_tc`
through `_launch.flash`): 1, 2 or 4 row warps, the rest splitting the keys,
and the plan's own pick (`flash_tc_shape`, named on its line). Each line
gives device µs a layer with the operands warm and TFLOP/s of the causal
products, beside `scaled_dot_product_attention` (causal, the KV head shared
by the group) on the same inputs: a yardstick, used nowhere in the port.
Every kernel output is first held to the plain version (2e-2 of each
row's scale). On the CPU (`--device cpu`) the plain version runs and the
times say nothing of the card.

    python -m gemma_tpu_torch.tools.bench_flash [T] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..models.params import resolve_device
from ..ops import attention as att
from . import _launch
from . import _timing as T

HQ, HKV, D = 8, 1, 256  # Gemma-2B's heads
ROW_WARPS = (1, 2, 4)
TOL = 2e-2  # of each row's scale: p rounds to bf16 against a tile's max


def make_inputs(T_: int, dev, seed: int = 0):
    """(q [1, T, HQ, D], k, v [1, HKV, T, D] bf16, positions 0..T-1, kv_limit T)."""
    gen = T.generator(dev, seed)
    q, k, v = ((torch.randn(*shape, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
               for shape in ((1, T_, HQ, D), (1, HKV, T_, D), (1, HKV, T_, D)))
    pos = torch.arange(T_, dtype=torch.int32, device=dev)[None]
    return q, k, v, pos, torch.tensor([T_], dtype=torch.int32, device=dev)


def run(dev: torch.device, T_: int = 2048, reps: int = 5) -> dict:
    """{row warps (0: the plan's) or "sdpa": (us a layer, TFLOP/s)}, one line each."""
    import torch.nn.functional as F

    from ..kernels import build
    from .tc_emulation import flash_shape

    print(T.card_line(dev), flush=True)
    print(f"flash attention, T=S={T_} causal, Hq={HQ} Hkv={HKV} D={D}: {T.clock(dev)} us a layer, "
          f"operands warm", flush=True)
    q, k, v, pos, lim = make_inputs(T_, dev)
    ref = att.flash_attention_plain(q, k, v, pos, lim)
    flops = 4 * HQ * D * T_ * (T_ + 1) // 2
    lib = build.load() if dev.type == "cuda" else None
    plan = flash_shape(1, HKV, T_, HQ // HKV)[0]
    out = {}
    for rw in (*ROW_WARPS, 0):
        if dev.type == "cuda":
            def fn(rw=rw):
                return _launch.flash(lib, q, k, v, pos, lim, rw)
        else:
            def fn():
                return att.flash_attention_plain(q, k, v, pos, lim)
        ratio = T.attn_err(fn(), ref, TOL)[1]
        if ratio > 1.0:
            raise RuntimeError(f"flash at {rw} row warps: |diff| {ratio:.3f} x {TOL} of its row's scale")
        us = T.time_us(fn, [()], dev, reps)
        out[rw] = (us, flops / us / 1e6)
        label = f"row warps {rw} ({4 // rw} key groups)" if rw else f"the plan's (row warps {plan})"
        line = f"  {label:28s} {us:10.1f} us/layer {out[rw][1]:7.1f} TFLOP/s"
        print(line if dev.type == "cuda" else f"{line} {T.CPU_NOTE}", flush=True)
    qh = q.transpose(1, 2)
    us = T.time_us(lambda: F.scaled_dot_product_attention(qh, k, v, is_causal=True, scale=1.0,
                                                          enable_gqa=True), [()], dev, reps)
    out["sdpa"] = (us, flops / us / 1e6)
    line = f"  {'scaled_dot_product_attention':28s} {us:10.1f} us/layer {out['sdpa'][1]:7.1f} TFLOP/s"
    print(line if dev.type == "cuda" else f"{line} {T.CPU_NOTE}", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("T", nargs="?", type=int, default=2048, help="query rows = keys (causal)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(resolve_device(args.device), args.T)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
