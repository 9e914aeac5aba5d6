"""Micro-benchmarks of the decode step's pieces: each quantized matmul at
M = 1, decode attention, the host's cost of one launch, and the whole step.

The counterpart of the reference's `tools/bench_micro.py` (positional
`fmt`), on the port's ops at full Gemma-2B width
(`testing.make_params(fill="zeros")`):

* each matmul of the recipe (layer 0's, and the head) at M = 1: the wall
  µs a call of `--reps` back-to-back calls ended by a synchronize (the
  reference's clock: on this card mostly the host's cost of a call for
  all but the widest rows), and the device µs a call, L2 cold, by CUDA
  events (`_timing.time_us`); GB/s of the weight's own bytes at each, the
  device figure against the card's HBM rate (`utils.device.device_peaks`),
  x its count in the model, and the sums a token;
* decode attention at S = 512: `torch.nn.functional.scaled_dot_product_attention`
  (the counterpart of the reference's non-Pallas arm, `sdpa_xla`) and the
  port's own `decode_attention` kernel, wall and device µs;
* a chain of 200 trivial launches (`x + 1` on an [8, 128] f32 tensor):
  the host's cost of one launch;
* one full decode step (`Engine.decode_step`), wall ms a token.

Before the JSON line it prints the card (name and power limit) and the
kernels the run launched (`launches {...}`). On the CPU (`--device cpu`,
`--model tiny`) the plain versions run and the times say nothing of the
card.

    python -m gemma_tpu_torch.tools.bench_micro [q4_0|q8_0|q4_k_m] [--model gemma2b] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import torch
import torch.nn.functional as F

from ..models.params import resolve_device
from ..ops.attention import decode_attention
from ..ops.quant_matmul import quant_matmul
from ..runtime import Engine, EngineConfig
from ..testing import make_params
from ..utils.device import device_peaks
from . import _timing as T

S = 512  # decode attention's cache slots
DISPATCHES = 200
# (printed name, the layer's weight) of each recipe, and the head
LAYER_WEIGHTS = (("qkv", "attn_qkv"), ("attn_q", "attn_q"), ("attn_k", "attn_k"),
                 ("attn_v", "attn_v"), ("attn_out", "attn_output"), ("gate_up", "ffn_gate_up"),
                 ("ffn_down", "ffn_down"))


def wall_us(fn, dev: torch.device, reps: int) -> float:
    """Wall µs a call of `reps` back-to-back calls after a warm-up call."""
    fn()
    T.sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    T.sync(dev)
    return (time.perf_counter() - t0) / reps * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("fmt", nargs="?", default="q4_0", choices=("q4_0", "q8_0", "q4_k_m"))
    ap.add_argument("--model", default="gemma2b", choices=T.MODELS)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(T.card_line(dev), flush=True)
    cfg = T.model_config(args.model)
    model = make_params(cfg, args.fmt, seed=0, device=dev, fill="zeros")
    peak_gbs = device_peaks(dev)[0] if dev.type == "cuda" else T.HBM_BPS / 1e9
    note = "" if dev.type == "cuda" else f" {T.CPU_NOTE}"
    T.reset_launches()

    lp = model.layers[0]
    weights = [(name, getattr(lp, attr), cfg.n_layers) for name, attr in LAYER_WEIGHTS
               if lp.has(attr)] + [("lm_head", model.embed, 1)]
    print(f"== quantized matmuls, M = 1 (fmt {args.fmt}; wall: {args.reps} back-to-back calls; "
          f"device: L2 cold; GB/s of the weight's bytes, peak {peak_gbs:.0f} GB/s) =={note}",
          flush=True)
    matmuls = {}
    for name, qt, n in weights:
        N, K = qt.shape
        x = torch.zeros(1, K, dtype=torch.bfloat16, device=dev)
        nbytes = T.nbytes(qt)
        us = wall_us(lambda: quant_matmul(x, qt), dev, args.reps)
        dus = T.time_us(quant_matmul, T.replicate((x, qt), T.copies_for(nbytes, dev)), dev)
        matmuls[name] = {"shape": [N, K], "us": round(us, 2), "device_us": round(dus, 2),
                         "device_gbs": round(nbytes / dus / 1e3, 1), "count": n}
        print(f"  {name:9s} [{N:6d},{K:6d}] wall {us:9.1f} us {nbytes / us / 1e3:7.1f} GB/s; device "
              f"{dus:8.1f} us {nbytes / dus / 1e3:7.1f} GB/s ({nbytes / dus / 1e3 / peak_gbs:.3f} of "
              f"peak)  x{n}", flush=True)
    sum_ms = sum(m["us"] * m["count"] for m in matmuls.values()) / 1e3
    dev_sum_ms = sum(m["device_us"] * m["count"] for m in matmuls.values()) / 1e3
    print(f"  sum over the model's matmuls: wall {sum_ms:.3f} ms/token, device {dev_sum_ms:.3f} "
          f"ms/token", flush=True)

    bf16 = torch.bfloat16
    q = torch.zeros(1, 1, cfg.n_heads, cfg.head_dim, dtype=bf16, device=dev)
    k = torch.zeros(1, cfg.n_kv_heads, S, cfg.head_dim, dtype=bf16, device=dev)
    v = torch.zeros_like(k)
    lim = torch.full((1,), S, dtype=torch.int32, device=dev)
    g = cfg.n_heads // cfg.n_kv_heads  # SDPA takes the K/V heads repeated to the query heads
    qs, ks, vs = q.transpose(1, 2), k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs)
    ours = lambda: decode_attention(q, k, v, lim)
    attn = {}
    for name, fn in (("sdpa", sdpa), ("decode_attention", ours)):
        us = wall_us(fn, dev, args.reps)
        dus = T.time_us(fn, [()], dev)
        attn[name] = (us, dus)
        print(f"== {name} decode (S={S}): wall {us:.1f} us, device {dus:.1f} us; x{cfg.n_layers} = "
              f"wall {us * cfg.n_layers / 1e3:.3f} ms, device {dus * cfg.n_layers / 1e3:.3f} ms{note}",
              flush=True)

    x = torch.zeros(8, 128, dtype=torch.float32, device=dev)
    dispatch = wall_us(lambda: x + 1.0, dev, DISPATCHES)
    print(f"== trivial launch (x + 1 on [8, 128] f32, {DISPATCHES} back to back): {dispatch:.1f} "
          f"us/launch{note}", flush=True)

    eng = Engine(cfg, model, EngineConfig(max_seq_len=S, max_batch=1))
    logits, cache = eng.prefill([list(range(2, 66))])
    tok = logits.argmax(-1)
    eng.decode_step(tok, cache)
    T.sync(dev)
    t0 = time.perf_counter()
    for _ in range(args.reps):
        logits, cache = eng.decode_step(tok, cache)
    T.sync(dev)
    step_ms = (time.perf_counter() - t0) / args.reps * 1e3
    print(f"== full decode step: {step_ms:.3f} ms/token ({1e3 / step_ms:.1f} tok/s){note}", flush=True)
    print(T.launches_line(dev), flush=True)
    print(json.dumps({
        "metric": f"decode_micro_{args.model}_{args.fmt}", "matmuls": matmuls,
        "matmul_sum_ms": round(sum_ms, 4), "matmul_device_sum_ms": round(dev_sum_ms, 4),
        "sdpa_us": round(attn["sdpa"][0], 2), "sdpa_device_us": round(attn["sdpa"][1], 2),
        "decode_attention_us": round(attn["decode_attention"][0], 2),
        "decode_attention_device_us": round(attn["decode_attention"][1], 2),
        "dispatch_us": round(dispatch, 2), "step_ms": round(step_ms, 4),
        "tok_s": round(1e3 / step_ms, 2), "peak_gbs": peak_gbs,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
