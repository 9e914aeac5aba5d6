"""The decode step in parts: the matmuls alone, then with decode attention,
then with the elementwise stack, then the whole step.

The counterpart of the reference's `tools/bench_step_parts.py`, on the
port's ops at full Gemma-2B width (`testing.make_params(fill="zeros")`,
the recipe's own weights: q4_0 and q8_0 fuse q|k|v and gate|up, q4_k_m
keeps attn_q, attn_k and attn_v apart). Four programs, each chaining CH = 8
tokens through every layer on one [1, d_model] row:

  matmuls   the model's quantized matmuls of one token (q|k|v or q, k, v;
            attn_output, gate|up, down each layer, and the head), chained
            through their outputs;
  +attn     and decode attention each layer over a cache of S = 512 slots
            at limit 66 (random bf16 keys and values, one cache a layer);
  +ew       and the elementwise stack: 4 RMS norms, RoPE on q and k, the
            query scale, GeGLU, the residuals (the step without the cache
            write and the engine's bookkeeping);
  step      `Engine.decode_step` and the argmax: everything, the cache write
            included (the cache's length is set back before each call).

Each program's wall ms a token is its marginal time between 1 and 1 + R
calls (each run ended by a synchronize), the median of `--reps`, over CH;
successive differences attribute the rest of the step: attention |
elementwise | cache write + step overhead. On this card the eager step is
mostly the host's launches, so beside the wall time each program's device
busy ms a token (the sum of its kernels' device times from torch.profiler
over one call, as chip_smoke.py reads a step's busy time) and its device
kernels a token are printed: busy against wall, by part.

Before the JSON line it prints the card (name and power limit) and the
kernels the run launched (`launches {...}`). On the CPU
(`--device cpu`, `--model tiny`) the plain versions run; the times say
nothing of the card and no busy time is read.

    python -m gemma_tpu_torch.tools.bench_step_parts [q4_0|q8_0|q4_k_m] [--model gemma2b]
        [--r 32] [--reps 5] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch
import torch.nn.functional as F

from ..models.gemma import apply_rope, rms_norm
from ..models.params import resolve_device
from ..ops.attention import decode_attention
from ..ops.quant_matmul import quant_matmul
from ..runtime import Engine, EngineConfig
from ..testing import make_params
from . import _timing as T

CH = 8  # tokens chained inside one program call
S, LIMIT = 512, 66  # the attention programs' cache slots and valid keys


def marginal(prog, dev: torch.device, r: int, reps: int) -> float:
    """Median over `reps` of (t(1 + r calls) - t(1 call)) / r / CH seconds."""
    def run(n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            prog()
        T.sync(dev)
        return time.perf_counter() - t0

    run(1)  # first launches, the allocator
    return statistics.median((run(1 + r) - run(1)) / r / CH for _ in range(reps))


def programs(cfg, model, dev: torch.device) -> dict:
    """name -> a zero-argument callable running CH chained tokens."""
    bf16 = torch.bfloat16
    layers = list(model.layers)
    fused = layers[0].has("attn_qkv")

    def q_k(lp, h):
        if fused:
            qkv = quant_matmul(h, lp.attn_qkv)
            return qkv[:, : cfg.q_dim], qkv[:, cfg.q_dim : cfg.q_dim + cfg.kv_dim]
        q, k = quant_matmul(h, lp.attn_q), quant_matmul(h, lp.attn_k)
        quant_matmul(h, lp.attn_v)
        return q, k

    def mlp(lp, a):
        gu = quant_matmul(a.to(bf16), lp.ffn_gate_up)
        return quant_matmul(gu[:, : cfg.d_ff].to(bf16), lp.ffn_down)

    def head(h):
        logits = quant_matmul(h, model.embed)
        return (h + logits[:, : cfg.d_model] * 1e-30).to(bf16)

    x = torch.zeros(1, cfg.d_model, dtype=bf16, device=dev)

    def matmuls():
        h = x
        for _ in range(CH):
            for lp in layers:
                q, _ = q_k(lp, h)
                a = quant_matmul(q.to(bf16), lp.attn_output)
                h = (h + mlp(lp, a) * 1e-30).to(bf16)
            h = head(h)
        return h

    gen = T.generator(dev)
    ks = [(torch.randn(1, cfg.n_kv_heads, S, cfg.head_dim, generator=gen, device=dev) * 0.3).to(bf16)
          for _ in layers]
    vs = [k.clone() for k in ks]
    lim = torch.tensor([LIMIT], dtype=torch.int32, device=dev)

    def attend(li, q):
        q = q.reshape(1, 1, cfg.n_heads, cfg.head_dim).to(bf16)
        return decode_attention(q, ks[li], vs[li], lim).reshape(1, cfg.q_dim)

    def mm_attn():
        h = x
        for _ in range(CH):
            for li, lp in enumerate(layers):
                q, _ = q_k(lp, h)
                a = quant_matmul(attend(li, q), lp.attn_output)
                h = (h + mlp(lp, a) * 1e-30).to(bf16)
            h = head(h)
        return h

    pos = torch.tensor([[LIMIT]], dtype=torch.int32, device=dev)
    qscale = torch.tensor(cfg.effective_query_scale, dtype=bf16)

    def mm_attn_ew():
        h = x[:, None, :]  # [1, 1, d_model]
        for _ in range(CH):
            for li, lp in enumerate(layers):
                hn = rms_norm(h, lp.attn_norm.weight, cfg.rms_eps).reshape(1, cfg.d_model)
                q, k = q_k(lp, hn)
                base, ps = cfg.layer_rope(li)
                q = apply_rope(q.reshape(1, 1, cfg.n_heads, cfg.head_dim).to(bf16), pos, base, ps) * qscale
                k = apply_rope(k.reshape(1, 1, cfg.n_kv_heads, cfg.head_dim).to(bf16), pos, base, ps)
                a = quant_matmul(attend(li, q + k.sum() * 1e-30), lp.attn_output)
                h = h + a[:, None, :].to(h.dtype)
                hn = rms_norm(h, lp.ffn_norm.weight, cfg.rms_eps).reshape(1, cfg.d_model)
                gu = quant_matmul(hn, lp.ffn_gate_up)
                gate = F.gelu(gu[:, : cfg.d_ff], approximate="tanh")
                d = quant_matmul((gate * gu[:, cfg.d_ff :]).to(bf16), lp.ffn_down)
                h = h + d[:, None, :].to(h.dtype)
            hn = rms_norm(h, model.final_norm.weight, cfg.rms_eps).reshape(1, cfg.d_model)
            logits = quant_matmul(hn, model.embed)
            h = (h + logits[:, None, : cfg.d_model] * 1e-30).to(bf16)
        return h

    eng = Engine(cfg, model, EngineConfig(max_seq_len=S, max_batch=1))
    logits, cache = eng.prefill([list(range(2, LIMIT))])
    tok0 = logits.argmax(-1)
    length0 = cache.length.clone()

    def step():
        cache.length.copy_(length0)
        tok = tok0
        for _ in range(CH):
            logits, _ = eng.decode_step(tok, cache)
            tok = logits.argmax(-1)
        return tok

    return {"matmuls": matmuls, "+attn": mm_attn, "+ew": mm_attn_ew, "step": step}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("fmt", nargs="?", default="q4_0", choices=("q4_0", "q8_0", "q4_k_m"))
    ap.add_argument("--model", default="gemma2b", choices=T.MODELS)
    ap.add_argument("--r", type=int, default=32, help="calls of the marginal run")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(T.card_line(dev), flush=True)
    cfg = T.model_config(args.model)
    model = make_params(cfg, args.fmt, seed=0, device=dev, fill="zeros")
    progs = programs(cfg, model, dev)

    wall, busy, kernels = {}, {}, {}
    T.reset_launches()
    for name, prog in progs.items():
        wall[name] = marginal(prog, dev, args.r, args.reps) * 1e3
        ms, n, _ = T.profile_busy(prog, dev)
        busy[name] = None if ms is None else round(ms / CH, 4)
        kernels[name] = None if n is None else n / CH
        on_card = "" if ms is None else (f"; device busy {ms / CH:.3f} ms, {n / CH:g} device "
                                         f"kernels a token")
        print(f"{name:8s} {wall[name]:.3f} ms/token wall{on_card}", flush=True)
    mm, at, ew, st = (wall[k] for k in progs)
    print(f"full step:    {st:.3f} ms/token ({1e3 / st:.1f} tok/s)", flush=True)
    print(f"non-matmul:   {st - mm:.3f} ms/token", flush=True)
    print(f"attribution:  attention {at - mm:.3f}  elementwise {ew - at:.3f}  "
          f"cache-write+overhead {st - ew:.3f}  ms/token", flush=True)
    print(T.launches_line(dev), flush=True)
    print(json.dumps({
        "metric": f"decode_step_parts_ms_per_token_{args.model}_{args.fmt}",
        "matmuls_ms": round(mm, 4), "attn_ms": round(at, 4), "ew_ms": round(ew, 4),
        "step_ms": round(st, 4), "tok_s": round(1e3 / st, 2),
        "attribution_ms": {"attention": round(at - mm, 4), "elementwise": round(ew - at, 4),
                           "cache_write_overhead": round(st - ew, 4)},
        "busy_ms": busy, "kernels_per_token": kernels, "chained": CH,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
