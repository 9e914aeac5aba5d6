#!/usr/bin/env python3
"""Smoke run of gemma_tpu_torch (the PyTorch/CUDA port) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing `[phase]` info lines; any failure exits non-zero:
1. the card: `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`;
2. the build of the CUDA kernels (gemma_tpu_torch/csrc, nvcc for sm_90a);
3. each kernel against its plain PyTorch version on the card, at the
   Gemma-2B shapes of the q4_0 and q4_k_m paths, with max|diff| against the
   stated tolerance and the device times of kernel and plain version
   (torch.profiler), then correctness-only edge cases;
4. the main path at full Gemma-2B width, once with q4_0 weights (4) and
   once with the q4_k_m recipe (4b), random weights from a seed:
   `Engine.prefill` of a 203-token prompt then `Engine.generate_from` for 64
   greedy tokens (what `Engine.generate` and the CLI run), with finite
   logits, tokens in range, and the kernels' launch counters, set to 0 just
   before each run, equal to what the layer structure implies; then
   `Engine.generate` must give the same tokens;
5. `python -m gemma_tpu_torch generate --device cuda` in a subprocess on a
   tiny q4_0 GGUF and a tiny q4_k_m GGUF, its printed text equal to the
   in-process run's, and each tiny model on the card held against the same
   model on the CPU (plain path).

The last two lines of standard output are a JSON line of the kernels and
the contract line `{"ok": true, "device": {...}}`. With no CUDA device, or
without the rest of the repository beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PROMPT_LEN = 203  # about 200 tokens, not a power of two
NEW_TOKENS = 64
MAX_SEQ_LEN = 512

# TPU kernels replaced by each port kernel
KERNELS = {
    "q4_0_matmul": ("gemma_tpu_torch/csrc/q4_0_matmul.cu",
                    "gemma_tpu/ops/quant_matmul.py:95 _q4_0_kernel"),
    "q4_k_matmul": ("gemma_tpu_torch/csrc/q4_k_matmul.cu",
                    "gemma_tpu/ops/quant_matmul.py:110 _q4_k_kernel"),
    "q6_k_matmul": ("gemma_tpu_torch/csrc/q6_k_matmul.cu",
                    "gemma_tpu/ops/quant_matmul.py:162 _q6_k_kernel; "
                    "gemma_tpu/ops/quant_matmul.py:146 _q6_k_v4_kernel"),
    "flash_attention": ("gemma_tpu_torch/csrc/flash_attention.cu",
                        "gemma_tpu/ops/attention.py:94 _flash_kernel"),
    "decode_attention": ("gemma_tpu_torch/csrc/decode_attention.cu",
                         "gemma_tpu/ops/attention.py:273 _decode_kernel"),
}


class SmokeFailure(Exception):
    pass


def info(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def call_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time per call of fn() issued back to back (CUDA events): the
    larger of its device time and its host launch cost."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn(): the summed durations of the GPU kernels it
    launches, per call, from torch.profiler (CUPTI); host launch cost is
    not counted."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                   for e in prof.key_averages())
    require(total_us > 0, "torch.profiler recorded no device time")
    return total_us / iters / 1e3


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(out.returncode == 0 and out.stdout.strip(), f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def random_qtensor(torch, fmt: str, rows: int, cols: int, gen, dev):
    """Random payload bytes and tables, scales sized for outputs near 1."""
    from gemma_tpu_torch.quant.qtensor import QTensor

    def bytes_(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)

    def scales(base, *shape):
        return ((torch.rand(*shape, generator=gen, device=dev) + 0.5) * base).to(torch.float16)

    if fmt == "q4_0":
        return QTensor("q4_0", qs=bytes_(rows, cols // 2), scales=scales(0.005, rows, cols // 32))
    if fmt == "q4_k":
        return QTensor("q4_k", qs=bytes_(rows, cols // 2), scales=bytes_(rows, cols // 256, 12),
                       dm=scales(1e-4, rows, cols // 256, 2))
    return QTensor("q6_k", ql=bytes_(rows, cols // 2), qh=bytes_(rows, cols // 4),
                   sc=bytes_(rows, cols // 16).view(torch.int8), d=scales(2e-5, rows, cols // 256))


def check_matmul(torch, fmt: str, shapes, rep_name: str, gen, dev) -> dict:
    """One quantized matmul kernel against its plain version at M = 1 and
    M = 203 with bf16 x, on each (name, N, K) of `shapes`."""
    import gemma_tpu_torch.ops.quant_matmul as qmm

    kernel, plain = qmm.MATMULS[fmt], qmm.PLAIN[fmt]
    worst = 0.0
    rep = None
    for name, N, K in shapes:
        qt = random_qtensor(torch, fmt, N, K, gen, dev)
        wire_bytes = sum(a.numel() * a.element_size() for a in qt.arrays.values())
        for M in (1, PROMPT_LEN):
            x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            got = kernel(x, qt)
            ref = plain(x, qt)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            tol = 1e-4 * ref.abs().max().item() + 1e-6
            ms = device_ms(torch, lambda: kernel(x, qt))
            per_call = call_ms(torch, lambda: kernel(x, qt))
            plain_ms = device_ms(torch, lambda: plain(x, qt), iters=5, warmup=1)
            rate = (f"{wire_bytes / ms / 1e9:.3f} TB/s at wire bytes" if M == 1
                    else f"{2 * M * N * K / ms / 1e9:.3f} TFLOP/s")
            info("kernel", f"{fmt}_matmul {name} M={M} N={N} K={K}: max|diff|={err:.3e} "
                           f"tol={tol:.3e}; device ms: kernel {ms:.4f} ({rate}) plain "
                           f"{plain_ms:.4f}; kernel per back-to-back call {per_call:.4f} ms")
            require(bool(torch.isfinite(got).all()) and err <= tol,
                    f"{fmt}_matmul {name} M={M}: max|diff| {err} > tol {tol}")
            worst = max(worst, err)
            if name == rep_name and M == 1:
                rep = (ms, plain_ms, f"{name} M=1 N={N} K={K}")
        del qt
    return {"max_abs_err": worst, "ms": rep[0], "plain_ms": rep[1], "shape": rep[2]}


def check_kernels(torch, dev) -> dict[str, dict]:
    """Phase 3: every kernel against its plain version at the main path's
    shapes. Returns per-kernel results for the JSON line."""
    import gemma_tpu_torch.ops.attention as att

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results = {}

    # Quantized matmuls. q4_0 and q6_k: the kernel and the plain version
    # form the same f32 products (f32 weights at M <= 8, bf16-rounded
    # weights at M > 8) and differ only in the order of f32 sums. q4_k at
    # M <= 8 takes ggml's vec_dot form, d*sc * sum(x*q) - dmin*mn * sum(x),
    # against the plain x @ dequant: the products differ by the f32
    # rounding of each dequantized weight; at M > 8 both form
    # bf16(d*sc * (q - 8)) products plus the f32 affine part. Each is
    # ~1e-6 of the output's scale, so the tolerance is 1e-4 of it.
    for fmt, shapes, rep_name in (
        ("q4_0", [("qkv", 2560, 2048), ("attn_out", 2048, 2048), ("gate_up", 32768, 2048),
                  ("down", 2048, 16384), ("head", 256000, 2048)], "gate_up"),
        ("q4_k", [("attn_q", 2048, 2048), ("attn_k", 256, 2048), ("attn_out", 2048, 2048),
                  ("gate_up", 32768, 2048), ("down", 2048, 16384)], "gate_up"),
        # (2048, 16384): the deep-K shape of the reference's _q6_k_v4_kernel
        ("q6_k", [("attn_v", 256, 2048), ("head", 256000, 2048),
                  ("deep_k", 2048, 16384)], "head"),
    ):
        results[f"{fmt}_matmul"] = check_matmul(torch, fmt, shapes, rep_name, gen, dev)

    # attention: bf16 outputs, and p rounded to bf16 against a per-tile
    # (kernel) or per-row (plain) running max; the reference's own kernel
    # tests allow 2e-2 for the same reasons.
    att_tol = 2e-2
    Hq, Hkv, D = 8, 1, 256
    S = MAX_SEQ_LEN

    def kv():
        k = (torch.randn(1, Hkv, S, D, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        v = (torch.randn(1, Hkv, S, D, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        return k, v

    worst = 0.0
    rep = None
    for limit, cap, window in [(1, 0.0, 0), (64, 0.0, 0), (PROMPT_LEN + 1, 0.0, 0), (300, 0.0, 0),
                               (S, 0.0, 0), (300, 50.0, 128)]:
        q = (torch.randn(1, 1, Hq, D, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        k, v = kv()
        lim = torch.tensor([limit], dtype=torch.int32, device=dev)
        got = att.decode_attention(q, k, v, lim, cap, window)
        ref = att.decode_attention_plain(q, k, v, lim, cap, window)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        ms = device_ms(torch, lambda: att.decode_attention(q, k, v, lim, cap, window))
        per_call = call_ms(torch, lambda: att.decode_attention(q, k, v, lim, cap, window))
        plain_ms = device_ms(torch, lambda: att.decode_attention_plain(q, k, v, lim, cap, window))
        info("kernel", f"decode_attention S={S} limit={limit} softcap={cap} window={window}: "
                       f"max|diff|={err:.3e} tol={att_tol:.1e}; device ms: kernel {ms:.4f} "
                       f"plain {plain_ms:.4f}; kernel per back-to-back call {per_call:.4f} ms")
        require(bool(torch.isfinite(got).all()) and err <= att_tol,
                f"decode_attention limit={limit}: max|diff| {err} > tol {att_tol}")
        worst = max(worst, err)
        if limit == PROMPT_LEN + 1 and not cap:
            rep = (ms, plain_ms, f"S={S} kv_limit={limit} Hq={Hq} Hkv={Hkv} D={D}")
    results["decode_attention"] = {"max_abs_err": worst, "ms": rep[0], "plain_ms": rep[1], "shape": rep[2]}

    T = PROMPT_LEN
    worst = 0.0
    rep = None
    cases = [
        ("prompt", torch.arange(T, device=dev), T, 0.0, 0),
        ("softcap+window", torch.arange(T, device=dev) + 100, T + 100, 50.0, 64),
        # rows at positions >= 181 see no key below kv_limit 150 in a 32-window
        ("rows without keys", torch.arange(T, device=dev) + 100, 150, 0.0, 32),
    ]
    for name, pos, limit, cap, window in cases:
        q = (torch.randn(1, T, Hq, D, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        k, v = kv()
        positions = pos.to(torch.int32)[None]
        lim = torch.tensor([limit], dtype=torch.int32, device=dev)
        got = att.flash_attention(q, k, v, positions, lim, cap, window)
        ref = att.flash_attention_plain(q, k, v, positions, lim, cap, window)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        ms = device_ms(torch, lambda: att.flash_attention(q, k, v, positions, lim, cap, window))
        per_call = call_ms(torch, lambda: att.flash_attention(q, k, v, positions, lim, cap, window))
        plain_ms = device_ms(torch, lambda: att.flash_attention_plain(q, k, v, positions, lim, cap, window))
        info("kernel", f"flash_attention {name} T={T} S={S} limit={limit} softcap={cap} "
                       f"window={window}: max|diff|={err:.3e} tol={att_tol:.1e}; device ms: "
                       f"kernel {ms:.4f} plain {plain_ms:.4f}; kernel per back-to-back call "
                       f"{per_call:.4f} ms")
        require(bool(torch.isfinite(got).all()) and err <= att_tol,
                f"flash_attention {name}: max|diff| {err} > tol {att_tol}")
        if name == "rows without keys":
            empty = pos >= 181
            require(bool((got[0, empty] == 0).all()), "flash_attention: rows without keys are not 0")
        worst = max(worst, err)
        if name == "prompt":
            rep = (ms, plain_ms, f"T={T} S={S} Hq={Hq} Hkv={Hkv} D={D}")
    results["flash_attention"] = {"max_abs_err": worst, "ms": rep[0], "plain_ms": rep[1], "shape": rep[2]}
    return results


def check_edge_cases(torch, dev) -> None:
    """Phase 3, correctness only: the kernels' instances the main path does
    not reach (M = 2..9 and 70 on ragged N and K, f32 activations, GQA with
    head_dim 128, batch 2 with per-row limits, ragged T, softcap + window),
    each against its plain version with the tolerances of check_kernels
    (attention in f32: 1e-4, nothing rounds). The K-quants take K = 1280,
    five superblocks: off the GEMV's 1024-element K-chunk."""
    import gemma_tpu_torch.ops.attention as att
    import gemma_tpu_torch.ops.quant_matmul as qmm

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    worst = {}
    for fmt, K in (("q4_0", 1056), ("q4_k", 1280), ("q6_k", 1280)):  # N, K off every tile and chunk
        qt = random_qtensor(torch, fmt, 1000, K, gen, dev)
        for dtype in (torch.bfloat16, torch.float32):
            for M in (2, 5, 8, 9, 70):
                x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
                got, ref = qmm.MATMULS[fmt](x, qt), qmm.PLAIN[fmt](x, qt)
                err = (got - ref).abs().max().item()
                tol = 1e-4 * ref.abs().max().item() + 1e-6
                require(err <= tol, f"{fmt}_matmul M={M} {dtype}: max|diff| {err} > tol {tol}")
                worst[fmt] = max(worst.get(fmt, 0.0), err / tol)
    B, T, Hq, Hkv, D, S = 2, 37, 8, 2, 128, 100
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q = (torch.randn(B, T, Hq, D, generator=gen, device=dev) * 0.3).to(dtype)
        k = (torch.randn(B, Hkv, S, D, generator=gen, device=dev) * 0.3).to(dtype)
        v = (torch.randn(B, Hkv, S, D, generator=gen, device=dev) * 0.3).to(dtype)
        pos = torch.stack([torch.arange(T), torch.arange(T) + 50]).to(dev, torch.int32)
        lim = torch.tensor([T, 90], dtype=torch.int32, device=dev)
        for cap, window in ((0.0, 0), (30.0, 20)):
            got = att.flash_attention(q, k, v, pos, lim, cap, window)
            ref = att.flash_attention_plain(q, k, v, pos, lim, cap, window)
            err = (got.float() - ref.float()).abs().max().item()
            require(err <= tol, f"flash_attention edge {dtype} cap={cap}: {err} > {tol}")
            worst["flash"] = max(worst.get("flash", 0.0), err / tol)
            dlim = torch.tensor([1, 90], dtype=torch.int32, device=dev)
            got = att.decode_attention(q[:, :1], k, v, dlim, cap, window)
            ref = att.decode_attention_plain(q[:, :1], k, v, dlim, cap, window)
            err = (got.float() - ref.float()).abs().max().item()
            require(err <= tol, f"decode_attention edge {dtype} cap={cap}: {err} > {tol}")
            worst["decode"] = max(worst.get("decode", 0.0), err / tol)
    torch.cuda.synchronize()
    info("kernel", "edge cases (other M, ragged N/K/T, f32, GQA D=128, batch 2) within "
                   "tolerance; worst max|diff| / tol: "
                   + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()))


def reset_counters() -> None:
    import gemma_tpu_torch.ops.attention as att
    import gemma_tpu_torch.ops.quant_matmul as qmm

    for op in qmm.MATMULS.values():
        op.launches = 0
    att.flash_attention.launches = 0
    att.decode_attention.launches = 0


def read_counters() -> dict[str, int]:
    import gemma_tpu_torch.ops.attention as att
    import gemma_tpu_torch.ops.quant_matmul as qmm

    return {
        **{f"{fmt}_matmul": op.launches for fmt, op in qmm.MATMULS.items()},
        "flash_attention": att.flash_attention.launches,
        "decode_attention": att.decode_attention.launches,
    }


def decode_profile(torch, eng, cache, last_tok: int, steps: int = 8):
    """Device time of greedy decode steps from torch.profiler: (busy ms per
    step, the five largest kernels' ms per step)."""
    from torch.profiler import ProfilerActivity, profile

    tok = torch.tensor([last_tok], device=eng.device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            logits, cache = eng.decode_step(tok, cache)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
    per_kernel = sorted(((getattr(e, "self_device_time_total", 0) / steps / 1e3, e.key)
                         for e in prof.key_averages()), reverse=True)
    busy = sum(ms for ms, _ in per_kernel)
    top = "; ".join(f"{name[:48]} {ms:.4f}" for ms, name in per_kernel[:5])
    return busy, top


def host_profile(torch, eng, cache, last_tok: int, steps: int = 4) -> str:
    """Host time of greedy decode steps by op from torch.profiler (CPU
    activity): the eight largest self-CPU entries per step. Profiling
    inflates host time, so read the shares, not the sum."""
    from torch.profiler import ProfilerActivity, profile

    tok = torch.tensor([last_tok], device=eng.device)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            logits, cache = eng.decode_step(tok, cache)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
    rows = sorted(((e.self_cpu_time_total / steps / 1e3, e.key, e.count // steps)
                   for e in prof.key_averages()), reverse=True)
    total = sum(ms for ms, _, _ in rows)
    return f"{total:.3f} ms profiled; " + "; ".join(
        f"{name[:40]} x{n} {ms:.3f}" for ms, name, n in rows[:8])


def expected_launches(cfg, fmt: str) -> dict[str, int]:
    """Kernel launches of one prefill and NEW_TOKENS decode steps (65
    forwards) as the layer structure implies."""
    forwards = 1 + NEW_TOKENS
    if fmt == "q4_0":  # fused q|k|v, out, fused gate|up, down; tied head
        per_forward = {"q4_0_matmul": 4 * cfg.n_layers + 1}
    else:  # q4_k: q, k, out, fused gate|up, down; q6_k: attn_v, tied head
        per_forward = {"q4_k_matmul": 5 * cfg.n_layers, "q6_k_matmul": cfg.n_layers + 1}
    return {
        **{name: per_forward.get(name, 0) * forwards
           for name in ("q4_0_matmul", "q4_k_matmul", "q6_k_matmul")},
        "flash_attention": cfg.n_layers,
        "decode_attention": cfg.n_layers * NEW_TOKENS,
    }


def main_path(torch, dev, card: str, fmt: str) -> dict[str, int]:
    """Phase 4 (q4_0) and 4b (q4_k_m): full-width Gemma-2B, prefill + 64
    greedy tokens."""
    from gemma_tpu_torch.models import GEMMA_2B
    from gemma_tpu_torch.runtime import Engine, EngineConfig
    from gemma_tpu_torch.testing import make_params

    cfg = GEMMA_2B
    phase = f"main {fmt}"
    model = make_params(cfg, fmt, seed=0, device=dev)
    weight_gb = sum(b.numel() * b.element_size() for b in model.buffers()) / 1e9
    eng = Engine(cfg, model, EngineConfig(max_seq_len=MAX_SEQ_LEN, max_batch=1))
    prompt = [2 + (i * 7919) % (cfg.vocab_size - 2) for i in range(PROMPT_LEN)]
    eng.generate([prompt[:16]], 4)  # warm-up: first launches, allocator
    torch.cuda.synchronize()

    reset_counters()
    t0 = time.perf_counter()
    logits, cache = eng.prefill([prompt])
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    require(tuple(logits.shape) == (1, cfg.vocab_size), f"prefill logits shape {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits).all()), "prefill logits are not finite")
    t1 = time.perf_counter()
    toks = eng.generate_from(logits, cache, NEW_TOKENS)[0]
    t_decode = time.perf_counter() - t1
    counts = read_counters()

    require(len(toks) == NEW_TOKENS, f"generated {len(toks)} tokens, wanted {NEW_TOKENS}")
    require(all(0 <= t < cfg.vocab_size for t in toks), "token out of range")
    last = eng.decode_step(torch.tensor([toks[-1]], device=dev), cache)[0]
    require(bool(torch.isfinite(last).all()), "decode logits are not finite")
    expected = expected_launches(cfg, fmt)
    info(phase, f"Gemma-2B {fmt} ({weight_gb:.3f} GB of weights on the card), prompt "
                f"{PROMPT_LEN} tokens: prefill {t_prefill * 1e3:.2f} ms, decode {NEW_TOKENS} "
                f"tokens in {t_decode:.3f} s = {NEW_TOKENS / t_decode:.2f} tok/s on {card}; "
                f"launches {counts} (expected {expected})")
    require(counts == expected, f"launch counts {counts} != expected {expected}")
    busy, top = decode_profile(torch, eng, cache, toks[-1])
    per_token = t_decode / NEW_TOKENS * 1e3
    info(phase, f"decode step on {card}: {per_token:.3f} ms wall per token, device busy "
                f"{busy:.3f} ms (idle share {1 - busy / per_token:.3f}); device ms per token "
                f"by kernel: {top}")
    info(phase, f"host ms per decode step by op: {host_profile(torch, eng, cache, toks[-1])}")
    again = eng.generate([prompt], NEW_TOKENS)[0]
    require(again == toks, "Engine.generate differs from prefill + generate_from")
    del eng, model, cache
    torch.cuda.empty_cache()
    return counts


def tiny_checks(torch, dev, weight_type: str) -> None:
    """Phase 5: the CLI on the card, and the card against the CPU, on a tiny
    q4_0 or q4_k_m model (TINY_KERNEL_CONFIG: every K a multiple of 256)."""
    from gemma_tpu_torch import cli
    from gemma_tpu_torch.runtime import Engine, EngineConfig
    from gemma_tpu_torch.testing import TINY_KERNEL_CONFIG, make_gguf

    prompt = [1, 7, 300, 42, 260, 9, 77, 5, 400, 13, 2, 100]
    n_new = 16
    moved = [name for name, n in expected_launches(TINY_KERNEL_CONFIG, weight_type).items() if n]
    with tempfile.TemporaryDirectory() as tmp:
        path = make_gguf(Path(tmp) / "tiny.gguf", TINY_KERNEL_CONFIG, seed=0,
                         weight_type=weight_type)
        before = read_counters()
        proc = subprocess.run(
            [sys.executable, "-m", "gemma_tpu_torch", "generate", str(path), "--device", "cuda",
             "--tokens", ",".join(map(str, prompt)), "--max-new-tokens", str(n_new),
             "--no-eos"],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
        )
        require(proc.returncode == 0, f"CLI failed ({proc.returncode}):\n{proc.stderr[-4000:]}")

        cfg, model_gpu, tok = cli.load(path, dev)
        _, model_cpu, _ = cli.load(path, "cpu")
        gpu_toks = Engine(cfg, model_gpu, EngineConfig(max_seq_len=256)).generate([prompt], n_new)[0]
        after = read_counters()
        require(all(after[k] > before[k] for k in moved),
                f"tiny {weight_type} run missed a kernel of {moved}: {before} -> {after}")
        text = tok.decode(gpu_toks)
        require(proc.stdout == text + "\n", f"CLI printed {proc.stdout!r}, in-process run {text!r}")

        # f32 activations and cache: the kernels' f32 arms against the plain
        # path on the CPU; identical products, sums in another order
        cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
        ecfg32 = EngineConfig(max_seq_len=256, kv_dtype=torch.float32)
        e_gpu, e_cpu = Engine(cfg32, model_gpu, ecfg32), Engine(cfg32, model_cpu, ecfg32)
        lg, _ = e_gpu.prefill([prompt])
        lc, _ = e_cpu.prefill([prompt])
        err = (lg.cpu() - lc).abs().max().item()
        tol = 1e-3 * lc.abs().max().item()
        toks_g = e_gpu.generate([prompt], n_new)[0]
        toks_c = e_cpu.generate([prompt], n_new)[0]
        # bf16 activations: rounding points agree, rounding inputs differ in
        # their last bits, so only the prefill logits' scale is held
        lgb, _ = Engine(cfg, model_gpu, EngineConfig(max_seq_len=256)).prefill([prompt])
        lcb, _ = Engine(cfg, model_cpu, EngineConfig(max_seq_len=256)).prefill([prompt])
        err_b = (lgb.cpu() - lcb).abs().max().item()
        tol_b = 5e-2 * lcb.abs().max().item()
    info("tiny", f"{weight_type}: CLI on cuda: its {n_new} tokens' text equals the in-process "
                 f"run's; kernels {moved} launched; card vs CPU, "
                 f"f32: prefill logits max|diff|={err:.3e} (tol {tol:.3e}), greedy streams "
                 f"{'equal' if toks_g == toks_c else 'DIFFER'}; bf16: max|diff|={err_b:.3e} "
                 f"(tol {tol_b:.3e})")
    require(err <= tol, f"f32 prefill logits card vs CPU: {err} > {tol}")
    require(toks_g == toks_c, f"f32 greedy streams differ: {toks_g} vs {toks_c}")
    require(err_b <= tol_b, f"bf16 prefill logits card vs CPU: {err_b} > {tol_b}")


def run() -> dict:
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false: no CUDA device")
    from gemma_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = device_line()
    print(card, flush=True)
    info("device", f"{card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
                   f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    build.load()
    built = build.build_seconds
    info("build", (f"nvcc sm_90a build of {len(build.sources())} sources in {built:.1f} s"
                   if built is not None else "kernel library already built")
         + f" ({time.perf_counter() - t0:.1f} s to load): {build.library_path().name}")

    results = check_kernels(torch, dev)
    check_edge_cases(torch, dev)
    counts_q4_0 = main_path(torch, dev, card, "q4_0")
    counts = main_path(torch, dev, card, "q4_k_m")  # this slice's path: reported below
    counts["q4_0_matmul"] = counts_q4_0["q4_0_matmul"]
    for weight_type in ("q4_0", "q4_k_m"):
        tiny_checks(torch, dev, weight_type)
    require("jax" not in sys.modules, "jax was imported")

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": counts[name], **results[name]}
        for name, (src, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    return {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


def main() -> int:
    try:
        result = run()
    except ImportError as e:
        print(f"chip_smoke: cannot import the port (run from the repository root): {e}",
              file=sys.stderr)
        return 1
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
