"""Parent against change on the card, in turns: the quantized-matmul GEMVs,
the attention kernels and the end-to-end paths they move, measured by the
same code in two trees.

    python -m gemma_tpu_torch.tools.parent_turn --parent DIR

DIR is the parent commit unpacked (`git archive`) beside this tree. The
command runs one turn in a fresh process in each tree, in the order
parent, change, change, parent, each from its tree's root with that tree
on PYTHONPATH (its own kernels, built at first use, and its own
`chip_smoke.py`). A turn prints, tagged with its tree:
* device ms, L2 cold, of each format's quantized matmul at M = 1 (the
  decode step), 2, 4 and 8 (the serving step's rows) on the main path's shapes of
  `probe_variants` (q4_0, q8_0, q4_k, q6_k); each format's outputs at M =
  1-8 on the same seeded inputs, compared across the trees at the end
  (max|diff| / max|parent|: 0 where the two compute bit for bit alike);
  device ms, warm, of
  `flash_attention` and `decode_attention` (both arms) at the attention
  shapes of `probe_variants attn`, and `paged_decode_attention` (bf16 and
  int8 pages) at its PAGED_SHAPES with the host µs of one wrapper call
  back to back (this tree's tables, handed to every turn), all through the
  public wrappers, so each tree takes its own kernels and routes;
* chip_smoke's `main_path` for Gemma-2B q4_0 and q4_k_m and Gemma-7B q8_0
  (prefill wall and device profile, decode step with its busy time and
  kernel count, host profile);
* a device profile of a 2048-token Gemma-2B q4_0 prefill (busy time by
  kernel);
* `bench_prefill` q4_0 and chip_smoke's `serving` over its four caches
  (dense and paged, bf16 and int8), then paged bf16 serving and decode
  steps under torch.profiler (`paged_serving_profile`: device busy,
  kernels and the paged kernels' ms a step).
Then DECODE_ROUNDS more rounds in the same order, each turn a fresh
process that only decodes (`decode_turn`): batch-1 tok/s of Gemma-2B q4_k_m
and q4_0, several runs without a profiler, and the host µs of one call of
the quantized-matmul wrapper. The card's `nvidia-smi` line heads each turn.

    python -m gemma_tpu_torch.tools.parent_turn --parent DIR --gemv

runs only the f32 routes' part, four turns and no decode rounds: the
quantized matmuls at M = 1, 2, 4 and 8 with bf16 and with f32 x (times L2
cold, and outputs compared across the trees, f32 too), q4_0's with f32 x at
the tile's M = 17, 64, 203 and 512 (L2 cold), `decode_attention` with f32
q, k and v at F32_DECODE_SHAPES (device ms, warm), then chip_smoke's
`f32_decode_steps` (device busy of a decode step with f32 activations at 1
and 8 rows: Gemma-2B q4_0 and q4_k_m, Gemma-7B q8_0): copy this tree's
chip_smoke.py into DIR first, as the parent's may lack that phase or a
model of it.

    python -m gemma_tpu_torch.tools.parent_turn --parent DIR --attn

runs only the decode attention cores, four turns: `decode_attention`
(bf16 and int8 caches, and f32 q over f32) at G1_DECODE_SHAPES (Gemma-7B,
G = 1) and TC_DECODE_SHAPES (Gemma-2B, the tensor-core core), and
`paged_decode_attention` (bf16 and int8 pages) at G1_PAGED_SHAPES and
TC_PAGED_SHAPES, f32 q over f32 and int8 pages and an int8 dense cache at
F32_CORE_SHAPES, device ms warm through the public wrappers, then the
device busy ms of a decode step at 1 and 8 rows of Gemma-7B q8_0 and
Gemma-2B q4_0 (`decode_step_busy`; copy this tree's chip_smoke.py into DIR
first). Runs on the card only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

D = 256


def paged_inputs(gen: torch.Generator, dev: torch.device, B: int, Hq: int, Hkv: int, D: int, ps: int,
                 limits: list[int], n_pages: int, seq_len: int, quantized: bool,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 3):
    """(q [B, 1, Hq, D], a one-layer PagedKVCache of `n_pages` pages of `ps`
    keys and seq_len // ps table entries a row, kv_limit): random pages
    (int8 with their scales if `quantized`), each row's live prefix on
    distinct physical pages shuffled by a numpy permutation from `seed`, the
    rest of each table row on the trash page 0, which holds random values
    too. q is in `dtype` (bf16 over int8 pages). It uses only what every
    tree of the port has (`PagedKVCache`, `quantize_kv`), so a turn builds
    the same inputs in a parent tree; chip_smoke.py and probe_variants
    build theirs here too."""
    import numpy as np

    from gemma_tpu_torch.runtime import PagedKVCache
    from gemma_tpu_torch.runtime.kv_cache import quantize_kv

    maxp = seq_len // ps
    perm = np.random.default_rng(seed).permutation(n_pages - 1) + 1
    pt = np.zeros((B, maxp), np.int32)
    live = [-(-lim // ps) for lim in limits]
    pt[np.arange(maxp)[None, :] < np.asarray(live)[:, None]] = perm[: sum(live)]
    kp = (torch.randn(n_pages, Hkv, ps, D, generator=gen, device=dev) * 0.3).to(dtype)
    vp = (torch.randn(n_pages, Hkv, ps, D, generator=gen, device=dev) * 0.3).to(dtype)
    ks = vs = None
    if quantized:
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
    lim = torch.tensor(limits, dtype=torch.int32, device=dev)
    cache = PagedKVCache([kp], [vp], torch.from_numpy(pt).to(dev), lim.clone(),
                         None if ks is None else [ks], None if vs is None else [vs])
    q = (torch.randn(B, 1, Hq, D, generator=gen, device=dev) * 0.3).to(
        torch.bfloat16 if quantized else dtype)
    return q, cache, lim


def kernel_times(dev: torch.device, flash_shapes, decode_shapes, paged_shapes) -> dict[str, float]:
    """Device ms of the public attention wrappers at probe_variants'
    FLASH_SHAPES, DECODE_SHAPES and PAGED_SHAPES (decode and paged: both
    arms), and of paged attention also the host µs of one call, back to
    back (HOST_CALLS calls; the device's part is shorter)."""
    import gemma_tpu_torch.ops.attention as att
    import gemma_tpu_torch.ops.paged_attention as pat
    from gemma_tpu_torch.runtime.kv_cache import quantize_kv
    from gemma_tpu_torch.tools import _timing as T

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rnd(*shape):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.3).to(torch.bfloat16)

    def ms(fn):
        return T.time_us(lambda: fn(), [()], dev) / 1e3

    res = {}
    for name, T_, p0, S, limit, hq, hkv in flash_shapes:
        q, k, v = rnd(1, T_, hq, D), rnd(1, hkv, S, D), rnd(1, hkv, S, D)
        pos = torch.arange(p0, p0 + T_, dtype=torch.int32, device=dev)[None]
        lim = torch.tensor([limit], dtype=torch.int32, device=dev)
        res[f"flash {name}"] = ms(lambda: att.flash_attention(q, k, v, pos, lim))
    for name, S, limits, hq, hkv in decode_shapes:
        B = len(limits)
        q, k, v = rnd(B, 1, hq, D), rnd(B, hkv, S, D), rnd(B, hkv, S, D)
        lim = torch.tensor(limits, dtype=torch.int32, device=dev)
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        at = f"{name} S={S} Hq={hq} Hkv={hkv} limits={limits}"
        res[f"decode {at}"] = ms(lambda: att.decode_attention(q, k, v, lim))
        res[f"decode int8 {at}"] = ms(lambda: att.decode_attention(q, k8, v8, lim, k_scale=ks,
                                                                    v_scale=vs))
    for name, S, limits, ps, hq, hkv, pool in paged_shapes:
        for quantized in (False, True):
            q, cache, lim = paged_inputs(gen, dev, len(limits), hq, hkv, D, ps, limits, pool, S,
                                         quantized)
            at = (f"paged{' int8' if quantized else ''} {name} S={S} ps={ps} pool={pool} Hq={hq} "
                  f"Hkv={hkv} limits={limits}")
            res[at] = ms(lambda: pat.paged_decode_attention(q, cache, 0, lim))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                pat.paged_decode_attention(q, cache, 0, lim)
            torch.cuda.synchronize()
            res[f"host us a call, {at}"] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
            del q, cache
    return res


# f32-q decode attention of --gemv (name, S, kv_limits, Hq, Hkv): Gemma-2B's
# heads at a prompt's first decode step, over a full 4096-slot cache and
# over 8 serving rows; Gemma-7B's at the first step
F32_DECODE_SHAPES = (("Gemma-2B", 512, [204], 8, 1), ("Gemma-2B", 4096, [4096], 8, 1),
                     ("Gemma-2B serving", 512, [1, 64, 65, 203, 300, 512, 203, 64], 8, 1),
                     ("Gemma-7B", 512, [204], 16, 16))


def f32_decode_times(dev: torch.device, shapes=F32_DECODE_SHAPES) -> dict[str, float]:
    """Device ms, warm, of `decode_attention` with f32 q, k and v at
    `shapes` (name, S, kv_limits, Hq, Hkv), through the public wrapper (each
    tree's route)."""
    import gemma_tpu_torch.ops.attention as att
    from gemma_tpu_torch.tools import _timing as T

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    res = {}
    for name, S, limits, hq, hkv in shapes:
        B = len(limits)
        q, k, v = (torch.randn(*shape, generator=gen, device=dev) * 0.3
                   for shape in ((B, 1, hq, D), (B, hkv, S, D), (B, hkv, S, D)))
        lim = torch.tensor(limits, dtype=torch.int32, device=dev)
        res[f"f32 decode {name} S={S} Hq={hq} Hkv={hkv} limits={limits}"] = T.time_us(
            lambda: att.decode_attention(q, k, v, lim), [()], dev) / 1e3
    return res


SERVE_LIMITS = [1, 64, 65, 203, 300, 512, 203, 64]  # chip_smoke.py's serving rows
# --attn: Gemma-7B's heads (16 over 16 KV heads, G = 1) at its first decode
# step's limit, the serving rows and a 4096-slot cache (decode), and the
# serving rows through 64-key pages (paged: a 65-page pool)
G1_DECODE_SHAPES = (("Gemma-7B", 512, [204], 16, 16), ("Gemma-7B serving", 512, SERVE_LIMITS, 16, 16),
                    ("Gemma-7B", 4096, [2048], 16, 16), ("Gemma-7B", 4096, [4096], 16, 16))
G1_PAGED_SHAPES = (("Gemma-7B serving", 512, SERVE_LIMITS, 64, 16, 16, 65),)
# --attn: Gemma-2B's heads (8 over 1 KV head) on the tensor-core decode core,
# whose last block merges the splits through the same code as the G = 1
# core's: its first decode step, the serving rows, a full 4096-slot cache,
# and the serving rows through 64-key pages
TC_DECODE_SHAPES = (("Gemma-2B", 512, [204], 8, 1), ("Gemma-2B serving", 512, SERVE_LIMITS, 8, 1),
                    ("Gemma-2B", 4096, [4096], 8, 1))
TC_PAGED_SHAPES = (("Gemma-2B serving", 512, SERVE_LIMITS, 64, 8, 1, 65),)
# --attn: f32 queries at Gemma-2B's heads over SERVE_LIMITS through 64-key
# pages of f32 and of int8 (a 65-page pool), and over an int8 dense cache
# at limit 204 (chip_smoke.py phase 8's shapes): (name, paged, int8)
F32_CORE_SHAPES = (("paged f32 pages", True, False), ("paged int8 pages", True, True),
                   ("dense int8 cache", False, True))
STEP_ROWS = (1, 8)  # rows of the --attn decode steps
STEP_MODELS = (("Gemma-7B", "q8_0"), ("Gemma-2B", "q4_0"))  # the --attn decode steps' models
STEP_PROFILED = 16  # decode steps under the profiler
STEP_TRIES = 4  # profiles of a decode step until one records every quantized-matmul launch


def f32_core_times(dev: torch.device) -> dict[str, float]:
    """Device ms, warm, of f32-q decode attention at F32_CORE_SHAPES through
    the public wrappers (each tree's route: the decode core's f32 policies,
    or a parent's split-S kernel and its combine)."""
    import gemma_tpu_torch.ops.attention as att
    import gemma_tpu_torch.ops.paged_attention as pat
    from gemma_tpu_torch.runtime.kv_cache import quantize_kv
    from gemma_tpu_torch.tools import _timing as T

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    res = {}
    for name, paged, int8 in F32_CORE_SHAPES:
        limits = SERVE_LIMITS if paged else [204]
        q = torch.randn(len(limits), 1, 8, D, generator=gen, device=dev) * 0.3
        lim = torch.tensor(limits, dtype=torch.int32, device=dev)
        if paged:
            _, cache, lim = paged_inputs(gen, dev, len(limits), 8, 1, D, 64, limits, 65, 512, int8,
                                         torch.float32)
            fn = lambda: pat.paged_decode_attention(q, cache, 0, lim)  # noqa: E731
        else:
            (k8, ks), (v8, vs) = (quantize_kv(torch.randn(1, 1, 512, D, generator=gen, device=dev) * 0.3)
                                  for _ in range(2))
            fn = lambda: att.decode_attention(q, k8, v8, lim, k_scale=ks, v_scale=vs)  # noqa: E731
        res[f"f32 q {name} Hq=8 Hkv=1 limits={limits}"] = T.time_us(fn, [()], dev) / 1e3
    return res


def decode_step_busy(dev: torch.device, c, rows: int, model_name: str = "Gemma-7B",
                     fmt: str = "q8_0") -> str:
    """A decode step of `model_name` `fmt` (weights from seed 0) at `rows`
    rows over a dense bf16 cache, after a prefill of chip_smoke's (`c`)
    prompt (one row) or its first `rows` serving prompts: chip_smoke's
    `decode_profile` over STEP_PROFILED greedy steps (device busy ms a step,
    the largest kernels, the kernels a step; a parent's split-S combines
    allowed). The profiler may drop kernel records: up to STEP_TRIES
    profiles, the first that records every quantized-matmul launch kept,
    or the last, marked as short."""
    import re

    from gemma_tpu_torch.runtime import Engine, EngineConfig
    from gemma_tpu_torch.testing import make_params

    cfg = c.model_config(model_name)
    model = make_params(cfg, fmt, seed=0, device=dev)
    eng = Engine(cfg, model, EngineConfig(max_seq_len=c.MAX_SEQ_LEN, max_batch=rows))
    prompts = ([[2 + (i * 7919) % (cfg.vocab_size - 2) for i in range(c.PROMPT_LEN)]] if rows == 1
               else [r.prompt for r in c.serve_requests(cfg)[:rows]])
    logits, cache = eng.prefill(prompts)
    tok = logits.argmax(-1)
    for _ in range(2):  # warm-up
        logits, cache = eng.decode_step(tok, cache)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    for tries in range(1, STEP_TRIES + 1):
        busy, top = c.decode_profile(torch, eng, cache, tok, steps=STEP_PROFILED, no_combine=False)
        recorded, launched = map(int, re.search(r"(\d+) of (\d+) quantized-matmul", top).groups())
        if recorded == launched:
            break
        for _ in range(STEP_PROFILED):  # the profiled steps, to carry the cache on
            logits, cache = eng.decode_step(tok, cache)
            tok = logits.argmax(-1)
    del eng, model, cache
    torch.cuda.empty_cache()
    kept = (f"profile {tries} of {STEP_TRIES} recorded every launch" if recorded == launched else
            f"SHORT: no profile of {STEP_TRIES} recorded every launch, the last kept")
    return f"{model_name} {fmt} decode step, {rows} rows ({kept}): device busy {busy:.4f} ms a step; {top}"


def attn_turn(tag: str) -> None:
    """One --attn turn, in the tree of the current directory."""
    if not torch.cuda.is_available():
        raise SystemExit("parent_turn: no CUDA device (it times the kernels on the card)")
    sys.path.insert(0, os.getcwd())  # this tree's chip_smoke.py
    import chip_smoke as c
    from gemma_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.load()
    print(tag, c.device_line(), f"build+load {time.perf_counter() - t0:.1f} s", flush=True)
    times = kernel_times(dev, (), G1_DECODE_SHAPES + TC_DECODE_SHAPES, G1_PAGED_SHAPES + TC_PAGED_SHAPES)
    times.update(f32_decode_times(dev, G1_DECODE_SHAPES + TC_DECODE_SHAPES))
    times.update(f32_core_times(dev))
    print(tag, "Gemma-7B (G = 1) and Gemma-2B (tensor cores) attention device ms, warm:", json.dumps(times),
          flush=True)
    for model_name, fmt in STEP_MODELS:
        for rows in STEP_ROWS:
            print(tag, decode_step_busy(dev, c, rows, model_name, fmt), flush=True)
    print(tag, "turn done", f"{time.perf_counter() - t0:.1f} s", flush=True)


PAGED_KERNELS = ("paged_split_kernel", "attend_combine_kernel", "decode_tc_kernel", "decode_g1_kernel")
PAGED_STEPS = 16  # decode steps of the decode-only profile


def _device_reading(prof, steps: int) -> str:
    """Device busy ms, device kernels and the paged attention kernels' ms
    (PAGED_KERNELS: the split-S kernel and its combine, or the tensor-core
    kernel) of a profile, in all and a step. It reads the profile itself,
    not through `_timing.profile_busy`: a turn imports its own tree's
    `_timing`, and a parent's may predate that function."""
    events = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    paged = sum(e.self_device_time_total for e in events
                if any(n in e.key for n in PAGED_KERNELS)) / 1e3
    kernels = sum(e.count for e in events)
    return (f"device busy {busy:.3f} ms ({busy / steps:.4f} a step), device kernels {kernels} "
            f"({kernels / steps:.2f} a step), paged attention kernels {paged:.3f} ms "
            f"({paged / steps:.4f} a step)")


def paged_serving_profile(dev: torch.device, c) -> str:
    """Paged bf16 attention at full Gemma-2B q4_0 width under torch.profiler
    (device activity), with chip_smoke's (`c`) serving settings: the first
    wave of serving (SERVE_SLOTS requests; a step's share includes the
    admission prefills), then PAGED_STEPS greedy decode steps alone over
    those SERVE_SLOTS prompts prefilled (`Engine.prefill`, identity pages).
    Each: `_device_reading`."""
    from torch.profiler import ProfilerActivity, profile

    from gemma_tpu_torch.models import GEMMA_2B
    from gemma_tpu_torch.runtime import Engine, EngineConfig, Request, serve
    from gemma_tpu_torch.testing import make_params

    model = make_params(GEMMA_2B, "q4_0", seed=0, device=dev)
    eng = Engine(GEMMA_2B, model, EngineConfig(max_seq_len=c.MAX_SEQ_LEN, max_batch=c.SERVE_SLOTS,
                                               paged=True, page_size=c.PAGE))
    reqs = c.serve_requests(GEMMA_2B)[:c.SERVE_SLOTS]
    serve(eng, [Request(r.id, r.prompt, 8) for r in reqs[:4]], block=c.SERVE_BLOCK)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sched = serve(eng, reqs, block=c.SERVE_BLOCK)
        torch.cuda.synchronize()
    steps = sched.stats()["decode_steps"]
    served = _device_reading(prof, steps)
    logits, cache = eng.prefill([r.prompt for r in reqs])
    tok = logits.argmax(-1)
    for _ in range(2):  # warm-up
        logits, cache = eng.decode_step(tok, cache)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PAGED_STEPS):
            logits, cache = eng.decode_step(tok, cache)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
    stepped = _device_reading(prof, PAGED_STEPS)
    del eng, model, cache
    torch.cuda.empty_cache()
    return (f"paged bf16 serving, first wave of {len(reqs)} requests, {steps} decode steps: "
            f"{served}; {PAGED_STEPS} decode steps alone over {len(reqs)} rows: {stepped}")


MATMUL_MS = (1, 2, 4, 8)  # the decode step's rows and the serving step's
TILE_F32_MS = (17, 64, 203, 512)  # prefill rows and the perplexity window: f32 x on the tile


def matmul_times(dev: torch.device, shapes: dict, dtype: torch.dtype = torch.bfloat16,
                 ms=MATMUL_MS) -> dict[str, float]:
    """Device ms, L2 cold, of the public quantized matmuls at `shapes`
    (probe_variants' SHAPES: format -> (name, N, K)) and each M of `ms`, x
    in `dtype`."""
    import gemma_tpu_torch.ops.quant_matmul as qmm
    from gemma_tpu_torch.tools import _timing as T

    gen = T.generator(dev)
    res = {}
    for fmt, rows in shapes.items():
        for name, N, K in rows:
            qt = T.random_qtensor(fmt, N, K, gen, dev)
            for M in ms:
                x = T.bf16_x(M, K, gen, dev).to(dtype)
                args = T.replicate((x, qt), T.copies_for(T.nbytes(x, qt), dev))
                res[f"{fmt} {name} M={M} N={N} K={K}"] = T.time_us(qmm.MATMULS[fmt], args, dev) / 1e3
                del args
            del qt
    return res


# (format, N, K) of the outputs compared across the trees: ragged N and K
# (odd counts of scales), and Gemma-2B's down
OUTPUT_SHAPES = (("q4_0", 1000, 1056), ("q4_0", 2048, 16384), ("q8_0", 999, 1056),
                 ("q8_0", 3072, 4096), ("q4_k", 999, 1280), ("q4_k", 2048, 16384),
                 ("q6_k", 999, 1280), ("q6_k", 2048, 16384))


def matmul_outputs(dev: torch.device, f32: bool = False) -> dict[str, torch.Tensor]:
    """Each format's quantized matmul at OUTPUT_SHAPES and M = 1-8, bf16 x
    (and with `f32`, the same x in f32), on inputs from a fixed seed (so
    the same in every tree): y on the CPU."""
    import gemma_tpu_torch.ops.quant_matmul as qmm
    from gemma_tpu_torch.tools import _timing as T

    gen = T.generator(dev, seed=5)
    out = {}
    for fmt, N, K in OUTPUT_SHAPES:
        qt = T.random_qtensor(fmt, N, K, gen, dev)
        for M in range(1, 9):
            x = T.bf16_x(M, K, gen, dev)
            out[f"{fmt} N={N} K={K} M={M}"] = qmm.MATMULS[fmt](x, qt).cpu()
            if f32:
                out[f"f32 {fmt} N={N} K={K} M={M}"] = qmm.MATMULS[fmt](x.float(), qt).cpu()
    return out


def turn(tag: str, shapes: dict, outputs: str | None = None, gemv: bool = False) -> None:
    """One turn, in the tree of the current directory (`gemv`: the GEMVs'
    part only)."""
    if not torch.cuda.is_available():
        raise SystemExit("parent_turn: no CUDA device (it times the kernels on the card)")
    sys.path.insert(0, os.getcwd())  # this tree's chip_smoke.py
    import chip_smoke as c
    from gemma_tpu_torch.kernels import build
    from gemma_tpu_torch.models import GEMMA_2B
    from gemma_tpu_torch.runtime import Engine, EngineConfig
    from gemma_tpu_torch.testing import make_params
    from gemma_tpu_torch.tools import bench_prefill

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.load()
    card = c.device_line()
    print(tag, card, f"build+load {time.perf_counter() - t0:.1f} s", flush=True)
    print(tag, "quantized matmuls device ms, L2 cold:",
          json.dumps(matmul_times(dev, shapes["matmul"])), flush=True)
    if gemv:
        print(tag, "quantized matmuls with f32 x device ms, L2 cold:",
              json.dumps(matmul_times(dev, shapes["matmul"], torch.float32)), flush=True)
        print(tag, "q4_0 with f32 x at M > 8 device ms, L2 cold:",
              json.dumps(matmul_times(dev, {"q4_0": shapes["matmul"]["q4_0"]}, torch.float32,
                                      TILE_F32_MS)), flush=True)
    if outputs:
        torch.save(matmul_outputs(dev, f32=gemv), outputs)
    if gemv:
        print(tag, "f32 decode attention device ms, warm:", json.dumps(f32_decode_times(dev)), flush=True)
        busy, _ = c.f32_decode_steps(torch, dev, card, check=False)  # a parent has no f32 GEMV counter
        print(tag, "f32 decode step busy ms:", json.dumps(busy), flush=True)
        print(tag, "turn done", f"{time.perf_counter() - t0:.1f} s", flush=True)
        return
    times = kernel_times(dev, shapes["flash"], shapes["decode"], shapes["paged"])
    print(tag, "kernels device ms, warm:", json.dumps(times), flush=True)
    c.main_path(torch, dev, card, "Gemma-2B", "q4_0")
    c.main_path(torch, dev, card, "Gemma-2B", "q4_k_m")
    c.main_path(torch, dev, card, "Gemma-7B", "q8_0")
    model = make_params(GEMMA_2B, "q4_0", seed=0, device=dev)
    eng = Engine(GEMMA_2B, model, EngineConfig(max_seq_len=4096, max_batch=1))
    med, prof = c.prefill_profile(torch, eng, [2 + i % 1000 for i in range(2048)], runs=3)
    print(tag, f"prefill T=2048 Gemma-2B q4_0: {med:.3f} ms wall (median of 3); {prof}", flush=True)
    del eng, model
    torch.cuda.empty_cache()
    print(tag, "bench_prefill", bench_prefill.run(dev, ("q4_0",)), flush=True)
    c.serving(torch, dev, card, "Gemma-2B", "q4_0", runs=c.SERVE_RUNS)
    print(tag, paged_serving_profile(dev, c), flush=True)
    print(tag, "turn done", f"{time.perf_counter() - t0:.1f} s", flush=True)


DECODE_ROUNDS = 3  # rounds of decode turns: 12 processes, 30 decodes a tree and format
DECODE_RUNS = 5  # decodes of NEW_TOKENS a format in a decode turn
HOST_CALLS = 400  # wrapper calls a host reading: device time < host time, queue not full


def decode_turn(tag: str) -> None:
    """One decode turn, in the tree of the current directory: Gemma-2B
    q4_k_m and q4_0, DECODE_RUNS batch-1 greedy decodes of chip_smoke's
    prompt and NEW_TOKENS each (wall tok/s, no profiler), and the host µs
    of one bf16 M = 1 call of the quantized-matmul wrapper at attn_k (q4_k,
    N = 256: K split) and qkv (q4_0), back to back (the device's part is
    shorter, so the wall is the host's)."""
    if not torch.cuda.is_available():
        raise SystemExit("parent_turn: no CUDA device (it times the kernels on the card)")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as c
    import gemma_tpu_torch.ops.quant_matmul as qmm
    from gemma_tpu_torch.models import GEMMA_2B
    from gemma_tpu_torch.runtime import Engine, EngineConfig
    from gemma_tpu_torch.testing import make_params
    from gemma_tpu_torch.tools import _timing as T

    dev = torch.device("cuda", 0)
    gen = T.generator(dev)
    host = {}
    for fmt, N, K in (("q4_k", 256, 2048), ("q4_0", 2560, 2048)):
        qt, x = T.random_qtensor(fmt, N, K, gen, dev), T.bf16_x(1, K, gen, dev)
        for _ in range(2):  # the first pass builds, loads and warms
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                qmm.MATMULS[fmt](x, qt)
            torch.cuda.synchronize()
        host[f"{fmt} N={N} K={K}"] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    print(tag, c.device_line(), "host us a quantized-matmul call, M = 1:", json.dumps(host), flush=True)
    prompt = [2 + (i * 7919) % (GEMMA_2B.vocab_size - 2) for i in range(c.PROMPT_LEN)]
    for fmt in ("q4_k_m", "q4_0"):
        model = make_params(GEMMA_2B, fmt, seed=0, device=dev)
        eng = Engine(GEMMA_2B, model, EngineConfig(max_seq_len=c.MAX_SEQ_LEN, max_batch=1))
        eng.generate([prompt[:16]], 4)  # warm-up
        rates = []
        for _ in range(DECODE_RUNS):
            logits, cache = eng.prefill([prompt])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.generate_from(logits, cache, c.NEW_TOKENS)
            torch.cuda.synchronize()
            rates.append(c.NEW_TOKENS / (time.perf_counter() - t0))
        print(tag, f"decode Gemma-2B {fmt} tok/s, {DECODE_RUNS} runs of {c.NEW_TOKENS} tokens:",
              json.dumps([round(r, 2) for r in rates]), flush=True)
        del eng, model, cache, logits
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the parent commit's tree: run the four turns")
    ap.add_argument("--turn", help="run one turn in the current directory's tree, with this tag")
    ap.add_argument("--shapes", help="(with --turn) the attention shapes, as JSON")
    ap.add_argument("--outputs", help="(with --turn) save the matmul outputs to this file")
    ap.add_argument("--decode", action="store_true", help="(with --turn) a decode turn")
    ap.add_argument("--gemv", action="store_true", help="the GEMVs' part only, bf16 and f32 x")
    ap.add_argument("--attn", action="store_true", help="the decode attention cores and decode steps only")
    args = ap.parse_args(argv)
    if args.turn:
        if args.decode:
            decode_turn(args.turn)
        elif args.attn:
            attn_turn(args.turn)
        else:
            turn(args.turn, json.loads(args.shapes), args.outputs, args.gemv)
        return 0
    if not args.parent:
        ap.error("give --parent DIR (or --turn TAG --shapes JSON)")
    from .probe_variants import DECODE_SHAPES, FLASH_SHAPES, PAGED_SHAPES, SHAPES

    shapes = json.dumps({"matmul": SHAPES, "flash": FLASH_SHAPES, "decode": DECODE_SHAPES,
                         "paged": PAGED_SHAPES})
    change = Path(__file__).resolve().parents[2]
    order = ("parent", "change", "change", "parent")
    with tempfile.TemporaryDirectory() as tmp:
        saved = {tag: Path(tmp) / f"{tag}.pt" for tag in ("parent", "change")}
        for i, tag in enumerate(order * (1 if args.gemv or args.attn else 1 + DECODE_ROUNDS)):
            tree = Path(args.parent).resolve() if tag == "parent" else change
            env = {**os.environ, "PYTHONPATH": str(tree)}
            if args.attn:
                proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--turn", tag,
                                       "--attn"], cwd=tree, env=env, timeout=900)
                if proc.returncode != 0:
                    return proc.returncode
                continue
            if i >= len(order):
                extra = ["--decode"]
            else:
                extra = (["--shapes", shapes] + ([] if saved[tag].exists() else ["--outputs", str(saved[tag])])
                         + (["--gemv"] if args.gemv else []))
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--turn", tag, *extra],
                                  cwd=tree, env=env, timeout=900)
            if proc.returncode != 0:
                return proc.returncode
            if i == len(order) - 1:
                ref, got = (torch.load(saved[tag]) for tag in ("parent", "change"))
                diffs = {k: ((got[k] - ref[k]).abs().max() / ref[k].abs().max()).item() for k in ref}
                print("matmul outputs, max|change - parent| / max|parent|:", json.dumps(diffs),
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
