#!/usr/bin/env python3
"""Smoke run of gemma_tpu_torch (the PyTorch/CUDA port) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing `[phase]` info lines; any failure exits non-zero:
1. the card: `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`;
2. the build of the CUDA kernels (gemma_tpu_torch/csrc, nvcc for sm_90a);
3. each kernel against its plain PyTorch version on the card, at the
   Gemma-2B shapes of the q4_0 and q4_k_m paths (every format's prefill
   tile at M = 17, 64 and 203, its GEMV at M = 1 and the serving step's
   M = 8), the Gemma-7B
   shapes of the q8_0 path (its tiles and serving GEMV likewise; attention
   at 16 heads on the core for one query row, csrc/decode_g1.cuh, in every
   (q, cache) arm at batch 1, 8 rows and S = 4096, and through 64-key
   pages, equal bit for bit to the dense core), and the shapes of
   8-slot serving (the paged kernel and both int8 arms), and attention
   over long caches (S = 4096: flash at 2048 tokens from position 0 and at
   the last 512-token chunk, decode and paged decode at limits 2048 and
   4096, both arms; paged decode equal bit for bit to decode on the
   gathered rows), and flash at the speculative verify's shapes (T = 8
   and T = 2 query rows from each sequence's length, batch 1 and the 8
   serving rows; q4_0 also at the verify's M = 2 and 16), and every
   format's f32 route at M > 8, the TF32 tile (csrc/dq_tile_tf32.cuh), at
   every Gemma-2B q4_0 row, every Gemma-7B q8_0 row and every q4_k_m row
   at M = 17, 64, 203 and 512 and at ragged N and K (q4_0 and q8_0 at K %
   64 == 32 too), within 1e-5 of the output's scale, with the route
   each took (bf16: the tensor-core kernels), max|diff|
   against the stated tolerance, the device
   times of kernel, plain version and a PyTorch library call where one
   computes the same function (CUDA events), and the least time the
   card could take (bound); then correctness-only edge cases; then the
   same at Gemma-2-2B's q4_k_m and Gemma-3-4B's q4_0 shapes (every matmul
   row at M = 1, 8 and a 512-row chunk; decode, paged decode and flash at
   their heads, G = 2 and D = 256, with softcap and window);
4. the main path at full width with random weights from a seed: Gemma-2B
   q4_0 (4), Gemma-2B q4_k_m (4b) and Gemma-7B q8_0 (4c): `Engine.prefill`
   of a 203-token prompt then `Engine.generate_from` for 32 greedy tokens
   (what `Engine.generate` and the CLI run), with finite logits, tokens in
   range, and the kernels' launch counters, set to 0 just before each run,
   equal to what the layer structure implies (the tensor-core attention
   kernels' share too); then `Engine.generate` must
   give the same tokens; the prefill's median wall time over 5 more runs
   and a device profile of one; then, on the same engine, speculative
   decoding (`SpecDecoder`, k = 7, blocks of 4) of 96 tokens from a
   repetitive 203-token prompt with exact launch counts, its verify logits
   held to plain decode steps (2e-2 of their scale; delta = twice the
   largest difference) and its stream teacher-forced through plain decode
   (each token the plain argmax or within delta of the plain maximum),
   tokens a verify forward, wall tok/s against plain, device busy a verify
   forward against a plain step, and one block issued under
   `set_sync_debug_mode("error")`; 4d: Gemma-2-2B q4_k_m and Gemma-3-4B
   q4_0 at full width (sandwich norms, softcaps, QK-norm, split rope
   bases, sliding windows), prompts of 4200 and 1200 tokens prefilled in
   512-token chunks past their windows, then 32 greedy tokens, with exact
   launch counts, weight GB, prefill ms, decode tok/s and the step's busy
   and idle share; the kernels against the plain versions on the card
   (bf16 within 2e-2 of the logits' scale, f32 greedy streams equal) and
   the window shown to bind, at the logits and kernel by kernel at layer 0;
5. `python -m gemma_tpu_torch generate --device cuda` in subprocesses, all
   started at once, on tiny q4_0, q4_k_m and q8_0 GGUFs (TINY_RUNS: Gemma-1
   geometry, and Gemma-2 and Gemma-3 at the kernels' widths in every
   format), its printed text equal to the in-process run's (exact launch
   counts), and each tiny model on the card held against the same model
   on the CPU (plain path); the Gemma-2 and Gemma-3 models also served
   dense and paged, streams equal, and paged f32 card against CPU; then `python -m gemma_tpu_torch serve
   --device cuda --paged --kv-quant` against the in-process `serve`, and
   serving on the card against the CPU in f32 over paged f32, paged int8
   and dense int8 caches, every decode call on the decode core's f32
   policies (their launches are the kernels' line's for
   `paged_attention_tf32`, `paged_attention_tf32_int8` and
   `decode_attention_tf32_int8`); `generate --speculative` and `serve
   --speculative` likewise,
   and the tiny f32 model's speculative streams card vs CPU;
6. continuous-batching serving (8 slots, 24 requests of 96 tokens) at full
   width over each model's first layers (CUT_LAYERS: Gemma-2B 6 of 18,
   Gemma-7B 7 of 28, Gemma-2-2B and Gemma-3-4B 6), Gemma-2B q4_0 over four caches: dense, dense int8, paged, and
   paged int8 with overlapped chunked admission (6), and at full Gemma-7B
   q8_0 width over the dense bf16 cache (6b), once more with the requests
   shuffled and admitted every 4 steps, which must give the same streams,
   and over a paged bf16 cache of 64-token pages; 6c: Gemma-2-2B q4_k_m
   and Gemma-3-4B q4_0 (16 requests of 48 tokens, Gemma-3-4B's cache 2048
   slots with two 1100-token prompts past its window) over dense and paged
   bf16; every paged run's streams equal to its dense run's; all with exact
   launch counts (every paged decode call on the tensor cores, at G = 1
   on its core); then speculative serving of the same requests (Gemma-2B,
   dense bf16 and int8, adaptive k; k = 7 in admission order and shuffled,
   which must give the same streams), each stream teacher-forced through
   plain decode against the delta of the same calibration as phase 4's
   on this model, and a batched block under
   `set_sync_debug_mode("error")`; then non-greedy serving (Gemma-2B,
   temperature 1.0, top-k 64, top-p 0.95, four requests of one prompt)
   twice from one seed, the same streams both times, exact launch counts,
   and the sampler's frequencies on the card against the filtered softmax;
7. the decode-GEMV instruments, the kernels that replace the Pallas
   kernels of the reference's tools/ (bench_qmm_variants, bench_bn_sweep,
   probe_int4, bench_q4k_variants, bench_q6k_variants): every mode against
   its plain version at the tools' Gemma-2B shapes with exact launch
   counts, each kernel's L2-cold time, bound, plain and library time, then
   `python -m gemma_tpu_torch.tools.bench_qmm_variants` in a subprocess,
   as a user runs it, and the other four through their `main` here;
8. the quality gates: the TF32 flash kernel at the perplexity window's
   M = T = 512 against its plain version, timed with bound and library
   call (the matmuls' f32 route there, the TF32 tile, is phase 3's), also
   at ragged T, a window, a softcap, kv_limit < T (rows without keys) and
   D = 128; the f32-q decode attention at limit 204 and S = 4096, timed
   (Gemma-2B's heads on the tensor-core decode core in 3xTF32, also at
   limit 1, limit 0, softcap, window, G = 2 and 4, D = 128; Gemma-7B's
   on the G = 1 core); f32 q on the same core over 64-key pages of f32
   and of int8 (8 serving rows) and over an int8 dense cache (limit 204),
   one launch a call, against the plain versions, through pages bit for
   bit the dense core on the gathered rows, timed with bound and in turns
   against the split-S kernel and its combine (which must be slower), and
   at the same edges; every format's f32 GEMV at M = 1 and 8 on its
   recipe's rows (the tensor-core GEMV with x in three bf16 parts), timed
   with bound and library call; the f32 decode step of Gemma-2B q4_0 and q4_k_m and
   Gemma-7B q8_0 at 1 and 8 rows against the plain versions;
   `perplexity.evaluate` at full width (Gemma-2B q4_0 and q4_k_m, Gemma-7B
   q8_0) over two 512-token windows of seeded token ids, each window's
   launch counts exact (its flash launches and every matmul on the TF32
   kernels) and its wall time printed, its NLL within 1e-4 of the same
   through the plain versions on the card;
   `verify_device_kernels` at full Gemma-2B q4_0 and Gemma-7B q8_0 width
   over the dense bf16, dense int8 and paged (64-token pages) caches: ok,
   the kernel side's launches exact, the plain side's zero; then the CLI's
   `perplexity` (card against CPU), `bench`, `generate --verify --profile`,
   `generate --mode dequant` and `quantize` in subprocesses on phase 5's
   tiny files;
9. serving across two processes on the card (`serve(roles=...,
   transport=...)`): this script re-invoked with `--prefill-host` is rank 1
   of a gloo group and serves the admission prefills of Gemma-2B q4_0
   (6 of its 18 layers, weights of seed 0) at an AF_UNIX path; the parent, rank 0, decodes 16
   of phase 6's requests (64 tokens each) over a dense bf16 cache, then a
   paged int8 cache of 16-key pages behind an int8 host that prefills in
   64-token chunks. Each arm's streams equal the same `serve` with an
   in-process prefill engine; the decode process's launches are exact (no
   tile, no flash); the host prints `SERVED <n>` for every admission and
   its own exact launches; one remote tuple equals the parent's own
   `prefill_standalone` bit for bit; TTFT and wall tok/s disaggregated
   against in-process; a hand-off's bytes and its serialize, wire and
   deserialize-to-card ms at Gemma-2B and (random tensors, no model)
   Gemma-7B width, bit for bit; then `python -m
   gemma_tpu_torch.runtime.kv_transfer --device cuda` on phase 5's tiny
   q4_0 file, driven by a `RemotePrefillClient` on the card;
10. tensor parallelism (`parallel/shard_decode.py` `TPEngine`): every
   kernel at a shard's shapes against its plain version, timed with bound
   and library call (q4_0 at Gemma-2B's and q8_0 at Gemma-7B's tp = 2 and
   4 shards, q4_k and q6_k at TINY_MHA_CONFIG's tp = 2, decode and flash
   at each shard's heads, paged at Gemma-2B's); 10a and 10b at full width
   over 7 of Gemma-7B's 28 and 6 of Gemma-2B's 18 layers; 10a: Gemma-7B q8_0
   through a TPEngine at world size 1 over NCCL, prompt 203 + 32
   greedy tokens, bit for bit the Engine; 10b: tp = 2 and 4 as ranks
   sharing the card over gloo with CUDA tensors (this script re-invoked
   with `--tp-rank`, each rank drawing only its shard on the card):
   Gemma-7B q8_0 and Gemma-2B q4_0 in bf16 (first-step logits within 2e-2
   of their scale of the single-device Engine's; Gemma-2B also over paged
   int8) and f32 (16-token greedy streams equal), at tp = 2 also 8 requests through
   `serve()` on a paged int8 TPEngine in f32 and TINY_MHA_CONFIG q4_k_m,
   with exact launches, the collectives a decode step by axis and the wall
   ms a step; 10c: NCCL, one rank a card, where there are 2 or more cards
   (on one card a line says it did not run);
11. the serving and step benches (gemma_tpu_torch/tools/) at full Gemma-2B
   width with short arguments: `python -m gemma_tpu_torch.tools.bench_serving`
   (8 requests of 16 tokens, centred q4_0 weights, whose streams must
   differ from request to request) in a subprocess, then through their `main` here bench_serving
   with `--admit-per-tick 1` (at least the uncapped run's decode steps,
   the same streams) and over a paged int8 cache, bench_itl (a 1024-token
   prompt), bench_longctx (q4_k_m, 1024 slots, a 512-token prefill, four
   arms), bench_step_parts, bench_micro and bench_scan: each last line
   with its keys and finite rates, each run's launches above 0 with no
   plain version, and between them #1, #3, #4, #6 (bf16 and int8), #7 and
   #8. The phase's launches are printed on a line of their own (`[bench]
   launches`) and are not added to the paths' counts in the kernels'
   line: the benches time the wrappers in loops;
12. the reference's last five tools (gemma_tpu_torch/tools/) through their
   `main`: `bench_decode_attn` at S = 8192 (four arms at five splits and
   the split-S kernel), `bench_flash` at T = S = 2048, `bench_fmt_kernels
   2b`, `bench_shapes` and `probe_cache_cost` (Gemma-7B, 2048 and 4096
   slots), each line checked (REF_TOOLS), every kernel held to its plain
   version inside the tool.

Quantized-matmul times are taken with L2 cold (operands rotated over
copies totalling >= 100 MB), as a decode step meets its weights.

The last two lines of standard output are a JSON line of the kernels and
the contract line `{"ok": true, "device": {...}}`. With no CUDA device, or
without the rest of the repository beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import dataclasses
import faulthandler
import json
import math
import os
import random
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PROMPT_LEN = 203  # about 200 tokens, not a power of two
NEW_TOKENS = 32  # greedy tokens of the phase 4 generation runs
MAX_SEQ_LEN = 512
LONG_SEQ_LEN = 4096  # phase 3's long attention readings (bench_prefill's longest prompt)
PREFILL_CHUNK = 512  # bench_prefill's chunk
STACK_DUMP_S = 1100  # the script must end within 1200 s; it aims at 600

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and dense bf16
# tensor-core flop/s; a kernel's bound is the larger of its bytes and its
# flops over these. The quantized matmuls' products of bf16 x with
# small-integer weights are exact on the tensor cores (f32 sums, the scale
# per block after), so their flops count at the bf16 rate at any M.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12

# TPU kernels replaced by each port kernel
KERNELS = {
    "q4_0_matmul": ("gemma_tpu_torch/csrc/q4_0_matmul.cu",
                    "gemma_tpu/ops/quant_matmul.py:95 _q4_0_kernel"),
    "q8_0_matmul": ("gemma_tpu_torch/csrc/q8_0_matmul.cu",
                    "gemma_tpu/ops/quant_matmul.py:103 _q8_0_kernel"),
    "q4_k_matmul": ("gemma_tpu_torch/csrc/q4_k_matmul.cu",
                    "gemma_tpu/ops/quant_matmul.py:110 _q4_k_kernel"),
    "q6_k_matmul": ("gemma_tpu_torch/csrc/q6_k_matmul.cu",
                    "gemma_tpu/ops/quant_matmul.py:162 _q6_k_kernel; "
                    "gemma_tpu/ops/quant_matmul.py:146 _q6_k_v4_kernel"),
    "flash_attention": ("gemma_tpu_torch/csrc/flash_attention.cu",
                        "gemma_tpu/ops/attention.py:94 _flash_kernel"),
    "decode_attention": ("gemma_tpu_torch/csrc/decode_attention.cu",
                         "gemma_tpu/ops/attention.py:273 _decode_kernel"),
    "decode_attention_int8": ("gemma_tpu_torch/csrc/decode_attention.cu",
                              "gemma_tpu/ops/attention.py:273 _decode_kernel (int8 arm)"),
    "paged_attention": ("gemma_tpu_torch/csrc/paged_attention.cu",
                        "gemma_tpu/ops/paged_attention.py:47 _paged_kernel"),
    "paged_attention_int8": ("gemma_tpu_torch/csrc/paged_attention.cu",
                             "gemma_tpu/ops/paged_attention.py:47 _paged_kernel (int8 pages)"),
    # the f32 evaluation routes on the tensor cores: every format at M > 8
    # (the TF32 tile) and flash attention with f32 queries
    "q4_0_matmul_tf32": ("gemma_tpu_torch/csrc/dq_tile_tf32.cuh",
                         "gemma_tpu/ops/quant_matmul.py:95 _q4_0_kernel (f32 x, M > 8)"),
    "q8_0_matmul_tf32": ("gemma_tpu_torch/csrc/dq_tile_tf32.cuh",
                         "gemma_tpu/ops/quant_matmul.py:103 _q8_0_kernel (f32 x, M > 8)"),
    "q4_k_matmul_tf32": ("gemma_tpu_torch/csrc/dq_tile_tf32.cuh",
                         "gemma_tpu/ops/quant_matmul.py:110 _q4_k_kernel (f32 x, M > 8)"),
    "q6_k_matmul_tf32": ("gemma_tpu_torch/csrc/dq_tile_tf32.cuh",
                         "gemma_tpu/ops/quant_matmul.py:162 _q6_k_kernel (f32 x, M > 8)"),
    "flash_attention_tf32": ("gemma_tpu_torch/csrc/flash_attention.cu",
                             "gemma_tpu/ops/attention.py:94 _flash_kernel (f32 queries)"),
    # decode and paged decode attention at G = 1 (Gemma-7B), every (q, cache)
    # arm: the core built for one query row
    "decode_attention_g1": ("gemma_tpu_torch/csrc/decode_g1.cuh",
                            "gemma_tpu/ops/attention.py:273 _decode_kernel (G = 1)"),
    "paged_attention_g1": ("gemma_tpu_torch/csrc/decode_g1.cuh",
                           "gemma_tpu/ops/paged_attention.py:47 _paged_kernel (G = 1)"),
    # decode attention with f32 queries over an f32 cache at 2 <= G <= 8:
    # the tensor-core decode core's TF32 policy
    "decode_attention_tf32": ("gemma_tpu_torch/csrc/decode_tc.cuh",
                              "gemma_tpu/ops/attention.py:273 _decode_kernel (f32 queries)"),
    # f32 queries on the same core over an int8 cache (`DecTf32Int8`), and
    # through pages of f32 (`DecTf32`) and of int8 (`DecTf32Int8`)
    "decode_attention_tf32_int8": ("gemma_tpu_torch/csrc/decode_tc.cuh",
                                   "gemma_tpu/ops/attention.py:273 _decode_kernel (int8 arm, f32 queries)"),
    "paged_attention_tf32": ("gemma_tpu_torch/csrc/decode_tc.cuh",
                             "gemma_tpu/ops/paged_attention.py:47 _paged_kernel (f32 queries)"),
    "paged_attention_tf32_int8": ("gemma_tpu_torch/csrc/decode_tc.cuh",
                                  "gemma_tpu/ops/paged_attention.py:47 _paged_kernel (int8 pages, f32 queries)"),
    # every format's f32 x at M <= 8: the tensor-core GEMV with x in three
    # bf16 parts
    "q4_0_matmul_gemv_f32": ("gemma_tpu_torch/csrc/dq_gemv.cuh",
                             "gemma_tpu/ops/quant_matmul.py:95 _q4_0_kernel (f32 x, M <= 8)"),
    "q8_0_matmul_gemv_f32": ("gemma_tpu_torch/csrc/dq_gemv.cuh",
                             "gemma_tpu/ops/quant_matmul.py:103 _q8_0_kernel (f32 x, M <= 8)"),
    "q4_k_matmul_gemv_f32": ("gemma_tpu_torch/csrc/dq_gemv.cuh",
                             "gemma_tpu/ops/quant_matmul.py:110 _q4_k_kernel (f32 x, M <= 8)"),
    "q6_k_matmul_gemv_f32": ("gemma_tpu_torch/csrc/dq_gemv.cuh",
                             "gemma_tpu/ops/quant_matmul.py:162 _q6_k_kernel (f32 x, M <= 8)"),
}
# prefill rows of the quantized-matmul tiles: a serving prompt, an
# admission chunk, the prompt
TILE_MS = (17, 64, PROMPT_LEN)
SERVE_SLOTS = 8  # the serving step's rows: every format's tensor-core GEMV
# the speculative verify: k = 7 drafts (T = 8 rows a sequence; the k = 1
# decoder of adaptive serving: T = 2), blocks of 4 verify forwards
SPEC_K, SPEC_BLOCK, SPEC_TOKENS = 7, 4, 96
# q4_0's verify rows beside M = 8 and 64: k = 1 at batch 1 (M = 2, the
# GEMV) and over 8 slots (M = 16, the tile)
VERIFY_MS = (2, 16)
# phase 3's quantized-matmul shapes (name, N, K, Ms): Gemma-2B's for q4_0
# and for the q4_k_m path (q4_k q, k, out, fused gate|up, down; q6_k attn_v,
# and the tied head, which prefill runs at its last row only), the deep-K
# shape of the reference's _q6_k_v4_kernel, and Gemma-7B's for q8_0, whose
# head's plain version dequantizes 3.1 GB of f32 and so runs at decode M.
# M = 1 is the decode step and M = 8 the serving step (every format: the
# tensor-core GEMV of csrc/dq_gemv.cuh)
MATMUL_SHAPES = {
    "q4_0": ([(name, N, K, (1, *VERIFY_MS, SERVE_SLOTS, *TILE_MS)) for name, N, K in (
        ("qkv", 2560, 2048), ("attn_out", 2048, 2048), ("gate_up", 32768, 2048),
        ("down", 2048, 16384))] + [("head", 256000, 2048, (1, *VERIFY_MS, SERVE_SLOTS, 64,
                                                           PROMPT_LEN))], "gate_up"),
    "q8_0": ([(name, N, K, (1, SERVE_SLOTS, *TILE_MS)) for name, N, K in (
        ("qkv", 12288, 3072), ("attn_out", 3072, 4096), ("gate_up", 49152, 3072),
        ("down", 3072, 24576))] + [("head", 256000, 3072, (1, SERVE_SLOTS))], "gate_up"),
    "q4_k": ([(name, N, K, (1, SERVE_SLOTS, *TILE_MS)) for name, N, K in (
        ("attn_q", 2048, 2048), ("attn_k", 256, 2048), ("attn_out", 2048, 2048),
        ("gate_up", 32768, 2048), ("down", 2048, 16384))], "gate_up"),
    "q6_k": ([(name, N, K, (1, SERVE_SLOTS, *TILE_MS)) for name, N, K in (
        ("attn_v", 256, 2048), ("deep_k", 2048, 16384), ("head", 256000, 2048))], "head"),
}
# every format's f32 route (the TF32 tile): phase 3 holds it at the
# Gemma-2B q4_0, Gemma-7B q8_0 and q4_k_m rows of MATMUL_SHAPES (not deep_k:
# on no GGUF path) at the tiles' M and the perplexity window's, and at
# ragged edges (N past a tile, K of an odd count of superblocks; q4_0 and
# q8_0: K % 64 == 32, the tile's half step past K, with an odd count of
# scales, and a split K; q4_0's half step in the last split), to 1e-5 of the
# output's scale
TF32_MS = (*TILE_MS, 512)
TF32_EDGES = (("q4_k", "edge", 1000, 1280), ("q4_k", "edge", 1100, 256),
              ("q6_k", "edge", 999, 1280), ("q8_0", "edge", 1000, 1056),
              ("q8_0", "edge", 999, 1056), ("q8_0", "edge", 130, 4064),
              ("q4_0", "edge", 1000, 1056), ("q4_0", "edge", 999, 2144))
TF32_PASSES = 2  # the tile's TF32 products a k8 step (x's hi and lo): not in the bound
SERVE_PROMPT_LENS = (17, 64, 100, 203)  # cycled over the requests of phase 6
SERVE_REQUESTS = 24
SERVE_NEW_TOKENS = 96
SERVE_BLOCK = 8
PAGE = 64
# kv_limit of each of SERVE_SLOTS rows in the serving kernels' checks
SERVE_LIMITS = [1, 64, 65, PROMPT_LEN, 300, MAX_SEQ_LEN, PROMPT_LEN, 64]


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


def device_ms(torch, fn, launches: int = 20, reps: int = 5) -> float:
    """Device ms per call of fn() with its operands warm: CUDA events around
    back-to-back calls queued behind a sleep that outlasts their enqueue,
    so the host's launch cost is hidden (tools/_timing.py `time_us`). A
    plain version launches tens of kernels a call: time it one call a
    repetition (launches=1), or the calls overflow the launch queue behind
    the sleep and the host's time leaks in. Not torch.profiler: a short
    profile on the H100 machine lost kernel records (a plain version read
    at a tenth of its time), though the long decode and serving profiles
    lose almost none (`profiler_coverage`)."""
    from gemma_tpu_torch.tools import _timing as T

    dev = torch.device("cuda", torch.cuda.current_device())
    return T.time_us(lambda: fn(), [()], dev, reps, launches) / 1e3


def bound(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations"): the larger
    of nbytes over HBM bandwidth and flops over `peak`."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_ms(torch, q, k, v, valid) -> float:
    """Device ms of torch.nn.functional.scaled_dot_product_attention on the
    kernels' inputs (q [B, T, Hq, D], k/v [B, Hkv, S, D], valid [B, T, S]
    bool): the library yardstick of decode and flash attention, timed here
    and used nowhere in the port."""
    import torch.nn.functional as F

    qh = q.transpose(1, 2)
    mask = valid[:, None]
    return device_ms(torch, lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask,
                                                                   enable_gqa=True))


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(out.returncode == 0 and out.stdout.strip(), f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cold_ms(fn, args: tuple, dev, reps: int = 5) -> float:
    """Device ms per call of fn(*args) with L2 cold: CUDA events around
    launches rotating over copies of args totalling >= 100 MB, behind a
    sleep that hides the host's launch cost (gemma_tpu_torch/tools/_timing.py)."""
    from gemma_tpu_torch.tools import _timing as T

    sets = T.replicate(args, T.copies_for(T.nbytes(*args), dev))
    us = T.time_us(fn, sets, dev, reps)
    del sets
    return us / 1e3


def check_matmul(torch, fmt: str, shapes, rep_name: str, gen, dev) -> dict:
    """One quantized matmul kernel against its plain version with bf16 x, on
    each (name, N, K, Ms) of `shapes`, at each M of Ms; the JSON reading is
    `rep_name` at M = 1, with the prefill tile's at M = 203 under "tile"
    and the serving GEMV's at M = 8 under "m8". The library yardstick is
    torch.matmul of x with the weight dequantized to bf16 beforehand: it
    reads 16 bits per weight, not the format's bits. The bound counts the wire bytes of the weight, x and
    the f32 y, and the flops at the bf16 rate. Kernel and library are timed
    with L2 cold (`cold_ms`), as a decode step meets its weights; the warm
    time (`device_ms`), operands back to back in L2, stays in the line
    beside them."""
    import gemma_tpu_torch.ops.quant_matmul as qmm
    from gemma_tpu_torch.quant.qtensor import dequant
    from gemma_tpu_torch.tools._timing import random_qtensor

    kernel, plain = qmm.MATMULS[fmt], qmm.PLAIN[fmt]
    worst = 0.0
    readings = {}
    for name, N, K, ms in shapes:
        qt = random_qtensor(fmt, N, K, gen, dev)
        wire_bytes = sum(a.numel() * a.element_size() for a in qt.arrays.values())
        w16 = dequant(qt, torch.bfloat16)
        for M in ms:
            x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            got = kernel(x, qt)
            ref = plain(x, qt)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            tol = 1e-4 * ref.abs().max().item() + 1e-6
            warm_ms = device_ms(torch, lambda: kernel(x, qt))
            ms = cold_ms(kernel, (x, qt), dev)
            per_call = call_ms(torch, lambda: kernel(x, qt))
            plain_ms = device_ms(torch, lambda: plain(x, qt), launches=1)
            warm_library_ms = device_ms(torch, lambda: torch.matmul(x, w16.T))
            library_ms = cold_ms(lambda x_, w_: torch.matmul(x_, w_.T), (x, w16), dev)
            bound_ms, bound_by = bound(wire_bytes + x.numel() * 2 + M * N * 4, 2 * M * N * K,
                                       BF16_FLOPS)
            rate = (f"{wire_bytes / ms / 1e9:.3f} TB/s at wire bytes" if M <= 8
                    else f"{2 * M * N * K / ms / 1e9:.3f} TFLOP/s")
            info("kernel", f"{fmt}_matmul {name} M={M} N={N} K={K}: max|diff|={err:.3e} "
                           f"tol={tol:.3e}; device ms, L2 cold: kernel {ms:.4f} ({rate}) library "
                           f"(bf16 matmul, weight dequantized beforehand) {library_ms:.4f}; "
                           f"warm: kernel {warm_ms:.4f} library {warm_library_ms:.4f}; "
                           f"plain {plain_ms:.4f}; bound {bound_ms:.4f} ({bound_by}); "
                           f"kernel per back-to-back call {per_call:.4f} ms")
            require(bool(torch.isfinite(got).all()) and err <= tol,
                    f"{fmt}_matmul {name} M={M}: max|diff| {err} > tol {tol}")
            worst = max(worst, err)
            if name == rep_name:
                readings[M] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                               "bound_by": bound_by, "library_ms": library_ms,
                               "shape": f"{name} M={M} N={N} K={K}"}
        del qt, w16
    extra = {key: readings[M] for key, M in (("tile", PROMPT_LEN), ("m8", SERVE_SLOTS))
             if M in readings}
    return {"max_abs_err": worst, **readings[1], **extra}


def check_matmuls(torch, dev, formats=tuple(MATMUL_SHAPES)) -> dict[str, dict]:
    """Phase 3, the quantized matmuls of `formats` at MATMUL_SHAPES.

    q4_0, q8_0 and q6_k: the kernel and the plain version form the same f32
    products (f32 weights at M <= 8, where the tensor-core GEMV multiplies
    the integers and scales each group's sum in f32; bf16-rounded weights
    at M > 8, whose products with bf16 x are exact in f32 on the tensor
    cores too) and differ only in the order of f32 sums. q4_k at M <= 8
    forms d*sc * sum((q - 8) x) + (8 d*sc - dmin*mn) * sum(x) per 32-group
    against the plain x @ dequant: the products differ by the f32 rounding
    of each dequantized weight; at M > 8 both form bf16(d*sc * (q - 8))
    products plus the f32 affine part. Each is ~1e-6 of the output's scale,
    so the tolerance is 1e-4 of it."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return {f"{fmt}_matmul": check_matmul(torch, fmt, *MATMUL_SHAPES[fmt], gen, dev)
            for fmt in formats}


def check_tf32_routes(torch, dev) -> dict[str, dict]:
    """Phase 3, every format's f32 route at M > 8 (`dq_tile_tf32_kernel`,
    csrc/dq_tile_tf32.cuh): each Gemma-2B q4_0, Gemma-7B q8_0 and q4_k_m
    row of MATMUL_SHAPES at TF32_MS and the ragged TF32_EDGES
    against the plain version (f32 x @ the weight
    dequantized to f32), held to 1e-5 of the output's scale. The main rows
    are timed with L2 cold, with the library call (torch.matmul of f32 x
    with the weight dequantized to f32 beforehand, TF32 off) and the bound:
    the wire bytes over HBM bandwidth, or the function's 2 M N K flops over
    the TF32 rate (the tile's second pass is its way to f32 accuracy, not
    work the function needs: the info line gives the TF32_PASSES figure
    beside it). Each launch is counted by the library's own count of the
    tile's launches, and the library's K-split scratch at each shape is
    held to the plan that tools/tc_emulation.py emulates (`tf32_plan`). The
    JSON reading of each is its EVAL_REP row at M = 512 (the perplexity
    window), every row's under "rows"."""
    import gemma_tpu_torch.ops.quant_matmul as qmm
    from gemma_tpu_torch.kernels import build
    from gemma_tpu_torch.quant.qtensor import dequant
    from gemma_tpu_torch.tools import _timing as T
    from gemma_tpu_torch.tools import tc_emulation as emu
    from gemma_tpu_torch.utils.device import H100_TF32_FLOPS

    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    require(not torch.backends.cuda.matmul.allow_tf32, "the library yardstick must run in f32")
    rows = [(fmt, name, N, K) for fmt in qmm.TF32_FORMATS
            for name, N, K, _ in MATMUL_SHAPES[fmt][0] if name != "deep_k"]
    readings: dict[str, dict] = {f"{fmt}_matmul_tf32": {"max_abs_err": 0.0, "rows": []}
                                 for fmt in qmm.TF32_FORMATS}
    for fmt, name, N, K in rows + list(TF32_EDGES):
        timed = name != "edge"
        qt = T.random_qtensor(fmt, N, K, gen, dev)
        w32 = dequant(qt, torch.float32)
        wire = T.nbytes(qt)
        reading = readings[f"{fmt}_matmul_tf32"]
        for M in TF32_MS:
            x = torch.randn(M, K, generator=gen, device=dev)
            before = qmm.MATMULS[fmt].tf32_launches
            got = qmm.MATMULS[fmt](x, qt)
            ref = qmm.PLAIN[fmt](x, qt)
            torch.cuda.synchronize()
            require(qmm.MATMULS[fmt].tf32_launches == before + 1,
                    f"{fmt}_matmul f32 M={M}: the library launched no TF32 tile")
            splits = emu.tf32_plan(fmt, M, N, K)[1]
            work = build.matmul_scratch(build.load(), build.FORMAT_CODES[fmt],
                                        build.DTYPE_CODES[torch.float32], M, N, K)[0]
            require(work == (splits * M * N * 4 if splits > 1 else 0),
                    f"{fmt}_matmul_tf32 M={M} N={N} K={K}: the library's scratch {work} bytes, "
                    f"the emulated plan's {splits} splits")
            err = (got - ref).abs().max().item()
            tol = 1e-5 * ref.abs().max().item()
            require(bool(torch.isfinite(got).all()) and err <= tol,
                    f"{fmt}_matmul_tf32 {name} M={M} N={N} K={K}: max|diff| {err} > tol {tol}")
            reading["max_abs_err"] = max(reading["max_abs_err"], err)
            line = (f"{fmt}_matmul_tf32 {name} M={M} N={N} K={K}: max|diff|={err:.3e} "
                    f"tol={tol:.3e} (1e-5 of scale)")
            if timed:
                ms = cold_ms(qmm.MATMULS[fmt], (x, qt), dev, reps=3)
                library_ms = cold_ms(lambda x_, w_: torch.matmul(x_, w_.T), (x, w32), dev, reps=3)
                plain_ms = device_ms(torch, lambda: qmm.PLAIN[fmt](x, qt), launches=1, reps=3)
                bound_ms, bound_by = bound(wire + M * K * 4 + M * N * 4, 2 * M * N * K,
                                           H100_TF32_FLOPS)
                passes_ms = TF32_PASSES * 2 * M * N * K / H100_TF32_FLOPS * 1e3
                row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": library_ms, "shape": f"f32 {name} M={M} N={N} K={K}"}
                reading["rows"].append(row)
                if name == EVAL_REP[fmt] and M == PPL_WINDOW:
                    reading.update(row)
                line += (f"; device ms, L2 cold: kernel {ms:.4f} "
                         f"({2 * M * N * K / ms / 1e9:.3f} TFLOP/s of the product, "
                         f"{bound_ms / ms:.3f} of the bound) library (f32 matmul, weight "
                         f"dequantized beforehand) {library_ms:.4f} (kernel / library "
                         f"{ms / library_ms:.3f}); plain {plain_ms:.4f}; bound {bound_ms:.4f} "
                         f"({bound_by}, 2 M N K at the TF32 rate); at {TF32_PASSES} TF32 "
                         f"passes {passes_ms:.4f} ({passes_ms / ms:.3f} of the kernel's time); "
                         f"K splits {splits}")
            info("kernel", line)
            del x, got, ref
        del qt, w32
        torch.cuda.empty_cache()
    return readings


# attention: bf16 outputs, and p rounded to bf16 against a per-tile
# (kernel) or per-row (plain) running max; the reference's own kernel
# tests allow 2e-2 for the same reasons. Held row by row to 2e-2 of
# the row's scale (`_timing.attn_err`).
ATT_TOL = 2e-2
HEAD_DIM = 256  # Gemma-2B's and Gemma-7B's


def held_attention(torch, kind, desc, kernel, plain, library=None, nbytes=0, flops=0, tol=ATT_TOL,
                   peak=BF16_FLOPS):
    """kernel() against plain() within `tol` of each row's scale, with
    their device times; given `library` (a timing function), also its ms
    and the bound of nbytes and flops at `peak` (the bf16 rate). Returns
    (reading, kernel output)."""
    from gemma_tpu_torch.tools._timing import attn_err

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    err, ratio, lo, hi = attn_err(got, ref, tol)
    r = {"max_abs_err": err, "ms": device_ms(torch, kernel),
         "plain_ms": device_ms(torch, plain, launches=1)}
    per_call = call_ms(torch, kernel)
    line = (f"{kind} {desc}: max|diff|={err:.3e}, worst |diff| / ({tol:.0e} x row scale) "
            f"{ratio:.3f}, row scales {lo:.3e}-{hi:.3e}; device ms: kernel "
            f"{r['ms']:.4f} plain {r['plain_ms']:.4f}")
    if library is not None:
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops, peak)
        r["library_ms"] = library()
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        line += (f" library (scaled_dot_product_attention, boolean mask) "
                 f"{lib}; bound {r['bound_ms']:.6f} ({r['bound_by']})")
    info("kernel", f"{line}; kernel per back-to-back call {per_call:.4f} ms")
    require(bool(torch.isfinite(got).all()) and ratio <= 1.0,
            f"{kind} {desc}: |diff| {ratio:.3f} x {tol} of its row's scale")
    return r, got


def decode_cost(limits, hq, hkv, kv_bytes=2 * HEAD_DIM * 2, window=0):
    """(bytes, flops) of decode attention: the live keys' K and V (int8:
    and their scales), q, out and the limits; QK and PV products. With a
    window, a row's live keys are its last `window`."""
    D = HEAD_DIM
    live = sum(min(n, window) if window else n for n in limits)
    return live * hkv * kv_bytes + 2 * len(limits) * hq * D * 2 + len(limits) * 4, 4 * hq * D * live


def flash_cost(pos, limit, hq, hkv, window=0):
    """(bytes, flops) of prefill attention of rows at positions `pos`
    (consecutive) below `limit`: q, the live keys' K and V, out and
    positions; the query at p sees the keys below min(p + 1, limit) and,
    with a window, above p - window."""
    D = HEAD_DIM
    T = len(pos)

    def lo(p_):
        return max(0, int(p_) + 1 - window) if window else 0

    seen = sum(max(0, min(int(p_) + 1, limit) - lo(p_)) for p_ in pos)
    live = min(int(pos[-1]) + 1, limit) - lo(pos[0])
    return 2 * T * hq * D * 2 + 2 * live * hkv * D * 2 + T * 4, 4 * hq * D * seen


def check_kernels(torch, dev) -> dict[str, dict]:
    """Phase 3: every kernel against its plain version at the main path's
    shapes (the quantized matmuls by `check_matmuls`). Returns per-kernel
    results for the JSON line."""
    import gemma_tpu_torch.ops.attention as att

    results = check_matmuls(torch, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    Hq, Hkv, D = 8, 1, HEAD_DIM
    S = MAX_SEQ_LEN
    key = torch.arange(S, device=dev)

    def held(*args, **kw):
        return held_attention(torch, *args, **kw)

    def kv(B=1, hkv=Hkv, S=S):
        return ((torch.randn(B, hkv, S, D, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
                for _ in range(2))

    def route(hq, hkv, S_):
        return "{}, {} keys a block".format(*att.decode_route(torch.bfloat16, hq // hkv, S_))

    worst = 0.0
    rep = None
    for limit, cap, window in [(1, 0.0, 0), (64, 0.0, 0), (PROMPT_LEN + 1, 0.0, 0), (300, 0.0, 0),
                               (S, 0.0, 0), (300, 50.0, 128)]:
        q = (torch.randn(1, 1, Hq, D, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        k, v = kv()
        lim = torch.tensor([limit], dtype=torch.int32, device=dev)
        is_rep = limit == PROMPT_LEN + 1 and not cap
        r, _ = held("decode_attention", f"S={S} limit={limit} softcap={cap} window={window} "
                                        f"({route(Hq, Hkv, S)})",
                    lambda: att.decode_attention(q, k, v, lim, cap, window),
                    lambda: att.decode_attention_plain(q, k, v, lim, cap, window),
                    (lambda: sdpa_ms(torch, q, k, v, key[None, None] < limit)) if is_rep else None,
                    *decode_cost([limit], Hq, Hkv))
        worst = max(worst, r["max_abs_err"])
        if is_rep:
            rep = {**r, "shape": f"S={S} kv_limit={limit} Hq={Hq} Hkv={Hkv} D={D}"}
    # long caches (S = 4096): the bf16 arm with its library call, the int8 arm
    from gemma_tpu_torch.runtime.kv_cache import quantize_kv

    SL = LONG_SEQ_LEN
    keyl = torch.arange(SL, device=dev)
    kl, vl = kv(S=SL)
    (kl8, ksl), (vl8, vsl) = quantize_kv(kl), quantize_kv(vl)
    for limit in (SL // 2, SL):
        q = (torch.randn(1, 1, Hq, D, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        lim = torch.tensor([limit], dtype=torch.int32, device=dev)
        r, _ = held("decode_attention", f"S={SL} limit={limit} ({route(Hq, Hkv, SL)})",
                    lambda: att.decode_attention(q, kl, vl, lim),
                    lambda: att.decode_attention_plain(q, kl, vl, lim),
                    lambda: sdpa_ms(torch, q, kl, vl, keyl[None, None] < limit),
                    *decode_cost([limit], Hq, Hkv))
        worst = max(worst, r["max_abs_err"])
        r, _ = held("decode_attention_int8", f"S={SL} limit={limit} ({route(Hq, Hkv, SL)}; no single "
                                             "library call)",
                    lambda: att.decode_attention(q, kl8, vl8, lim, k_scale=ksl, v_scale=vsl),
                    lambda: att.decode_attention_plain(q, kl8, vl8, lim, k_scale=ksl, v_scale=vsl),
                    lambda: None, *decode_cost([limit], Hq, Hkv, 2 * (D + 4)))
        worst = max(worst, r["max_abs_err"])
    del kl, vl, kl8, vl8
    results["decode_attention"] = {"max_abs_err": worst, **rep}

    H7 = 16  # Gemma-7B's heads (Hq = Hkv = 16: one query head per KV head)
    T = PROMPT_LEN
    worst = 0.0
    rep = None
    chunk = LONG_SEQ_LEN - PREFILL_CHUNK
    cases = [  # name, positions, kv_limit, softcap, window, query and KV heads, S
        ("prompt", torch.arange(T, device=dev), T, 0.0, 0, Hq, Hkv, S),
        ("softcap+window", torch.arange(T, device=dev) + 100, T + 100, 50.0, 64, Hq, Hkv, S),
        # rows at positions >= 181 see no key below kv_limit 150 in a 32-window
        ("rows without keys", torch.arange(T, device=dev) + 100, 150, 0.0, 32, Hq, Hkv, S),
        ("Gemma-7B heads prompt", torch.arange(T, device=dev), T, 0.0, 0, H7, H7, S),
        # long prefill (bench_prefill): 2048 tokens from position 0, and the
        # last 512-token chunk of a 4096-token prompt
        ("long prompt", torch.arange(2048, device=dev), 2048, 0.0, 0, Hq, Hkv, LONG_SEQ_LEN),
        ("Gemma-7B heads long prompt", torch.arange(2048, device=dev), 2048, 0.0, 0, H7, H7,
         LONG_SEQ_LEN),
        ("chunk prompt", torch.arange(chunk, LONG_SEQ_LEN, device=dev), LONG_SEQ_LEN, 0.0, 0, Hq, Hkv,
         LONG_SEQ_LEN),
    ]
    for name, pos, limit, cap, window, hq, hkv, S_ in cases:
        T_ = len(pos)
        q = (torch.randn(1, T_, hq, D, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        k, v = kv(1, hkv, S_)
        positions = pos.to(torch.int32)[None]
        lim = torch.tensor([limit], dtype=torch.int32, device=dev)
        timed = name.endswith("prompt")
        key_ = torch.arange(S_, device=dev)
        valid = (key_[None, None] <= pos[None, :, None]) & (key_ < limit)
        nbytes, flops = flash_cost(pos.tolist(), limit, hq, hkv)
        r, got = held("flash_attention", f"{name} T={T_} S={S_} limit={limit} softcap={cap} "
                                         f"window={window} Hq={hq} Hkv={hkv}",
                      lambda: att.flash_attention(q, k, v, positions, lim, cap, window),
                      lambda: att.flash_attention_plain(q, k, v, positions, lim, cap, window),
                      (lambda: sdpa_ms(torch, q, k, v, valid)) if timed else None, nbytes, flops)
        if timed:
            info("kernel", f"flash_attention {name}: {flops / 1e9:.3f} GFLOP, kernel "
                           f"{flops / r['ms'] / 1e9:.2f} TFLOP/s, library "
                           f"{flops / r['library_ms'] / 1e9:.2f} TFLOP/s")
        if name == "rows without keys":
            empty = pos >= 181
            require(bool((got[0, empty] == 0).all()), "flash_attention: rows without keys are not 0")
        worst = max(worst, r["max_abs_err"])
        if name == "prompt":
            rep = {**r, "shape": f"T={T} S={S} Hq={Hq} Hkv={Hkv} D={D}"}
    results["flash_attention"] = {"max_abs_err": worst, **rep}
    return results


# Gemma-7B's attention (Hq = Hkv = 16: G = 1) on the core built for one
# query row (csrc/decode_g1.cuh), phase 3: (label, S, kv_limits) at batch 1
# and kv_limit 204 (phase 4c's first decode step), the 8 serving rows (phase
# 6b) and a 4096-slot cache at limits 2048 and 4096; in each (q, cache) arm
# (name, q dtype, int8 cache, tolerance of each row's scale): bf16 and int8
# round p (p * vs) to bf16 against a warp's running max, f32 over f32
# rounds nothing, f32 over int8 keeps bf16(p * vs)
G1_HEADS = 16
G1_SHAPES = (("B=1", MAX_SEQ_LEN, [PROMPT_LEN + 1]), (f"{SERVE_SLOTS} rows", MAX_SEQ_LEN, SERVE_LIMITS),
             ("S=4096", LONG_SEQ_LEN, [LONG_SEQ_LEN // 2]), ("S=4096", LONG_SEQ_LEN, [LONG_SEQ_LEN]))
G1_ARMS = (("bf16", "bfloat16", False, ATT_TOL), ("int8", "bfloat16", True, ATT_TOL),
           ("f32", "float32", False, 1e-4), ("f32 q int8", "float32", True, ATT_TOL))


def g1_once(torch, what: str, call, route: str, counter) -> None:
    """One call of a G = 1 wrapper (`counter`: decode_attention or
    paged_decode_attention) must take route "g1" and count one launch in
    `g1_launches` and none on the other one-launch cores."""
    before = (counter.g1_launches, counter.tc_launches, getattr(counter, "tf32_launches", 0))
    call()
    after = (counter.g1_launches, counter.tc_launches, getattr(counter, "tf32_launches", 0))
    require(route == "g1" and after == (before[0] + 1, before[1], before[2]),
            f"{what}: route {route}, launches (G = 1, tensor cores, TF32) {before} -> {after}")


def check_g1(torch, dev) -> dict[str, dict]:
    """Phase 3: decode and paged decode attention at G = 1 on the core for
    one query row, at Gemma-7B's heads: G1_SHAPES in every arm of G1_ARMS,
    each against its plain version at its tolerance of each row's scale,
    one call counted on the core (`g1_once`), timed warm with its plain
    version, SDPA (bf16 and f32 arms; none takes int8) and its bound (the
    live keys' K and V, int8 with their scales, q, out and the limits over
    HBM bandwidth against 4 Hq D flops a key at the bf16 or TF32 rate);
    then paged attention over the 8 serving rows of 64-key pages (a 65-page
    pool) in every arm, timed, equal bit for bit to decode attention on the
    gathered rows. Returns the readings of `decode_attention_g1` (bf16, B =
    1) and `paged_attention_g1` (bf16 pages), every reading under
    "readings"."""
    import gemma_tpu_torch.ops.attention as att
    import gemma_tpu_torch.ops.paged_attention as pat
    from gemma_tpu_torch.runtime.kv_cache import quantize_kv
    from gemma_tpu_torch.tools.parent_turn import paged_inputs
    from gemma_tpu_torch.utils.device import H100_TF32_FLOPS

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    H, D = G1_HEADS, HEAD_DIM
    readings = {"decode_attention_g1": {}, "paged_attention_g1": {}}

    def size(dtype):  # bytes of an element
        return 4 if dtype == torch.float32 else 2

    def kv_bytes(dtype, int8):
        return 2 * (D + 4) if int8 else 2 * D * size(dtype)

    for label, S, limits in G1_SHAPES:
        B = len(limits)
        q32, k32, v32 = (torch.randn(*shape, generator=gen, device=dev) * 0.3
                         for shape in ((B, 1, H, D), (B, H, S, D), (B, H, S, D)))
        lim = torch.tensor(limits, dtype=torch.int32, device=dev)
        valid = torch.arange(S, device=dev)[None, None] < lim[:, None, None]
        for arm, dtype_name, int8, tol in G1_ARMS:
            dtype = getattr(torch, dtype_name)
            q = q32.to(dtype)
            if int8:
                (k, ks), (v, vs) = quantize_kv(k32.to(torch.bfloat16)), quantize_kv(v32.to(torch.bfloat16))
            else:
                k, v, ks, vs = k32.to(dtype), v32.to(dtype), None, None
            route, split = att.decode_route(dtype, 1, S)
            desc = f"Gemma-7B heads Hq=Hkv={H} {label} S={S} limits={limits} {arm} ({route}, {split} keys a block)"
            g1_once(torch, f"decode_attention {desc}", lambda: att.decode_attention(q, k, v, lim, k_scale=ks,
                                                                                     v_scale=vs),
                    route, att.decode_attention)
            nbytes, flops = decode_cost(limits, H, H, kv_bytes(dtype, int8))
            nbytes += 2 * B * H * D * (size(dtype) - 2)  # q and out in f32
            r, _ = held_attention(
                torch, "decode_attention_g1", desc,
                lambda: att.decode_attention(q, k, v, lim, k_scale=ks, v_scale=vs),
                lambda: att.decode_attention_plain(q, k, v, lim, k_scale=ks, v_scale=vs),
                (lambda: None) if int8 else (lambda: sdpa_ms(torch, q, k, v, valid)), nbytes, flops, tol,
                BF16_FLOPS if dtype == torch.bfloat16 else H100_TF32_FLOPS)
            readings["decode_attention_g1"][f"{label} S={S} limits={limits} {arm}"] = {
                **r, "shape": f"B={B} Hq=Hkv={H} D={D} S={S} kv_limits={limits} {arm}"}
            del k, v, ks, vs
        del q32, k32, v32
    S, pool = MAX_SEQ_LEN, 65
    for arm, dtype_name, int8, tol in G1_ARMS:
        dtype = getattr(torch, dtype_name)
        q, cache, lim = paged_inputs(gen, dev, SERVE_SLOTS, H, H, D, PAGE, SERVE_LIMITS, pool, S, int8,
                                     torch.bfloat16 if int8 else dtype, seed=8)
        q = q.to(dtype)
        route, split = pat.paged_route(dtype, 1, PAGE, S)
        desc = (f"Gemma-7B heads Hq=Hkv={H} {SERVE_SLOTS} rows ps={PAGE} pool={pool} limits={SERVE_LIMITS} "
                f"{arm} ({route}, {split} keys a block; no single library call)")
        g1_once(torch, f"paged_attention {desc}", lambda: pat.paged_decode_attention(q, cache, 0, lim),
                route, pat.paged_decode_attention)
        nbytes, flops = decode_cost(SERVE_LIMITS, H, H, kv_bytes(dtype, int8))
        nbytes += 2 * SERVE_SLOTS * H * D * (size(dtype) - 2) + sum(-(-n // PAGE) for n in SERVE_LIMITS) * 4
        r, got = held_attention(
            torch, "paged_attention_g1", desc, lambda: pat.paged_decode_attention(q, cache, 0, lim),
            lambda: pat.paged_decode_attention_plain(q, cache, 0, lim), lambda: None, nbytes, flops, tol,
            BF16_FLOPS if dtype == torch.bfloat16 else H100_TF32_FLOPS)
        k, v, ks, vs = (None if x is None else x.contiguous() for x in cache.layer_kv(0))
        same = torch.equal(got, att.decode_attention(q, k, v, lim, k_scale=ks, v_scale=vs))
        info("kernel", f"paged_attention_g1 {arm}: equal bit for bit to decode_attention on the gathered "
                       f"rows: {same}")
        require(same, f"paged_attention_g1 {arm}: differs from decode_attention on the gathered rows")
        readings["paged_attention_g1"][arm] = {**r, "shape": f"B={SERVE_SLOTS} Hq=Hkv={H} D={D} ps={PAGE} "
                                                             f"limits={SERVE_LIMITS} {arm}"}
        del q, cache, k, v, ks, vs
    out = {}
    for name, rep_key in (("decode_attention_g1", f"B=1 S={MAX_SEQ_LEN} limits={[PROMPT_LEN + 1]} bf16"),
                          ("paged_attention_g1", "bf16")):
        rows = readings[name]
        out[name] = {**rows[rep_key], "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
                     "readings": rows}
    return out


def check_verify_attention(torch, dev) -> dict[str, dict]:
    """Phase 3, flash attention at the speculative verify's shapes: T = 8
    (k = 7) and T = 2 (k = 1) query rows a sequence at positions length ..
    length + T - 1 over a MAX_SEQ_LEN cache, kv_limit length + T: Gemma-2B
    heads at batch 1 (length PROMPT_LEN) and over the 8 serving rows (each
    its own length, SERVE_LIMITS clipped to S - T), Gemma-7B heads at
    batch 1 (T = 8: 8 of a block's 16 rows are padding at G = 1), and
    correctness only, an idle serving row whose positions and limit passed
    the cache (the kernel clamps the limit to S). Each within 2e-2 of each
    row's scale of its plain version (`_timing.attn_err`), with kernel,
    plain and SDPA times, decode attention's time at the same limits (one
    query row a sequence), and the bound. Returns the Gemma-2B batch-1
    readings by T."""
    import gemma_tpu_torch.ops.attention as att
    from gemma_tpu_torch.tools._timing import attn_err

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    tol, D, S = 2e-2, 256, MAX_SEQ_LEN
    key = torch.arange(S, device=dev)
    readings = {}
    cases = [(f"Gemma-2B heads B=1 T={T}", 8, 1, T, [PROMPT_LEN]) for T in (1 + SPEC_K, 2)]
    cases += [(f"Gemma-2B heads {SERVE_SLOTS} rows T={T}", 8, 1, T,
               [min(n, S - T) for n in SERVE_LIMITS]) for T in (1 + SPEC_K, 2)]
    cases += [(f"Gemma-7B heads B=1 T={1 + SPEC_K}", 16, 16, 1 + SPEC_K, [PROMPT_LEN]),
              ("idle row past the cache", 8, 1, 1 + SPEC_K, [PROMPT_LEN, S + 40])]
    for name, hq, hkv, T, starts in cases:
        B = len(starts)
        q = (torch.randn(B, T, hq, D, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        k, v = ((torch.randn(B, hkv, S, D, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
                for _ in range(2))
        length = torch.tensor(starts, dtype=torch.int32, device=dev)
        pos = length[:, None] + torch.arange(T, dtype=torch.int32, device=dev)
        lim = length + T
        kernel = lambda: att.flash_attention(q, k, v, pos, lim)
        plain = lambda: att.flash_attention_plain(q, k, v, pos, lim)
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        err, ratio, lo, hi = attn_err(got, ref, tol)
        require(bool(torch.isfinite(got).all()) and ratio <= 1.0,
                f"flash_attention verify {name}: |diff| {ratio:.3f} x {tol} of its row's scale")
        if name.startswith("idle"):
            info("kernel", f"flash_attention verify {name}: lengths {starts}, max|diff|={err:.3e}, "
                           f"worst |diff| / ({tol:.0e} x row scale) {ratio:.3f}")
            continue
        ms, plain_ms = device_ms(torch, kernel), device_ms(torch, plain, launches=1)
        valid = (key[None, None] <= pos[:, :, None]) & (key < lim[:, None, None])
        library_ms = sdpa_ms(torch, q, k, v, valid)
        qd = q[:, -1:].contiguous()
        decode_ms = device_ms(torch, lambda: att.decode_attention(qd, k, v, lim))
        live = sum(min(n + T, S) for n in starts)
        seen = int(valid.sum())  # (row, key) pairs a query head reads
        bound_ms, bound_by = bound(2 * B * T * hq * D * 2 + 2 * live * hkv * D * 2 + B * T * 4,
                                   4 * hq * D * seen, BF16_FLOPS)
        info("kernel", f"flash_attention verify {name} lengths {starts} S={S}: max|diff|={err:.3e}, "
                       f"worst |diff| / ({tol:.0e} x row scale) {ratio:.3f}, row scales "
                       f"{lo:.3e}-{hi:.3e}; device ms: kernel {ms:.4f} plain {plain_ms:.4f} library "
                       f"(scaled_dot_product_attention, boolean mask) {library_ms:.4f} decode "
                       f"attention (T = 1, same limits) {decode_ms:.4f}; bound {bound_ms:.6f} "
                       f"({bound_by})")
        if B == 1 and hq == 8:
            readings[f"verify_t{T}"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms, "decode_ms": decode_ms,
                "shape": f"T={T} positions {starts[0]}.. S={S} Hq={hq} Hkv={hkv} D={D}"}
    return readings


def check_edge_cases(torch, dev) -> None:
    """Phase 3, correctness only: the kernels' instances the main path does
    not reach (M = 2..9 and 70 on ragged N and K, and the prefill rows 17,
    64, 130 and 203, f32 activations, GQA with
    head_dim 128, batch 2 with per-row limits, ragged T, softcap + window),
    and attention at Gemma-7B's heads (Hq = Hkv = 16, D = 256: one query
    head per KV head), each against its plain version with the tolerances
    of check_kernels (attention in f32: 1e-4, nothing rounds), also over
    the 8 serving rows (SERVE_LIMITS) as phase 6b decodes them. Every
    format takes K = 1280 (five superblocks), off the SIMT GEMV's
    1024-element K-chunk, at every GEMV M (1-9); q4_0 and q8_0 also K =
    1056, whose 33 blocks end the
    tensor-core tile's K on a half step and put odd rows' scales at odd
    halves of their words, at N = 1000 and at N = 999 (an odd count of
    scales); q6_k also N = 999 at K = 1280, an odd count of its f16 d
    values, whose last ends the array in the middle of a word."""
    import gemma_tpu_torch.ops.attention as att
    import gemma_tpu_torch.ops.quant_matmul as qmm
    from gemma_tpu_torch.tools._timing import attn_err, random_qtensor

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    worst = {}
    # N, K off every tile and chunk; N = 999 with K = 1056 (q6_k: 1280): an
    # odd count of scales, whose last one ends the array in the middle of an
    # f16 word
    for fmt, N, K in (("q4_0", 1000, 1056), ("q4_0", 1000, 1280), ("q4_0", 999, 1056),
                      ("q8_0", 1000, 1056), ("q8_0", 1000, 1280), ("q8_0", 999, 1056),
                      ("q4_k", 1000, 1280), ("q6_k", 1000, 1280), ("q6_k", 999, 1280)):
        qt = random_qtensor(fmt, N, K, gen, dev)
        for dtype in (torch.bfloat16, torch.float32):
            for M in (*range(1, 10), 16, 17, 64, 70, 130, PROMPT_LEN):
                x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
                got, ref = qmm.MATMULS[fmt](x, qt), qmm.PLAIN[fmt](x, qt)
                err = (got - ref).abs().max().item()
                tol = 1e-4 * ref.abs().max().item() + 1e-6
                require(err <= tol, f"{fmt}_matmul N={N} K={K} M={M} {dtype}: max|diff| {err} > "
                                    f"tol {tol}")
                key = f"{fmt} N={N} K={K}"
                worst[key] = max(worst.get(key, 0.0), err / tol)
    P = PROMPT_LEN
    attn_cases = [  # name, B, T, Hq, Hkv, D, S, positions, limits, decode limits
        ("GQA D=128", 2, 37, 8, 2, 128, 100, torch.stack([torch.arange(37), torch.arange(37) + 50]),
         [37, 90], [1, 90]),
        ("Gemma-7B heads", 1, P, 16, 16, 256, MAX_SEQ_LEN, torch.arange(P)[None], [P], [P + 1]),
        # phase 6b's decode: 8 rows of Gemma-7B heads at the serving limits;
        # flash on each row's last 16 positions below its limit
        ("Gemma-7B heads, 8 rows", SERVE_SLOTS, 16, 16, 16, 256, MAX_SEQ_LEN,
         torch.arange(16)[None] + torch.tensor([max(0, n - 16) for n in SERVE_LIMITS])[:, None],
         SERVE_LIMITS, SERVE_LIMITS),
        # G = 1 at D = 128: decode rows of limit 0 (exactly 0) and 1
        ("MHA D=128", 3, 16, 4, 4, 128, 200,
         torch.stack([torch.arange(16), torch.arange(16) + 20, torch.arange(16) + 100]), [16, 36, 116],
         [0, 1, 150]),
    ]
    for name, B, T, Hq, Hkv, D, S, positions, limits, dlimits in attn_cases:
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            q = (torch.randn(B, T, Hq, D, generator=gen, device=dev) * 0.3).to(dtype)
            k = (torch.randn(B, Hkv, S, D, generator=gen, device=dev) * 0.3).to(dtype)
            v = (torch.randn(B, Hkv, S, D, generator=gen, device=dev) * 0.3).to(dtype)
            pos = positions.to(dev, torch.int32)
            lim = torch.tensor(limits, dtype=torch.int32, device=dev)
            dlim = torch.tensor(dlimits, dtype=torch.int32, device=dev)
            for cap, window in ((0.0, 0), (30.0, 20)):
                got = att.flash_attention(q, k, v, pos, lim, cap, window)
                ref = att.flash_attention_plain(q, k, v, pos, lim, cap, window)
                ratio = attn_err(got, ref, tol)[1]
                require(ratio <= 1.0, f"flash_attention {name} {dtype} cap={cap}: |diff| {ratio:.3f} "
                                      f"x {tol} of its row's scale")
                worst[f"flash {name}"] = max(worst.get(f"flash {name}", 0.0), ratio)
                got = att.decode_attention(q[:, :1], k, v, dlim, cap, window)
                ref = att.decode_attention_plain(q[:, :1], k, v, dlim, cap, window)
                ratio = attn_err(got, ref, tol)[1]
                require(ratio <= 1.0, f"decode_attention {name} {dtype} cap={cap}: |diff| "
                                      f"{ratio:.3f} x {tol} of its row's scale")
                worst[f"decode {name}"] = max(worst.get(f"decode {name}", 0.0), ratio)
    torch.cuda.synchronize()
    info("kernel", "edge cases (other M, ragged N/K/T, f32, GQA D=128, batch 2, Gemma-7B heads "
                   "at batch 1 and 8, G = 1 at D = 128 with decode limits 0 and 1) "
                   "within tolerance; worst max|diff| / tol (attention: of the row's scale): "
                   + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()))


def _counters():
    """(name, wrapper, attribute) of every launch counter
    (`gemma_tpu_torch/utils/verify.py`, which reads them around each side
    of its check)."""
    from gemma_tpu_torch.utils.verify import launch_counters

    return launch_counters()


def check_serving_kernels(torch, dev) -> dict[str, dict]:
    """Phase 3, the serving kernels: paged attention (Gemma-2B heads, 64-token
    pages, bf16 and int8 pages) at the serving shape (8 rows, limits
    SERVE_LIMITS, a 65-page pool) and over long caches (2 rows of 64 pages,
    S = 4096, limits 2048 and 4096: four pages a block), and the int8 arm of
    decode attention at S = 512 (8 rows). Tolerance 2e-2 of each row's
    scale (`_timing.attn_err`) as for bf16 decode: p (int8: p * vs) rounds
    to bf16 against a split-local max in the kernels, the row max in the
    plain versions. Paged attention must take the tensor-core route there
    and equal `decode_attention` on the same rows gathered densely
    (`cache.layer_kv`, made contiguous) bit for bit: the same split, tiles
    and arithmetic. Returns the serving shape's readings."""
    import gemma_tpu_torch.ops.attention as att
    import gemma_tpu_torch.ops.paged_attention as pat
    from gemma_tpu_torch.runtime.kv_cache import quantize_kv
    from gemma_tpu_torch.tools._timing import attn_err
    from gemma_tpu_torch.tools.parent_turn import paged_inputs

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    tol = 2e-2
    Hq, Hkv, D = 8, 1, 256
    results = {}

    def held(name, desc, kernel, plain, limits, kv_bytes_per_key, table_bytes=0):
        """No single PyTorch call computes paged or int8 attention: no
        library time. The bound counts the live keys' K and V (int8: and
        their f32 scales), q, out, the limits and the live table entries."""
        B, live = len(limits), sum(limits)
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        err, ratio, lo, hi = attn_err(got, ref, tol)
        ms = device_ms(torch, kernel)
        per_call = call_ms(torch, kernel)
        plain_ms = device_ms(torch, plain, launches=1)
        bound_ms, bound_by = bound(live * Hkv * kv_bytes_per_key + 2 * B * Hq * D * 2 + B * 4
                                   + table_bytes, 4 * Hq * D * live, BF16_FLOPS)
        info("kernel", f"{name} {desc}: max|diff|={err:.3e}, worst |diff| / ({tol:.0e} x row "
                       f"scale) {ratio:.3f}, row scales {lo:.3e}-{hi:.3e}; device ms: kernel "
                       f"{ms:.4f} plain {plain_ms:.4f}; bound {bound_ms:.6f} ({bound_by}); "
                       f"kernel per back-to-back call {per_call:.4f} ms")
        require(bool(torch.isfinite(got).all()) and ratio <= 1.0,
                f"{name}: |diff| {ratio:.3f} x {tol} of its row's scale")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
                "shape": f"B={B} Hq={Hq} Hkv={Hkv} D={D} {desc}"}

    long_limits = [LONG_SEQ_LEN // 2, LONG_SEQ_LEN]
    for S, limits, pool in ((MAX_SEQ_LEN, SERVE_LIMITS, 65),
                            (LONG_SEQ_LEN, long_limits, 2 * LONG_SEQ_LEN // PAGE + 1)):
        for quantized in (False, True):
            name = "paged_attention_int8" if quantized else "paged_attention"
            q, cache, lim = paged_inputs(gen, dev, len(limits), Hq, Hkv, D, PAGE, limits, pool, S,
                                         quantized)
            route, split = pat.paged_route(q.dtype, Hq // Hkv, PAGE, S)
            tc_before = pat.paged_decode_attention.tc_launches
            r = held(name, f"S={S} ps={PAGE} pool={pool} limits={limits} ({route}, {split} keys a "
                           "block)",
                     lambda: pat.paged_decode_attention(q, cache, 0, lim),
                     lambda: pat.paged_decode_attention_plain(q, cache, 0, lim), limits,
                     2 * (D + 4) if quantized else 2 * D * 2,
                     sum(-(-n // PAGE) for n in limits) * 4)
            require(route == "tc" and pat.paged_decode_attention.tc_launches > tc_before,
                    f"{name} S={S}: took the {route} route, not the tensor cores")
            k, v, ks, vs = (None if x is None else x.contiguous() for x in cache.layer_kv(0))
            dense = att.decode_attention(q, k, v, lim, k_scale=ks, v_scale=vs)
            same = torch.equal(pat.paged_decode_attention(q, cache, 0, lim), dense)
            info("kernel", f"{name} S={S}: equal bit for bit to decode_attention on the gathered "
                           f"rows: {same}")
            require(same, f"{name} S={S}: differs from decode_attention on the gathered rows")
            if S == MAX_SEQ_LEN:
                results[name] = r
            del q, cache, k, v, ks, vs, dense
    B = SERVE_SLOTS
    q = (torch.randn(B, 1, Hq, D, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
    k, v = ((torch.randn(B, Hkv, MAX_SEQ_LEN, D, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
            for _ in range(2))
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    lim = torch.tensor(SERVE_LIMITS, dtype=torch.int32, device=dev)
    results["decode_attention_int8"] = held(
        "decode_attention_int8", f"S={MAX_SEQ_LEN} limits={SERVE_LIMITS}",
        lambda: att.decode_attention(q, k8, v8, lim, k_scale=ks, v_scale=vs),
        lambda: att.decode_attention_plain(q, k8, v8, lim, k_scale=ks, v_scale=vs), SERVE_LIMITS,
        2 * (D + 4))
    return results


def check_serving_edge_cases(torch, dev) -> None:
    """Phase 3, correctness only: the paged kernels and the int8 decode arm
    off the serving shapes. bf16 queries take the tensor-core route (GQA
    with head_dim 128, softcap with window, 16-, 64- and 256-key pages:
    four pages a block, one, a quarter of one) and equal `decode_attention`
    on the gathered rows bit for bit; f32 queries the same core's f32
    policies (over f32 and int8 pages), bit for bit likewise; G = 1 (D =
    128 and 16-key pages with softcap and window; f32 pages of 8 keys) the
    core for one query row, equal bit for bit to `decode_attention` on the
    gathered rows. f32 queries over f32 pages round nothing: tolerance
    1e-4. Every int8 case
    keeps the bf16 rounding of p * vs (against a local max in the kernel,
    the row max in the plain version), and bf16 queries round p: tolerance
    2e-2. Each of the row's scale (`_timing.attn_err`). Then no fallback: a
    page table that is not int32 raises, and so does the tensor-core entry
    at a page size off 16, and the G = 1 entry at G = 8."""
    import gemma_tpu_torch.ops.attention as att
    import gemma_tpu_torch.ops.paged_attention as pat
    from gemma_tpu_torch.kernels import build
    from gemma_tpu_torch.tools._timing import attn_err
    from gemma_tpu_torch.tools.parent_turn import paged_inputs

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    worst = {}
    cases = [  # name, Hq, Hkv, D, ps, dtype, cap, window
        ("f32", 8, 1, 256, 64, torch.float32, 0.0, 0),
        ("GQA D=128", 8, 2, 128, 64, torch.bfloat16, 0.0, 0),
        ("softcap+window", 8, 1, 256, 64, torch.bfloat16, 50.0, 128),
        ("ps=16", 8, 1, 256, 16, torch.bfloat16, 0.0, 0),
        ("ps=256", 8, 1, 256, 256, torch.bfloat16, 30.0, 100),
        ("G=1 D=128 ps=16", 4, 4, 128, 16, torch.bfloat16, 30.0, 100),
        ("G=1 f32 ps=8", 2, 2, 256, 8, torch.float32, 0.0, 0),
    ]
    limits = [1, 16, 17, 255, 256, 257, 400, MAX_SEQ_LEN]
    for name, Hq, Hkv, D, ps, dtype, cap, window in cases:
        for quantized in (False, True):
            q, cache, lim = paged_inputs(gen, dev, len(limits), Hq, Hkv, D, ps, limits,
                                         len(limits) * MAX_SEQ_LEN // ps + 1, MAX_SEQ_LEN, quantized,
                                         dtype, seed=5)
            if quantized and dtype == torch.float32:  # f32 queries over int8 pages too
                q = torch.randn(q.shape, generator=gen, device=dev) * 0.3
            tol = 1e-4 if dtype == torch.float32 and not quantized else 2e-2
            route = pat.paged_route(q.dtype, Hq // Hkv, ps, MAX_SEQ_LEN)[0]
            op = pat.paged_decode_attention
            before = (op.tc_launches, op.tf32_launches + op.tf32_int8_launches, op.g1_launches)
            got = pat.paged_decode_attention(q, cache, 0, lim, cap, window)
            arm = f"paged{' int8' if quantized else ''}"
            want = "g1" if Hq == Hkv else "tc" if dtype == torch.bfloat16 else "tf32"
            require(route == want and (op.tc_launches - before[0],
                                       op.tf32_launches + op.tf32_int8_launches - before[1],
                                       op.g1_launches - before[2])
                    == (route == "tc", route == "tf32", route == "g1"), f"{arm} {name}: took the {route} route")
            ref = pat.paged_decode_attention_plain(q, cache, 0, lim, cap, window)
            ratio = attn_err(got, ref, tol)[1]
            require(ratio <= 1.0, f"{arm} {name}: |diff| {ratio:.3f} x {tol} of its row's scale")
            worst[f"{arm} {route}"] = max(worst.get(f"{arm} {route}", 0.0), ratio)
            k, v, ks, vs = (None if x is None else x.contiguous() for x in cache.layer_kv(0))
            if route != "split":  # the dense kernel on the gathered rows, bit for bit
                dense = att.decode_attention(q, k, v, lim, cap, window, ks, vs)
                require(torch.equal(got, dense), f"{arm} {name}: differs from decode_attention on "
                                                 "the gathered rows")
            if quantized:  # the int8 decode arm on the same rows, densely
                got = att.decode_attention(q, k, v, lim, cap, window, ks, vs)
                ref = att.decode_attention_plain(q, k, v, lim, cap, window, ks, vs)
                ratio = attn_err(got, ref, tol)[1]
                require(ratio <= 1.0, f"decode int8 {name}: |diff| {ratio:.3f} x {tol} of its row's "
                                      "scale")
                worst["decode int8"] = max(worst.get("decode int8", 0.0), ratio)
    # no fallback on the tensor-core route
    q, cache, lim = paged_inputs(gen, dev, 2, 8, 1, 256, PAGE, [100, 200], 9, MAX_SEQ_LEN, False)
    refused = []
    table = cache.page_table
    cache.page_table = table.long()
    try:
        pat.paged_decode_attention(q, cache, 0, lim)
    except ValueError as e:
        refused.append(f"int64 table: {e}")
    cache.page_table = table
    work, tickets = build.workspace(dev, build.stream_ptr(dev), 0, 0)
    kp, vp = cache.layer_pages(0)[:2]
    err = build.load().gt_paged_attention_tc(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), None, None, table.data_ptr(), lim.data_ptr(),
        torch.empty_like(q).data_ptr(), work.data_ptr(), tickets.data_ptr(), 2, 8, 1, 8,
        table.shape[1] * PAGE // 8, 256, build.DTYPE_CODES[torch.bfloat16], build.DTYPE_CODES[torch.bfloat16],
        64, 0, 0.0, build.stream_ptr(dev))
    try:
        build.check(err, "paged attention (tc) at page size 8")
    except build.KernelLaunchError as e:
        refused.append(str(e))
    err = build.load().gt_paged_attention_g1(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), None, None, table.data_ptr(), lim.data_ptr(),
        torch.empty_like(q).data_ptr(), work.data_ptr(), tickets.data_ptr(), 2, 8, 1, PAGE,
        table.shape[1], 256, build.DTYPE_CODES[torch.bfloat16], build.DTYPE_CODES[torch.bfloat16], 32,
        0, 0.0, build.stream_ptr(dev))
    try:
        build.check(err, "paged attention (G = 1 core) at G = 8")
    except build.KernelLaunchError as e:
        refused.append(str(e))
    require(len(refused) == 3, f"paged attention: a bad call did not raise ({refused})")
    torch.cuda.synchronize()
    info("kernel", "serving edge cases (f32, GQA D=128, softcap+window, ps 16 and 256, G = 1 at D = "
                   f"128 and ps 8 and 16, limits {limits}; bf16 and f32 on the tensor cores and G = 1 on "
                   "its core, equal bit for bit to decode_attention on the gathered rows) within "
                   "tolerance; worst max|diff| / (tol x row scale): "
                   + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
                   + "; refused: " + "; ".join(refused))


# Gemma-2-2B q4_k_m and Gemma-3-4B q4_0 (phases 4d and 6c), phase 3: (model,
# format, its phase 4d prompt and cache). Their matmul rows at the decode
# step's M = 1, the serving step's 8 and a prefill chunk's 512 (the head
# at 1 and 8: prefill runs it at its last row); decode attention at their
# heads (8 query heads over 4 KV heads, D = 256: G = 2 on the tensor-core
# core) with softcap and window at the last decode step's limit, dense and
# through 64-key pages (two rows, one past the window, one inside it);
# flash over the prompt's last chunk, which crosses the window's lower edge
ARCH_MODELS = (("Gemma-2-2B", "q4_k_m", 4200, 4608), ("Gemma-3-4B", "q4_0", 1200, 2048))
ARCH_MS = (1, SERVE_SLOTS, PREFILL_CHUNK)


def arch_matmul_rows(cfg, fmt: str) -> dict[str, list]:
    """{format: [(name, N, K, Ms)]} of one decode forward of `cfg` in
    `fmt`: q4_0 fuses q|k|v and gate|up; q4_k_m is q4_k with q6_k attn_v
    and the tied head."""
    d, q, kv, ff, V = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff, cfg.vocab_size
    head = ("head", V, d, (1, SERVE_SLOTS))
    if fmt == "q4_0":
        return {"q4_0": [(n, N, K, ARCH_MS) for n, N, K in (
            ("qkv", q + 2 * kv, d), ("attn_out", d, q), ("gate_up", 2 * ff, d), ("down", d, ff))] + [head]}
    return {"q4_k": [(n, N, K, ARCH_MS) for n, N, K in (
                ("attn_q", q, d), ("attn_k", kv, d), ("attn_out", d, q), ("gate_up", 2 * ff, d),
                ("down", d, ff))],
            "q6_k": [("attn_v", kv, d, ARCH_MS), head]}


def check_arch_kernels(torch, dev) -> dict[str, dict]:
    """Phase 3 at ARCH_MODELS' shapes: each matmul row (`check_matmul`: L2
    cold, bound, library), decode attention (G = 2, D = 256, softcap and
    window, S the phase 4d cache) against its plain version and SDPA, the
    same rows through 64-key pages equal bit for bit to decode on the
    gathered rows, and flash over the prompt's last 512-token chunk. The
    bounds count only the keys a window leaves. Returns {kernel: {model:
    reading}}."""
    import gemma_tpu_torch.ops.attention as att
    import gemma_tpu_torch.ops.paged_attention as pat
    from gemma_tpu_torch.tools.parent_turn import paged_inputs

    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    readings: dict[str, dict] = {}
    D = HEAD_DIM
    for model_name, fmt, prompt_len, S in ARCH_MODELS:
        cfg = model_config(model_name)
        for f, rows in arch_matmul_rows(cfg, fmt).items():
            rep = rows[-1][0] if f == "q6_k" else "gate_up"
            readings.setdefault(f"{f}_matmul", {})[model_name] = check_matmul(torch, f, rows, rep, gen, dev)
        hq, hkv, cap, window = cfg.n_heads, cfg.n_kv_heads, cfg.attn_softcap, cfg.sliding_window
        limit = prompt_len + NEW_TOKENS
        route = "{}, {} keys a block".format(*att.decode_route(torch.bfloat16, hq // hkv, S))
        q = (torch.randn(1, 1, hq, D, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        k, v = ((torch.randn(1, hkv, S, D, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
                for _ in range(2))
        lim = torch.tensor([limit], dtype=torch.int32, device=dev)
        key = torch.arange(S, device=dev)
        valid = ((key < limit) & (key > limit - 1 - window))[None, None]
        tc_before = att.decode_attention.tc_launches
        r, _ = held_attention(torch, "decode_attention", f"{model_name} S={S} limit={limit} Hq={hq} "
                                                         f"Hkv={hkv} softcap={cap} window={window} "
                                                         f"({route})",
                              lambda: att.decode_attention(q, k, v, lim, cap, window),
                              lambda: att.decode_attention_plain(q, k, v, lim, cap, window),
                              lambda: sdpa_ms(torch, q, k, v, valid),
                              *decode_cost([limit], hq, hkv, window=window))
        require(att.decode_attention.tc_launches > tc_before, f"decode {model_name}: off the tensor cores")
        readings.setdefault("decode_attention", {})[model_name] = r
        limits = [limit, window // 2]
        pq, cache, plim = paged_inputs(gen, dev, 2, hq, hkv, D, PAGE, limits, 2 * S // PAGE + 1, S, False)
        proute = pat.paged_route(torch.bfloat16, hq // hkv, PAGE, S)
        tc_before = pat.paged_decode_attention.tc_launches
        r, got = held_attention(torch, "paged_attention", f"{model_name} S={S} ps={PAGE} limits={limits} "
                                                          f"softcap={cap} window={window} ({proute[0]}, "
                                                          f"{proute[1]} keys a block)",
                                lambda: pat.paged_decode_attention(pq, cache, 0, plim, cap, window),
                                lambda: pat.paged_decode_attention_plain(pq, cache, 0, plim, cap, window),
                                lambda: None, *decode_cost(limits, hq, hkv, window=window))
        require(proute[0] == "tc" and pat.paged_decode_attention.tc_launches > tc_before,
                f"paged {model_name}: took the {proute[0]} route, not the tensor cores")
        kd, vd = (x.contiguous() for x in cache.layer_kv(0)[:2])
        same = torch.equal(got, att.decode_attention(pq, kd, vd, plim, cap, window))
        info("kernel", f"paged_attention {model_name}: equal bit for bit to decode_attention on the "
                       f"gathered rows: {same}")
        require(same, f"paged {model_name}: differs from decode_attention on the gathered rows")
        readings.setdefault("paged_attention", {})[model_name] = r
        start = (prompt_len - 1) // PREFILL_CHUNK * PREFILL_CHUNK
        pos = torch.arange(start, prompt_len, device=dev)
        T = len(pos)
        qf = (torch.randn(1, T, hq, D, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        positions = pos.to(torch.int32)[None]
        flim = torch.tensor([prompt_len], dtype=torch.int32, device=dev)
        fvalid = ((key[None, None] <= pos[None, :, None]) & (key < prompt_len)
                  & (key > pos[None, :, None] - window))
        r, _ = held_attention(torch, "flash_attention", f"{model_name} last chunk T={T} from {start} "
                                                        f"S={S} limit={prompt_len} Hq={hq} Hkv={hkv} "
                                                        f"softcap={cap} window={window}",
                              lambda: att.flash_attention(qf, k, v, positions, flim, cap, window),
                              lambda: att.flash_attention_plain(qf, k, v, positions, flim, cap, window),
                              lambda: sdpa_ms(torch, qf, k, v, fvalid),
                              *flash_cost(pos.tolist(), prompt_len, hq, hkv, window))
        readings.setdefault("flash_attention", {})[model_name] = r
        del k, v, cache, pq
        torch.cuda.empty_cache()
    return readings


def reset_counters() -> None:
    for _, op, attr in _counters():
        setattr(op, attr, 0)


def read_counters() -> dict[str, int]:
    return {name: getattr(op, attr) for name, op, attr in _counters()}


def profiler_coverage(prof, before: dict[str, int]) -> str:
    """'<recorded> of <launched> quantized-matmul launches recorded' by a
    torch.profiler run that began at counters `before`: each wrapper
    call launches one GEMV or tile kernel (`dq_tile_kernel` for the bf16
    prefill tiles, `dq_gemv_kernel` for every format's bf16 GEMV at
    M <= 8). Busy times and idle shares read
    from the run rest on its records; a share below 1 makes busy read
    low and idle high."""
    after = read_counters()
    launched = sum(after[k] - before[k] for k in after if k.endswith("_matmul"))
    recorded = sum(e.count for e in prof.key_averages()
                   if re.search(r"q[468]_[0k]_gemv_kernel|dq_(tile|gemv|tile_tf32)_kernel", e.key))
    return f"{recorded} of {launched} quantized-matmul launches recorded"


def prefill_profile(torch, eng, prompt: list[int], runs: int = 5) -> tuple[float, str]:
    """(median wall ms of `runs` prefills of `prompt`, each ended by a
    synchronize; a torch.profiler reading of one more: device busy ms, the
    largest kernels' ms and the profiler's coverage)."""
    from torch.profiler import ProfilerActivity, profile

    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        eng.prefill([prompt])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    before = read_counters()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.prefill([prompt])
        torch.cuda.synchronize()
    per_kernel = sorted(((getattr(e, "self_device_time_total", 0) / 1e3,
                          e.key.replace("void ", "").replace("(anonymous namespace)::", ""))
                         for e in prof.key_averages()), reverse=True)
    busy = sum(ms for ms, _ in per_kernel)
    top = "; ".join(f"{name[:72]} {ms:.4f}" for ms, name in per_kernel[:6])
    return statistics.median(times), (f"device busy {busy:.3f} ms; device ms by kernel: {top}; "
                                      f"{profiler_coverage(prof, before)}")


def decode_profile(torch, eng, cache, last_tok, steps: int = 8, no_combine: bool = True):
    """Device time of greedy decode steps from torch.profiler, from the
    last token (an int at batch 1, or a tensor of each row's): (busy ms per
    step, the five largest kernels' ms per step and the profiler's
    coverage, and the device kernels a step beside the quantized-matmul
    wrapper launches a step: a K split summed in a second launch shows as
    `dq_split_sum_kernel`, a GEMV off the tensor cores as a SIMT kernel).
    Every decode route of Gemma-2B and Gemma-7B merges its splits in its
    one launch: with `no_combine`, a split-S combine
    (`attend_combine_kernel`) fails."""
    from torch.profiler import ProfilerActivity, profile

    tok = last_tok if torch.is_tensor(last_tok) else torch.tensor([last_tok], device=eng.device)
    before = read_counters()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            logits, cache = eng.decode_step(tok, cache)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
    events = prof.key_averages()
    per_kernel = sorted(((getattr(e, "self_device_time_total", 0) / steps / 1e3, e.key)
                         for e in events), reverse=True)
    busy = sum(ms for ms, _ in per_kernel)
    top = "; ".join(f"{name[:48]} {ms:.4f}" for ms, name in per_kernel[:5])
    after = read_counters()
    wrapper = sum(after[k] - before[k] for k in after if k.endswith("_matmul")) / steps
    kernels = sum(e.count for e in events if getattr(e, "self_device_time_total", 0) > 0) / steps
    split_sums = sum(e.count for e in events if "dq_split_sum_kernel" in e.key) / steps
    simt = sum(e.count for e in events if re.search(r"q[468]_[0k]_gemv_kernel", e.key)) / steps
    combines = sum(e.count for e in events if "attend_combine_kernel" in e.key) / steps
    require(not (no_combine and combines), f"decode steps launched {combines:g} attention combines a step")
    counted = (f"device kernels a step {kernels:g} (quantized-matmul wrapper launches {wrapper:g}, "
               f"second-launch split sums {split_sums:g}, SIMT GEMVs {simt:g}, attention combines "
               f"{combines:g})")
    return busy, f"{top}; {profiler_coverage(prof, before)}; {counted}"


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
    """Kernel launches of one prefill and NEW_TOKENS decode steps as the
    layer structure implies."""
    return expected_forward_launches(cfg, fmt, prefills=1, decode_steps=NEW_TOKENS,
                                     decode_kernel="decode_attention")


def expected_forward_launches(cfg, fmt: str, prefills: int, decode_steps: int,
                              decode_kernel: str) -> dict[str, int]:
    """Kernel launches of `prefills` prefill forwards (chunks counted one by
    one) and `decode_steps` decode forwards whose attention is
    `decode_kernel` (a counter name of `_counters`)."""
    forwards = prefills + decode_steps
    if fmt in ("q4_0", "q8_0"):  # fused q|k|v, out, fused gate|up, down; tied head
        per_forward = {f"{fmt}_matmul": 4 * cfg.n_layers + 1}
    else:  # q4_k_m: q4_k q, k, out, fused gate|up, down; q6_k attn_v, tied head
        per_forward = {"q4_k_matmul": 5 * cfg.n_layers, "q6_k_matmul": cfg.n_layers + 1}
    counts = {name: 0 for name, _, _ in _counters()}
    counts.update({name: n * forwards for name, n in per_forward.items()})
    counts["flash_attention"] = counts["flash_attention_tc"] = cfg.n_layers * prefills
    counts[decode_kernel] = cfg.n_layers * decode_steps
    # bf16 activations: dense and paged decode take the tensor cores or, at
    # G = 1, the core for one query row, where their routes say so
    for op in ("decode_attention", "paged_attention"):
        route = decode_route(cfg, paged=op == "paged_attention")[0]
        if decode_kernel.startswith(op) and route in ("tc", "g1"):
            counts[f"{op}_{route}"] = cfg.n_layers * decode_steps
    return counts


def decode_route(cfg, paged: bool = False, S: int = MAX_SEQ_LEN):
    """The decode kernel's route for `cfg`'s bf16 queries over an S-slot
    cache, dense or of PAGE-key pages."""
    import torch

    import gemma_tpu_torch.ops.attention as att
    import gemma_tpu_torch.ops.paged_attention as pat

    G = cfg.n_heads // cfg.n_kv_heads
    if paged:
        return pat.paged_route(torch.bfloat16, G, PAGE, S)
    return att.decode_route(torch.bfloat16, G, S)


# the GGUF architecture of each model by its printed name: Gemma-2B and
# Gemma-7B (gemma_tpu_torch.models), Gemma-2-2B and Gemma-3-4B
# (gemma_tpu_torch.testing; phases 3, 4d and 6c)
MODEL_ARCH = {"Gemma-2B": "gemma", "Gemma-7B": "gemma", "Gemma-2-2B": "gemma2", "Gemma-3-4B": "gemma3"}
# The phases that serve or shard a model (6-6c, 9 and 10b) run it at full
# width over its first CUT_LAYERS layers. They take hundreds of decode steps
# each, and a step's host time grows with the layers (about 1.3 ms a layer
# on the H100's host, phase 4's host profile): at every layer they took half
# the script's 1200 s. Gemma-2-2B keeps sliding and global layers in turn,
# Gemma-3-4B its five sliding layers and one global. Phases 3, 4-4d, 8, 11
# and 12 keep every layer.
CUT_LAYERS = {"Gemma-2B": 6, "Gemma-7B": 7, "Gemma-2-2B": 6, "Gemma-3-4B": 6}


def model_config(name: str, cut: bool = False):
    """The full-width config of a model by its printed name (MODEL_ARCH);
    with `cut`, its first CUT_LAYERS[name] layers."""
    from gemma_tpu_torch.models import GEMMA_2B, GEMMA_7B
    from gemma_tpu_torch.testing import GEMMA2_2B, GEMMA3_4B

    cfg = {"Gemma-2B": GEMMA_2B, "Gemma-7B": GEMMA_7B, "Gemma-2-2B": GEMMA2_2B,
           "Gemma-3-4B": GEMMA3_4B}[name]
    return dataclasses.replace(cfg, n_layers=CUT_LAYERS[name]) if cut else cfg


def depth(name: str, cfg) -> str:
    """`cfg`'s layers against the whole model's, for the phases' lines."""
    return f"{cfg.n_layers} of {model_config(name).n_layers} layers"


def make_model(name: str, fmt: str, dev, cut: bool = False):
    """A model by its printed name at full width (with `cut`, its first
    CUT_LAYERS layers), random weights from seed 0 in `fmt`, with its
    architecture's norms, on `dev`. Gemma-2 and Gemma-3 models take
    make_params' centred q4_0 nibbles, on which their sliding windows move
    the output (phase 4d; on uniform nibbles a 1024-key window moved
    Gemma-3-4B's logits by 6e-4 of their scale); Gemma-2B and Gemma-7B keep
    the draws their phases' tolerances were set on."""
    from gemma_tpu_torch.testing import make_params

    arch = MODEL_ARCH[name]
    return make_params(model_config(name, cut), fmt, seed=0, device=dev, arch=arch,
                       centred=arch != "gemma")


def main_path(torch, dev, card: str, model_name: str, fmt: str):
    """Phases 4 (Gemma-2B q4_0), 4b (Gemma-2B q4_k_m) and 4c (Gemma-7B
    q8_0): the model at full width, prefill + NEW_TOKENS greedy tokens, then
    the speculative run on the same engine (`speculative_path`). Returns
    (the plain run's launch counts, the speculative run's)."""
    from gemma_tpu_torch.runtime import Engine, EngineConfig
    from gemma_tpu_torch.testing import make_params

    cfg = model_config(model_name)
    phase = f"main {model_name} {fmt}"
    model = make_params(cfg, fmt, seed=0, device=dev)
    weight_gb = sum(b.numel() * b.element_size() for b in model.buffers()) / 1e9
    eng = Engine(cfg, model, EngineConfig(max_seq_len=MAX_SEQ_LEN, max_batch=1))
    prompt = prompt_tokens(cfg, PROMPT_LEN)
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
    info(phase, f"{model_name} {fmt} ({weight_gb:.3f} GB of weights on the card), prompt "
                f"{PROMPT_LEN} tokens: prefill {t_prefill * 1e3:.2f} ms, decode {NEW_TOKENS} "
                f"tokens in {t_decode:.3f} s = {NEW_TOKENS / t_decode:.2f} tok/s on {card}; "
                f"launches {counts} (expected {expected})")
    require(counts == expected, f"launch counts {counts} != expected {expected}")
    median_ms, profiled = prefill_profile(torch, eng, prompt)
    info(phase, f"prefill of {PROMPT_LEN} tokens on {card}: {median_ms:.3f} ms wall, the median of "
                f"5 after warm-up; one more under torch.profiler: {profiled}")
    busy, top = decode_profile(torch, eng, cache, toks[-1])
    per_token = t_decode / NEW_TOKENS * 1e3
    info(phase, f"decode step on {card}: {per_token:.3f} ms wall per token, device busy "
                f"{busy:.3f} ms (idle share {1 - busy / per_token:.3f}); device ms per token "
                f"by kernel: {top}")
    info(phase, f"host ms per decode step by op: {host_profile(torch, eng, cache, toks[-1])}")
    again = eng.generate([prompt], NEW_TOKENS)[0]
    require(again == toks, "Engine.generate differs from prefill + generate_from")
    del cache
    spec_counts = speculative_path(torch, card, eng, fmt, phase, busy)
    del eng, model
    torch.cuda.empty_cache()
    return counts, spec_counts


# phase 4d: (model, format, prompt tokens, cache slots) of ARCH_MODELS. The
# prompts pass each model's window (Gemma-2-2B 4096 keys on even layers,
# Gemma-3-4B 1024 on five layers of six) and prefill in PREFILL_CHUNK chunks
# (9 and 3), so every sliding layer's window binds in prefill and decode.
# bf16 logits are held to LONG_REL of their scale against the plain versions
# on the card (phase 8's Gemma-7B standard); f32 greedy streams must be
# equal, with max|dlogit| against the reference's 0.05
LONG_REL = 2e-2


def prompt_tokens(cfg, n: int) -> list[int]:
    """The n-token prompt of phases 4-4d: token ids from a fixed recipe."""
    return [2 + (i * 7919) % (cfg.vocab_size - 2) for i in range(n)]


def replay(torch, eng, prompt: list[int], stream: list[int]):
    """Prefill `prompt`, then decode each token of `stream`, on `eng`:
    (layer 0's output, `blk.0.attn_out`, the residual after its attention,
    at the prompt's last prefill chunk, and at the last step; the last
    step's logits), as float tensors on the host."""
    from gemma_tpu_torch.utils import tensor_dump

    with tensor_dump.capture(["blk.0.attn_out"]) as cap:  # each chunk's; the last one stays
        logits, cache = eng.prefill([prompt])
    chunk = cap.values["blk.0.attn_out"]
    for t in stream[:-1]:
        logits, cache = eng.decode_step(torch.tensor([t], device=eng.device), cache)
    with tensor_dump.capture(["blk.0.attn_out"]) as cap:
        logits, _ = eng.decode_step(torch.tensor([stream[-1]], device=eng.device), cache)
    return torch.from_numpy(chunk), torch.from_numpy(cap.values["blk.0.attn_out"]), logits[0].cpu()


def long_context(torch, dev, card: str, model_name: str, fmt: str, prompt_len: int,
                 max_seq_len: int) -> dict[str, int]:
    """Phase 4d: `model_name` at full width with its architecture's norms,
    a `prompt_len`-token prompt prefilled in PREFILL_CHUNK chunks into a
    `max_seq_len`-slot cache, then NEW_TOKENS greedy tokens (`prefill` and
    `generate_from`, as phases 4-4c), with exact launch counts (a flash
    launch a layer a chunk, every decode call on the tensor-core core);
    weight GB, prefill ms, decode tok/s and the decode step's device busy
    and idle share. Then `verify_device_kernels` over the same prompt and
    steps, the kernels against the plain versions on the card: bf16 within
    LONG_REL of the logits' scale, its greedy stream the run's; f32 (the
    TF32 flash, tile and decode core, the f32 GEMV) with every argmax
    equal, so the plain versions' greedy stream is the kernels', and
    max|dlogit| within 0.05. Then the window must bind: the kernels'
    last-step logits must differ by more than LONG_REL of the scale from
    those of the same weights and stream with a window as wide as the cache
    (`sliding_window = max_seq_len`: no key falls out, and each layer keeps
    its rope base; 0 would also move Gemma-3's sliding layers to the global
    base), so a kernel that ignored the window would fail the comparison
    with the plain versions. The same holds kernel by kernel at layer 0, a
    sliding layer of both models: its output at the prompt's last chunk
    (flash) and at the last decode step lies within LONG_REL of its scale
    of the plain versions' with the window (layer 0 run alone, with the
    embedding and head) and moves by more than that when the window is
    widened to the cache. Returns the bf16 run's launch counts."""
    from gemma_tpu_torch.models import Gemma
    from gemma_tpu_torch.runtime import Engine, EngineConfig
    from gemma_tpu_torch.utils.verify import plain_versions, verify_device_kernels

    cfg = model_config(model_name)
    phase = f"long {model_name} {fmt}"
    model = make_model(model_name, fmt, dev)
    weight_gb = sum(b.numel() * b.element_size() for b in model.buffers()) / 1e9
    ecfg = EngineConfig(max_seq_len=max_seq_len, max_batch=1, prefill_chunk=PREFILL_CHUNK)
    eng = Engine(cfg, model, ecfg)
    prompt = prompt_tokens(cfg, prompt_len)
    chunks = -(-prompt_len // PREFILL_CHUNK)
    eng.generate([prompt[:PREFILL_CHUNK + 88]], 4)  # warm-up: two chunks, decode steps
    torch.cuda.synchronize()

    reset_counters()
    t0 = time.perf_counter()
    logits, cache = eng.prefill([prompt])
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    require(tuple(logits.shape) == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
            f"{phase}: prefill logits {tuple(logits.shape)}, or not finite")
    t1 = time.perf_counter()
    toks = eng.generate_from(logits, cache, NEW_TOKENS)[0]
    t_decode = time.perf_counter() - t1
    counts = read_counters()
    expected = expected_forward_launches(cfg, fmt, chunks, NEW_TOKENS, "decode_attention")
    step = {k: n for k, n in expected_forward_launches(cfg, fmt, 0, 1, "decode_attention").items() if n}
    require(len(toks) == NEW_TOKENS and all(0 <= t < cfg.vocab_size for t in toks),
            f"{phase}: {len(toks)} tokens, or a token out of range")
    busy, top = decode_profile(torch, eng, cache, toks[-1])
    per_token = t_decode / NEW_TOKENS * 1e3
    info(phase, f"{model_name} {fmt} ({weight_gb:.3f} GB of weights on the card), prompt {prompt_len} "
                f"tokens in {chunks} chunks of {PREFILL_CHUNK} into {max_seq_len} slots (window "
                f"{cfg.sliding_window}, pattern {cfg.swa_pattern}): prefill {t_prefill * 1e3:.2f} ms, "
                f"decode {NEW_TOKENS} tokens in {t_decode:.3f} s = {NEW_TOKENS / t_decode:.2f} tok/s on "
                f"{card}; decode step {per_token:.3f} ms wall, device busy {busy:.3f} ms (idle share "
                f"{1 - busy / per_token:.3f}); a decode step launches {step}; launches {counts} "
                f"(expected {expected}); device ms per token by kernel: {top}")
    require(counts == expected, f"{phase}: launch counts {counts} != expected {expected}")
    del cache

    for act in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        res = verify_device_kernels(dataclasses.replace(cfg, activation_dtype=act), model, prompt,
                                    n_decode=NEW_TOKENS, max_seq_len=max_seq_len,
                                    prefill_chunk=PREFILL_CHUNK)
        want = expected_forward_launches(cfg, fmt, chunks, NEW_TOKENS, "decode_attention")
        if act == "float32":  # the TF32 flash, tile and decode core, the f32 GEMV
            want["flash_attention_tc"] = want["decode_attention_tc"] = 0
            f32_route_launches(want, cfg, fmt, chunks, head=False)
        info(phase, f"{act} kernels against the plain versions on {card} over the prefill and "
                    f"{NEW_TOKENS} decode steps ({time.perf_counter() - t0:.1f} s): max|dlogit| "
                    f"{res['max_abs']:.4e} ({res['max_abs'] / res['scale']:.3e} of the logits' scale "
                    f"{res['scale']:.3f}; tol {LONG_REL:g} of it in bf16, the reference's 0.05 "
                    f"{'holds' if res['max_abs'] <= 0.05 else 'does not hold'}); every argmax "
                    f"equal: {res['argmax_agree']}; per step "
                    + ", ".join(f"{x:.2e}" for x in res["steps"]))
        require(res["kernel_launches"] == want,
                f"{phase} {act}: launch counts {res['kernel_launches']} != expected {want}")
        require(not any(res["plain_launches"].values()),
                f"{phase} {act}: the plain side launched {res['plain_launches']}")
        require(all(math.isfinite(x) for x in res["steps"]), f"{phase} {act}: logits are not finite")
        if act == "bfloat16":
            require(res["stream"] == toks, f"{phase}: verify's greedy stream differs from generate_from's")
            require(res["max_abs"] <= LONG_REL * res["scale"],
                    f"{phase} bf16: max|dlogit| {res['max_abs']} > {LONG_REL} of {res['scale']}")
            scale = res["scale"]
        else:
            require(res["argmax_agree"] and res["max_abs"] <= 0.05,
                    f"{phase} f32: the plain versions' greedy stream differs, or max|dlogit| "
                    f"{res['max_abs']} > 0.05")

    wide = dataclasses.replace(cfg, sliding_window=max_seq_len)
    got, got_wide = (replay(torch, Engine(c, model, ecfg), prompt, toks) for c in (cfg, wide))
    d_logits = (got[2] - got_wide[2]).abs().max().item()
    one = dataclasses.replace(cfg, n_layers=1)  # layer 0 alone, with the embedding and head
    first = Gemma(one, model.embed, model.final_norm.weight, [dict(model.layers[0].named_children())])
    with plain_versions():
        want = replay(torch, Engine(one, first, ecfg), prompt, toks)
    line = []
    for where, g, w, gw in zip(("the prompt's last chunk (flash)", "the last decode step"), got[:2],
                               want[:2], got_wide[:2]):
        sc, err, moved = w.abs().max().item(), (g - w).abs().max().item(), (g - gw).abs().max().item()
        line.append(f"{where}: kernels against plain versions {err:.4e}, against the kernels with a "
                    f"{max_seq_len}-key window {moved:.4e} (tol {LONG_REL * sc:.4e}, {LONG_REL:g} of "
                    f"the scale {sc:.3f})")
        require(err <= LONG_REL * sc < moved, f"{phase}: layer 0 at {where}: kernels against plain "
                                              f"{err}, window moved it {moved}, tol {LONG_REL * sc}")
    info(phase, f"the window binds: last-step logits with window {cfg.sliding_window} against a "
                f"{max_seq_len}-key window (no key falls out) max|dlogit| {d_logits:.4e} "
                f"({d_logits / scale:.3e} of the scale, tol {LONG_REL:g}); layer 0's output at "
                + "; at ".join(line))
    require(d_logits > LONG_REL * scale, f"{phase}: the window moves the last-step logits by "
                                         f"{d_logits} <= {LONG_REL} of {scale}")
    del eng, model
    torch.cuda.empty_cache()
    return counts


def long_contexts(torch, dev, card: str) -> dict[str, int]:
    """Phase 4d: `long_context` of each of ARCH_MODELS, one model at a time,
    each model's phase time printed. Returns the bf16 runs' launches, summed."""
    total: dict[str, int] = {}
    for model_name, fmt, prompt_len, max_seq_len in ARCH_MODELS:
        t0 = time.perf_counter()
        add_counts(total, long_context(torch, dev, card, model_name, fmt, prompt_len, max_seq_len))
        info("time", f"phase 4d {model_name} {fmt} took {time.perf_counter() - t0:.1f} s")
    return total


def spec_prompt(cfg) -> list[int]:
    """A repetitive prompt: one 29-token block seen 7 times (203 tokens)."""
    return [2 + (i * 7919 + 13) % (cfg.vocab_size - 2) for i in range(29)] * 7


def clone_cache(cache):
    from gemma_tpu_torch.runtime import KVCache

    def c(xs):
        return None if xs is None else [x.clone() for x in xs]

    return KVCache(c(cache.k), c(cache.v), cache.length.clone(), c(cache.k_scale), c(cache.v_scale))


def teacher_forced_gaps(torch, eng, prompts: list[list[int]], streams: list[list[int]]):
    """Feed each stream through the plain path (prefill, then one decode
    step a token, the sequences batched in eng's slots): for every position,
    max(plain logits) - plain logit of the stream's token (0 where the
    stream's token is the plain argmax). Returns [n_tokens, len(prompts)]
    on the host."""
    B = len(prompts)
    cache = eng.new_cache(B)
    logits = torch.empty(B, eng.cfg.vocab_size, dtype=torch.float32, device=eng.device)
    for b, p in enumerate(prompts):
        pre = eng.prefill_standalone(p)
        eng.insert_sequence(cache, b, pre)
        logits[b] = pre[0]
    toks = torch.tensor(streams, dtype=torch.int64, device=eng.device)  # [B, n]
    gaps = []
    for j in range(toks.shape[1]):
        mine = logits.gather(1, toks[:, j : j + 1])[:, 0]
        am = logits.argmax(-1)
        gaps.append(torch.where(am == toks[:, j], 0.0, logits.amax(-1) - mine))
        logits, cache = eng.decode_step(toks[:, j], cache)
    return torch.stack(gaps).cpu()


def speculative_path(torch, card, eng, fmt: str, phase: str, plain_busy: float):
    """Phases 4-4c, speculative: on the engine the plain run used,
    `SpecDecoder(k=SPEC_K, block=SPEC_BLOCK).generate` of SPEC_TOKENS tokens
    from `spec_prompt`, with exact launch counts (one prefill, then one
    flash launch a layer a verify forward and no decode attention), against
    plain `prefill` + `generate_from` of the same prompt (wall tok/s, both
    with their prefill). bf16: the verify's M = 8 and flash round otherwise
    than M = 1 and decode attention, so the stream is held by calibration,
    not equality: one verify forward of 8 tokens and 8 plain decode steps
    over the same tokens from the same cache must agree within 2e-2 of the
    logits' scale, and delta is twice their largest |difference|; then the
    stream, teacher-forced through the plain path, must at every position
    be the plain argmax or lie within delta of the plain maximum. Device
    busy a verify forward (torch.profiler, one block) beside a plain step's.
    One block issued under `torch.cuda.set_sync_debug_mode("error")` must
    not sync. Returns the launch counts."""
    from gemma_tpu_torch.runtime import SpecDecoder
    from torch.profiler import ProfilerActivity, profile

    cfg = eng.cfg
    prompt = spec_prompt(cfg)
    dec = SpecDecoder(eng, k=SPEC_K, block=SPEC_BLOCK)
    dec.generate(prompt[:16], 8)  # warm-up: first launches at the verify shapes
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    stream = dec.generate(prompt, SPEC_TOKENS)
    t_spec = time.perf_counter() - t0
    counts = read_counters()
    expected = expected_forward_launches(cfg, fmt, 1 + dec.steps, 0, "decode_attention")
    require(counts == expected, f"{phase} speculative: launch counts {counts} != expected {expected}")
    require(len(stream) == SPEC_TOKENS and all(0 <= t < cfg.vocab_size for t in stream),
            f"{phase} speculative: {len(stream)} tokens, or a token out of range")
    t0 = time.perf_counter()
    logits0, cache = eng.prefill([prompt])
    plain = eng.generate_from(logits0, cache, SPEC_TOKENS)[0]
    t_plain = time.perf_counter() - t0

    delta = verify_delta(torch, eng, prompt, stream[:1 + SPEC_K], phase)
    gaps = teacher_forced_gaps(torch, eng, [prompt], [stream])[:, 0]
    off = [j for j, g in enumerate(gaps.tolist()) if g > 0]
    info(phase, f"speculative stream teacher-forced through plain decode: {len(off)} of "
                f"{SPEC_TOKENS} positions not the plain argmax (first {off[:1]}), largest gap "
                f"{float(gaps.max()):.4e} (delta {delta:.4e}); equal to plain greedy's stream: "
                f"{stream == plain}")
    require(float(gaps.max()) <= delta, f"{phase}: a speculative token lies {float(gaps.max())} "
                                        f"below the plain maximum (delta {delta})")

    _, carry, cache = dec.start(prompt)
    torch.cuda.synchronize()
    before = read_counters()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        carry, _ = dec.batch_block(carry, cache)
        torch.cuda.synchronize()
    busy = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()) / 1e3 / SPEC_BLOCK
    coverage = profiler_coverage(prof, before)
    no_sync(torch, lambda: dec.batch_block(carry, cache), f"{phase} batch-1 speculative block")
    info(phase, f"speculative on {card}: k={SPEC_K}, block {SPEC_BLOCK}, {dec.steps} verify forwards "
                f"for {dec.emitted} tokens ({dec.emitted / dec.steps:.3f} a forward; {SPEC_TOKENS} "
                f"kept); prefill + {SPEC_TOKENS} tokens {t_spec:.3f} s = {SPEC_TOKENS / t_spec:.2f} "
                f"tok/s against plain prefill + generate_from {t_plain:.3f} s = "
                f"{SPEC_TOKENS / t_plain:.2f} tok/s ({t_plain / t_spec:.3f}x); device busy "
                f"{busy:.3f} ms a verify forward against {plain_busy:.3f} a plain decode step "
                f"({busy / plain_busy:.3f}x; {coverage}); launches {counts}")
    return counts


def verify_delta(torch, eng, prompt: list[int], toks: list[int], phase: str) -> float:
    """The speculative streams' calibration on `eng`: one verify forward of
    the 1 + SPEC_K tokens `toks` after `prompt` and as many plain decode
    steps over them from the same cache must agree within 2e-2 of the
    logits' scale. Returns delta, twice their largest |difference|."""
    from gemma_tpu_torch.models import forward

    with torch.no_grad():
        _, cache = eng.prefill([prompt])
        ca, cb = clone_cache(cache), clone_cache(cache)
        toks = torch.tensor([toks], device=eng.device)
        pos = len(prompt) + torch.arange(1 + SPEC_K, dtype=torch.int32, device=eng.device)[None]
        verify = forward(eng.params, eng.cfg, toks, pos, ca, write_index=ca.length,
                         kv_limit=ca.length + 1 + SPEC_K)[0]
        steps = []
        for j in range(1 + SPEC_K):
            lg, cb = eng.decode_step(toks[:, j], cb)
            steps.append(lg[0])
        steps = torch.stack(steps)
        dmax = (verify - steps).abs().max().item()
        scale = steps.abs().max().item()
    delta = 2 * dmax
    info(phase, f"speculative logit check: {1 + SPEC_K} verify rows against {1 + SPEC_K} decode "
                f"steps over the same tokens, max|diff| {dmax:.4e} (tol {2e-2 * scale:.4e}, 2e-2 of "
                f"the logits' scale {scale:.3f}); delta = {delta:.4e}")
    require(dmax <= 2e-2 * scale, f"{phase}: verify logits differ from decode steps by {dmax} > "
                                  f"{2e-2 * scale}")
    return delta


def no_sync(torch, fn, what: str) -> None:
    """fn() under `torch.cuda.set_sync_debug_mode("error")`: a host sync
    inside it fails the phase."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        raise SmokeFailure(f"{what} synchronized with the host: {e}") from None
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    info("sync", f"{what}: no host sync under set_sync_debug_mode('error')")


def serve_requests(cfg, n: int = SERVE_REQUESTS, new_tokens: int = SERVE_NEW_TOKENS,
                   long: dict[int, int] | None = None):
    """Phase 6's requests: `n` of them, prompt lengths cycling
    SERVE_PROMPT_LENS (request r of `long` has long[r] tokens instead),
    token ids from a fixed recipe, `new_tokens` greedy tokens each, no EOS."""
    from gemma_tpu_torch.runtime import Request

    long = long or {}
    return [Request(f"r{r}", [2 + (r * 104729 + i * 7919) % (cfg.vocab_size - 2)
                              for i in range(long.get(r, SERVE_PROMPT_LENS[r % len(SERVE_PROMPT_LENS)]))],
                    max_new_tokens=new_tokens)
            for r in range(n)]


# phase 6's caches: (name, EngineConfig options, decode attention counter)
SERVE_RUNS = (
    ("dense bf16", {}, "decode_attention"),
    ("dense int8", {"kv_quantized": True}, "decode_attention_int8"),
    ("paged bf16", {"paged": True, "page_size": PAGE}, "paged_attention"),
    # prompts of 100 and 203 tokens prefill in 64-token chunks; the 203-token
    # ones (> 2 chunks) admit overlapped, one chunk per decode block
    ("paged int8", {"paged": True, "page_size": PAGE, "kv_quantized": True, "prefill_chunk": PAGE},
     "paged_attention_int8"),
)
# phase 6b's runs: dense bf16, then the same requests in a shuffled order
# admitted every 4 decode steps, so each request decodes in another slot
# beside other requests; rows are computed independently, so every stream
# must equal the first run's; then paged bf16 (64-token pages)
SERVE_7B_RUNS = (
    SERVE_RUNS[0],
    ("dense bf16, shuffled, block 4", {"block": 4, "shuffle_seed": 1}, "decode_attention"),
    SERVE_RUNS[2],
)
# phase 6c: ARCH_MODELS through `serve`, 8 slots, over dense and paged bf16
# (64-key pages), every paged stream equal to its dense stream (the paged
# route is the dense core on the gathered rows): (model, format, cache
# slots, {request: prompt tokens}). Gemma-3-4B's two 1100-token prompts
# pass its 1024-key window, so the window binds in a paged row
ARCH_SERVE_REQUESTS, ARCH_SERVE_NEW_TOKENS = 16, 48
ARCH_SERVE_RUNS = (SERVE_RUNS[0], SERVE_RUNS[2])
ARCH_SERVE_MODELS = (("Gemma-2-2B", "q4_k_m", MAX_SEQ_LEN, {}),
                     ("Gemma-3-4B", "q4_0", 2048, {5: 1100, 13: 1100}))


def serving(torch, dev, card: str, model_name: str, fmt: str, runs=SERVE_RUNS,
            spec: bool = False, make_requests=serve_requests,
            max_seq_len: int = MAX_SEQ_LEN, profile: bool = True) -> dict[str, dict[str, int]]:
    """Phases 6 (Gemma-2B q4_0, the four caches of SERVE_RUNS), 6b
    (Gemma-7B q8_0, SERVE_7B_RUNS) and 6c (ARCH_SERVE_MODELS): `serve` at
    full width over the model's first CUT_LAYERS layers, weights from
    make_params(seed=0), SERVE_SLOTS slots,
    `max_seq_len` slots a sequence, the requests of `make_requests(cfg)`,
    blocks of SERVE_BLOCK (or a run's "block"), greedy; a run with
    "shuffle_seed" submits the requests shuffled and must give the first
    run's streams; the paged bf16 run's streams must equal the dense bf16
    run's (the paged route is the dense core on the gathered rows). With
    `spec`, the speculative runs follow (`spec_serving`, against the delta
    of `verify_delta` on this model); with
    `profile`, a profiled dense run (`serving_profile`). Returns each run's
    launch counts."""
    from gemma_tpu_torch.runtime import Engine, EngineConfig, Request, serve

    cfg = model_config(model_name, cut=True)
    model = make_model(model_name, fmt, dev, cut=True)
    streams, counts_by_run, rates = {}, {}, {}
    for name, options, decode_kernel in runs:
        phase = f"serve {model_name} {fmt} {name}"
        options = dict(options)
        block, shuffle_seed = options.pop("block", SERVE_BLOCK), options.pop("shuffle_seed", None)
        eng = Engine(cfg, model, EngineConfig(max_seq_len=max_seq_len, max_batch=SERVE_SLOTS,
                                              **options))
        reqs = make_requests(cfg)
        if not streams:  # first launches and allocations of the serving path
            serve(eng, [Request(r.id, r.prompt[:SERVE_PROMPT_LENS[-1]], 8) for r in reqs[:4]],
                  block=SERVE_BLOCK)
            torch.cuda.synchronize()
        if shuffle_seed is not None:
            random.Random(shuffle_seed).shuffle(reqs)
        reset_counters()
        t0 = time.perf_counter()
        sched = serve(eng, reqs, block=block)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counters()
        st = sched.stats()
        require(len(sched.finished) == len(reqs) and all(
            len(r.tokens) == r.max_new_tokens and all(0 <= t < cfg.vocab_size for t in r.tokens)
            for r in sched.finished), f"{phase}: not every request finished with its in-range tokens")
        require(bool(torch.isfinite(sched._logits).all()), f"{phase}: logits are not finite")
        chunk = options.get("prefill_chunk", 0)
        prefills = sum(-(-len(r.prompt) // chunk) if chunk and len(r.prompt) > chunk else 1
                       for r in reqs)
        expected = expected_forward_launches(cfg, fmt, prefills, st["decode_steps"],
                                             decode_kernel)
        lens = sorted({len(r.prompt) for r in reqs})
        info(phase, f"{model_name} {fmt} ({depth(model_name, cfg)}), {SERVE_SLOTS} slots, "
                    f"{len(reqs)} requests x "
                    f"{reqs[0].max_new_tokens} tokens, prompts {lens}, block {block}, {max_seq_len} "
                    f"slots a sequence on {card}: {st['total_tokens'] / wall:.2f} tok/s aggregate "
                    f"(tokens / wall), "
                    f"TTFT p50 {st['p50_ttft_s'] * 1e3:.1f} ms p99 {st['p99_ttft_s'] * 1e3:.1f} ms, "
                    f"wall {wall:.3f} s, decode steps {st['decode_steps']}, tokens discarded "
                    f"{st['tokens_discarded']}, admission forwards {prefills}; launches {counts}")
        require(counts == expected, f"{phase}: launch counts {counts} != expected {expected}")
        # every decode call on its route's one-launch core: the tensor cores, or at G = 1 its own
        op = "paged_attention" if decode_kernel.startswith("paged_attention") else "decode_attention"
        core = f"{op}_{decode_route(cfg, paged=op == 'paged_attention', S=max_seq_len)[0]}"
        require(counts.get(core, 0) == counts[decode_kernel] > 0,
                f"{phase}: {counts.get(core, 0)} of {counts[decode_kernel]} decode calls took {core}")
        streams[name] = {r.id: r.tokens for r in sched.finished}
        counts_by_run[name] = counts
        rates[name] = (st["total_tokens"] / wall, st["p50_ttft_s"], st["p99_ttft_s"])
        del eng, sched
        torch.cuda.empty_cache()
    dense = streams["dense bf16"]
    # every run prefills each prompt into the same flash kernel: int8 caches
    # quantize the prompt's K/V, and on these weights no first token moved
    firsts = {name: sum(s[i][0] == dense[i][0] for i in dense) / len(dense)
              for name, s in streams.items()}
    if "paged bf16" in streams:
        same = sum(streams["paged bf16"][i] == dense[i] for i in dense)
        info("serve", f"{model_name} {fmt}: share of first tokens equal to the dense bf16 run's: "
                      f"{firsts}; {same} of {len(dense)} paged bf16 streams equal to the dense bf16 "
                      f"streams ({same / len(dense):.3f})")
        require(same == len(dense),
                f"serve {model_name} {fmt}: {len(dense) - same} paged streams differ from dense")
    require(all(v == 1.0 for v in firsts.values()), f"serve: first tokens differ across runs {firsts}")
    for name, options, _ in runs:
        if "shuffle_seed" in options:
            same = sum(streams[name][i] == dense[i] for i in dense)
            info("serve", f"{model_name} {fmt} {name}: {same} of {len(dense)} streams equal to "
                          "the dense bf16 run's")
            require(same == len(dense), f"serve {model_name} {fmt} {name}: {len(dense) - same} "
                                        "streams differ from the dense bf16 run's")
    if spec:
        eng = Engine(cfg, model, EngineConfig(max_seq_len=MAX_SEQ_LEN, max_batch=1))
        prompt = spec_prompt(cfg)
        delta = verify_delta(torch, eng, prompt, eng.generate([prompt], 1 + SPEC_K)[0],
                             f"serve {model_name} {fmt} speculative")
        del eng
        counts_by_run.update(spec_serving(torch, card, model_name, cfg, model, fmt, delta, rates))
        sampled_serving(torch, dev, card, model_name, cfg, model, fmt)
    if profile:
        serving_profile(torch, cfg, model, card, f"{model_name} {fmt}")
    del model
    torch.cuda.empty_cache()
    return counts_by_run


def arch_serving(torch, dev, card: str) -> dict[str, int]:
    """Phase 6c: `serving` of each of ARCH_SERVE_MODELS over ARCH_SERVE_RUNS,
    each model's phase time printed. Returns the runs' launches, summed."""
    total: dict[str, int] = {}
    for model_name, fmt, max_seq_len, long in ARCH_SERVE_MODELS:
        t0 = time.perf_counter()
        served = serving(torch, dev, card, model_name, fmt, runs=ARCH_SERVE_RUNS,
                         make_requests=lambda cfg: serve_requests(cfg, ARCH_SERVE_REQUESTS,
                                                                  ARCH_SERVE_NEW_TOKENS, long),
                         max_seq_len=max_seq_len, profile=False)
        for counts in served.values():
            add_counts(total, counts)
        info("time", f"phase 6c {model_name} {fmt} took {time.perf_counter() - t0:.1f} s")
    return total


# phase 6's non-greedy run: the sampler's three filters at once
SAMPLED = {"temperature": 1.0, "top_k": 64, "top_p": 0.95}
SAMPLED_NEW_TOKENS = 32
SAMPLER_DRAWS = 20000  # rows of one small-vocabulary logits row, phase 6's frequency check


def filtered_probs(logits, temperature: float, top_k: int, top_p: float):
    """The plain version of the sampler's filter on one row of logits
    (numpy, f64): temperature, then the top_k largest, then the smallest
    prefix of those, most probable first, whose mass reaches top_p (the
    first token always kept); the softmax over what is kept, 0 elsewhere."""
    import numpy as np

    z = np.asarray(logits, np.float64) / temperature
    order = np.argsort(-z, kind="stable")
    kept = order[:top_k] if 0 < top_k < z.size else order
    p = np.exp(z[kept] - z[kept].max())
    p /= p.sum()
    before = np.cumsum(p) - p  # mass of the more probable tokens
    kept = kept[before < top_p]
    out = np.zeros(z.size)
    out[kept] = np.exp(z[kept] - z[kept].max())
    return out / out.sum()


def sampled_serving(torch, dev, card: str, model_name: str, cfg, model, fmt: str) -> None:
    """Phase 6, non-greedy: `serve` on the dense bf16 cache with SAMPLED
    over phase 6's first SERVE_SLOTS requests, the first prompt given to
    four of them, SAMPLED_NEW_TOKENS tokens each, twice from one seed: every
    request finishes with in-range tokens, the launch counts are exact, and
    the second run repeats the first token for token; the share of the four
    identical prompts' streams that differ is printed. Then the sampler
    alone on the card: SAMPLER_DRAWS rows of one 64-token row of logits,
    each token's frequency within 5 binomial deviations of
    `filtered_probs`, and no draw of a filtered token."""
    import numpy as np

    from gemma_tpu_torch.runtime import (Engine, EngineConfig, Request, SamplingParams,
                                         sample, serve)

    phase = f"serve {model_name} {fmt} sampled"
    params = SamplingParams(**SAMPLED)
    base = serve_requests(cfg)[:SERVE_SLOTS]
    eng = Engine(cfg, model, EngineConfig(max_seq_len=MAX_SEQ_LEN, max_batch=SERVE_SLOTS))
    streams = []
    for _ in range(2):  # fresh requests each run: the scheduler fills them in
        reqs = [Request(r.id, base[0].prompt if i < 4 else r.prompt, SAMPLED_NEW_TOKENS)
                for i, r in enumerate(base)]
        reset_counters()
        t0 = time.perf_counter()
        sched = serve(eng, reqs, sampling=params, block=SERVE_BLOCK, seed=16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, st = read_counters(), sched.stats()
        got = {r.id: r.tokens for r in sched.finished}
        require(len(got) == len(reqs) and all(
            len(t) == SAMPLED_NEW_TOKENS and all(0 <= v < cfg.vocab_size for v in t)
            for t in got.values()), f"{phase}: not every request finished with "
                                    f"{SAMPLED_NEW_TOKENS} in-range tokens")
        expected = expected_forward_launches(cfg, fmt, len(reqs), st["decode_steps"],
                                             "decode_attention")
        require(counts == expected, f"{phase}: launch counts {counts} != expected {expected}")
        streams.append(got)
    require(streams[0] == streams[1], f"{phase}: two runs from one seed sampled different streams")
    same = [streams[0][reqs[i].id] for i in range(4)]
    differ = sum(same[i] != same[j] for i in range(4) for j in range(i + 1, 4)) / 6
    info(phase, f"{model_name} {fmt}, {len(reqs)} requests x {SAMPLED_NEW_TOKENS} tokens, "
                f"{SAMPLED} on {card}: wall {wall:.3f} s, decode steps {st['decode_steps']}; "
                f"two runs from seed 16 equal; share of the 6 pairs of the 4 identical prompts' "
                f"streams that differ: {differ:.3f}; launches {counts}")
    del eng, sched

    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    row = torch.randn(64, generator=gen, device=dev) * 2
    want = filtered_probs(row.cpu().numpy(), **SAMPLED)
    toks = sample(row.expand(SAMPLER_DRAWS, -1), params, gen).cpu().numpy()
    freq = np.bincount(toks, minlength=row.numel()) / SAMPLER_DRAWS
    slack = 5 * np.sqrt(want * (1 - want) / SAMPLER_DRAWS)
    worst = float(np.max(np.abs(freq - want) - slack))
    info(phase, f"sampler on the card: {SAMPLER_DRAWS} draws of one 64-token row, {SAMPLED}: "
                f"{int((want > 0).sum())} tokens kept, max |freq - p| "
                f"{np.abs(freq - want).max():.2e}, draws of filtered tokens "
                f"{int(freq[want == 0].sum() * SAMPLER_DRAWS)}")
    require(worst <= 0 and not freq[want == 0].any(),
            f"{phase}: sampled frequencies {freq} against the filtered softmax {want}")


# phase 6's speculative runs: (name, EngineConfig options, Scheduler options,
# shuffle seed). `serve(speculative=True)` (adaptive k) over the dense bf16
# and int8 caches; then k = 7 pinned, in admission order and shuffled: at a
# fixed k and B every row's arithmetic is its own, so the streams must match
SPEC_SERVE_RUNS = (
    ("dense bf16", {}, None, None),
    ("dense int8", {"kv_quantized": True}, None, None),
    ("dense bf16, k = 7", {}, {"spec_min_accept": 0.0}, None),
    ("dense bf16, k = 7, shuffled", {}, {"spec_min_accept": 0.0}, 1),
)


def spec_serving(torch, card: str, model_name: str, cfg, model, fmt: str, delta: float,
                 rates: dict) -> dict[str, dict[str, int]]:
    """Phase 6, speculative: SPEC_SERVE_RUNS over phase 6's requests
    (SERVE_SLOTS slots, k = SPEC_K, blocks of SPEC_BLOCK ticks, two in
    flight), each with exact launch counts (one admission forward a request,
    then one flash launch a layer a verify forward, no decode attention).
    Every stream of a run in admission order is teacher-forced through the
    plain decode path of its cache (8 sequences a batch) and must at every
    position be the plain argmax or lie within `delta` (`verify_delta`'s) of the
    plain maximum; the shuffled run must give its unshuffled run's streams.
    Then one batched block under set_sync_debug_mode("error"). Returns each
    run's launch counts."""
    from gemma_tpu_torch.runtime import Engine, EngineConfig, Request, Scheduler, serve

    streams, counts_by_run = {}, {}
    for name, options, sched_options, shuffle_seed in SPEC_SERVE_RUNS:
        phase = f"serve {model_name} {fmt} speculative {name}"
        ecfg = EngineConfig(max_seq_len=MAX_SEQ_LEN, max_batch=SERVE_SLOTS, **options)
        eng = Engine(cfg, model, ecfg)
        reqs = serve_requests(cfg)
        if shuffle_seed is not None:
            random.Random(shuffle_seed).shuffle(reqs)
        reset_counters()
        t0 = time.perf_counter()
        if sched_options is None:
            sched = serve(eng, reqs, speculative=True, spec_k=SPEC_K, spec_block=SPEC_BLOCK)
        else:
            sched = Scheduler(eng, speculative=True, spec_k=SPEC_K, spec_block=SPEC_BLOCK,
                              **sched_options)
            for r in reqs:
                sched.submit(r)
            sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, st = read_counters(), sched.stats()
        require(len(sched.finished) == SERVE_REQUESTS and all(
            len(r.tokens) == SERVE_NEW_TOKENS and all(0 <= t < cfg.vocab_size for t in r.tokens)
            for r in sched.finished), f"{phase}: not every request finished with "
                                      f"{SERVE_NEW_TOKENS} in-range tokens")
        expected = expected_forward_launches(cfg, fmt, len(reqs) + st["spec_forwards"], 0,
                                             "decode_attention")
        plain_rate, p50, p99 = rates[name.split(",")[0]]
        info(phase, f"{SERVE_SLOTS} slots, {SERVE_REQUESTS} requests x {SERVE_NEW_TOKENS} tokens "
                    f"on {card}: {st['total_tokens'] / wall:.2f} tok/s aggregate (plain "
                    f"{plain_rate:.2f}), TTFT p50 {st['p50_ttft_s'] * 1e3:.1f} ms p99 "
                    f"{st['p99_ttft_s'] * 1e3:.1f} ms (plain {p50 * 1e3:.1f}, {p99 * 1e3:.1f}), wall "
                    f"{wall:.3f} s; verify forwards {st['spec_forwards']} ({st['spec_lo_forwards']} "
                    f"of them k = 1), tokens / (verify forwards x {SERVE_SLOTS} slots) "
                    f"{st['total_tokens'] / st['spec_forwards'] / SERVE_SLOTS:.3f}, tokens "
                    f"discarded {st['tokens_discarded']}; "
                    f"launches {counts}")
        require(counts == expected, f"{phase}: launch counts {counts} != expected {expected}")
        streams[name] = {r.id: r.tokens for r in sched.finished}
        counts_by_run[f"speculative {name}"] = counts
        if shuffle_seed is None:
            by_id = {r.id: r for r in sched.finished}
            plain_eng = Engine(cfg, model, ecfg)
            ids = sorted(by_id, key=lambda i: int(i[1:]))
            gaps = torch.cat([teacher_forced_gaps(torch, plain_eng,
                                                  [by_id[i].prompt for i in ids[g:g + SERVE_SLOTS]],
                                                  [by_id[i].tokens for i in ids[g:g + SERVE_SLOTS]])
                              for g in range(0, len(ids), SERVE_SLOTS)], dim=1)
            off = int((gaps > 0).sum())
            info(phase, f"streams teacher-forced through plain decode ({name.split(',')[0]} cache): "
                        f"{off} of {gaps.numel()} tokens not the plain argmax, largest gap "
                        f"{float(gaps.max()):.4e} (delta {delta:.4e})")
            require(float(gaps.max()) <= delta, f"{phase}: a token lies {float(gaps.max())} below "
                                                f"the plain maximum (delta {delta})")
        else:
            base = streams[name.rsplit(",", 1)[0]]
            same = sum(streams[name][i] == base[i] for i in base)
            info(phase, f"{same} of {len(base)} streams equal to the unshuffled run's")
            require(same == len(base), f"{phase}: {len(base) - same} streams differ")
        del eng, sched
    eng = Engine(cfg, model, EngineConfig(max_seq_len=MAX_SEQ_LEN, max_batch=SERVE_SLOTS))
    sched = Scheduler(eng, speculative=True, spec_k=SPEC_K, spec_block=SPEC_BLOCK)
    for r in serve_requests(cfg)[:SERVE_SLOTS]:
        sched.submit(Request(r.id, r.prompt, SERVE_NEW_TOKENS))
    sched._admit()
    require(len(sched.active) == SERVE_SLOTS, "speculative no-sync check: slots not all admitted")
    no_sync(torch, lambda: sched.spec.batch_block(sched._sp_carry, sched.cache),
            f"serve {model_name} {fmt} batched speculative block ({SERVE_SLOTS} slots)")
    torch.cuda.empty_cache()
    return counts_by_run


def serving_profile(torch, cfg, model, card: str, label: str) -> None:
    """The first wave of the dense bf16 serving run (one request per slot)
    once more under torch.profiler (device activity only): device busy
    time against the run's wall time, and the largest kernels. Profiling
    slows the host, so this run's tok/s is not the one reported above."""
    from torch.profiler import ProfilerActivity, profile

    from gemma_tpu_torch.runtime import Engine, EngineConfig, serve

    eng = Engine(cfg, model, EngineConfig(max_seq_len=MAX_SEQ_LEN, max_batch=SERVE_SLOTS))
    reqs = serve_requests(cfg)[:SERVE_SLOTS]
    before = read_counters()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched = serve(eng, reqs, block=SERVE_BLOCK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = sorted(((getattr(e, "self_device_time_total", 0) / 1e3, e.key)
                         for e in prof.key_averages()), reverse=True)
    busy = sum(ms for ms, _ in per_kernel) / 1e3
    require(busy > 0, "the profiled serving run recorded no device time")
    combines = sum(e.count for e in prof.key_averages() if "attend_combine_kernel" in e.key)
    require(combines == 0, f"serve {label}: {combines} split-S attention combines launched")
    steps = sched.stats()["decode_steps"]
    info(f"serve {label} dense bf16 profiled", f"{len(reqs)} requests on {card}: wall {wall:.3f} s, "
                                      f"device busy {busy:.3f} s, "
                                      f"idle share {1 - busy / wall:.3f}; {steps} decode steps, "
                                      f"{combines} attention combines; "
                                      f"{profiler_coverage(prof, before)}; "
                                      "device s by kernel: " + "; ".join(
                                          f"{name[:48]} {ms / 1e3:.3f}" for ms, name in per_kernel[:6]))


# phase 5's f32 serving runs, card against CPU: (name, paged, int8 cache, the
# decode calls' counter, the counter of those on the decode core's f32
# policy, which must be all of them)
TINY_F32_SERVE = (("paged f32", True, False, "paged_attention", "paged_attention_tf32"),
                  ("paged int8", True, True, "paged_attention_int8", "paged_attention_tf32_int8"),
                  ("dense int8", False, True, "decode_attention_int8", "decode_attention_tf32_int8"))


def tiny_serving_checks(torch, dev) -> dict[str, int]:
    """Phase 5, serving: the CLI `serve --device cuda --paged --kv-quant` in a
    subprocess against the in-process `serve`, then serving on the card
    against the CPU in f32 over TINY_F32_SERVE's caches (paged f32 and int8,
    dense int8): equal streams, every decode call on the decode core's f32
    policy. Returns those runs' launches on the card, summed."""
    from gemma_tpu_torch import cli
    from gemma_tpu_torch.runtime import Engine, EngineConfig, Request, serve
    from gemma_tpu_torch.testing import TINY_KERNEL_CONFIG, make_gguf

    texts = ["hello world", "the hello", "world of the worlds and hello", "a", "hello " * 40]
    flags = ["--batch", "4", "--paged", "--kv-quant", "--page-size", "64", "--prefill-chunk",
             "64", "--max-seq-len", "256", "--max-new-tokens", "12", "--block", "4", "--no-eos"]
    with tempfile.TemporaryDirectory() as tmp:
        path = make_gguf(Path(tmp) / "tiny.gguf", TINY_KERNEL_CONFIG, seed=0)
        (Path(tmp) / "p.txt").write_text("\n".join(texts) + "\n")
        before = read_counters()
        proc = subprocess.run(
            [sys.executable, "-m", "gemma_tpu_torch", "serve", str(path), "--device", "cuda",
             "--prompts-file", str(Path(tmp) / "p.txt"), *flags],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
        )
        require(proc.returncode == 0, f"CLI serve failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        cli_texts = [json.loads(line)["text"] for line in proc.stdout.strip().splitlines()]
        cfg, model_gpu, tok = cli.load(path, dev)
        ecfg = dict(max_seq_len=256, max_batch=4, paged=True, page_size=64, kv_quantized=True,
                    prefill_chunk=64)
        sched = serve(Engine(cfg, model_gpu, EngineConfig(**ecfg)),
                      [Request(f"r{i}", tok.encode(t), 12) for i, t in enumerate(texts)], block=4)
        ours = [tok.decode(r.tokens) for r in sorted(sched.finished, key=lambda r: int(r.id[1:]))]
        require(cli_texts == ours, f"CLI serve printed {cli_texts}, in-process serve {ours}")
        after = read_counters()
        require(after["paged_attention_int8"] > before["paged_attention_int8"],
                "tiny serve did not launch the int8 paged kernel")

        _, model_cpu, _ = cli.load(path, "cpu")
        cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
        prompts = [tok.encode(t) for t in texts]
        results, total = {}, {}
        for name, paged, quant, calls, core in TINY_F32_SERVE:
            ecfg32 = EngineConfig(max_seq_len=256, max_batch=4, kv_dtype=torch.float32,
                                  paged=paged, page_size=64, kv_quantized=quant, prefill_chunk=64)
            runs = []
            for m in (model_gpu, model_cpu):
                reset_counters()
                runs.append(serve(Engine(cfg32, m, ecfg32),
                                  [Request(f"r{i}", p, 16) for i, p in enumerate(prompts)], block=4))
                if m is model_gpu:
                    counts = read_counters()
            gpu, cpu = ({r.id: r.tokens for r in s.finished} for s in runs)
            results[name] = f"streams {'equal' if gpu == cpu else 'DIFFER'}, {counts[core]} {core}"
            require(gpu == cpu, f"tiny f32 serving, {name}: card streams {gpu} != CPU {cpu}")
            require(counts[core] > 0 and counts[core] == counts[calls],
                    f"tiny f32 serving, {name}: {counts[core]} of {counts[calls]} decode calls took {core}")
            add_counts(total, counts)
    info("tiny", f"serve: CLI on cuda (paged int8, chunk 64) prints the in-process serve's texts; "
                 f"f32 serving card vs CPU: {results}")
    return total


def tiny_spec_checks(torch, dev) -> None:
    """Phase 5, speculative: `generate --speculative` and `serve
    --speculative` (dense cache) on the card in subprocesses, their texts
    equal to the in-process SpecDecoder's and serve's, on a tiny q4_0 GGUF
    (TINY_KERNEL_CONFIG); then the tiny model in f32 on the card against the
    same model on the CPU: SpecDecoder and speculative serving streams
    equal, with drafts accepted (more tokens than verify forwards)."""
    from gemma_tpu_torch import cli
    from gemma_tpu_torch.runtime import Engine, EngineConfig, Request, SpecDecoder, serve
    from gemma_tpu_torch.testing import TINY_KERNEL_CONFIG, make_gguf

    prompt = [1, 7, 300, 42, 260, 9, 77, 5, 400, 13, 2, 100]
    texts = ["hello world", "the hello", "world of the worlds and hello", "a", "hello " * 40]
    n_new = 16
    with tempfile.TemporaryDirectory() as tmp:
        path = make_gguf(Path(tmp) / "tiny.gguf", TINY_KERNEL_CONFIG, seed=0)
        (Path(tmp) / "p.txt").write_text("\n".join(texts) + "\n")
        gen_cmd = ["generate", str(path), "--device", "cuda", "--tokens", ",".join(map(str, prompt)),
                   "--max-new-tokens", str(n_new), "--no-eos", "--speculative"]
        serve_flags = ["--batch", "4", "--max-seq-len", "256", "--max-new-tokens", "12", "--no-eos",
                       "--speculative"]
        serve_cmd = ["serve", str(path), "--device", "cuda", "--prompts-file",
                     str(Path(tmp) / "p.txt"), *serve_flags]
        out = {}
        for name, cmd in (("generate", gen_cmd), ("serve", serve_cmd)):
            proc = subprocess.run([sys.executable, "-m", "gemma_tpu_torch", *cmd], cwd=ROOT,
                                  capture_output=True, text=True, timeout=600)
            require(proc.returncode == 0, f"CLI {name} --speculative failed ({proc.returncode}):\n"
                                          f"{proc.stderr[-4000:]}")
            out[name] = proc
        cfg, model_gpu, tok = cli.load(path, dev)
        before = read_counters()
        gpu_spec = SpecDecoder(Engine(cfg, model_gpu, EngineConfig(max_seq_len=512)), k=SPEC_K)
        text = tok.decode(gpu_spec.generate(prompt, n_new))
        require(read_counters()["flash_attention_tc"] > before["flash_attention_tc"],
                "tiny speculative generate launched no flash kernel")
        require(out["generate"].stdout == text + "\n",
                f"CLI generate --speculative printed {out['generate'].stdout!r}, in-process {text!r}")
        sched = serve(Engine(cfg, model_gpu, EngineConfig(max_seq_len=256, max_batch=4)),
                      [Request(f"r{i}", tok.encode(t), 12) for i, t in enumerate(texts)],
                      speculative=True)
        ours = [tok.decode(r.tokens) for r in sorted(sched.finished, key=lambda r: int(r.id[1:]))]
        cli_texts = [json.loads(line)["text"] for line in out["serve"].stdout.strip().splitlines()]
        require(cli_texts == ours, f"CLI serve --speculative printed {cli_texts}, in-process {ours}")

        _, model_cpu, _ = cli.load(path, "cpu")
        cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
        ecfg32 = dict(max_seq_len=256, kv_dtype=torch.float32)
        decs = [SpecDecoder(Engine(cfg32, m, EngineConfig(**ecfg32)), k=SPEC_K, block=SPEC_BLOCK)
                for m in (model_gpu, model_cpu)]
        gpu, cpu = (d.generate(prompt, 24) for d in decs)
        require(gpu == cpu, f"tiny f32 SpecDecoder: card {gpu} != CPU {cpu}")
        require(decs[0].emitted > decs[0].steps, f"tiny f32 SpecDecoder: no draft accepted "
                                                 f"({decs[0].steps} verify forwards)")
        prompts = [tok.encode(t) for t in texts]
        runs = [serve(Engine(cfg32, m, EngineConfig(max_batch=4, **ecfg32)),
                      [Request(f"r{i}", p, 16) for i, p in enumerate(prompts)], speculative=True)
                for m in (model_gpu, model_cpu)]
        g_streams, c_streams = ({r.id: r.tokens for r in s.finished} for s in runs)
        require(g_streams == c_streams, f"tiny f32 speculative serving: card {g_streams} != CPU "
                                        f"{c_streams}")
        st = runs[0].stats()
        require(0 < st["spec_forwards"] < st["total_tokens"],
                f"tiny f32 speculative serving stats {st}")
    info("tiny", f"speculative: CLI generate and serve --speculative on cuda print the in-process "
                 f"texts; f32 card vs CPU: SpecDecoder streams equal ({decs[0].steps} verify "
                 f"forwards for {decs[0].emitted} tokens), speculative serving streams equal "
                 f"({st['spec_forwards']} verify forwards, {st['total_tokens']} tokens)")


# phase 5's tiny models: (format, config of gemma_tpu_torch.testing, GGUF
# architecture). TINY_KERNEL_CONFIG (MQA, every K a multiple of 256) for
# q4_0 and q4_k_m, TINY_MHA_CONFIG (multi-head, q_dim != d_model) for q8_0;
# then Gemma-2 and Gemma-3 at the kernels' widths (G = 2 and 4, 16-key
# windows, softcaps, QK-norm, split rope bases) in every format, their
# streams longer than the window, also served dense and paged
TINY_RUNS = (("q4_0", "TINY_KERNEL_CONFIG", "gemma"), ("q4_k_m", "TINY_KERNEL_CONFIG", "gemma"),
             ("q8_0", "TINY_MHA_CONFIG", "gemma"),
             *((fmt, name, arch) for name, arch in (("TINY_GEMMA2_KERNEL_CONFIG", "gemma2"),
                                                    ("TINY_GEMMA3_KERNEL_CONFIG", "gemma3"))
               for fmt in ("q4_0", "q4_k_m", "q8_0")))
TINY_PROMPT = [1, 7, 300, 42, 260, 9, 77, 5, 400, 13, 2, 100]
TINY_NEW_TOKENS = 16
TINY_PAGE = 16


def tiny_checks(torch, dev, runs=TINY_RUNS) -> None:
    """Phase 5: the CLI on the card, and the card against the CPU, on a tiny
    GGUF of each of `runs` (`make_gguf(..., arch=)`). Every file's `generate
    --device cuda` subprocess starts first, all at once; then each model in
    process: TINY_NEW_TOKENS greedy tokens from TINY_PROMPT with exact launch
    counts, the CLI's text equal to theirs; f32 prefill logits within 1e-3
    of scale of the same model on the CPU and the greedy streams equal; bf16
    within 5e-2. A Gemma-2 or Gemma-3 model (16-key window: the stream
    passes it) is also served through `serve` on the card over dense and
    paged (TINY_PAGE-key pages) bf16 caches with exact launch counts and
    equal streams, and over a paged f32 cache equal to the CPU's streams."""
    from gemma_tpu_torch import cli, testing
    from gemma_tpu_torch.runtime import Engine, EngineConfig

    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for weight_type, config_name, arch in runs:
            path = testing.make_gguf(Path(tmp) / f"{config_name}_{weight_type}.gguf",
                                     getattr(testing, config_name), seed=0, weight_type=weight_type,
                                     arch=arch)
            procs.append((path, subprocess.Popen(
                [sys.executable, "-m", "gemma_tpu_torch", "generate", str(path), "--device", "cuda",
                 "--tokens", ",".join(map(str, TINY_PROMPT)), "--max-new-tokens",
                 str(TINY_NEW_TOKENS), "--no-eos"],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        try:
            for (weight_type, config_name, arch), (path, proc) in zip(runs, procs):
                cfg, model_gpu, tok = cli.load(path, dev)
                _, model_cpu, _ = cli.load(path, "cpu")
                reset_counters()
                gpu_toks = Engine(cfg, model_gpu, EngineConfig(max_seq_len=256)).generate(
                    [TINY_PROMPT], TINY_NEW_TOKENS)[0]
                counts = read_counters()
                expected = expected_forward_launches(cfg, weight_type, 1, TINY_NEW_TOKENS,
                                                     "decode_attention")
                require(counts == expected, f"tiny {weight_type} {config_name}: launch counts {counts} "
                                            f"!= expected {expected}")
                text = tok.decode(gpu_toks)
                out, cli_err = proc.communicate(timeout=600)
                require(proc.returncode == 0, f"CLI failed ({proc.returncode}):\n{cli_err[-4000:]}")
                require(out == text + "\n", f"CLI printed {out!r}, in-process run {text!r}")

                # f32 activations and cache: the kernels' f32 arms against the
                # plain path on the CPU; identical products, sums in another order
                cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
                ecfg32 = EngineConfig(max_seq_len=256, kv_dtype=torch.float32)
                e_gpu, e_cpu = Engine(cfg32, model_gpu, ecfg32), Engine(cfg32, model_cpu, ecfg32)
                lg, _ = e_gpu.prefill([TINY_PROMPT])
                lc, _ = e_cpu.prefill([TINY_PROMPT])
                err = (lg.cpu() - lc).abs().max().item()
                tol = 1e-3 * lc.abs().max().item()
                toks_g = e_gpu.generate([TINY_PROMPT], TINY_NEW_TOKENS)[0]
                toks_c = e_cpu.generate([TINY_PROMPT], TINY_NEW_TOKENS)[0]
                # bf16 activations: rounding points agree, rounding inputs differ
                # in their last bits, so only the prefill logits' scale is held
                lgb, _ = Engine(cfg, model_gpu, EngineConfig(max_seq_len=256)).prefill([TINY_PROMPT])
                lcb, _ = Engine(cfg, model_cpu, EngineConfig(max_seq_len=256)).prefill([TINY_PROMPT])
                err_b = (lgb.cpu() - lcb).abs().max().item()
                tol_b = 5e-2 * lcb.abs().max().item()
                served = tiny_serve(torch, cfg, model_gpu, model_cpu, weight_type) if arch != "gemma" else ""
                info("tiny", f"{weight_type} {config_name} ({arch}): CLI on cuda: its "
                             f"{TINY_NEW_TOKENS} tokens' text equals the in-process run's; launches "
                             f"exact {({k: n for k, n in counts.items() if n})}; card vs CPU, f32: "
                             f"prefill logits max|diff|={err:.3e} (tol {tol:.3e}), greedy streams "
                             f"{'equal' if toks_g == toks_c else 'DIFFER'}; bf16: max|diff|={err_b:.3e} "
                             f"(tol {tol_b:.3e}){served}")
                require(err <= tol, f"f32 prefill logits card vs CPU: {err} > {tol}")
                require(toks_g == toks_c, f"f32 greedy streams differ: {toks_g} vs {toks_c}")
                require(err_b <= tol_b, f"bf16 prefill logits card vs CPU: {err_b} > {tol_b}")
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()


def tiny_serve(torch, cfg, model_gpu, model_cpu, fmt: str) -> str:
    """`serve` of a tiny model on the card: 6 requests of prompts up to 40
    tokens and 12 tokens each, 4 slots, over dense and paged bf16 caches
    (exact launches; paged on the tensor-core route, its streams the dense
    ones), then over a paged f32 cache against the CPU's streams."""
    from gemma_tpu_torch.runtime import Engine, EngineConfig, Request, serve

    prompts = [[2 + (r * 31 + i * 7) % (cfg.vocab_size - 2) for i in range(n)]
               for r, n in enumerate((5, 12, 17, 24, 33, 40))]
    streams = {}
    for name, opts, kernel in (("dense", {}, "decode_attention"),
                               ("paged", {"paged": True, "page_size": TINY_PAGE}, "paged_attention")):
        reset_counters()
        sched = serve(Engine(cfg, model_gpu, EngineConfig(max_seq_len=128, max_batch=4, **opts)),
                      [Request(f"r{i}", p, 12) for i, p in enumerate(prompts)], block=4)
        counts = read_counters()
        expected = expected_forward_launches(cfg, fmt, len(prompts), sched.stats()["decode_steps"], kernel)
        require(counts == expected, f"tiny serve {name}: launch counts {counts} != expected {expected}")
        streams[name] = {r.id: r.tokens for r in sched.finished}
    require(streams["paged"] == streams["dense"], f"tiny serve: paged streams {streams['paged']} != "
                                                  f"dense {streams['dense']}")
    cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
    ecfg32 = EngineConfig(max_seq_len=128, max_batch=4, kv_dtype=torch.float32, paged=True,
                          page_size=TINY_PAGE)
    gpu, cpu = ({r.id: r.tokens for r in serve(Engine(cfg32, m, ecfg32), [Request(f"r{i}", p, 12)
                 for i, p in enumerate(prompts)], block=4).finished} for m in (model_gpu, model_cpu))
    require(gpu == cpu, f"tiny f32 paged serving: card {gpu} != CPU {cpu}")
    return (f"; serve dense and paged bf16: {len(prompts)} streams equal, launches exact; paged f32 "
            f"card vs CPU streams equal")


# phase 7: the decode-GEMV instruments, kernels of the reference's tools/
TOOL_KERNELS = {
    "qmm_variant": ("gemma_tpu_torch/csrc/q4_0_matmul.cu",
                    "tools/bench_qmm_variants.py:55 _kernel; tools/probe_int4.py:43 kernel, "
                    ":81 kernel2"),
    "row_checksum": ("gemma_tpu_torch/csrc/qmm_variants.cu",
                     "tools/bench_qmm_variants.py:55 _kernel (stream); "
                     "tools/bench_q6k_variants.py:68 _kernel (stream)"),
    "q4_0_gemv_warps": ("gemma_tpu_torch/csrc/q4_0_matmul.cu", "tools/bench_bn_sweep.py:43 call"),
    "q4_k_variant": ("gemma_tpu_torch/csrc/q4_k_matmul.cu", "tools/bench_q4k_variants.py:40 _kernel"),
    "q6_k_variant": ("gemma_tpu_torch/csrc/q6_k_matmul.cu", "tools/bench_q6k_variants.py:68 _kernel"),
    "int4_dot": ("gemma_tpu_torch/csrc/qmm_variants.cu", "tools/probe_int4.py:120 kernel3"),
}
TOOLS = ("bench_qmm_variants", "bench_bn_sweep", "probe_int4", "bench_q4k_variants",
         "bench_q6k_variants")
INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate (data sheet)


def check_tool_kernels(torch, dev) -> dict[str, dict]:
    """Phase 7: every mode of the instruments' kernels against its plain
    version on the card at the tools' Gemma-2B shapes (M = 8, bf16 x):
    1e-4 x max|ref| for float modes (f32 products, sums in another order;
    the bf16-rounded modes round the same weights on both sides), exact for
    the checksum and the int32 dot. The launches of these checks are
    counted and must equal the checks made. Then each kernel's
    representative shape: L2-cold device time, plain time (warm),
    bound, and a library call's L2-cold time. Returns the JSON records."""
    import gemma_tpu_torch.ops.qmm_variants as qv
    from gemma_tpu_torch.ops.quant_matmul import q4_0_matmul_plain
    from gemma_tpu_torch.quant.qtensor import dequant
    from gemma_tpu_torch.tools import bench_bn_sweep, bench_qmm_variants
    from gemma_tpu_torch.tools._timing import random_qtensor

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    M = qv.GEMV_M
    for op in qv.COUNTERS.values():
        op.launches = 0
    made = {name: 0 for name in qv.COUNTERS}
    worst = {name: 0.0 for name in qv.COUNTERS}

    def held(name, desc, got, ref, exact=False):
        torch.cuda.synchronize()
        made[name] += 1
        if exact:
            require(torch.equal(got, ref), f"{name} {desc}: differs from its plain version")
            return
        err = (got - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item() + 1e-6
        require(bool(torch.isfinite(got).all()) and err <= tol,
                f"{name} {desc}: max|diff| {err} > tol {tol}")
        worst[name] = max(worst[name], err)

    x8 = {}
    for sname, N, K in bench_qmm_variants.SHAPES:
        qt = random_qtensor("q4_0", N, K, gen, dev)
        x = x8[K] = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        for mode, scd, _ in bench_qmm_variants.CONFIGS:
            sc = qt.scales.to(scd)
            if mode == "stream":
                held("row_checksum", f"q4_0 {sname}", qv.row_checksum(qt.qs, sc),
                     qv.row_checksum_plain(qt.qs, sc), exact=True)
            else:
                held("qmm_variant", f"{mode} {scd} {sname}", qv.qmm_variant(mode, x, qt.qs, sc),
                     qv.qmm_variant_plain(mode, x, qt.qs, sc))
        del qt
    for sname, N, K in bench_bn_sweep.SHAPES:
        qt = random_qtensor("q4_0", N, K, gen, dev)
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        ref = q4_0_matmul_plain(x, qt)
        for warps in qv.WARPS:
            held("q4_0_gemv_warps", f"{warps} warps {sname}", qv.q4_0_gemv_warps(x, qt, warps), ref)
        del qt, ref
    N, K = 2048, 16384  # ffn_down
    xd = x8[K]
    q4k = random_qtensor("q4_k", N, K, gen, dev)
    q4k_w = {"prod": q4k, "nohilo": qv.q4_k_hi_parts(q4k), "noaffine": q4k, "nosub": q4k,
             "q4_0ref": qv.q4_0ref_weight(q4k)}
    for mode, w in q4k_w.items():
        held("q4_k_variant", f"{mode} ffn_down", qv.q4_k_variant(mode, xd, w),
             qv.q4_k_variant_plain(mode, xd, w))
    q6k = random_qtensor("q6_k", N, K, gen, dev)
    q6k_w = {"prod": qv.q6_k_int8_payload(q6k), "split_f32": q6k.arrays, "split_int": q6k.arrays}
    for mode, arrays in q6k_w.items():
        held("q6_k_variant", f"{mode} ffn_down", qv.q6_k_variant(mode, xd, arrays),
             qv.q6_k_variant_plain(mode, xd, arrays))
    planes = tuple(q6k.arrays.values())
    held("row_checksum", "q6_k planes ffn_down", qv.row_checksum(*planes),
         qv.row_checksum_plain(*planes), exact=True)
    int4 = {}
    for sname, (N4, K4) in (("probe", (256, 512)), ("ffn_down", (N, K))):
        xi = torch.randint(-128, 128, (M, K4), generator=gen, device=dev, dtype=torch.int8)
        w4 = torch.randint(0, 256, (N4, K4 // 2), generator=gen, device=dev, dtype=torch.uint8)
        held("int4_dot", f"{sname} [{M}, {K4}] x [{K4}, {N4}]", qv.int4_dot(xi, w4),
             qv.int4_dot_plain(xi, w4), exact=True)
        int4[sname] = (xi, w4)
    counts = {name: op.launches for name, op in qv.COUNTERS.items()}
    info("tools", f"instrument kernels within tolerance against their plain versions; worst "
                  f"max|diff| {worst}; launches {counts} (checks made {made})")
    require(counts == made, f"phase 7 launch counts {counts} != checks made {made}")

    # each kernel's representative shape: cold time, plain, bound, library
    results = {}

    def timed(name, shape, kernel, plain, args, nbytes, ops, peak, library=None, lib_args=None,
              lib_name="none"):
        ms = cold_ms(kernel, args, dev)
        plain_ms = device_ms(torch, lambda: plain(*args), launches=1)
        bound_ms, bound_by = bound(nbytes, ops, peak)
        library_ms = cold_ms(library, lib_args, dev) if library is not None else None
        results[name] = {"max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                         "shape": shape}
        info("tools", f"{name} {shape}: device ms, L2 cold: kernel {ms:.4f} library ({lib_name}) "
                      f"{'none' if library_ms is None else f'{library_ms:.4f}'}; plain "
                      f"{plain_ms:.4f}; bound {bound_ms:.4f} ({bound_by})")

    def matmul_yardstick(w16):
        return (lambda x_, w_: torch.matmul(x_, w_.T)), (xd, w16)

    qt = random_qtensor("q4_0", N, K, gen, dev)
    lib, lib_args = matmul_yardstick(dequant(qt, torch.bfloat16))
    wire = qt.qs.numel() + qt.scales.numel() * 2
    timed("qmm_variant", f"f32dot f16 scales ffn_down M=8 N={N} K={K}",
          lambda *a: qv.qmm_variant("f32dot", *a), lambda *a: qv.qmm_variant_plain("f32dot", *a),
          (xd, qt.qs, qt.scales), wire + xd.numel() * 2 + M * N * 4, 2 * M * N * K, BF16_FLOPS,
          lib, lib_args, "bf16 matmul, weight dequantized beforehand")
    sc_bits = qt.scales.view(torch.int16)
    timed("row_checksum", f"q4_0 ffn_down N={N} K={K}", qv.row_checksum, qv.row_checksum_plain,
          (qt.qs, qt.scales), wire + N * 4, 0, BF16_FLOPS,
          lambda a, b: (torch.sum(a, -1, dtype=torch.int32), torch.sum(b, -1, dtype=torch.int32)),
          (qt.qs, sc_bits), "torch.sum of the payload and of the scale bits, two calls")
    timed("q4_0_gemv_warps", f"8 warps ffn_down M=8 N={N} K={K}",
          lambda *a: qv.q4_0_gemv_warps(*a, 8), q4_0_matmul_plain, (xd, qt),
          wire + xd.numel() * 2 + M * N * 4, 2 * M * N * K, BF16_FLOPS, lib, lib_args,
          "bf16 matmul, weight dequantized beforehand")
    del qt, lib_args
    lib, lib_args = matmul_yardstick(dequant(q4k, torch.bfloat16))
    timed("q4_k_variant", f"prod ffn_down M=8 N={N} K={K}", lambda *a: qv.q4_k_variant("prod", *a),
          lambda *a: qv.q4_k_variant_plain("prod", *a), (xd, q4k),
          sum(a.numel() * a.element_size() for a in q4k.arrays.values()) + xd.numel() * 2
          + M * N * 4, 2 * M * N * K, BF16_FLOPS, lib, lib_args,
          "bf16 matmul, weight dequantized beforehand")
    lib, lib_args = matmul_yardstick(dequant(q6k, torch.bfloat16))
    payload = q6k_w["prod"]
    timed("q6_k_variant", f"prod (int8 payload) ffn_down M=8 N={N} K={K}",
          lambda *a: qv.q6_k_variant("prod", *a), lambda *a: qv.q6_k_variant_plain("prod", *a),
          (xd, payload), sum(a.numel() * a.element_size() for a in payload.values())
          + xd.numel() * 2 + M * N * 4, 2 * M * N * K, BF16_FLOPS, lib, lib_args,
          "bf16 matmul, weight dequantized beforehand")
    del lib_args
    xi, w4 = int4["ffn_down"]
    w8 = qv.int4_values(w4)
    xpad = torch.zeros(32, K, dtype=torch.int8, device=dev)
    xpad[:M] = xi
    timed("int4_dot", f"ffn_down [{M}, {K}] x [{K}, {N}]", qv.int4_dot, qv.int4_dot_plain, (xi, w4),
          xi.numel() + w4.numel() + M * N * 4, 2 * M * N * K, INT8_OPS,
          lambda a, b: torch._int_mm(a, b.t()), (xpad, w8),
          "torch._int_mm on int8 weights, x padded to 32 rows (its shape rule m > 16)")
    return results


def run_tools(dev) -> dict[str, int]:
    """Phase 7, the benches: the first of TOOLS as a user runs it, `python
    -m gemma_tpu_torch.tools.<name>` in a subprocess on the card, the others
    through their `main([])` in this process (a process costs ~10 s to
    start and reach the card); each holds its kernels against their plain
    versions, times them L2 cold and checks its own launch counts (its
    tally counts from 0). Returns the launches they report, summed by
    kernel."""
    import contextlib
    import importlib
    import io

    launches: dict[str, int] = {}
    for i, name in enumerate(TOOLS):
        t0 = time.perf_counter()
        if i == 0:
            proc = subprocess.run([sys.executable, "-m", f"gemma_tpu_torch.tools.{name}"], cwd=ROOT,
                                  capture_output=True, text=True, timeout=600)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        else:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = importlib.import_module(f"gemma_tpu_torch.tools.{name}").main([])
            out, err = buf.getvalue(), ""
        for line in out.splitlines():
            info(f"tool {name}", line)
        require(rc == 0, f"tools.{name} failed ({rc}):\n{err[-4000:]}")
        reported = [json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
                    if line.startswith("launches ")]
        require(len(reported) == 1 and all(n > 0 for n in reported[0].values()),
                f"tools.{name} reported launches {reported}")
        for k, n in reported[0].items():
            launches[k] = launches.get(k, 0) + n
        info("tools", f"tools.{name} passed in {time.perf_counter() - t0:.1f} s"
                      + (" (a subprocess)" if i == 0 else " (in this process)"))
    require(set(launches) == set(TOOL_KERNELS), f"the tools launched {sorted(launches)}")
    return launches


# phase 8: the quality gates. Perplexity (f32 activations: the kernels'
# evaluation routes) at full width over PPL_WINDOWS windows of PPL_WINDOW
# seeded token ids, against the same through the plain versions on the
# card; `verify_device_kernels` at full width over three caches; the f32
# routes timed at the windows' shapes; the CLI's new commands on tiny files
PPL_WINDOW, PPL_WINDOWS = 512, 2
PPL_MODELS = (("Gemma-2B", "q4_0"), ("Gemma-2B", "q4_k_m"), ("Gemma-7B", "q8_0"))
# (model, format, bf16 tolerance: None for the reference's absolute 0.05,
# else a fraction of the logits' scale). With bf16 activations a sum that
# lands on the other side of a bf16 rounding is carried through every
# later layer: at Gemma-7B width (28 layers, logits up to ~12) kernels and
# plain versions differ by 0.10-0.14, where f32 activations on the same
# weights read 2-4e-5 and Gemma-2B bf16 5-7e-3 (NVIDIA H100 80GB HBM3).
# So the reference's 0.05 does not hold there: Gemma-7B bf16 is held to
# 2e-2 of the logits' scale (phase 4's verify-against-decode criterion),
# and the line says whether 0.05 held; f32 to 0.05 everywhere.
VERIFY_MODELS = (("Gemma-2B", "q4_0", None), ("Gemma-7B", "q8_0", 2e-2))
# (name, verify_device_kernels options, the decode attention counter,
# activation dtype)
VERIFY_CACHES = (("dense bf16", {}, "decode_attention", "bfloat16"),
                 ("dense int8", {"kv_quantized": True}, "decode_attention_int8", "bfloat16"),
                 ("paged bf16", {"paged": True, "page_size": PAGE}, "paged_attention", "bfloat16"),
                 ("dense f32", {}, "decode_attention", "float32"))
VERIFY_PROMPT_LEN = 64  # the prompt of the CLI's --verify
VERIFY_STEPS = 4
# the representative f32 route of each kernel in the JSON line
EVAL_REP = {"q4_0": "gate_up", "q8_0": "gate_up", "q4_k": "gate_up", "q6_k": "head"}
# sha256 of `python -m gemma_tpu_torch quantize` of phase 8's tiny F32 file
# (TINY_KERNEL_CONFIG, seed 0) on the CPU; tests/test_torch_utils.py holds
# them there, and the CLI's bytes to the reference CLI's
QUANTIZE_SHA256 = {
    "q4_0": "f95609d2f58de7923137413891d2ac08698647599ea6705d14e2a2ce903f3d93",
    "q8_0": "56159ecd879a836486fa5487b2a2baaf3d92bb0a98897cf064c00ef3dcd52532",
    "q4_k_m": "fcf9b6d0cbe2f9dbf2b20ed2c57f8867b755c5c205123d53b201d41211ac2509",
}


def f32_route_launches(counts: dict[str, int], cfg, fmt: str, prefills: int,
                       head: bool) -> None:
    """Set the f32 tensor-core routes' share of `counts` with f32
    activations, `prefills` of its forwards prefills of more than 8 rows:
    every flash launch (the TF32 flash kernel), and every matmul launch of
    a prefill (the TF32 tile), the head too where it runs at every row
    (perplexity; a prefill runs it at the last row, M = 1); every other
    matmul launch (the decode steps', and the head at a prefill's last row)
    is the f32 GEMV's; every decode attention launch at 2 <= G <= 8, dense
    or through pages, one of the decode core's f32 policies."""
    counts["flash_attention_tf32"] = cfg.n_layers * prefills
    if fmt in ("q4_0", "q8_0"):
        counts[f"{fmt}_matmul_tf32"] = (4 * cfg.n_layers + head) * prefills
        counts[f"{fmt}_matmul_gemv_f32"] = counts[f"{fmt}_matmul"] - counts[f"{fmt}_matmul_tf32"]
    if fmt == "q4_k_m":
        counts["q4_k_matmul_tf32"] = 5 * cfg.n_layers * prefills
        counts["q6_k_matmul_tf32"] = (cfg.n_layers + head) * prefills
        counts["q4_k_matmul_gemv_f32"] = counts["q4_k_matmul"] - counts["q4_k_matmul_tf32"]
        counts["q6_k_matmul_gemv_f32"] = counts["q6_k_matmul"] - counts["q6_k_matmul_tf32"]
    for op, core in (("decode_attention", "decode_attention_tf32"),
                     ("decode_attention_int8", "decode_attention_tf32_int8"),
                     ("paged_attention", "paged_attention_tf32"),
                     ("paged_attention_int8", "paged_attention_tf32_int8")):
        if tf32_decode(cfg, paged=op.startswith("paged")):
            counts[core] = counts[op]


def tf32_decode(cfg, paged: bool = False) -> bool:
    """Whether `cfg`'s f32 queries take the decode core's f32 policies (2 <=
    G <= 8; dense, or through PAGE-key pages) rather than the G = 1 core or
    the split-S kernel."""
    import torch

    import gemma_tpu_torch.ops.attention as att
    import gemma_tpu_torch.ops.paged_attention as pat

    G = cfg.n_heads // cfg.n_kv_heads
    route = (pat.paged_route(torch.float32, G, PAGE, MAX_SEQ_LEN) if paged
             else att.decode_route(torch.float32, G, MAX_SEQ_LEN))
    return route[0] == "tf32"


def expected_eval_launches(cfg, fmt: str) -> dict[str, int]:
    """Kernel launches of one perplexity window: a prefill forward whose
    f32 queries take the TF32 flash kernel (no bf16 tensor-core launch) and
    whose head runs at every row (one launch all the same); every matmul
    on the TF32 tile."""
    counts = expected_forward_launches(cfg, fmt, prefills=1, decode_steps=0,
                                       decode_kernel="decode_attention")
    counts["flash_attention_tc"] = 0
    f32_route_launches(counts, cfg, fmt, 1, head=True)
    return counts


def add_counts(total: dict[str, int], counts: dict[str, int]) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def quality_perplexity(torch, dev, card: str, model_name: str, fmt: str) -> dict[str, int]:
    """Phase 8a: `perplexity.evaluate` at full width, one window at a time,
    each with exact launch counts and its wall time, then through the plain
    versions on the card: the NLLs agree within 1e-4 of the NLL (both f32:
    only the order of the sums differs). Returns the launches."""
    from gemma_tpu_torch.testing import make_params
    from gemma_tpu_torch.utils.perplexity import evaluate
    from gemma_tpu_torch.utils.verify import plain_versions

    cfg = model_config(model_name)
    phase = f"quality {model_name} {fmt}"
    model = make_params(cfg, fmt, seed=0, device=dev)
    rng = random.Random(0)
    tokens = [rng.randrange(2, cfg.vocab_size) for _ in range(PPL_WINDOW * PPL_WINDOWS)]
    evaluate(model, cfg, tokens[:64], ctx=64)  # warm-up: first launches, allocator
    expected = expected_eval_launches(cfg, fmt)
    total: dict[str, int] = {}
    nlls = []
    for w in range(PPL_WINDOWS):
        window = tokens[w * PPL_WINDOW:(w + 1) * PPL_WINDOW]
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        res = evaluate(model, cfg, window, ctx=PPL_WINDOW)  # ends on a host read of the NLL
        wall = time.perf_counter() - t0
        counts = read_counters()
        t1 = time.perf_counter()
        with plain_versions():
            plain = evaluate(model, cfg, window, ctx=PPL_WINDOW)
        plain_wall = time.perf_counter() - t1
        plain_counts = read_counters()
        d = abs(res.nll - plain.nll)
        info(phase, f"window {w} ({PPL_WINDOW} tokens, f32 activations) on {card}: nll kernels "
                    f"{res.nll:.7f}, plain versions {plain.nll:.7f}, |diff| {d:.3e} (tol "
                    f"{1e-4 * plain.nll:.3e}); wall {wall * 1e3:.1f} ms (plain {plain_wall * 1e3:.1f} "
                    f"ms); launches {({k: n for k, n in counts.items() if n})}")
        require(res.n_tokens == PPL_WINDOW - 1 and math.isfinite(res.nll),
                f"{phase}: {res.n_tokens} tokens scored, nll {res.nll}")
        require(counts == expected, f"{phase}: launch counts {counts} != expected {expected}")
        require(plain_counts == counts, f"{phase}: the plain run launched kernels: {plain_counts}")
        require(d <= 1e-4 * plain.nll, f"{phase}: nll kernels {res.nll} plain {plain.nll}")
        add_counts(total, counts)
        nlls.append(res.nll)
    info(phase, f"perplexity over {PPL_WINDOWS} windows: {math.exp(sum(nlls) / len(nlls)):.4f}")
    del model
    torch.cuda.empty_cache()
    return total


def quality_verify(torch, dev, model_name: str, fmt: str, rel: float | None) -> dict[str, int]:
    """Phase 8b: `verify_device_kernels` at full width (the CLI's 64-token
    prompt, 4 decode steps) over VERIFY_CACHES: ok at the stated
    tolerance, the kernel side's launches exact, the plain side's zero.
    Returns the kernel launches."""
    from gemma_tpu_torch.runtime import Engine, EngineConfig
    from gemma_tpu_torch.testing import make_params
    from gemma_tpu_torch.utils.verify import format_report, verify_device_kernels

    cfg = model_config(model_name)
    model = make_params(cfg, fmt, seed=0, device=dev)
    prompt = [2 + (i % (cfg.vocab_size - 2)) for i in range(VERIFY_PROMPT_LEN)]
    scale = float(Engine(cfg, model).prefill([prompt])[0].abs().max())
    total: dict[str, int] = {}
    for name, opts, decode_kernel, act in VERIFY_CACHES:
        phase = f"quality {model_name} {fmt} verify {name}"
        atol = 0.05 if rel is None or act == "float32" else rel * scale
        res = verify_device_kernels(dataclasses.replace(cfg, activation_dtype=act), model, prompt,
                                    n_decode=VERIFY_STEPS, max_seq_len=MAX_SEQ_LEN, atol=atol,
                                    **opts)
        expected = expected_forward_launches(cfg, fmt, prefills=1, decode_steps=VERIFY_STEPS,
                                             decode_kernel=decode_kernel)
        if act == "float32":  # f32: the TF32 flash, tile and decode core, the f32 GEMV
            expected["flash_attention_tc"] = expected["decode_attention_tc"] = 0
            f32_route_launches(expected, cfg, fmt, 1, head=False)
        held = ("the reference's 0.05" if atol == 0.05 else
                f"{rel:g} of the logits' scale {scale:.3f} (the reference's 0.05 "
                f"{'holds' if res['max_abs'] <= 0.05 else 'does not hold'} here)")
        info(phase, "per-step max|dlogit| " + ", ".join(f"{s:.4e}" for s in res["steps"])
                    + f", logits up to {res['scale']:.3f}; atol {atol:.4f}: {held}; argmax agree "
                    f"{res['argmax_agree']}; kernel launches "
                    f"{({k: n for k, n in res['kernel_launches'].items() if n})}; plain side "
                    f"{sum(res['plain_launches'].values())}")
        require(res["kernel_launches"] == expected,
                f"{phase}: launch counts {res['kernel_launches']} != expected {expected}")
        require(not any(res["plain_launches"].values()), f"{phase}: the plain side launched "
                                                         f"{res['plain_launches']}")
        require(res["ok"], f"{phase}:\n{format_report(res)}")
        add_counts(total, res["kernel_launches"])
    del model
    torch.cuda.empty_cache()
    return total


# phase 8's f32 flash edge cases, the TF32 kernel at 1e-4 of each row's
# scale (name, B, T, Hq, Hkv, D, S, first position, limits, softcap,
# window, the row warps of the kernel's plan): ragged T, a softcap, a
# window, kv_limit below the rows' positions (rows without a valid key:
# exactly 0), D = 128. With the two windows at T = S = PPL_WINDOW (D = 256:
# 2 row warps at Gemma-2B's heads, 4 at Gemma-7B's) they run every block
# plan the kernel has, FLASH_PLANS
EVAL_FLASH_EDGES = (
    ("Gemma-2B heads, ragged T, softcap, window", 1, PROMPT_LEN, 8, 1, 256, MAX_SEQ_LEN, 0,
     [PROMPT_LEN], 50.0, 64, 1),
    ("Gemma-7B heads, kv_limit < T", 1, 100, 16, 16, 256, MAX_SEQ_LEN, 0, [60], 0.0, 0, 1),
    ("GQA D=128, window, rows without keys", 2, 45, 8, 2, 128, 200, 20, [40, 120], 30.0, 16, 1),
    ("MQA D=128, 2048 rows from position 100", 1, 256, 8, 1, 128, 400, 100, [356], 0.0, 0, 1),
    ("MQA D=128, 3200 rows, softcap", 1, 400, 8, 1, 128, MAX_SEQ_LEN, 0, [400], 30.0, 0, 2),
    ("GQA D=128, 4 groups of 1600 rows, window, kv_limit < T", 2, 400, 8, 2, 128, MAX_SEQ_LEN, 0,
     [400, 300], 0.0, 128, 4),
)
FLASH_PLANS = {(D, r) for D in (256, 128) for r in (1, 2, 4)}  # (D, row warps) of flash_tc_shape
# phase 8's f32 GEMVs (f32 x at M <= 8: the decode and serving steps of f32
# serving and --verify's f32 cache), on every row of a decode step of each
# format's recipe (q4_0 Gemma-2B, q8_0 Gemma-7B, q4_k and q6_k Gemma-2B
# q4_k_m: q6_k is its attn_v and head), at the decode step's M = 1 and the
# serving step's 8: on the tensor-core GEMV with x in three bf16 parts
# (1e-5 of the output's scale)
GEMV_F32_ROWS = {"q4_0": ("qkv", "attn_out", "gate_up", "down", "head"),
                 "q8_0": ("qkv", "attn_out", "gate_up", "down", "head"),
                 "q4_k": ("attn_q", "attn_k", "attn_out", "gate_up", "down"), "q6_k": ("attn_v", "head")}
GEMV_F32_MS = (1, SERVE_SLOTS)
# the tensor-core f32 GEMV's edges (format, N, K, Ms): every M of 1-8 at N
# not a multiple of 16, q4_0 and q8_0 at K % 64 == 32 and q4_k and q6_k at
# an odd count of superblocks, each summing its K splits by ticket; and at
# M = 8 ragged rows wide enough that a second launch (`dq_split_sum_kernel`)
# sums them
GEMV_F32_EDGES = (("q4_0", 1000, 1056, tuple(range(1, 9))), ("q4_k", 999, 1280, tuple(range(1, 9))),
                  ("q8_0", 999, 1056, tuple(range(1, 9))), ("q6_k", 999, 1280, tuple(range(1, 9))),
                  ("q4_0", 9990, 2048, (SERVE_SLOTS,)), ("q4_k", 19990, 2048, (SERVE_SLOTS,)),
                  ("q8_0", 9990, 3072, (SERVE_SLOTS,)), ("q6_k", 19990, 2048, (SERVE_SLOTS,)))
FLASH_TF32_PASSES = 3  # the TF32 flash kernel's products a k8 step (3xTF32): not in the bound


def check_eval_routes(torch, dev) -> dict[str, dict]:
    """Phase 8: the f32 evaluation routes of attention. The TF32 flash
    kernel at the perplexity window's shapes (T = PPL_WINDOW) at
    Gemma-2B's and Gemma-7B's heads against its plain version (f32 both:
    1e-4 of each row's scale), with device times, the bound (HBM bytes, or
    the function's flops at the TF32 rate, 495 TFLOP/s; its three passes
    in the info line) and the library call (scaled_dot_product_attention
    in f32), and at EVAL_FLASH_EDGES, each launch counted in
    `tf32_launches`; f32-q decode (`check_f32_decode`); then every format's
    f32 GEMV (`check_gemv_f32`). The matmuls' f32 route at M > 8, the TF32
    tile, is phase 3's (`check_tf32_routes`). Returns readings: the TF32
    flash kernel's as `flash_attention_tf32`, the TF32 decode core's as
    `decode_attention_tf32`, the G = 1 core's with f32 q under
    `decode_attention_g1` ("f32"), the f32 GEMV's as `<format>_matmul_gemv_f32`."""
    import gemma_tpu_torch.ops.attention as att
    from gemma_tpu_torch.tools import _timing as T
    from gemma_tpu_torch.tools import tc_emulation as emu
    from gemma_tpu_torch.utils.device import H100_TF32_FLOPS

    require(not torch.backends.cuda.matmul.allow_tf32, "the library yardstick must run in f32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    M = PPL_WINDOW

    def cold(fn, args):
        return T.time_us(fn, T.replicate(args, T.copies_for(T.nbytes(*args), dev)), dev, reps=3,
                         launches=5) / 1e3

    readings: dict[str, dict] = {}
    flash = {"max_abs_err": 0.0}
    plans = set()  # (D, row warps) run
    for heads, hq, hkv in (("Gemma-2B", 8, 1), ("Gemma-7B", 16, 16)):
        S, D = M, 256
        q = torch.randn(1, M, hq, D, generator=gen, device=dev) * 0.3
        k, v = (torch.randn(1, hkv, S, D, generator=gen, device=dev) * 0.3 for _ in range(2))
        pos = torch.arange(M, dtype=torch.int32, device=dev)[None]
        lim = torch.tensor([M], dtype=torch.int32, device=dev)
        before = att.flash_attention.tf32_launches
        got = att.flash_attention(q, k, v, pos, lim)
        ref = att.flash_attention_plain(q, k, v, pos, lim)
        torch.cuda.synchronize()
        require(att.flash_attention.tf32_launches == before + 1,
                f"flash_attention f32 {heads}: no TF32 kernel launched")
        err, ratio, lo, hi = T.attn_err(got, ref, 1e-4)
        ms = device_ms(torch, lambda: att.flash_attention(q, k, v, pos, lim), reps=3)
        plain_ms = device_ms(torch, lambda: att.flash_attention_plain(q, k, v, pos, lim),
                             launches=1, reps=3)
        valid = torch.arange(S, device=dev)[None, :] <= pos[0][:, None]
        library_ms = sdpa_ms(torch, q, k, v, valid[None])
        plans.add((D, emu.flash_shape(1, hkv, M, hq // hkv)[0]))
        seen = M * (M + 1) // 2
        flops = 4 * hq * D * seen
        bound_ms, bound_by = bound(2 * M * hq * D * 4 + 2 * S * hkv * D * 4 + M * 4, flops,
                                   H100_TF32_FLOPS)
        passes_ms = FLASH_TF32_PASSES * flops / H100_TF32_FLOPS * 1e3
        info("quality", f"flash_attention f32 route T={M} S={S} {heads} heads (Hq={hq} Hkv={hkv} "
                        f"D={D}, TF32 kernel, {emu.flash_shape(1, hkv, M, hq // hkv)[0]} row "
                        f"warps): max|diff|={err:.3e}, worst |diff| / (1e-4 x row "
                        f"scale) {ratio:.3f}, row scales {lo:.3e}-{hi:.3e}; device ms: kernel "
                        f"{ms:.4f} ({flops / ms / 1e9:.3f} TFLOP/s) library "
                        f"(scaled_dot_product_attention, f32, boolean mask) {library_ms:.4f} "
                        f"(kernel / library {ms / library_ms:.3f}); plain {plain_ms:.4f}; bound "
                        f"{bound_ms:.6f} ({bound_by}, HBM bytes or the flops at the TF32 rate); "
                        f"at {FLASH_TF32_PASSES} TF32 passes {passes_ms:.6f}")
        require(ratio <= 1.0, f"flash_attention f32 {heads}: |diff| {ratio:.3f} x 1e-4 of its row's "
                              f"scale")
        flash["max_abs_err"] = max(flash["max_abs_err"], err)
        if heads == "Gemma-2B":
            flash.update({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": library_ms, "shape": f"f32 T={M} S={S} Hq={hq} Hkv={hkv} D={D}"})
        else:
            flash["gemma_7b"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                 "bound_by": bound_by, "library_ms": library_ms,
                                 "shape": f"f32 T={M} S={S} Hq={hq} Hkv={hkv} D={D}"}
        del q, k, v, got, ref
    worst = 0.0
    for name, B, T_, hq, hkv, D, S, p0, limits, cap, window, row_warps in EVAL_FLASH_EDGES:
        require(emu.flash_shape(B, hkv, T_, hq // hkv)[0] == row_warps,
                f"flash_attention f32 edge {name}: the plan is not {row_warps} row warps")
        plans.add((D, row_warps))
        q = torch.randn(B, T_, hq, D, generator=gen, device=dev) * 0.3
        k, v = (torch.randn(B, hkv, S, D, generator=gen, device=dev) * 0.3 for _ in range(2))
        pos = (torch.arange(T_, dtype=torch.int32, device=dev) + p0).expand(B, T_).contiguous()
        lim = torch.tensor(limits, dtype=torch.int32, device=dev)
        before = att.flash_attention.tf32_launches
        got = att.flash_attention(q, k, v, pos, lim, cap, window)
        ref = att.flash_attention_plain(q, k, v, pos, lim, cap, window)
        torch.cuda.synchronize()
        err, ratio, lo, _ = T.attn_err(got, ref, 1e-4)
        require(att.flash_attention.tf32_launches == before + 1 and ratio <= 1.0,
                f"flash_attention f32 {name}: |diff| {ratio:.3f} x 1e-4 of its row's scale "
                f"(TF32 launches {att.flash_attention.tf32_launches - before})")
        worst = max(worst, ratio)
        flash["max_abs_err"] = max(flash["max_abs_err"], err)
        info("quality", f"flash_attention f32 edge {name} (B={B} T={T_} Hq={hq} Hkv={hkv} D={D} "
                        f"S={S} limits={limits} softcap={cap} window={window}, {row_warps} row "
                        f"warps): max|diff|={err:.3e}, "
                        f"worst |diff| / (1e-4 x row scale) {ratio:.3f}, least row scale {lo:.3e} "
                        f"(0: rows without a key, held to exactly 0)")
        del q, k, v, got, ref
    info("quality", f"TF32 flash edge cases within 1e-4 of each row's scale (worst ratio {worst:.3f})")
    require(plans == FLASH_PLANS, f"TF32 flash: block plans {sorted(FLASH_PLANS - plans)} never ran")
    readings["flash_attention_tf32"] = flash
    readings.update(check_f32_decode(torch, dev, gen))
    readings.update(check_gemv_f32(torch, dev, cold))
    return readings


# phase 8's f32-q decode readings: (heads, Hq, Hkv, S, kv_limit) at a
# prompt's first decode step over the main path's cache and over a 4096-slot
# one, full
F32_DECODE_SHAPES = tuple((heads, hq, hkv, S, limit) for heads, hq, hkv in (("Gemma-2B", 8, 1),
                                                                           ("Gemma-7B", 16, 16))
                          for S, limit in ((MAX_SEQ_LEN, PROMPT_LEN + 1), (LONG_SEQ_LEN, LONG_SEQ_LEN)))
# the TF32 decode core's edges (name, Hq, Hkv, D, S, limits, softcap,
# window): limit 1, limits not a multiple of 16 over batch rows, a row of
# limit 0 (no live key: exactly 0), softcap, a window (dead splits), G = 2
# and 4, D = 128 with two ring stages a warp (256 keys a block)
F32_DECODE_EDGES = (
    ("Gemma-2B heads, limit 1", 8, 1, 256, MAX_SEQ_LEN, [1], 0.0, 0),
    ("Gemma-2B heads, serving rows, softcap", 8, 1, 256, MAX_SEQ_LEN, SERVE_LIMITS, 50.0, 0),
    ("G=4 D=128, window: dead splits, a row without keys", 8, 2, 128, MAX_SEQ_LEN, [0, 17, 300], 30.0, 48),
    ("G=2 D=128, two stages a warp, limit 1000", 4, 2, 128, LONG_SEQ_LEN, [1000], 0.0, 0),
)
F32_DECODE_TOL = 1e-4  # of each row's scale: the TF32 flash kernel's
# f32 queries on the one-launch decode core over pages and int8 caches, each
# timed in turns against the split-S kernel and its combine that took them
# before (the route of G > 8, whose source is unchanged): (kernel name,
# paged, int8) at Gemma-2B's heads: SERVE_SLOTS rows through PAGE-key pages
# (a 65-page pool, SERVE_LIMITS) of f32 and of int8, and one row over an
# int8 dense cache at limit PROMPT_LEN + 1
F32_CORE_ROUTES = (("paged_attention_tf32", True, False), ("paged_attention_tf32_int8", True, True),
                   ("decode_attention_tf32_int8", False, True))
# each arm's launch counter on its wrapper
F32_CORE_COUNTERS = {"paged_attention_tf32": "tf32_launches", "paged_attention_tf32_int8": "tf32_int8_launches",
                     "decode_attention_tf32_int8": "tf32_int8_launches"}


def check_f32_decode(torch, dev, gen) -> dict[str, dict]:
    """Phase 8: decode attention with f32 queries over an f32 cache (every
    f32 decode step's) at F32_DECODE_SHAPES, batch 1, against its plain
    version (F32_DECODE_TOL of each row's scale), timed warm beside f32
    scaled_dot_product_attention, with its bound: the live keys' f32 K and
    V, q and out over HBM bandwidth against the function's flops at the
    TF32 rate. Gemma-2B's G = 8 takes the tensor-core core's TF32 policy,
    one launch counted in `tf32_launches` a call; Gemma-7B's G = 1 the core
    for one query row, one launch counted in `g1_launches`. Then the TF32
    core at F32_DECODE_EDGES. Returns readings: the TF32 core's as
    `decode_attention_tf32` (its S = MAX_SEQ_LEN row, every row under
    "rows"), the G = 1 core's under `decode_attention_g1` ("f32")."""
    import gemma_tpu_torch.ops.attention as att
    from gemma_tpu_torch.tools._timing import attn_err
    from gemma_tpu_torch.utils.device import H100_TF32_FLOPS

    rows: dict[str, list] = {"tf32": [], "g1": []}
    D = HEAD_DIM
    for heads, hq, hkv, S, limit in F32_DECODE_SHAPES:
        q = torch.randn(1, 1, hq, D, generator=gen, device=dev) * 0.3
        k, v = (torch.randn(1, hkv, S, D, generator=gen, device=dev) * 0.3 for _ in range(2))
        lim = torch.tensor([limit], dtype=torch.int32, device=dev)
        route, split = att.decode_route(torch.float32, hq // hkv, S)
        op = att.decode_attention
        before = (op.tc_launches, op.tf32_launches, op.g1_launches)
        got = att.decode_attention(q, k, v, lim)
        ref = att.decode_attention_plain(q, k, v, lim)
        torch.cuda.synchronize()
        err, ratio, lo, hi = attn_err(got, ref, F32_DECODE_TOL)
        launched = tuple(n - b for n, b in zip((op.tc_launches, op.tf32_launches, op.g1_launches), before))
        require(launched == (0, route == "tf32", route == "g1") and ratio <= 1.0,
                f"decode_attention f32 {heads} S={S}: |diff| {ratio:.3f} x {F32_DECODE_TOL} of its row's "
                f"scale (bf16 tensor-core, TF32, G = 1 launches {launched}; route {route})")
        ms = device_ms(torch, lambda: att.decode_attention(q, k, v, lim), reps=3)
        plain_ms = device_ms(torch, lambda: att.decode_attention_plain(q, k, v, lim), launches=1, reps=3)
        library_ms = sdpa_ms(torch, q, k, v, torch.arange(S, device=dev)[None, None] < limit)
        bound_ms, bound_by = bound(limit * hkv * 2 * D * 4 + 2 * hq * D * 4 + 4, 4 * hq * D * limit,
                                   H100_TF32_FLOPS)
        what = ("the tensor-core core, 3xTF32" if route == "tf32" else "the core for one query row")
        info("quality", f"decode_attention f32 q {heads} heads (Hq={hq} Hkv={hkv} D={D}) S={S} "
                        f"limit={limit} ({route}, {split} keys a block: {what}): max|diff|={err:.3e}, "
                        f"worst |diff| / ({F32_DECODE_TOL} x row scale) {ratio:.3f}, row scales "
                        f"{lo:.3e}-{hi:.3e}; device ms, warm: kernel {ms:.4f} library "
                        f"(scaled_dot_product_attention, f32, boolean mask) {library_ms:.4f} (kernel / "
                        f"library {ms / library_ms:.3f}); plain {plain_ms:.4f}; bound {bound_ms:.6f} "
                        f"({bound_by}: f32 K and V at HBM rate, or the flops at the TF32 rate)")
        rows[route].append({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": library_ms,
                            "shape": f"f32 q {heads} S={S} kv_limit={limit} Hq={hq} Hkv={hkv} D={D}"})
        del q, k, v, got, ref
    worst = max(r["max_abs_err"] for r in rows["tf32"])
    for name, hq, hkv, D_, S, limits, cap, window in F32_DECODE_EDGES:
        B = len(limits)
        q = torch.randn(B, 1, hq, D_, generator=gen, device=dev) * 0.3
        k, v = (torch.randn(B, hkv, S, D_, generator=gen, device=dev) * 0.3 for _ in range(2))
        lim = torch.tensor(limits, dtype=torch.int32, device=dev)
        route, split = att.decode_route(torch.float32, hq // hkv, S)
        before = att.decode_attention.tf32_launches
        got = att.decode_attention(q, k, v, lim, cap, window)
        ref = att.decode_attention_plain(q, k, v, lim, cap, window)
        torch.cuda.synchronize()
        err, ratio, lo, _ = attn_err(got, ref, F32_DECODE_TOL)
        empty = lim == 0
        require(route == "tf32" and att.decode_attention.tf32_launches == before + 1 and ratio <= 1.0
                and not bool(got[empty].any()),
                f"decode_attention f32 edge {name}: |diff| {ratio:.3f} x {F32_DECODE_TOL} of its row's "
                f"scale (route {route}, TF32 launches {att.decode_attention.tf32_launches - before}; "
                f"rows without a key exactly 0: {not bool(got[empty].any())})")
        worst = max(worst, err)
        info("quality", f"decode_attention f32 edge {name} (B={B} Hq={hq} Hkv={hkv} D={D_} S={S} "
                        f"limits={limits} softcap={cap} window={window}; {split} keys a block): "
                        f"max|diff|={err:.3e}, worst |diff| / ({F32_DECODE_TOL} x row scale) {ratio:.3f}, "
                        f"least row scale {lo:.3e} (0: a row without a key, held to exactly 0)")
        del q, k, v, got, ref
    rep = rows["tf32"][0]
    readings = {"decode_attention_tf32": {**rep, "max_abs_err": worst, "rows": rows["tf32"]},
                "decode_attention_g1": {"f32": rows["g1"]}}
    readings.update(f32_core_routes(torch, dev, gen))
    return readings


def f32_core_inputs(torch, gen, dev, paged: bool, int8: bool, hq: int, hkv: int, D: int, S: int, limits,
                    seed: int = 6):
    """(q [B, 1, hq, D] f32, the cache, kv_limit) of an f32-q core arm: a
    one-layer PagedKVCache of PAGE-key pages (the live pages shuffled over
    the pool, f32 or int8 with scales), or a dense cache's (k, v, k_scale,
    v_scale), f32 or int8; q drawn in f32 (not bf16 values)."""
    from gemma_tpu_torch.runtime.kv_cache import quantize_kv
    from gemma_tpu_torch.tools.parent_turn import paged_inputs

    B = len(limits)
    lim = torch.tensor(limits, dtype=torch.int32, device=dev)
    if paged:
        _, cache, lim = paged_inputs(gen, dev, B, hq, hkv, D, PAGE, limits, B * S // PAGE + 1, S, int8,
                                     torch.float32, seed=seed)
    else:
        k, v = (torch.randn(B, hkv, S, D, generator=gen, device=dev) * 0.3 for _ in range(2))
        if int8:
            (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
            cache = (k, v, ks, vs)
        else:
            cache = (k, v, None, None)
    q = torch.randn(B, 1, hq, D, generator=gen, device=dev) * 0.3
    return q, cache, lim


def f32_core_calls(paged: bool, q, cache, lim, cap: float = 0.0, window: int = 0):
    """(the wrapper's call, its plain version, decode_attention on the
    gathered rows or None) of an f32-q core arm."""
    import gemma_tpu_torch.ops.attention as att
    import gemma_tpu_torch.ops.paged_attention as pat

    if paged:
        dense = [None if x is None else x.contiguous() for x in cache.layer_kv(0)]
        return (lambda: pat.paged_decode_attention(q, cache, 0, lim, cap, window),
                lambda: pat.paged_decode_attention_plain(q, cache, 0, lim, cap, window),
                lambda: att.decode_attention(q, dense[0], dense[1], lim, cap, window, *dense[2:]))
    k, v, ks, vs = cache
    return (lambda: att.decode_attention(q, k, v, lim, cap, window, ks, vs),
            lambda: att.decode_attention_plain(q, k, v, lim, cap, window, ks, vs), None)


def f32_core_once(torch, name: str, paged: bool, call, dense, what: str):
    """call() (one wrapper call of arm `name`) once: one launch counted in
    its counter and nothing else on the tensor cores; through pages equal
    to decode_attention on the gathered rows bit for bit. Returns call()'s
    output."""
    import gemma_tpu_torch.ops.attention as att
    import gemma_tpu_torch.ops.paged_attention as pat

    op = pat.paged_decode_attention if paged else att.decode_attention
    names = ("tc_launches", "tf32_launches", "tf32_int8_launches", "g1_launches")
    before = [getattr(op, n) for n in names]
    got = call()
    launched = {n: getattr(op, n) - b for n, b in zip(names, before)}
    require(launched == {n: int(n == F32_CORE_COUNTERS[name]) for n in names},
            f"{name} {what}: launches {launched}, not one of the core's f32 policy")
    if dense is not None:
        require(torch.equal(got, dense()), f"{name} {what}: differs from decode_attention on the gathered "
                                           "rows")
    return got


def f32_core_routes(torch, dev, gen) -> dict[str, dict]:
    """Phase 8: f32 queries on the one-launch decode core over pages of f32
    (`DecTf32` through `PagedRows`) and over int8 pages and an int8 dense
    cache (`DecTf32Int8`), F32_CORE_ROUTES at Gemma-2B's heads: one launch
    a call counted in the arm's counter (F32_CORE_COUNTERS), against the
    plain version (f32 pages: F32_DECODE_TOL of each row's scale; int8:
    ATT_TOL, p * vs rounds to bf16), through pages equal bit for bit to
    decode_attention on the gathered rows, timed warm with its bound (the
    live keys' K and V, int8 with their scales, q and out over HBM
    bandwidth against the flops at the TF32 rate) and in turns against the
    split-S kernel and its combine on the same inputs (core, split-S,
    split-S, core: the route these arms took before); no single library
    call computes either. Then each arm at F32_DECODE_EDGES. Returns
    readings under each arm's kernel name."""
    import gemma_tpu_torch.ops.attention as att
    from gemma_tpu_torch.kernels import build
    from gemma_tpu_torch.tools import _launch
    from gemma_tpu_torch.tools._timing import attn_err
    from gemma_tpu_torch.utils.device import H100_TF32_FLOPS

    D, hq, hkv = HEAD_DIM, 8, 1
    lib = build.load()
    out = {}
    for name, paged, int8 in F32_CORE_ROUTES:
        limits = SERVE_LIMITS if paged else [PROMPT_LEN + 1]
        q, cache, lim = f32_core_inputs(torch, gen, dev, paged, int8, hq, hkv, D, MAX_SEQ_LEN, limits)
        kernel, plain, dense = f32_core_calls(paged, q, cache, lim)
        if paged:
            split_s = lambda: _launch.paged_split(lib, q, cache, 0, lim)  # noqa: E731
        else:
            split_s = lambda: _launch.decode(lib, att.DECODE_SPLIT, q, *cache[:2], lim, *cache[2:],  # noqa: E731
                                             kind="split")
        tol = ATT_TOL if int8 else F32_DECODE_TOL
        got = f32_core_once(torch, name, paged, kernel, dense, f"limits {limits}")
        ref = plain()
        torch.cuda.synchronize()
        err, ratio, lo, hi = attn_err(got, ref, tol)
        split_ratio = attn_err(split_s(), ref, tol)[1]
        require(ratio <= 1.0 and split_ratio <= 1.0,
                f"{name}: |diff| {ratio:.3f} x {tol} of its row's scale (split-S: {split_ratio:.3f})")
        turns = [device_ms(torch, fn, reps=3) for fn in (kernel, split_s, split_s, kernel)]
        ms = statistics.median([turns[0], turns[3]])
        plain_ms = device_ms(torch, plain, launches=1, reps=3)
        live = sum(limits)
        key_bytes = 2 * (D + 4) if int8 else 2 * D * 4
        bound_ms, bound_by = bound(live * hkv * key_bytes + 2 * len(limits) * hq * D * 4 + 4 * len(limits),
                                   4 * hq * D * live, H100_TF32_FLOPS)
        route = f"{'int8' if int8 else 'f32'} {'pages' if paged else 'cache'}"
        equal = "; equal bit for bit to the dense core on the gathered rows" if paged else ""
        info("quality", f"{name}: f32 q over {route} (Gemma-2B heads, limits {limits}; one launch of the "
                        f"decode core): max|diff|={err:.3e}, worst |diff| / ({tol} x row scale) {ratio:.3f}, "
                        f"row scales {lo:.3e}-{hi:.3e}{equal}; device ms, warm, in turns: core {turns[0]:.4f}, split-S kernel and combine "
                        f"{turns[1]:.4f} / {turns[2]:.4f}, core {turns[3]:.4f} (core / split-S "
                        f"{ms / statistics.median(turns[1:3]):.3f}); library none; plain {plain_ms:.4f}; "
                        f"bound {bound_ms:.6f} ({bound_by}: K and V at HBM rate, or the flops at the TF32 rate)")
        require(ms < min(turns[1:3]), f"{name}: the core ({ms:.4f} ms) is not faster than the split-S "
                                      f"kernel ({turns[1]:.4f} / {turns[2]:.4f})")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None, "split_s_ms": turns[1:3],
                     "shape": f"f32 q over {route} limits={limits} Hq={hq} Hkv={hkv} D={D}"}
        del q, cache, got, ref
    worst = {name: 0.0 for name in out}
    for edge, hq_, hkv_, D_, S, limits, cap, window in F32_DECODE_EDGES:
        for name, paged, int8 in F32_CORE_ROUTES:
            q, cache, lim = f32_core_inputs(torch, gen, dev, paged, int8, hq_, hkv_, D_, S, limits, seed=9)
            kernel, plain, dense = f32_core_calls(paged, q, cache, lim, cap, window)
            got = f32_core_once(torch, name, paged, kernel, dense, f"edge {edge}")
            tol = ATT_TOL if int8 else F32_DECODE_TOL
            ratio = attn_err(got, plain(), tol)[1]
            empty = lim == 0
            require(ratio <= 1.0 and not bool(got[empty].any()),
                    f"{name} edge {edge}: |diff| {ratio:.3f} x {tol} of its row's scale (rows without a key "
                    f"exactly 0: {not bool(got[empty].any())})")
            worst[name] = max(worst[name], ratio)
            del q, cache, got
    info("quality", "f32-q core arms at F32_DECODE_EDGES (limit 1, serving rows with softcap, G = 4 at D = 128 "
                    "with a window and a row without keys, G = 2 at D = 128 over 4096 slots; pages equal bit "
                    "for bit to the dense core on the gathered rows, rows without a key exactly 0), worst "
                    "|diff| / (tol x row scale): " + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()))
    return out


def gemv_f32_plan(torch, fmt: str, M: int, N: int, K: int) -> tuple[str, str]:
    """The f32 GEMV's plan at (M, N, K) as tools/tc_emulation.py emulates
    it, held to the library's K-split scratch and tickets there: (a line
    with its slice, splits, how they are summed, and the shared bytes and
    blocks an SM against bf16 x's; how the splits are summed)."""
    from gemma_tpu_torch.kernels import build
    from gemma_tpu_torch.tools import tc_emulation as emu

    F = emu.GEMV_FORMATS[fmt]
    sl_max = emu.gemv_slice_max(M, fmt, emu.GV_F32_PARTS)
    sl, splits = emu.gemv_plan(M, N, K, emu.H100_SMS, F.gran, F.target, F.slice_min, sl_max)
    tiles = -(-(-(-N // 16)) // emu.GV_WARPS)
    ticket = splits > 1 and tiles * splits <= 4 * emu.H100_SMS
    work, tickets = build.matmul_scratch(build.load(), build.FORMAT_CODES[fmt],
                                         build.DTYPE_CODES[torch.float32], M, N, K)
    require((work, tickets) == (splits * M * N * 4 if splits > 1 else 0, tiles if ticket else 0),
            f"{fmt} f32 GEMV M={M} N={N} K={K}: the library's scratch {work} bytes and {tickets} "
            f"tickets, the emulated plan's {splits} splits (ticket sum {ticket})")
    smem = emu.gemv_smem_bytes(fmt, M, sl, emu.GV_F32_PARTS)
    bf16_sl = emu.gemv_plan(M, N, K, emu.H100_SMS, F.gran, F.target, F.slice_min)[0]
    bf16_smem = emu.gemv_smem_bytes(fmt, M, bf16_sl)
    how = "one split" if splits == 1 else "summed by ticket" if ticket else "summed by dq_split_sum_kernel"
    return (f"slice {sl} (at most {sl_max}) x {splits} splits, {how}; {smem} B shared, "
            f"{emu.gemv_sm_blocks(smem)} blocks an SM (bf16 x: slice {bf16_sl}, {bf16_smem} B, "
            f"{emu.gemv_sm_blocks(bf16_smem)})"), how


def check_gemv_f32(torch, dev, cold) -> dict[str, dict]:
    """Phase 8: every format's f32 GEMV (the tensor-core GEMV with x in
    three bf16 parts, qmm.GEMV_F32_FORMATS) at GEMV_F32_ROWS and
    GEMV_F32_MS against its plain version, L2 cold, with the bound (wire
    bytes over HBM bandwidth against the function's 2 M N K flops at the
    TF32 rate; the three bf16 passes at the bf16 rate in its info line) and
    the library call (f32 torch.matmul on the weight dequantized
    beforehand): 1e-5 of the output's scale, one `gemv_f32_launches` a
    call, the library's K-split scratch held to the emulated plan
    (`gemv_f32_plan`), and GEMV_F32_EDGES too. Returns readings as
    `<format>_matmul_gemv_f32` (its EVAL_REP row at M = 8, every row under
    "rows")."""
    import gemma_tpu_torch.ops.quant_matmul as qmm
    from gemma_tpu_torch.quant.qtensor import dequant
    from gemma_tpu_torch.tools import _timing as T
    from gemma_tpu_torch.tools import tc_emulation as emu
    from gemma_tpu_torch.utils.device import H100_TF32_FLOPS

    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    readings: dict[str, dict] = {}

    def held(fmt, qt, x, what) -> tuple[float, str]:
        """(max|diff|, its line) of one call against the plain version"""
        op = qmm.MATMULS[fmt]
        require(fmt in qmm.GEMV_F32_FORMATS, f"{fmt}: f32 x at M <= 8 is not on the tensor-core GEMV")
        before = op.gemv_f32_launches
        got, ref = op(x, qt), qmm.PLAIN[fmt](x, qt)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item()
        require(op.gemv_f32_launches == before + 1,
                f"{fmt}_matmul f32 GEMV {what}: {op.gemv_f32_launches - before} f32 GEMV launches")
        require(bool(torch.isfinite(got).all()) and err <= tol,
                f"{fmt}_matmul f32 GEMV {what}: max|diff| {err} > tol {tol}")
        return err, f"max|diff|={err:.3e} tol={tol:.3e} (1e-5 of scale)"

    for fmt, names in GEMV_F32_ROWS.items():
        shapes = {name: (N, K) for name, N, K, _ in MATMUL_SHAPES[fmt][0]}
        rows, worst = [], 0.0
        for name in names:
            N, K = shapes[name]
            qt = T.random_qtensor(fmt, N, K, gen, dev)
            w32 = dequant(qt, torch.float32)
            wire = T.nbytes(qt)
            for Mg in GEMV_F32_MS:
                x = torch.randn(Mg, K, generator=gen, device=dev)
                err, held_line = held(fmt, qt, x, f"{name} M={Mg}")
                worst = max(worst, err)
                ms = cold(qmm.MATMULS[fmt], (x, qt))
                library_ms = cold(lambda x_, w_: torch.matmul(x_, w_.T), (x, w32))
                plain_ms = device_ms(torch, lambda: qmm.PLAIN[fmt](x, qt), launches=1, reps=3)
                bound_ms, bound_by = bound(wire + Mg * K * 4 + Mg * N * 4, 2 * Mg * N * K,
                                           H100_TF32_FLOPS)
                plan, _ = gemv_f32_plan(torch, fmt, Mg, N, K)
                route = (f"tensor cores, x in {emu.GV_F32_PARTS} bf16 parts: the passes at the "
                         f"bf16 rate {emu.GV_F32_PARTS * 2 * Mg * N * K / BF16_FLOPS * 1e3:.4f}; {plan}")
                info("quality", f"{fmt}_matmul f32 GEMV {name} M={Mg} N={N} K={K}: {held_line}; device "
                                f"ms, L2 cold: kernel {ms:.4f} ({wire / ms / 1e9:.3f} TB/s at wire bytes) "
                                f"library (f32 matmul, weight dequantized beforehand) {library_ms:.4f} "
                                f"(kernel / library {ms / library_ms:.3f}); plain {plain_ms:.4f}; bound "
                                f"{bound_ms:.4f} ({bound_by}: wire bytes at HBM rate, or the flops at the "
                                f"TF32 rate); {route}")
                rows.append({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "library_ms": library_ms,
                             "shape": f"f32 {name} M={Mg} N={N} K={K}"})
                del x
            del qt, w32
            torch.cuda.empty_cache()
        rep = next(r for r in rows if r["shape"].startswith(f"f32 {EVAL_REP[fmt]} M={SERVE_SLOTS} "))
        readings[f"{fmt}_matmul_gemv_f32"] = {**rep, "max_abs_err": worst, "rows": rows}
    sums = set()
    for fmt, N, K, ms in GEMV_F32_EDGES:
        qt = T.random_qtensor(fmt, N, K, gen, dev)
        for Mg in ms:
            x = torch.randn(Mg, K, generator=gen, device=dev)
            err, held_line = held(fmt, qt, x, f"edge M={Mg} N={N} K={K}")
            plan, how = gemv_f32_plan(torch, fmt, Mg, N, K)
            sums.add(how)
            readings[f"{fmt}_matmul_gemv_f32"]["max_abs_err"] = max(
                readings[f"{fmt}_matmul_gemv_f32"]["max_abs_err"], err)
            info("quality", f"{fmt}_matmul f32 GEMV edge M={Mg} N={N} K={K}: {held_line}; {plan}")
            del x
        del qt
    require({"summed by ticket", "summed by dq_split_sum_kernel"} <= sums,
            f"f32 GEMV edges: the splits were {sorted(sums)}")
    return readings


# phase 8's tiny files: those of phase 5
TINY_FILES = (("q4_0", "TINY_KERNEL_CONFIG"), ("q4_k_m", "TINY_KERNEL_CONFIG"),
              ("q8_0", "TINY_MHA_CONFIG"))


def quality_cli(torch, dev) -> None:
    """Phase 8c: the CLI's new commands in subprocesses, all started at
    once, on phase 5's tiny files: `perplexity --device cuda` against the
    same command on the CPU (1e-4 relative: f32 both); `bench` (the
    reference CLI's keys, a positive rate); `generate --verify --profile`
    (exit 0, the verify OK, the report's spans and counters); `generate
    --mode dequant` against the in-process dense run; `quantize` of the tiny
    F32 file to the bytes it writes on the CPU (QUANTIZE_SHA256)."""
    import hashlib

    from gemma_tpu_torch import cli, testing
    from gemma_tpu_torch.runtime import Engine, EngineConfig

    tokens = ",".join(map(str, TINY_PROMPT))
    procs: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        files = {wt: testing.make_gguf(Path(tmp) / f"{wt}.gguf", getattr(testing, name), seed=0,
                                       weight_type=wt) for wt, name in TINY_FILES}
        f32 = testing.make_gguf(Path(tmp) / "f32.gguf", testing.TINY_KERNEL_CONFIG, seed=0,
                                weight_type="f32")
        corpus = Path(tmp) / "corpus.txt"
        corpus.write_text("hello world the hello world of worlds and the world " * 24)

        # one CPU thread each: a dozen processes share the host's cores
        env = {**os.environ, "OMP_NUM_THREADS": "1"}

        def start(key, *argv):
            procs[key] = subprocess.Popen([sys.executable, "-m", "gemma_tpu_torch", *map(str, argv)],
                                          cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True)

        try:
            for wt, path in files.items():
                for device in ("cuda", "cpu"):
                    start(("perplexity", wt, device), "perplexity", path, "--device", device,
                          "--text-file", corpus, "--window", 64)
            q4 = files["q4_0"]
            start("bench", "bench", q4, "--device", "cuda", "--max-new-tokens", 16,
                  "--max-seq-len", 64)
            start("verify", "generate", q4, "--device", "cuda", "--tokens", tokens,
                  "--max-new-tokens", 16, "--no-eos", "--verify", "--profile")
            start("dequant", "generate", q4, "--device", "cuda", "--tokens", tokens,
                  "--max-new-tokens", 16, "--no-eos", "--mode", "dequant")
            for qtype in QUANTIZE_SHA256:
                start(("quantize", qtype), "quantize", f32, Path(tmp) / f"{qtype}.out.gguf",
                      "--type", qtype)
            out = {}
            for key, p in procs.items():
                stdout, stderr = p.communicate(timeout=600)
                require(p.returncode == 0, f"CLI {key} failed ({p.returncode}):\n{stderr[-4000:]}")
                out[key] = (stdout, stderr)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for wt in files:
            card, cpu = (json.loads(out[("perplexity", wt, d)][0]) for d in ("cuda", "cpu"))
            rel = abs(card["perplexity"] / cpu["perplexity"] - 1)
            info("quality", f"CLI perplexity {wt}: cuda {card['perplexity']:.6f}, cpu "
                            f"{cpu['perplexity']:.6f} ({card['tokens']} tokens), relative diff "
                            f"{rel:.3e} (tol 1e-4)")
            require(card["tokens"] == cpu["tokens"] > 64 and rel <= 1e-4,
                    f"CLI perplexity {wt}: cuda {card} cpu {cpu}")
        bench = json.loads(out["bench"][0])
        require(set(bench) == {"metric", "value", "unit", "batch"} and bench["value"] > 0
                and bench["metric"] == "decode_tokens_per_sec", f"CLI bench printed {bench}")
        err = out["verify"][1]
        for needle in ("verification: OK", "prefill.dispatch", "decode.steps[B=1]",
                       "trace.matmul.cuda"):
            require(needle in err, f"generate --verify --profile: no {needle!r} in:\n{err[-4000:]}")
        cfg, model_d, tok = cli.load(q4, dev, "dequant")
        dense = tok.decode(Engine(cfg, model_d, EngineConfig()).generate([TINY_PROMPT], 16)[0])
        require(out["dequant"][0] == dense + "\n",
                f"generate --mode dequant printed {out['dequant'][0]!r}, in-process {dense!r}")
        digests = {q: hashlib.sha256((Path(tmp) / f"{q}.out.gguf").read_bytes()).hexdigest()
                   for q in QUANTIZE_SHA256}
        require(digests == QUANTIZE_SHA256, f"quantize wrote {digests}, the CPU {QUANTIZE_SHA256}")
    info("quality", f"CLI on cuda: bench {bench['value']} tok/s (tiny q4_0); generate --verify "
                    f"--profile exit 0 with the report; --mode dequant prints the in-process dense "
                    f"text; quantize {sorted(QUANTIZE_SHA256)} wrote the CPU's bytes")


F32_DECODE_STEPS = 4  # f32_decode_steps's checked steps a run
F32_DECODE_REL = 1e-4  # of the logits' scale: kernels against plain versions, both f32
# f32_decode_steps's models: each recipe's f32 GEMVs and f32-q decode
F32_DECODE_MODELS = (("Gemma-2B", "q4_0"), ("Gemma-2B", "q4_k_m"), ("Gemma-7B", "q8_0"))


def f32_decode_steps(torch, dev, card: str, check: bool = True) -> tuple[dict[str, float],
                                                                            dict[str, int]]:
    """Phase 8: F32_DECODE_MODELS' decode steps with f32 activations and
    cache, at 1 and SERVE_SLOTS rows (each row its own rotation of one
    PROMPT_LEN-token prompt) after a prefill. With `check`:
    F32_DECODE_STEPS greedy steps with exact launches (a step: 73 q4_0, or
    90 q4_k and 19 q6_k, or 113 q8_0, every one the f32 GEMV's; an attention
    a layer, Gemma-2B's on the TF32 decode core, Gemma-7B's on the G = 1
    core), each step's logits held against
    the same steps through the plain versions on the card (the same token
    stream, F32_DECODE_REL of the logits' scale), the plain side launching
    nothing. Then the device busy ms of a step by torch.profiler over 8
    more (`decode_profile`, as phases 4 and 6; `check=False` times only, as
    a parent tree's turn of `tools/parent_turn.py` does). Returns (the busy
    ms by "<format> rows=<rows>", the checked steps' launches)."""
    from gemma_tpu_torch.runtime import Engine, EngineConfig
    from gemma_tpu_torch.testing import make_params
    from gemma_tpu_torch.utils.verify import plain_versions

    busy: dict[str, float] = {}
    total: dict[str, int] = {}
    for model_name, fmt in F32_DECODE_MODELS:
        base = model_config(model_name)
        cfg = dataclasses.replace(base, activation_dtype="float32")
        prompt = [2 + (i * 7919) % (cfg.vocab_size - 2) for i in range(PROMPT_LEN)]
        model = make_params(base, fmt, seed=0, device=dev)
        for rows in (1, SERVE_SLOTS):
            phase = f"quality {model_name} {fmt} f32 decode, {rows} rows"
            ecfg = EngineConfig(max_seq_len=MAX_SEQ_LEN, max_batch=rows, kv_dtype=torch.float32)
            prompts = [prompt[r:] + prompt[:r] for r in range(rows)]

            def run(stream):
                """A prefill and F32_DECODE_STEPS steps, greedy (stream None)
                or replaying `stream`: (engine, cache, each step's logits,
                the tokens fed, the steps' launches)."""
                eng = Engine(cfg, model, ecfg)
                logits, cache = eng.prefill(prompts)
                outs, fed = [], []
                torch.cuda.synchronize()
                reset_counters()
                for i in range(F32_DECODE_STEPS if check else 2):
                    fed.append(logits.argmax(-1) if stream is None else stream[i])
                    logits, cache = eng.decode_step(fed[-1], cache)
                    outs.append(logits)
                torch.cuda.synchronize()
                return eng, cache, outs, fed, read_counters()

            eng, cache, outs, fed, counts = run(None)
            if check:
                expected = expected_forward_launches(cfg, fmt, prefills=0, decode_steps=F32_DECODE_STEPS,
                                                     decode_kernel="decode_attention")
                expected["decode_attention_tc"] = 0  # f32 queries: no bf16 tensor-core decode
                f32_route_launches(expected, cfg, fmt, 0, head=False)
                with plain_versions():
                    _, _, plain, _, plain_counts = run(fed)
                errs = [(a - b).abs().max().item() for a, b in zip(outs, plain)]
                scale = max(b.abs().max().item() for b in plain)
                info(phase, f"{F32_DECODE_STEPS} steps on {card}: per-step max|dlogit| "
                            + ", ".join(f"{e:.3e}" for e in errs) + f", logits up to {scale:.3f} "
                            f"(tol {F32_DECODE_REL * scale:.3e}, {F32_DECODE_REL:g} of scale); launches "
                            f"{({k: n for k, n in counts.items() if n})}; plain side "
                            f"{sum(plain_counts.values())}")
                require(counts == expected, f"{phase}: launch counts {counts} != expected {expected}")
                require(not any(plain_counts.values()), f"{phase}: the plain side launched {plain_counts}")
                require(all(math.isfinite(e) for e in errs) and max(errs) <= F32_DECODE_REL * scale,
                        f"{phase}: max|dlogit| {errs} > {F32_DECODE_REL} of {scale}")
                add_counts(total, counts)
                del plain
            ms, top = decode_profile(torch, eng, cache, outs[-1].argmax(-1), no_combine=check)
            busy[f"{fmt} rows={rows}"] = ms
            info("quality", f"{model_name} {fmt} f32 decode step, {rows} rows, on {card}: device busy "
                            f"{ms:.4f} ms; device ms a step by kernel: {top}")
            del eng, cache, outs
        del model
        torch.cuda.empty_cache()
    return busy, total


def quality_gates(torch, dev, card: str) -> tuple[dict[str, int], dict[str, dict]]:
    """Phase 8. Returns (its launches, the f32 routes' readings)."""
    counts: dict[str, int] = {}
    readings = check_eval_routes(torch, dev)
    add_counts(counts, f32_decode_steps(torch, dev, card)[1])
    for model_name, fmt in PPL_MODELS:
        add_counts(counts, quality_perplexity(torch, dev, card, model_name, fmt))
    for model_name, fmt, rel in VERIFY_MODELS:
        add_counts(counts, quality_verify(torch, dev, model_name, fmt, rel))
    quality_cli(torch, dev)
    return counts, readings


# phase 9: serving across two processes on the card. The parent is rank 0
# and decodes; a child (this script with --prefill-host) is rank 1 and
# serves the admission prefills. 16 of phase 6's requests (prompts cycling
# SERVE_PROMPT_LENS), 64 greedy tokens each
DISAGG_REQUESTS = 16
DISAGG_NEW_TOKENS = 64
DISAGG_PAGE = 16  # the tensor-core paged route takes pages of a multiple of 16 keys
# (name, decode EngineConfig options, prefill host's, decode attention
# counter): a dense bf16 cache behind a host that does not chunk; a paged
# int8 cache of 16-key pages behind an int8 host that prefills in 64-token
# chunks, so a 203-token prompt hands over 256 slots (208 without the
# host's chunk in the handshake)
DISAGG_RUNS = (
    ("dense bf16", {}, {}, "decode_attention"),
    ("paged int8, chunking host", {"paged": True, "page_size": DISAGG_PAGE, "kv_quantized": True},
     {"kv_quantized": True, "prefill_chunk": PAGE}, "paged_attention_int8"),
)
HANDOFF_REPS = 3


def disagg_requests(cfg):
    from gemma_tpu_torch.runtime import Request

    return [Request(r.id, r.prompt, DISAGG_NEW_TOKENS)
            for r in serve_requests(cfg)[:DISAGG_REQUESTS]]


def prefill_forwards(reqs, chunk: int) -> int:
    """Forwards of the admission prefills: one a prompt, or one a chunk."""
    return sum(-(-len(r.prompt) // chunk) if chunk and len(r.prompt) > chunk else 1 for r in reqs)


def prefill_host(spec: dict) -> int:
    """Phase 9's child, rank 1 of the gloo group at spec["coordinator"]: the
    Gemma-2B q4_0 weights of make_params(seed=0) on the card, then, for each
    of DISAGG_RUNS, `serve(roles=HostRoles((1,), (0,)), transport=...)` with
    the run's prefill host configuration, then one more connection for the
    parent's bit-for-bit check. Prints each run's launch counts and
    `SERVED <n>` (prefills served) after each connection."""
    import torch
    import torch.distributed as dist

    require(torch.cuda.is_available(), "prefill host: no CUDA device")
    from gemma_tpu_torch.parallel import multihost
    from gemma_tpu_torch.runtime import Engine, EngineConfig, serve
    from gemma_tpu_torch.runtime.kv_transfer import serve_prefill_host
    from gemma_tpu_torch.testing import make_params

    class CountingEngine(Engine):
        served = 0

        def prefill_standalone(self, prompt, pad_to=None):
            self.served += 1
            return super().prefill_standalone(prompt, pad_to)

    dev = torch.device("cuda", 0)
    multihost.initialize(spec["coordinator"], 2, 1, timeout=300)
    cfg = model_config("Gemma-2B", cut=True)
    model = make_params(cfg, "q4_0", seed=0, device=dev)
    roles = multihost.HostRoles((1,), (0,))
    try:
        for (name, _, host_options, _), transport in zip(DISAGG_RUNS, spec["transports"]):
            ecfg = EngineConfig(max_seq_len=MAX_SEQ_LEN, **host_options)
            Engine(cfg, model, ecfg).prefill_standalone(disagg_requests(cfg)[-1].prompt)  # warm-up
            torch.cuda.synchronize()
            eng = CountingEngine(cfg, model, ecfg)
            reset_counters()
            serve(eng, disagg_requests(cfg), roles=roles, transport=transport)
            torch.cuda.synchronize()
            print(json.dumps({"run": name, "launches": read_counters()}), flush=True)
            print(f"SERVED {eng.served}", flush=True)
        eng = CountingEngine(cfg, model, EngineConfig(max_seq_len=MAX_SEQ_LEN))
        serve_prefill_host(eng, spec["tuple_transport"])
        print(f"SERVED {eng.served}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def same_bits(torch, a, b) -> bool:
    """Two insert tuples hold the same bits (bf16 compared as int16)."""
    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    pairs = list(zip(a[:3], b[:3])) + [(x, y) for x, y in zip(a[3], b[3]) if x is not None]
    return (all(x.dtype == y.dtype and x.shape == y.shape
                and torch.equal(bits(x).cpu(), bits(y).cpu()) for x, y in pairs)
            and int(a[4]) == int(b[4]) and (a[3][0] is None) == (b[3][0] is None))


def handoff(torch, pre, dev) -> tuple[int, float, float, float, bool]:
    """One hand-off of the insert tuple `pre` (on the card) through
    serialize -> a socketpair -> deserialize onto the card: (frame bytes,
    then the median over HANDOFF_REPS of serialize ms, wire ms and
    deserialize-to-card ms, each ended by a synchronize; and whether every
    repetition's tuple holds `pre`'s bits)."""
    import threading

    from gemma_tpu_torch.runtime import kv_transfer as kv

    times, same = [], True
    for _ in range(HANDOFF_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = kv.serialize_prefill(pre)
        t1 = time.perf_counter()
        a, b = socket.socketpair()
        with a, b:
            sender = threading.Thread(target=kv._send_frame, args=(a, data))
            sender.start()
            got = kv._recv_frame(b)
            sender.join()
        t2 = time.perf_counter()
        back = kv.deserialize_prefill(got, dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        same = same and got == data and same_bits(torch, back, pre) and back[0].device == dev
        times.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
    ser, wire, deser = (statistics.median(col) for col in zip(*times))
    return len(data), ser, wire, deser, same


def handoff_line(what: str, reading, card: str) -> str:
    nbytes, ser, wire, deser, _ = reading
    return (f"{what}: {nbytes / 1e6:.3f} MB a frame; serialize {ser:.3f} ms, wire (socketpair) "
            f"{wire:.3f} ms, deserialize to the card {deser:.3f} ms (medians of {HANDOFF_REPS}) "
            f"on {card}; bit for bit")


def first_line(proc, timeout: float) -> str:
    """The first line `proc` prints, or "" if it exits or `timeout` passes."""
    import queue
    import threading

    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: lines.put(proc.stdout.readline()), daemon=True).start()
    try:
        return lines.get(timeout=timeout).strip()
    except queue.Empty:
        return ""


def await_host(child, path: str, err: Path, timeout: float = 300) -> None:
    """Wait until the prefill host listens at the AF_UNIX `path`; fail at
    once if it exits first, or after `timeout` seconds."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        require(child.poll() is None, f"phase 9: the prefill host exited {child.returncode}:\n"
                                      f"{err.read_text()[-4000:]}")
        require(time.monotonic() < deadline, f"phase 9: no prefill host at {path} after "
                                             f"{timeout:g} s")
        time.sleep(0.05)


def disaggregated_serving(torch, dev, card: str) -> None:
    """Phase 9: `serve` across two processes on the card (DISAGG_RUNS), each
    arm against the same `serve` with an in-process prefill engine of the
    host's configuration; one remote tuple bit for bit against the parent's
    own; hand-off times at Gemma-2B and Gemma-7B widths; the prefill worker
    (`python -m gemma_tpu_torch.runtime.kv_transfer --device cuda`) on
    phase 5's tiny q4_0 file."""
    import torch.distributed as dist

    from gemma_tpu_torch.parallel import multihost
    from gemma_tpu_torch.runtime import Engine, EngineConfig, Request, serve
    from gemma_tpu_torch.runtime.kv_transfer import RemotePrefillClient
    from gemma_tpu_torch.testing import make_params

    t_phase = time.perf_counter()
    cfg = model_config("Gemma-2B", cut=True)
    with tempfile.TemporaryDirectory(prefix="smoke") as tmp:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        spec = {"coordinator": f"tcp://127.0.0.1:{port}",
                "transports": [os.path.join(tmp, f"run{i}.sock") for i in range(len(DISAGG_RUNS))],
                "tuple_transport": os.path.join(tmp, "tuple.sock")}
        with open(Path(tmp) / "child.err", "w") as err:
            child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                      "--prefill-host", json.dumps(spec)],
                                     cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            model = make_params(cfg, "q4_0", seed=0, device=dev)
            require(child.poll() is None, f"phase 9: the prefill host exited {child.returncode}:\n"
                                          f"{(Path(tmp) / 'child.err').read_text()[-4000:]}")
            multihost.initialize(spec["coordinator"], 2, 0, timeout=300)
            require((multihost.process_count(), multihost.process_index()) == (2, 0),
                    "phase 9: the parent is not rank 0 of 2")
            roles = multihost.HostRoles((1,), (0,))
            expected_child = []
            for (name, dec_options, host_options, decode_kernel), transport in zip(
                    DISAGG_RUNS, spec["transports"]):
                phase = f"disagg {name}"
                dec = Engine(cfg, model, EngineConfig(max_seq_len=MAX_SEQ_LEN,
                                                      max_batch=SERVE_SLOTS, **dec_options))
                local = Engine(cfg, model, EngineConfig(max_seq_len=MAX_SEQ_LEN, **host_options))
                serve(dec, [Request(r.id, r.prompt, 4) for r in disagg_requests(cfg)[:4]],
                      prefill_engine=local, block=SERVE_BLOCK, route_across_hosts=False)
                torch.cuda.synchronize()
                runs = {}
                for how in ("in-process", "disaggregated"):
                    kw = ({"prefill_engine": local, "route_across_hosts": False}
                          if how == "in-process" else {"roles": roles, "transport": transport})
                    if how == "disaggregated":
                        await_host(child, transport, Path(tmp) / "child.err")
                    reqs = disagg_requests(cfg)
                    reset_counters()
                    t0 = time.perf_counter()
                    sched = serve(dec, reqs, block=SERVE_BLOCK, **kw)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    counts, st = read_counters(), sched.stats()
                    require(len(sched.finished) == DISAGG_REQUESTS and all(
                        len(r.tokens) == DISAGG_NEW_TOKENS
                        and all(0 <= t < cfg.vocab_size for t in r.tokens)
                        for r in sched.finished), f"{phase} {how}: not every request finished "
                                                  f"with {DISAGG_NEW_TOKENS} in-range tokens")
                    # the decode process runs no prefill forward when the
                    # host prefills: no tile (M > 8) and no flash launch
                    prefills = prefill_forwards(reqs, host_options.get("prefill_chunk", 0))
                    expected = expected_forward_launches(
                        cfg, "q4_0", prefills if how == "in-process" else 0, st["decode_steps"],
                        decode_kernel)
                    info(phase, f"{how}: Gemma-2B q4_0 ({depth('Gemma-2B', cfg)}), {SERVE_SLOTS} "
                                f"slots, {DISAGG_REQUESTS} "
                                f"requests x {DISAGG_NEW_TOKENS} tokens, prompts "
                                f"{SERVE_PROMPT_LENS}, block {SERVE_BLOCK} on {card}: "
                                f"{st['total_tokens'] / wall:.2f} tok/s (tokens / wall), TTFT p50 "
                                f"{st['p50_ttft_s'] * 1e3:.1f} ms p99 "
                                f"{st['p99_ttft_s'] * 1e3:.1f} ms, wall {wall:.3f} s, decode "
                                f"steps {st['decode_steps']}; decode-process launches {counts}")
                    require(counts == expected, f"{phase} {how}: launch counts {counts} != "
                                                f"expected {expected}")
                    if decode_kernel.startswith("paged"):
                        require(counts["paged_attention_tc"] == counts[decode_kernel] > 0,
                                f"{phase} {how}: paged decode off the tensor cores")
                    runs[how] = {r.id: r.tokens for r in sched.finished}
                same = sum(runs["disaggregated"][i] == runs["in-process"][i] for i in runs["in-process"])
                info(phase, f"{same} of {DISAGG_REQUESTS} disaggregated streams equal the "
                            "in-process ones")
                require(same == DISAGG_REQUESTS, f"{phase}: {DISAGG_REQUESTS - same} streams differ")
                expected_child.append((name, expected_forward_launches(
                    cfg, "q4_0", prefill_forwards(reqs, host_options.get("prefill_chunk", 0)), 0,
                    "decode_attention")))
                del dec, local

            prompt = disagg_requests(cfg)[-1].prompt  # 203 tokens
            await_host(child, spec["tuple_transport"], Path(tmp) / "child.err")
            client = RemotePrefillClient(spec["tuple_transport"], device=dev)
            try:
                t0 = time.perf_counter()
                remote = client.prefill_standalone(prompt)
                torch.cuda.synchronize()
                fetch_ms = (time.perf_counter() - t0) * 1e3
            finally:
                client.close()
            local = Engine(cfg, model, EngineConfig(max_seq_len=MAX_SEQ_LEN))
            mine = local.prefill_standalone(prompt)
            exact = same_bits(torch, remote, mine)
            diff = max((x.float() - y.float()).abs().max().item()
                       for x, y in zip(remote[:3], mine[:3]))
            info("disagg", f"remote prefill of {len(prompt)} tokens fetched onto the card in "
                           f"{fetch_ms:.3f} ms (prefill, serialize, wire, deserialize); "
                           f"bit for bit the parent's own prefill_standalone: {exact} "
                           f"(max|diff| {diff:.3e})")
            require(exact, "phase 9: the remote tuple differs from the parent's prefill_standalone")
            a = handoff(torch, mine, dev)
            b = handoff(torch, Engine(cfg, model, EngineConfig(
                max_seq_len=MAX_SEQ_LEN, kv_quantized=True, prefill_chunk=PAGE)).prefill_standalone(
                    prompt, pad_to=DISAGG_PAGE), dev)
            info("disagg", handoff_line(f"Gemma-2B ({depth('Gemma-2B', cfg)}) hand-off of "
                                        f"{len(prompt)} tokens, bf16 K/V", a, card))
            info("disagg", handoff_line(f"Gemma-2B ({depth('Gemma-2B', cfg)}) hand-off of "
                                        f"{len(prompt)} tokens, int8 K/V with scales, 256 slots",
                                        b, card))
            require(a[4] and b[4], "phase 9: a Gemma-2B hand-off is not bit for bit")
            del model, local, mine, remote
            torch.cuda.empty_cache()

            out, _ = child.communicate(timeout=300)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
            if dist.is_initialized():
                dist.destroy_process_group()
        err_text = (Path(tmp) / "child.err").read_text()
    require(child.returncode == 0, f"phase 9: the prefill host exited {child.returncode}:\n"
                                   f"{err_text[-4000:]}")
    lines = out.strip().splitlines()
    child_counts = [json.loads(line) for line in lines if line.startswith("{")]
    served = [int(line.split()[1]) for line in lines if line.startswith("SERVED ")]
    info("disagg", f"prefill host (rank 1): SERVED {served}; launches "
                   f"{[(c['run'], c['launches']) for c in child_counts]}")
    require(served == [DISAGG_REQUESTS] * len(DISAGG_RUNS) + [1],
            f"phase 9: the prefill host served {served}, not one prefill an admission")
    for (name, expected), got in zip(expected_child, child_counts):
        require(got["run"] == name and got["launches"] == expected,
                f"phase 9: prefill host launches {got} != expected {expected}")

    # Gemma-7B q8_0's hand-off of a 203-token prompt, without a model
    cfg7 = model_config("Gemma-7B")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shape = (cfg7.n_layers, cfg7.n_kv_heads, PROMPT_LEN, cfg7.head_dim)
    pre7 = (torch.randn(cfg7.vocab_size, generator=gen, device=dev),
            torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16),
            torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16), (None, None),
            PROMPT_LEN)
    c = handoff(torch, pre7, dev)
    info("disagg", handoff_line(f"Gemma-7B hand-off of {PROMPT_LEN} tokens ({cfg7.n_layers} "
                                f"layers x {cfg7.n_kv_heads} KV heads x {PROMPT_LEN} x "
                                f"{cfg7.head_dim}, bf16 K and V)", c, card))
    require(c[4], "phase 9: the Gemma-7B hand-off is not bit for bit")
    del pre7
    torch.cuda.empty_cache()
    worker_checks(torch, dev)
    info("time", f"phase 9 took {time.perf_counter() - t_phase:.1f} s")


def worker_checks(torch, dev) -> None:
    """Phase 9, the worker: `python -m gemma_tpu_torch.runtime.kv_transfer
    --device cuda` on phase 5's tiny q4_0 file, driven by a
    RemotePrefillClient on the card through `serve`; its streams equal the
    same `serve` with an in-process prefill engine of the worker's
    configuration (mode dequant, bf16, max_seq_len 512)."""
    from gemma_tpu_torch.gguf.reader import GGUFReader
    from gemma_tpu_torch.models.params import load_params
    from gemma_tpu_torch.runtime import Engine, EngineConfig, Request, serve
    from gemma_tpu_torch.runtime.kv_transfer import RemotePrefillClient
    from gemma_tpu_torch.testing import TINY_KERNEL_CONFIG, make_gguf

    prompts = [TINY_PROMPT[: 3 + i] * (1 + i) for i in range(6)]
    with tempfile.TemporaryDirectory() as tmp:
        path = make_gguf(Path(tmp) / "tiny.gguf", TINY_KERNEL_CONFIG, seed=0)
        with open(Path(tmp) / "worker.err", "w") as err:
            worker = subprocess.Popen(
                [sys.executable, "-m", "gemma_tpu_torch.runtime.kv_transfer", "--gguf", str(path),
                 "--device", "cuda", "--max-connections", "1"],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            line = first_line(worker, 300)
            require(line.startswith("PORT "), f"worker printed {line!r}:\n"
                                              f"{(Path(tmp) / 'worker.err').read_text()[-4000:]}")
            cfg, model = load_params(GGUFReader(path), dev, mode="dequant")
            ecfg = EngineConfig(max_seq_len=256, max_batch=4)
            client = RemotePrefillClient(("127.0.0.1", int(line.split()[1])), device=dev)
            try:
                remote = serve(Engine(cfg, model, ecfg),
                               [Request(f"w{i}", p, 12) for i, p in enumerate(prompts)],
                               prefill_engine=client, block=4)
            finally:
                client.close()
            out, _ = worker.communicate(timeout=120)
        finally:
            if worker.poll() is None:
                worker.kill()
                worker.wait()
        require(worker.returncode == 0 and out.split() == ["SERVED", str(len(prompts))],
                f"worker exited {worker.returncode} after printing {out!r}")
    local = serve(Engine(cfg, model, ecfg), [Request(f"w{i}", p, 12) for i, p in enumerate(prompts)],
                  prefill_engine=Engine(cfg, model, EngineConfig(max_seq_len=512)), block=4)
    ours, theirs = ({r.id: r.tokens for r in s.finished} for s in (remote, local))
    info("disagg", f"worker on cuda (tiny q4_0, dequant): SERVED {len(prompts)}; "
                   f"{sum(ours[i] == theirs[i] for i in theirs)} of {len(prompts)} streams equal "
                   "the in-process prefill engine's")
    require(ours == theirs, f"worker streams {ours} != in-process {theirs}")


# ---------------------------------------------------------------------------
# phase 10: tensor parallelism
# ---------------------------------------------------------------------------
# 10a: world size 1 over NCCL, in this process; 10b: tp = 2 and 4 as ranks
# sharing the one card over gloo (NCCL puts one rank on one card); 10c: NCCL,
# one rank a card, where the machine has 2 or more
TP_SIZES = (2, 4)
TP_MODELS = (("Gemma-7B", "q8_0"), ("Gemma-2B", "q4_0"))
TP_REL = 2e-2  # bf16 logits against the single-device Engine: of their scale (phase 8's 7B standard)
TP_TIMED_STEPS = 8  # decode steps timed a run (after the first, checked one)
TP_SERVE_REQUESTS = 8  # 10b's serving: Gemma-2B q4_0, paged int8, f32, at tp = 2
TP_SERVE_TOKENS = 24


def tp_matmul_shapes(cfg, tp: int, ms, head_ms) -> list:
    """A shard's quantized-matmul shapes (name, N, K, Ms): fused q|k|v (its
    query heads and its KV heads, one duplicated head where the KV heads do
    not divide), attn_output and ffn_down at K / tp, fused gate|up, and the
    ceil(V / tp)-row head."""
    from gemma_tpu_torch.parallel.shard_decode import local_config

    lc = local_config(cfg, tp)
    return [("qkv", lc.q_dim + 2 * lc.kv_dim, cfg.d_model, ms), ("attn_out", cfg.d_model, lc.q_dim, ms),
            ("gate_up", 2 * lc.d_ff, cfg.d_model, ms), ("down", cfg.d_model, lc.d_ff, ms),
            ("head", lc.vocab_size, cfg.d_model, head_ms)]


def check_tp_kernels(torch, dev) -> dict[str, dict]:
    """Phase 10's kernel checks: every kernel of the tensor-parallel path at
    a shard's shapes, against its plain version, with its time, bound and
    library call, as phase 3 holds the full-width ones: q4_0 at Gemma-2B's
    and q8_0 at Gemma-7B's shard shapes (M = 1, the 203-token prefill's
    tile, and at Gemma-2B tp = 2 the 8 serving rows), q4_k and q6_k at
    TINY_MHA_CONFIG's tp = 2 shapes, decode and flash attention at each
    shard's heads (Gemma-2B: one KV head a shard, G = 4 and 2 on the
    tensor cores; Gemma-7B: 8 and 4 heads, G = 1 on its core), paged
    attention (bf16 and int8 pages of PAGE keys, the 8 serving rows) at
    Gemma-2B's shard heads. Returns {kernel: {"<model> tp=<n>": reading}}."""
    import gemma_tpu_torch.ops.attention as att
    import gemma_tpu_torch.ops.paged_attention as pat
    from gemma_tpu_torch.parallel.shard_decode import local_config
    from gemma_tpu_torch.testing import TINY_MHA_CONFIG
    from gemma_tpu_torch.tools.parent_turn import paged_inputs

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    out: dict[str, dict] = {}
    D, S, T = HEAD_DIM, MAX_SEQ_LEN, PROMPT_LEN
    key = torch.arange(S, device=dev)
    for model_name, fmt in TP_MODELS:
        cfg = model_config(model_name)
        for tp in TP_SIZES:
            label = f"{model_name} tp={tp}"
            serving = (model_name, tp) == ("Gemma-2B", 2)
            ms = (1, SERVE_SLOTS, T) if serving else (1, T)
            out.setdefault(f"{fmt}_matmul", {})[label] = check_matmul(
                torch, fmt, tp_matmul_shapes(cfg, tp, ms, (1,)), "gate_up", gen, dev)
            lc = local_config(cfg, tp)
            hq, hkv = lc.n_heads, lc.n_kv_heads
            q = (torch.randn(1, 1, hq, D, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
            k, v = ((torch.randn(1, hkv, S, D, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
                    for _ in range(2))
            limit = T + 1
            lim = torch.tensor([limit], dtype=torch.int32, device=dev)
            route, split = att.decode_route(torch.bfloat16, hq // hkv, S)
            kname = "decode_attention_g1" if route == "g1" else "decode_attention"
            if route == "g1":
                g1_once(torch, f"decode_attention {label}", lambda: att.decode_attention(q, k, v, lim),
                        route, att.decode_attention)
            r, _ = held_attention(
                torch, kname, f"{label} Hq={hq} Hkv={hkv} S={S} limit={limit} ({route}, {split} keys a "
                              "block)",
                lambda: att.decode_attention(q, k, v, lim),
                lambda: att.decode_attention_plain(q, k, v, lim),
                lambda: sdpa_ms(torch, q, k, v, key[None, None] < limit), *decode_cost([limit], hq, hkv))
            out.setdefault(kname, {})[label] = {**r, "shape": f"Hq={hq} Hkv={hkv} S={S} kv_limit={limit}"}
            qf = (torch.randn(1, T, hq, D, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
            pos = torch.arange(T, device=dev)
            valid = (key[None, None] <= pos[None, :, None]) & (key < T)
            r, _ = held_attention(
                torch, "flash_attention", f"{label} prompt T={T} S={S} Hq={hq} Hkv={hkv}",
                lambda: att.flash_attention(qf, k, v, pos.to(torch.int32)[None], lim - 1),
                lambda: att.flash_attention_plain(qf, k, v, pos.to(torch.int32)[None], lim - 1),
                lambda: sdpa_ms(torch, qf, k, v, valid), *flash_cost(pos.tolist(), T, hq, hkv))
            out.setdefault("flash_attention", {})[label] = {**r, "shape": f"T={T} S={S} Hq={hq} "
                                                                          f"Hkv={hkv}"}
            if model_name != "Gemma-2B":
                continue
            for quantized in (False, True):
                name = "paged_attention_int8" if quantized else "paged_attention"
                qp, cache, plim = paged_inputs(gen, dev, SERVE_SLOTS, hq, hkv, D, PAGE, SERVE_LIMITS,
                                               65, S, quantized)
                route, split = pat.paged_route(torch.bfloat16, hq // hkv, PAGE, S)
                require(route == "tc", f"{name} {label}: took the {route} route")
                nbytes, flops = decode_cost(SERVE_LIMITS, hq, hkv, 2 * (D + 4) if quantized
                                            else 2 * D * 2)
                r, _ = held_attention(
                    torch, name, f"{label} B={SERVE_SLOTS} Hq={hq} Hkv={hkv} ps={PAGE} limits="
                                 f"{SERVE_LIMITS} ({route}, {split} keys a block; no single "
                                 "library call)",
                    lambda: pat.paged_decode_attention(qp, cache, 0, plim),
                    lambda: pat.paged_decode_attention_plain(qp, cache, 0, plim), lambda: None,
                    nbytes + sum(-(-n // PAGE) for n in SERVE_LIMITS) * 4, flops)
                out.setdefault(name, {})[label] = {**r, "shape": f"B={SERVE_SLOTS} Hq={hq} Hkv={hkv} "
                                                                  f"ps={PAGE}"}
                del qp, cache
    # q4_k and q6_k: the tiny q4_k_m model of 10b (TINY_MHA_CONFIG at tp = 2)
    cfg = TINY_MHA_CONFIG
    lc = local_config(cfg, 2)
    out["q4_k_matmul"] = {"TINY_MHA tp=2": check_matmul(torch, "q4_k", [
        ("attn_q", lc.q_dim, cfg.d_model, (1,)), ("attn_k", lc.kv_dim, cfg.d_model, (1,)),
        ("attn_out", cfg.d_model, lc.q_dim, (1,)), ("gate_up", 2 * lc.d_ff, cfg.d_model, (1,)),
        ("down", cfg.d_model, lc.d_ff, (1,))], "down", gen, dev)}
    out["q6_k_matmul"] = {"TINY_MHA tp=2": check_matmul(torch, "q6_k", [
        ("attn_v", lc.kv_dim, cfg.d_model, (1,)), ("head", lc.vocab_size, cfg.d_model, (1,))],
        "head", gen, dev)}
    return out


def tp_prompt(cfg) -> list[int]:
    return [2 + (i * 7919) % (cfg.vocab_size - 2) for i in range(PROMPT_LEN)]


def tp_greedy(torch, eng, prompt, n: int, timed: int = 0, mesh=None) -> dict:
    """Greedy decode through `eng` (an Engine or a TPEngine): the prompt's
    logits, the first decode step's, n tokens (n decode steps), then `timed`
    more steps timed (wall ms a step, ended by a synchronize) and, given
    the mesh, one more step's collectives by axis. Logits on the host."""
    logits, cache = eng.prefill([prompt])
    out = {"prefill": logits[0].float().cpu()}
    toks = []
    for i in range(n):
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(int(tok[0]))
        logits, cache = eng.decode_step(tok, cache)
        if i == 0:
            out["step1"] = logits[0].float().cpu()
    out["tokens"] = toks
    if timed:
        tok = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            logits, cache = eng.decode_step(tok, cache)
        torch.cuda.synchronize()
        out["step_ms"] = (time.perf_counter() - t0) * 1e3 / timed
    if mesh is not None:
        mesh.reset_stats()
        eng.decode_step(logits.argmax(-1).to(torch.int32), cache)
        out["collectives"] = mesh.collective_stats()
        if timed:
            out["collectives_ms"] = collectives_ms(torch, eng, mesh, out["collectives"], timed)
    return out


def collectives_ms(torch, eng, mesh, stats: dict, reps: int) -> float:
    """Wall ms of a decode step's collectives alone (batch 1): its
    all-reduces of [1, 1, d_model] activations and its logits all-gather,
    replayed `reps` times on zeros, ended by a synchronize."""
    c = eng.lcfg
    x = torch.zeros(1, 1, c.d_model, dtype=c.act_dtype, device=eng.device)
    y = torch.zeros(1, 1, c.vocab_size, dtype=torch.float32, device=eng.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for _ in range(stats["model"]["all_reduce"]):
            mesh.model.all_reduce(x)
        mesh.model.all_gather(y, -1)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    mesh.reset_stats()
    return ms


def rel_diff(a, b) -> float:
    """max|a - b| over b's scale."""
    return float((a - b).abs().max() / b.abs().max())


def expected_tp_launches(cfg, fmt: str, prefills: int, steps: int, kernel: str, f32: bool) -> dict:
    """`expected_forward_launches`; f32 activations take no bf16
    tensor-core attention route, the TF32 flash kernel, q8_0's and
    q4_k_m's prefill matmuls (prompts of more than 8 tokens) the TF32
    tile, and q4_0's and q4_k's other matmuls the f32 GEMV."""
    counts = expected_forward_launches(cfg, fmt, prefills, steps, kernel)
    if f32:
        for name in ("flash_attention_tc", "decode_attention_tc", "paged_attention_tc"):
            counts[name] = 0
        f32_route_launches(counts, cfg, fmt, prefills, head=False)
    return counts


def tp_scenarios(cfg, fmt: str, serving: bool) -> list:
    """(name, activation dtype, EngineConfig options, new tokens, timed
    steps, decode counter) of one model in 10b: bf16 over the dense cache
    (the first step's logits, then timed steps), bf16 over paged int8 (the
    first step), f32 over an f32 cache (the stream), and at serving, the f32
    paged int8 serve."""
    import torch

    paged = {"paged": True, "page_size": PAGE, "kv_quantized": True}
    runs = [("bf16 dense", "bfloat16", {}, 1, TP_TIMED_STEPS, "decode_attention"),
            ("f32 dense", "float32", {"kv_dtype": torch.float32}, NEW_TOKENS, 0, "decode_attention")]
    if fmt == "q4_0":
        runs.insert(1, ("bf16 paged int8", "bfloat16", paged, 1, 0, "paged_attention_int8"))
    if serving:
        runs.append(("f32 serve paged int8", "float32", paged, TP_SERVE_TOKENS, 0,
                     "paged_attention_int8"))
    return runs


def tp_serve_requests(cfg):
    from gemma_tpu_torch.runtime import Request

    return [Request(r.id, r.prompt, TP_SERVE_TOKENS) for r in serve_requests(cfg)[:TP_SERVE_REQUESTS]]


def tp_run(torch, eng, cfg, prompt, name, new, timed, mesh=None) -> dict:
    """One scenario of `tp_scenarios` on `eng`."""
    from gemma_tpu_torch.runtime import serve

    if name.startswith("f32 serve"):
        sched = serve(eng, tp_serve_requests(cfg), block=4)
        return {"streams": {r.id: r.tokens for r in sched.finished},
                "decode_steps": sched.stats()["decode_steps"]}
    return tp_greedy(torch, eng, prompt, new, timed, mesh)


def tp_references(torch, dev, card: str) -> dict:
    """The single-device Engine's results of every 10b scenario (and the
    tiny q4_k_m stream), and 10a: Gemma-7B q8_0 through a TPEngine at world
    size 1 over NCCL, held to the Engine bit for bit. Returns {"refs":
    {(model, scenario): result}, "counts": 10a's launches}."""
    import dataclasses

    from gemma_tpu_torch.parallel import multihost
    from gemma_tpu_torch.parallel.shard_decode import TPEngine
    from gemma_tpu_torch.parallel.sharding import make_mesh
    from gemma_tpu_torch.runtime import Engine, EngineConfig
    from gemma_tpu_torch.testing import TINY_MHA_CONFIG, make_params

    refs, counts = {}, {}
    for model_name, fmt in TP_MODELS:
        cfg = model_config(model_name, cut=True)
        model = make_params(cfg, fmt, seed=0, device=dev)
        prompt = tp_prompt(cfg)
        for name, act, opts, new, timed, _ in tp_scenarios(cfg, fmt, model_name == "Gemma-2B"):
            c = dataclasses.replace(cfg, activation_dtype=act)
            batch = SERVE_SLOTS if "serve" in name else 1
            eng = Engine(c, model, EngineConfig(max_seq_len=MAX_SEQ_LEN, max_batch=batch, **opts))
            refs[(model_name, name)] = tp_run(torch, eng, c, prompt, name, new, timed)
        if model_name != "Gemma-7B":
            del model
            continue
        # 10a: the same Gemma-7B through a TPEngine over NCCL at world size 1
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        multihost.initialize(f"tcp://127.0.0.1:{port}", 1, 0, timeout=120)
        try:
            mesh = make_mesh(1, 1, backend="nccl", device=dev)
            tpe = TPEngine(cfg, model, mesh, max_seq_len=MAX_SEQ_LEN)
            tp_greedy(torch, tpe, prompt[:16], 2)  # warm-up
            reset_counters()
            got = tp_greedy(torch, tpe, prompt, NEW_TOKENS, TP_TIMED_STEPS, mesh)
            counts = read_counters()
            eng = Engine(cfg, model, EngineConfig(max_seq_len=MAX_SEQ_LEN))
            one = tp_greedy(torch, eng, prompt, NEW_TOKENS, TP_TIMED_STEPS)
        finally:
            dist_destroy()
        exact = all(torch.equal(got[k], one[k]) for k in ("prefill", "step1"))
        expected = expected_tp_launches(cfg, fmt, 1, NEW_TOKENS + TP_TIMED_STEPS + 1,
                                        "decode_attention", False)
        info("tp", f"10a: {model_name} {fmt} at full width ({depth(model_name, cfg)}) through "
                   f"TPEngine, world size 1 over "
                   f"NCCL (mesh {mesh.shape}): prompt {PROMPT_LEN} + {NEW_TOKENS} greedy tokens; "
                   f"prefill and first-step logits bit for bit the Engine's: {exact}; stream "
                   f"equal: {got['tokens'] == one['tokens']}; wall ms a decode step "
                   f"{got['step_ms']:.3f} (nccl, tp=1) against the Engine's {one['step_ms']:.3f} "
                   f"on {card}, its collectives alone {got['collectives_ms']:.3f} ms; collectives "
                   f"a decode step {got['collectives']}; launches {counts}")
        require(exact and got["tokens"] == one["tokens"], "10a: the TPEngine at world size 1 is not "
                                                           "the Engine bit for bit")
        require(counts == expected, f"10a: launch counts {counts} != expected {expected}")
        stats = got["collectives"]
        require(stats["data"] == {} and stats["model"]["all_reduce"] == 2 * cfg.n_layers + 1
                and stats["model"]["all_gather"] == 1, f"10a: collectives {stats}")
        del tpe, model, eng
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(TINY_MHA_CONFIG, activation_dtype="float32")
    model = make_params(cfg, "q4_k_m", seed=0, device=dev)
    eng = Engine(cfg, model, EngineConfig(max_seq_len=256, kv_dtype=torch.float32))
    refs[("TINY_MHA", "f32 dense")] = tp_greedy(torch, eng, TINY_PROMPT, NEW_TOKENS)
    del model, eng
    torch.cuda.empty_cache()
    return {"refs": refs, "counts": counts}


def dist_destroy() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def tp_rank(spec: dict) -> int:
    """A rank of 10b (gloo, every rank on cuda:0) or 10c (nccl, cuda:<rank>):
    each model's shard drawn on the card (`make_params(tp=...)`: the whole
    model never sits on a rank), each scenario of `tp_scenarios` through a
    TPEngine, launches counted from 0 around each on rank 0 (every rank
    counts the same), and its results saved for the parent to hold."""
    import dataclasses

    import torch

    from gemma_tpu_torch.kernels import build
    from gemma_tpu_torch.parallel import multihost
    from gemma_tpu_torch.parallel.shard_decode import TPEngine, local_config
    from gemma_tpu_torch.parallel.sharding import make_mesh
    from gemma_tpu_torch.testing import TINY_MHA_CONFIG, make_params

    require(torch.cuda.is_available(), "tp rank: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, tp = spec["rank"], spec["world"]
    dev = torch.device("cuda", rank if spec["backend"] == "nccl" else 0)
    torch.cuda.set_device(dev)
    build.load()
    multihost.initialize(spec["coordinator"], tp, rank, timeout=300)
    out = {"rank": rank, "runs": {}, "counts": {}, "peak_gb": {}}
    try:
        mesh = make_mesh(1, tp, backend=spec["backend"], device=dev)
        models = [(m, f, model_config(m, cut=True)) for m, f in TP_MODELS]
        if spec["tiny"]:
            models.append(("TINY_MHA", "q4_k_m", TINY_MHA_CONFIG))
        for model_name, fmt, cfg in models:
            torch.cuda.reset_peak_memory_stats(dev)
            shard = make_params(cfg, fmt, seed=0, device=dev, tp=(rank, tp))
            shard_gb = sum(b.numel() * b.element_size() for b in shard.buffers()) / 1e9
            out["peak_gb"][model_name] = (shard_gb, torch.cuda.max_memory_allocated(dev) / 1e9)
            lcfg = local_config(cfg, tp)
            if model_name == "TINY_MHA":
                scenarios = [("f32 dense", "float32", {"kv_dtype": torch.float32}, NEW_TOKENS, 0,
                              "decode_attention")]
                prompt, seq = TINY_PROMPT, 256
            else:
                scenarios = tp_scenarios(cfg, fmt, spec["serving"] and model_name == "Gemma-2B")
                prompt, seq = tp_prompt(cfg), MAX_SEQ_LEN
            for name, act, opts, new, timed, kernel in scenarios:
                c = dataclasses.replace(cfg, activation_dtype=act)
                batch = SERVE_SLOTS if "serve" in name else 1
                eng = TPEngine(c, shard, mesh, max_seq_len=seq, max_batch=batch, **opts)
                tp_greedy(torch, eng, prompt[:16], 2)  # warm-up
                torch.cuda.synchronize()
                reset_counters()
                got = tp_run(torch, eng, c, prompt, name, new, timed, mesh)
                torch.cuda.synchronize()
                counts = read_counters()
                # a greedy run's steps: n, the timed ones, the collectives' one
                steps = got["decode_steps"] if "streams" in got else new + timed + 1
                prefills = TP_SERVE_REQUESTS if "serve" in name else 1
                expected = expected_tp_launches(lcfg, fmt, prefills, steps, kernel,
                                                act == "float32")
                require(counts == expected, f"tp={tp} rank {rank} {model_name} {name}: launches "
                                            f"{counts} != expected {expected}")
                out["runs"][f"{model_name}|{name}"] = got
                out["counts"][f"{model_name}|{name}"] = counts
                del eng
            del shard
            torch.cuda.empty_cache()
        torch.save(out, Path(spec["out"]) / f"rank{rank}.pt")
    finally:
        dist_destroy()
    return 0


def spawn_tp(tp: int, backend: str, tmp: Path, serving: bool, tiny: bool) -> list[dict]:
    """Run a group of `tp` ranks (this script with --tp-rank) to its end;
    every rank's saved results."""
    import torch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp / f"{backend}{tp}"
    out.mkdir()
    procs = []
    for rank in range(tp):
        spec = {"coordinator": f"tcp://127.0.0.1:{port}", "world": tp, "rank": rank,
                "backend": backend, "out": str(out), "serving": serving, "tiny": tiny}
        with open(out / f"rank{rank}.err", "w") as err:
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                           "--tp-rank", json.dumps(spec)],
                                          cwd=ROOT, stdout=subprocess.DEVNULL, stderr=err))
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        require(p.returncode == 0, f"tp={tp} {backend} rank {rank} exited {p.returncode}:\n"
                                   f"{(out / f'rank{rank}.err').read_text()[-4000:]}")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(tp)]


def hold_tp_group(torch, card: str, tp: int, backend: str, ranks: list[dict], refs: dict) -> dict:
    """Hold one group's results against the single-device references:
    bf16 logits within TP_REL of their scale, f32 streams (and served
    streams) equal, every rank alike. Prints the collectives and wall ms a
    decode step. Returns rank 0's launches summed over its scenarios."""
    phase = f"tp={tp} {backend}"
    r0 = ranks[0]
    for key, got in r0["runs"].items():
        model_name, name = key.split("|")
        ref = refs[(model_name, name)]
        for other in ranks[1:]:
            o = other["runs"][key]
            require(o.get("tokens") == got.get("tokens") and o.get("streams") == got.get("streams"),
                    f"{phase} {key}: ranks disagree")
        if "streams" in got:
            same = sum(got["streams"][i] == ref["streams"][i] for i in ref["streams"])
            info("tp", f"{phase} {model_name} {name}: {TP_SERVE_REQUESTS} requests x "
                       f"{TP_SERVE_TOKENS} tokens through serve() on a paged int8 TPEngine; {same} "
                       f"of {len(ref['streams'])} streams equal the one-process Engine's f32 serve; "
                       f"decode steps {got['decode_steps']}")
            require(same == len(ref["streams"]), f"{phase} {key}: streams differ")
            continue
        d_pre, d_step = rel_diff(got["prefill"], ref["prefill"]), rel_diff(got["step1"], ref["step1"])
        line = (f"{phase} {model_name} {name}: prefill logits {d_pre:.3e} and first-step logits "
                f"{d_step:.3e} of their scale from the single-device Engine's; stream "
                f"{sum(a == b for a, b in zip(got['tokens'], ref['tokens']))} of "
                f"{len(ref['tokens'])} tokens equal")
        if "step_ms" in got:
            line += (f"; wall ms a decode step {got['step_ms']:.3f} ({backend}, tp={tp}, ranks "
                     f"{'sharing one card' if backend == 'gloo' else 'one a card'}) against "
                     f"{ref['step_ms']:.3f} single-device on {card}; its collectives alone "
                     f"{got['collectives_ms']:.3f} ms (share "
                     f"{got['collectives_ms'] / got['step_ms']:.3f})")
        info("tp", line)
        if name.startswith("bf16"):
            require(d_step <= TP_REL and d_pre <= TP_REL, f"{phase} {key}: logits {d_pre:.3e} / "
                                                          f"{d_step:.3e} > {TP_REL} of their scale")
        else:
            require(got["tokens"] == ref["tokens"], f"{phase} {key}: f32 stream {got['tokens']} != "
                                                    f"single-device {ref['tokens']}")
        if "collectives" in got:
            info("tp", f"{phase} {model_name}: collectives a decode step by axis (calls and bytes): "
                       f"{got['collectives']}")
            require(got["collectives"]["data"] == {}, f"{phase}: data-axis traffic in a decode step")
    for model_name, (shard_gb, peak_gb) in r0["peak_gb"].items():
        info("tp", f"{phase} {model_name}: rank 0 holds a {shard_gb:.3f} GB shard; peak allocated "
                   f"while drawing it {peak_gb:.3f} GB (one whole layer and the embedding at a time)")
    total: dict[str, int] = {}
    for counts in r0["counts"].values():
        add_counts(total, counts)
    info("tp", f"{phase}: rank 0's launches over its runs {total}")
    return total


def tensor_parallel(torch, dev, card: str) -> tuple[dict[str, int], dict[str, dict]]:
    """Phase 10. Returns (launches of the tensor-parallel runs: 10a's and
    rank 0's of each 10b group, the shard-shape readings by kernel)."""
    t_phase = time.perf_counter()
    readings = check_tp_kernels(torch, dev)
    info("time", f"phase 10 kernel checks took {time.perf_counter() - t_phase:.1f} s")
    info("tp", "10a and 10b at full width over each model's first layers: " + ", ".join(
        f"{m} {depth(m, model_config(m, cut=True))}" for m, _ in TP_MODELS))
    ref = tp_references(torch, dev, card)
    counts = dict(ref["counts"])
    with tempfile.TemporaryDirectory(prefix="tp") as tmp:
        for tp in TP_SIZES:
            t0 = time.perf_counter()
            ranks = spawn_tp(tp, "gloo", Path(tmp), serving=tp == 2, tiny=tp == 2)
            add_counts(counts, hold_tp_group(torch, card, tp, "gloo", ranks, ref["refs"]))
            info("time", f"10b tp={tp} took {time.perf_counter() - t0:.1f} s")
        n = torch.cuda.device_count()
        if n >= 2:
            t0 = time.perf_counter()
            ranks = spawn_tp(n, "nccl", Path(tmp), serving=False, tiny=False)
            add_counts(counts, hold_tp_group(torch, card, n, "nccl", ranks, ref["refs"]))
            info("time", f"10c tp={n} took {time.perf_counter() - t0:.1f} s")
        else:
            info("tp", "10c: not run: this machine has 1 CUDA device, and NCCL puts one rank on "
                       "one card, so a tp >= 2 NCCL mesh needs 2 or more cards (10b's ranks share "
                       "the card over gloo: they hold the path, not scaling)")
    info("time", f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return counts, readings


# phase 11: the serving and step benches (gemma_tpu_torch/tools/) at full
# Gemma-2B width with short arguments: (tool, argv). bench_serving runs once
# as a user runs it, in a subprocess beside the rest, which run through
# main(argv) here (the eager step leaves the card mostly idle). Its weights
# are centred q4_0 draws: with uniform nibbles or zero payloads every
# request repeats one token, the same in all, and the streams' digest shows
# nothing of which request went where. Centred, each request repeats its
# prompt's last token (the tied head reads back the residual's embedding):
# a request given another's prompt or slot shows, a wrong cache does not
BENCH_REQUESTS = 8
BENCH_SERVING = ["--requests", str(BENCH_REQUESTS), "--max-new", "16", "--fill", "centred"]
BENCH_RUNS = (
    ("bench_serving", [*BENCH_SERVING, "--admit-per-tick", "1"]),
    ("bench_serving", [*BENCH_SERVING, "--paged", "--kv-quant"]),
    ("bench_itl", ["--prompt-len", "1024", "--block", "4", "--steady-new", "80", "--repeats", "1"]),
    ("bench_longctx", ["--fmt", "q4_k_m", "--ctx", "1024", "--prefill", "512", "--tokens", "8",
                       "--repeats", "1"]),
    ("bench_step_parts", ["q4_0", "--r", "1", "--reps", "1"]),
    ("bench_micro", ["q4_0", "--reps", "10"]),
    ("bench_scan", ["--steps", "16", "--runs", "1"]),
)
# the keys of each bench's last line (the reference's, where it prints JSON)
BENCH_KEYS = {
    "bench_serving": {"metric", "value", "unit", "requests", "decode_steps", "p50_ttft_s",
                      "p99_ttft_s", "block", "wall_s", "admit_per_tick", "prefill_chunk",
                      "kv_quant", "fill"},
    "bench_itl": {"metric", "max_itl_ms_sync", "max_itl_ms_overlap", "prompt_len", "chunk",
                  "block"},
    "bench_longctx": {"metric", "prefill_tokens", "dense", "paged", "page_size_resolved",
                      "dense_int8kv", "paged_int8kv", "page_size", "unit"},
    "bench_step_parts": {"metric", "matmuls_ms", "attn_ms", "ew_ms", "step_ms", "tok_s",
                         "attribution_ms", "busy_ms", "kernels_per_token", "chained"},
    "bench_micro": {"metric", "matmuls", "matmul_sum_ms", "matmul_device_sum_ms", "sdpa_us",
                    "sdpa_device_us", "decode_attention_us", "decode_attention_device_us",
                    "dispatch_us", "step_ms", "tok_s", "peak_gbs"},
    "bench_scan": {"metric", "chain_ms", "chain_tok_s", "block_ms", "block_tok_s", "scan_ms",
                   "steps", "prompt"},
}
# each bench's rates, which must be finite and positive
BENCH_RATES = {"bench_serving": ("value", "p50_ttft_s", "wall_s"),
               "bench_itl": ("max_itl_ms_sync", "max_itl_ms_overlap"),
               "bench_longctx": ("dense", "paged", "dense_int8kv", "paged_int8kv"),
               "bench_step_parts": ("matmuls_ms", "attn_ms", "ew_ms", "step_ms"),
               "bench_micro": ("matmul_sum_ms", "matmul_device_sum_ms", "sdpa_device_us",
                               "decode_attention_device_us", "dispatch_us", "step_ms"),
               "bench_scan": ("chain_ms", "block_ms")}
# kernels the phase's runs must launch between them: #1, #3, #4, #6 in both
# arms, #7 and #8
BENCH_KERNELS = ("q4_0_matmul", "q4_k_matmul", "q6_k_matmul", "decode_attention",
                 "decode_attention_int8", "flash_attention", "paged_attention",
                 "paged_attention_int8")


def bench_output(name: str, text: str) -> tuple[dict, dict[str, int], str | None]:
    """(the last line's record, the `launches {...}` line's counts, the
    `streams ...` line's words after `streams`, or None) of a bench's
    output, its keys and rates held to BENCH_KEYS and BENCH_RATES and every
    launch count above 0."""
    lines = text.strip().splitlines()
    for line in lines:
        info(f"bench {name}", line)
    record = json.loads(lines[-1])
    want = BENCH_KEYS[name] | ({"speculative"} if "speculative" in record else set())
    require(set(record) == want, f"{name}: keys {sorted(record)} != {sorted(want)}")
    for key in BENCH_RATES[name]:
        require(isinstance(record[key], (int, float)) and math.isfinite(record[key])
                and record[key] > 0, f"{name}: {key} = {record[key]!r}, not a finite rate above 0")
    reported = [json.loads(line.split(" ", 1)[1]) for line in lines if line.startswith("launches ")]
    require(len(reported) == 1 and reported[0] and all(n > 0 for n in reported[0].values()),
            f"{name}: launches {reported}")
    streams = [line.split(" ", 1)[1] for line in lines if line.startswith("streams ")]
    return record, reported[0], streams[0] if streams else None


def serving_benches(card: str) -> None:
    """Phase 11: the serving and step benches on the card at full Gemma-2B
    width, short arguments: bench_serving uncapped in a subprocess, beside
    BENCH_RUNS in-process. Each bench resets the launch counters before its
    measured work and prints what it launched; a bench whose run took a
    plain version on the card raises (`_timing.launches_line`). The capped
    run (--admit-per-tick 1) decodes at least the uncapped run's steps and
    gives its streams, which must differ from request to request. The
    launches, summed by
    kernel, must cover BENCH_KERNELS; they are printed, not returned: they
    count the benches' timing loops, not a path's run."""
    import contextlib
    import importlib
    import io

    t_phase = time.perf_counter()
    counts: dict[str, int] = {}
    records: list[tuple[list[str], dict, str | None]] = []
    child = subprocess.Popen([sys.executable, "-m", "gemma_tpu_torch.tools.bench_serving",
                              *BENCH_SERVING], cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        for name, argv in BENCH_RUNS:
            t0 = time.perf_counter()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = importlib.import_module(f"gemma_tpu_torch.tools.{name}").main(argv)
            require(rc == 0 and out.getvalue().splitlines()[0] == card, f"{name} {argv}: rc {rc}")
            record, launched, streams = bench_output(name, out.getvalue())
            add_counts(counts, launched)
            if name == "bench_serving":
                records.append((argv, record, streams))
            info("time", f"{name} {' '.join(argv)} took {time.perf_counter() - t0:.1f} s")
        stdout, stderr = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    require(child.returncode == 0, f"tools.bench_serving failed ({child.returncode}):\n"
                                   f"{stderr[-4000:]}")
    require(stdout.splitlines()[0] == card, f"bench_serving printed no card line: {stdout[:200]!r}")
    base, launched, base_streams = bench_output("bench_serving", stdout)
    add_counts(counts, launched)
    info("time", f"bench_serving (subprocess, beside the rest) done at "
                 f"{time.perf_counter() - t_phase:.1f} s")
    _, _, distinct, _, fewest = base_streams.split()
    require(int(distinct) == BENCH_REQUESTS,
            f"bench_serving's streams are degenerate: {distinct} distinct of {BENCH_REQUESTS}")
    info("bench", f"{distinct} distinct streams of {BENCH_REQUESTS}, the poorest holding {fewest} "
                  f"distinct tokens")
    for argv, record, streams in records:
        require(record["requests"] == base["requests"] == BENCH_REQUESTS,
                f"bench_serving served {record['requests']} and {base['requests']} of "
                f"{BENCH_REQUESTS} requests")
        if "--admit-per-tick" in argv:
            require(record["decode_steps"] >= base["decode_steps"],
                    f"capped bench_serving decoded {record['decode_steps']} steps, fewer than the "
                    f"uncapped {base['decode_steps']}")
            require(streams == base_streams, "capped and uncapped bench_serving streams differ")
            info("bench", f"--admit-per-tick 1: {record['decode_steps']} decode steps against "
                          f"{base['decode_steps']} uncapped, streams equal ({streams})")
    missing = [k for k in BENCH_KERNELS if not counts.get(k)]
    require(not missing, f"the benches launched none of {missing}: {counts}")
    info("bench", f"launches {json.dumps(counts)}")
    info("time", f"phase 11 took {time.perf_counter() - t_phase:.1f} s")


# phase 12: the reference's last five tools (gemma_tpu_torch/tools/) at full
# width with short arguments, through their main(argv): (tool, argv, the
# regular expression of a reading line, the lines it must print). The decode
# sweep at the reference's longest cache, four arms at five splits and the
# split-S kernel; flash at 1, 2 and 4 row warps and the plan, and SDPA; every
# format at the 2b shapes; q4_0 at every Gemma-2B decode shape and the step's
# sum; the cache cost of Gemma-7B's five probes at 2048 and 4096 slots and
# their ratios
_NUM = r"\s+([0-9.]+)"
REF_TOOLS = (
    ("bench_decode_attn", ["--sizes", "8192:8000"],
     r"^\s+(bf16|int8|f32|f32_int8)\s+S= 8192 limit= 8000 (split=\s*\d+[ *]|split-S \(64 keys, \+ combine\))"
     + _NUM + " us" + _NUM + " GB/s$", 24),
    ("bench_flash", ["2048"], r"^\s+(row warps \d|the plan's|scaled_dot_product_attention).*?" + _NUM
     + " us/layer" + _NUM + " TFLOP/s$", 5),
    ("bench_fmt_kernels", ["2b"], r"^(ffn_down|gate_up|lm_head)\s+(q4_0|q4_k|q6_k|q8_0)" + _NUM + " us" + _NUM
     + r" GB/s\s+\(([0-9.]+) MB\)$", 12),
    ("bench_shapes", [], r"^\s+(qkv|attn_out|gate_up|ffn_down|lm_head|lm_head_pad)\s+\[.*\]" + _NUM + " us"
     + _NUM + r" GB/s\s+\(\s*([0-9.]+) MB\) x(1|18)$", 6),
    ("probe_cache_cost", [], r"^\s+S=(2048|4096): \S+" + _NUM + " ms/step device" + _NUM + " ms/step wall$",
     10),
)


def reference_tools(card: str) -> None:
    """Phase 12: REF_TOOLS on the card, in this process: each prints the card
    line first and its reading lines (as many as it must, every number
    finite and above 0), each holding its kernels to their plain versions
    as it runs; the decode sweep marks one split an arm as the route's, the
    shapes bench sums the step and the cache probe prints its five ratios.
    Every tool but the two attention sweeps (direct launches through the
    C entry points) prints its launches, each above 0."""
    import contextlib
    import importlib
    import io

    t_phase = time.perf_counter()
    for name, argv, pattern, n_lines in REF_TOOLS:
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = importlib.import_module(f"gemma_tpu_torch.tools.{name}").main(argv)
        lines = out.getvalue().strip().splitlines()
        for line in lines:
            info(f"tool {name}", line)
        readings = [m for m in map(re.compile(pattern).match, lines) if m]
        numbers = [float(x) for m in readings for x in m.groups() if re.fullmatch(r"[0-9.]+", x)]
        require(rc == 0 and lines[0] == card and len(readings) == n_lines
                and all(math.isfinite(x) and x > 0 for x in numbers),
                f"tools.{name} {argv}: rc {rc}, {len(readings)} of {n_lines} reading lines")
        launched = [json.loads(line.split(" ", 1)[1]) for line in lines if line.startswith("launches ")]
        require(name in ("bench_decode_attn", "bench_flash")
                or (len(launched) == 1 and launched[0] and all(n > 0 for n in launched[0].values())),
                f"tools.{name}: launches {launched}")
        if name == "bench_decode_attn":
            require(sum("*" in m.group(2) for m in readings) == 4, "bench_decode_attn: the route's split unmarked")
        if name == "bench_shapes":
            require(any(line.startswith("  sum over decode matmuls") for line in lines), "bench_shapes: no sum")
        if name == "probe_cache_cost":
            require(sum(" S=4096 / S=2048: device " in line for line in lines) == 5,
                    "probe_cache_cost: not every probe's ratio")
        info("time", f"tools.{name} {' '.join(argv)} took {time.perf_counter() - t0:.1f} s")
    info("time", f"phase 12 took {time.perf_counter() - t_phase:.1f} s")


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
    # a run near the 1200 s limit leaves its stack on stderr, so a cut run
    # shows the phase it was in
    faulthandler.dump_traceback_later(STACK_DUMP_S)
    build.load()
    built = build.build_seconds
    info("build", (f"nvcc sm_90a build of {len(build.sources())} sources in {built:.1f} s"
                   if built is not None else "kernel library already built")
         + f" ({time.perf_counter() - t0:.1f} s to load): {build.library_path().name}")

    last = [time.perf_counter()]

    def done(phase: str) -> None:
        now = time.perf_counter()
        info("time", f"{phase} took {now - last[0]:.1f} s, done at {now - t0:.1f} s")
        last[0] = now

    results = check_kernels(torch, dev)
    results.update(check_tf32_routes(torch, dev))
    results["flash_attention"].update(check_verify_attention(torch, dev))
    results.update(check_serving_kernels(torch, dev))
    results.update(check_g1(torch, dev))
    check_edge_cases(torch, dev)
    check_serving_edge_cases(torch, dev)
    done("kernels (phase 3)")
    for name, by_model in check_arch_kernels(torch, dev).items():
        results[name]["arch"] = by_model
    done("Gemma-2-2B and Gemma-3-4B kernels (phase 3)")
    # each path's launches: the plain generation's, plus its speculative run's
    counts_q4_0, spec_q4_0 = main_path(torch, dev, card, "Gemma-2B", "q4_0")
    counts, spec = main_path(torch, dev, card, "Gemma-2B", "q4_k_m")
    counts = {name: n + spec[name] for name, n in counts.items()}
    counts["q4_0_matmul"] = counts_q4_0["q4_0_matmul"] + spec_q4_0["q4_0_matmul"]
    done("generation (phases 4, 4b)")
    counts_7b, spec_7b = main_path(torch, dev, card, "Gemma-7B", "q8_0")
    counts["q8_0_matmul"] = counts_7b["q8_0_matmul"] + spec_7b["q8_0_matmul"]
    counts["decode_attention_g1"] = counts_7b["decode_attention_g1"] + spec_7b["decode_attention_g1"]
    done("Gemma-7B q8_0 generation (phase 4c)")
    add_counts(counts, long_contexts(torch, dev, card))
    done("Gemma-2-2B and Gemma-3-4B past their windows (phase 4d)")
    tiny_checks(torch, dev)
    tiny_f32 = tiny_serving_checks(torch, dev)
    for name, *_, core in TINY_F32_SERVE:  # f32 serving's path: the core's f32 policies over int8 and pages
        counts[core] = tiny_f32[core]
    tiny_spec_checks(torch, dev)
    done("tiny checks (phase 5)")
    served = serving(torch, dev, card, "Gemma-2B", "q4_0", spec=True)
    done("serving (phase 6)")
    for name, run in (("decode_attention_int8", "dense int8"), ("paged_attention", "paged bf16"),
                      ("paged_attention_int8", "paged int8")):
        counts[name] = served[run][name]
        if name.startswith("paged"):  # of those, on the tensor cores
            results[name]["tc_launches"] = served[run]["paged_attention_tc"]
    served_7b = serving(torch, dev, card, "Gemma-7B", "q8_0", runs=SERVE_7B_RUNS)
    counts["paged_attention_g1"] = served_7b["paged bf16"]["paged_attention_g1"]
    done("Gemma-7B q8_0 serving (phase 6b)")
    add_counts(counts, arch_serving(torch, dev, card))
    done("Gemma-2-2B and Gemma-3-4B serving (phase 6c)")
    results.update(check_tool_kernels(torch, dev))
    counts.update(run_tools(dev))
    done("decode-GEMV instruments (phase 7)")
    quality_counts, eval_readings = quality_gates(torch, dev, card)
    add_counts(counts, quality_counts)
    for name in ("flash_attention_tf32", "decode_attention_tf32", "q4_0_matmul_gemv_f32",
                 "q8_0_matmul_gemv_f32", "q4_k_matmul_gemv_f32", "q6_k_matmul_gemv_f32",
                 *(name for name, _, _ in F32_CORE_ROUTES)):
        results[name] = eval_readings.pop(name)
    for name, reading in eval_readings.items():  # the G = 1 kernels with f32 q ("f32")
        results[name].update(reading)
    done("quality gates (phase 8)")
    disaggregated_serving(torch, dev, card)
    done("serving across two processes (phase 9)")
    tp_counts, tp_readings = tensor_parallel(torch, dev, card)
    add_counts(counts, tp_counts)
    for name, reading in tp_readings.items():  # the shard-local shapes
        results[name]["tp"] = reading
    done("tensor parallelism (phase 10)")
    serving_benches(card)
    done("serving and step benches (phase 11)")
    reference_tools(card)
    done("the reference's last five tools (phase 12)")
    require("jax" not in sys.modules, "jax was imported")
    faulthandler.cancel_dump_traceback_later()
    info("time", f"the whole script took {time.perf_counter() - t0:.1f} s, the kernels' build included")

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": counts[name], **results[name]}
        for name, (src, replaces) in {**KERNELS, **TOOL_KERNELS}.items()
    ]
    require(all(counts[f"{fmt}_matmul_gemv_f32"] > 0 for fmt in ("q4_0", "q8_0", "q4_k", "q6_k")),
            "the f32 paths launched no f32 GEMV")
    require(counts["decode_attention_tf32"] > 0, "the f32 paths launched no TF32 decode")
    require(all(counts[name] > 0 for name, _, _ in F32_CORE_ROUTES),
            "f32 serving over pages or an int8 cache launched no f32 policy of the decode core")
    require(counts["decode_attention_g1"] > 0 and counts["paged_attention_g1"] > 0,
            "Gemma-7B's decode launched no G = 1 core, dense or paged")
    require(all(counts[f"{fmt}_matmul_tf32"] > 0 for fmt in ("q4_0", "q8_0", "q4_k", "q6_k")),
            "the f32 paths launched no TF32 tile")
    print(json.dumps({"kernels": kernels}), flush=True)
    return {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


def main() -> int:
    try:
        if sys.argv[1:2] == ["--prefill-host"]:  # phase 9's child
            return prefill_host(json.loads(sys.argv[2]))
        if sys.argv[1:2] == ["--tp-rank"]:  # a rank of phase 10
            return tp_rank(json.loads(sys.argv[2]))
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
