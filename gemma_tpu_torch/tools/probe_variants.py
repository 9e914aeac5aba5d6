"""Patched builds of the kernels, timed side by side on the card: the
measurements behind the tensor-core GEMV's constants (`csrc/dq_gemv.cuh`),
the tile plan (`csrc/dq_tile.cuh`) and the f32 route's TF32 tile
(`csrc/dq_tile_tf32.cuh`), and ablations that say where a kernel's time
goes; and the tensor-core attention kernels' launch shapes.

    python -m gemma_tpu_torch.tools.probe_variants gemv [--variants base,tw16,...] [--fmt q4_k,q6_k] [--ms 1,8] [--parent DIR]
    python -m gemma_tpu_torch.tools.probe_variants tile [--variants ...] [--fmt q8_0] [--ms 17,64,203]
    python -m gemma_tpu_torch.tools.probe_variants tf32 [--variants base,tf_cvt,...] [--fmt q4_k,q6_k] [--ms 17,512]
    python -m gemma_tpu_torch.tools.probe_variants gemv32 [--variants base,xf32_p2,ab_xf32_p1] [--fmt q4_0,q4_k] [--ms 1,8]
    python -m gemma_tpu_torch.tools.probe_variants sass --parent DIR
    python -m gemma_tpu_torch.tools.probe_variants attn [--parent DIR]
    python -m gemma_tpu_torch.tools.probe_variants mutants

`attn` needs no patched build: at the main path's attention shapes (and
S = 4096, bench_prefill's), each in bf16 with D = 256, it holds the flash
kernel's 4 warps as 1, 2 or 4 row warps (the rest splitting the keys)
and the decode kernel at 32-256 keys a
block (both arms, and at 2 <= G <= 8 the f32 policies: f32 q over f32 k
and v at 1e-4, and over the int8 cache) and, at G = 1 (Gemma-7B's heads,
S = 512 and 4096), the core for one query row at 16-512 keys a block
(bf16, int8, f32 and f32-over-int8 arms) to the plain version (2e-2 of
each row's scale, `_timing.attn_err`: p rounds to bf16 against a local
max), and times each, decode beside the split-S kernel and its combine
launch (the route of G > 8), device ms with the operands warm (as
chip_smoke.py); each launch through `_launch.py`. With
`--parent DIR` it also builds the parent's kernels and holds its bf16
flash at each block shape against this tree's bit for bit, timed in turns
(this, parent, parent, this), and prints whether the tensor-core decode
core's outputs at each split equal the parent's bit for bit;
`tools/parent_turn.py` times the parent's kernels through the public
wrappers.

`sass` needs no card, only the CUDA toolkit: it builds this tree's kernels
and the parent's (`--parent DIR`, a commit unpacked with `git archive`)
and compares, instruction by instruction (`cuobjdump -sass`, branch labels
numbered in order of use), each format's tensor-core GEMV with bf16 x and
with f32 x (`XF32`, `XF32Packed`), the TF32 tile's instances of
TF32_KERNELS and the decode core's instances that the parent has
(`decode_tc_kernel`: bf16 and int8, dense and paged, and f32 over f32
dense, D = 128 and 256) in the two builds; it fails unless every one is
the same code. It then lists this tree's other GEMV instances (the
instruments' `Q4KAblation` and `Q4_0Variant`) with their instructions and
the registers and spills of the build's ptxas log.

`mutants` checks that check: it builds MUTANTS, the attention kernels with
a planted fault (a decode split or a flash key tile dropped, a warp of the
G = 1 core's block merge dropped, the int8 V
scale of a paged tile read at its logical rather than its physical page;
in the f32 flash kernel a ring stage's keys, or the lo.hi product of the
3xTF32 that f32 flash and decode share; f32 q over an int8 cache reading
its raw K tile at the wrong pitch), and holds each, and the unpatched
kernels, to the plain version at the S = 4096 shapes, where a row averages
thousands of keys, and at PAGED_SHAPES (bf16 and f32 q over pages of
their dtype and int8, shuffled pages), at 2e-2 of each row's scale (f32
over f32 pages: 1e-4); and in f32 at chip_smoke.py phase 8's shapes
(flash at T = S = 512, Gemma-2B's and Gemma-7B's heads; decode on the TF32
core over 4096 slots and the serving rows, f32 and int8 caches) at its
1e-4 of each row's scale (over int8: 2e-2). The S = 4096 decode shapes include Gemma-7B's heads, on the
G = 1 core (whose split merge is the tensor-core core's). It fails unless the unpatched kernels pass and every mutant
fails.

A variant is a list of text substitutions in a copy of
`gemma_tpu_torch/csrc/`, built into `gemma_tpu_torch/build/variants/<name>/`
(`kernels/build.py build_library`). For each main-path shape of q4_0
(Gemma-2B), q8_0 (Gemma-7B), q4_k and q6_k (Gemma-2B q4_k_m, and q6_k's
deep-K shape), and each M (gemv: the decode step's 1 and the serving
step's 8; tile: the prefill rows; tf32: f32 x at M > 8; gemv32: f32 x at
M <= 8, the f32 GEMV's policy), a line gives the library call
(torch.matmul of the weight dequantized to bf16 beforehand; tf32 and
gemv32: to f32, with f32 x and TF32 off) and each variant's time, all
device ms with L2 cold (`_timing.py`). Variants named `ab_*` drop a part
of the kernel and compute wrong results, so they are timed only; every
other variant is first held to the plain version within 1e-4 x max|ref|
(tf32 and gemv32: 1e-5).
`--parent DIR` (a commit unpacked with `git archive`) adds its kernels,
built from its `csrc/`, as one more variant named `parent`. Runs on the
card only.
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import torch

from ..kernels import build
from ..ops import quant_matmul as qmm
from ..quant.qtensor import dequant
from . import _launch
from . import _timing as T

GV, TL, TF = "dq_gemv.cuh", "dq_tile.cuh", "dq_tile_tf32.cuh"
_PLAN = ("  const DqTilePlan p = dq_tile_plan(M, N, K);\n"
         "  if (p.splits > 1 && work == nullptr) return cudaErrorInvalidValue;\n")


def _forced(bm: int, bn: int) -> list[tuple[str, str, str]]:
    """The tile at bm x bn whatever the plan says (its K splits kept)."""
    return [(TL, _PLAN, f"  return launch_dq_tile_shape<F, {bm}, {bn}>(x, w, y, work, M, N, K, "
                        f"dq_splits(M, N, K, {bm}, {bn}), s);\n" + _PLAN)]


def _gv(old: str, new: str) -> tuple[str, str, str]:
    return (GV, old, new)


# name -> (file, old text, new text) substitutions in a copy of csrc/
VARIANTS: dict[str, list[tuple[str, str, str]]] = {
    "base": [],
    # the GEMV's constants
    "tw4": [_gv("kGvTargetWarps = 8;", "kGvTargetWarps = 4;")],
    "tw16": [_gv("kGvTargetWarps = 8;", "kGvTargetWarps = 16;")],
    "st3": [_gv("kGvStages = 4;", "kGvStages = 3;")],
    "st6": [_gv("kGvStages = 4;", "kGvStages = 6;")],
    "w2": [_gv("kGvWarps = 4;", "kGvWarps = 2;")],
    "w8": [_gv("kGvWarps = 4;", "kGvWarps = 8;")],
    "sl1024": [_gv("kGvSliceMax = 2048;", "kGvSliceMax = 1024;")],
    "sk256": [_gv("kGvStageK = 128;", "kGvStageK = 256;"),
              _gv("kGvScaleWords = 3;", "kGvScaleWords = 5;")],
    "nosplit": [_gv("kGvSliceMin = 512;", "kGvSliceMin = 1 << 30;"),
                _gv("kGvBlockSliceMin = 256;", "kGvBlockSliceMin = 1 << 30;")],
    "sl256": [_gv("kGvSliceMin = 512;", "kGvSliceMin = 256;")],
    # q4_0's and q8_0's splits stop above 512 (the parent's), not 256
    "bsl512": [_gv("kGvBlockSliceMin = 256;", "kGvBlockSliceMin = 512;")],
    # the K-quants' split target alone (q4_0 and q8_0 keep theirs)
    "ktw2": [_gv("kGvSuperTargetWarps = 4;", "kGvSuperTargetWarps = 2;")],
    "ktw8": [_gv("kGvSuperTargetWarps = 4;", "kGvSuperTargetWarps = 8;")],
    "ktw16": [_gv("kGvSuperTargetWarps = 4;", "kGvSuperTargetWarps = 16;")],
    # the tile's shape, forced
    "f64x64": _forced(64, 64), "f64x128": _forced(64, 128), "f128x64": _forced(128, 64),
    "f128x128": _forced(128, 128),
    # ablations of the tile: a part dropped
    "ab_nodeq": [(TL, "      F::store(src + r * F::kRaw", "      if (false) F::store(src + r * F::kRaw")],
    "ab_nomma": [(TL, "    if (rows && mma_first) mma_step(k);", ""),
                 (TL, "    if (rows && !mma_first) mma_step(k);", "")],
    "ab_noload": [(TL, "    if (k + S - 1 < steps) issue(k + S - 1);", "")],
    "ab_nosync": [(TL, "    cp_async_wait<S - 3>();  // step k + 2 has landed\n    __syncthreads();",
                   "    cp_async_wait<S - 3>();")],
    # ablations of the GEMV
    "ab_gv_nomma": [_gv("for (int q = X::kFrags - 1; q >= 0; --q) mma_16816(f, a, b[q][0], b[q][1]);",
                        "for (int q = X::kFrags - 1; q >= 0; --q) "
                        "f[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[q][0] ^ b[q][1]);")],
    # no weight bytes copied at all (the x slice still is)
    "ab_gv_noload": [_gv("    F::copy(w, ring + (st % kS) * F::kStage, lane, n0, N, K, "
                         "klo + st * F::kStageK, khi);", "")],
    # q4_0's and q8_0's A fragments as the raw payload words: no conversion
    "ab_gv_noconv": [_gv("""      a[0] = nibble_pair(w0 >> (4 * s));
      a[1] = nibble_pair(w1 >> (4 * s));
      a[2] = nibble_pair(w0 >> (4 * s + 8));
      a[3] = nibble_pair(w1 >> (4 * s + 8));""", """      a[0] = w0 >> (4 * s);
      a[1] = w1 >> (4 * s);
      a[2] = w0 >> (4 * s + 8);
      a[3] = w1 >> (4 * s + 8);"""),
                     _gv("""      a[0] = int8_pair(u0, 0, 2);
      a[1] = int8_pair(u1, 0, 2);
      a[2] = int8_pair(u0, 1, 3);
      a[3] = int8_pair(u1, 1, 3);""", """      a[0] = u0;
      a[1] = u1;
      a[2] = u0 >> 8;
      a[3] = u1 >> 8;""")],
    # q8_0's int8 pairs as bf16 128 + (q & 127) less 128, or 256 where q < 0:
    # two mask-ors and a bf16x2 subtract a pair in place of the f32 magic
    "mask8": [_gv("// bf16x2 (q_i, q_j) of the int8 bytes i and j of w, given u = w ^ 0x80808080\n",
                  """__device__ __forceinline__ uint32_t int8_pair_mask(uint32_t v) {
  const uint32_t b = (v & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = (v & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&b),
                                   *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&r);
}
"""),
              _gv("""      a[0] = int8_pair(u0, 0, 2);
      a[1] = int8_pair(u1, 0, 2);
      a[2] = int8_pair(u0, 1, 3);
      a[3] = int8_pair(u1, 1, 3);""", """      a[0] = int8_pair_mask(r[2 * s]);
      a[1] = int8_pair_mask(r[2 * s + 1]);
      a[2] = int8_pair_mask(r[2 * s] >> 8);
      a[3] = int8_pair_mask(r[2 * s + 1] >> 8);""")],
    # q4_0's and q8_0's scale parity in 32-bit ops: the parity of a product
    # is the AND of the parities, of a sum their XOR
    "par32": [_gv("((static_cast<size_t>(n0 + g + 8 * h) * (K / 32) + kb / 32) & 1);",
                  "((((n0 + g + 8 * h) & (K / 32)) ^ (kb / 32)) & 1);")],
    # six blocks an SM by registers (at most 80 a thread)
    "lb6": [_gv("constexpr int kGvMinBlocks = 4;", "constexpr int kGvMinBlocks = 6;")],
    # q4_0's and q8_0's payload copies without their L2 prefetch of the row's next stage
    "nopf": [_gv("kGvPrefetchAhead = 4;", "kGvPrefetchAhead = 1 << 20;")],
    # the L2 prefetch at every stage of every slice
    "pfall": [_gv("kGvPrefetchAhead = 4;", "kGvPrefetchAhead = 0;")],
    "st5": [_gv("kGvStages = 4;", "kGvStages = 5;")],
    # q4_0's and q8_0's stage rows unpadded, each 16-byte chunk c of row r at
    # c ^ (r & 7) (q8_0's 128-byte rows) or c ^ ((r / 2) & 3) (q4_0's 64):
    # the ldmatrix phases stay on distinct banks, and q8_0 holds 5 blocks
    # an SM at M <= 2 in place of 4
    "swz": [_gv("  static constexpr int kPitch = kRowBytes + 16;", "  static constexpr int kPitch = kRowBytes;"),
            _gv("      const uint32_t dst = smem_u32(stage + r * kPitch + c * 16);",
                "      const int sw = kRowBytes >= 128 ? r & 7 : (r / (128 / kRowBytes)) & (kRowBytes / 16 - 1);\n"
                "      const uint32_t dst = smem_u32(stage + r * kPitch + (c ^ sw) * 16);"),
            _gv("    ldmatrix_rows16(r, stage, kPitch, 32 * p, lane);",
                "    const int row = (lane & 7) + ((lane >> 3) & 1) * 8, c = 2 * p + (lane >> 4);\n"
                "    const int sw = kRowBytes >= 128 ? row & 7 : (row / (128 / kRowBytes)) & (kRowBytes / 16 - 1);\n"
                "    ldmatrix_x4(r, smem_u32(stage + row * kPitch + (c ^ sw) * 16));")],
    **{f"run{n}": [_gv("""        cp_async16(dst, ok ? src : w.qs, ok);
    }
""", f"""        cp_async16(dst, ok ? src : w.qs, ok);
    }}
    // at the first stage of each {n}-byte run of the rows, one lane a row
    // asks L2 for the run (to khi) by one bulk prefetch
    if (lane < 16 && n0 + lane < N && (kb / 32 * kBlockBytes) % {n} == 0) {{
      const int bytes = min({n}, (khi - kb) / 32 * kBlockBytes);
      const uint8_t* src = w.qs + static_cast<size_t>(n0 + lane) * row_bytes + static_cast<size_t>(kb) / 32 * kBlockBytes;
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\\n" ::"l"(src), "r"(bytes) : "memory");
    }}
""")] for n in (512, 1024, 2048)},
    # the L2 prefetch where the row's next stage lies in the block's slice
    "pfin": [_gv("kGvPrefetchAhead = 4;", "kGvPrefetchAhead = 1;")],
    # M = 1 holds x slices no wider than M >= 2 (the parent's plan)
    "m1slice": [_gv("const int bf16 = M == 1 ? 8 * kGvSliceMax : kGvSliceMax;", "const int bf16 = kGvSliceMax;")],
    # M = 1 holds a zero row beside x, as M >= 2 does (the parent's)
    "m1zero": [_gv("return M == 1 ? 1 : M < 8 ? M + 1 : 8;", "return M < 8 ? M + 1 : 8;"),
               _gv("const int bf16 = M == 1 ? 8 * kGvSliceMax : kGvSliceMax;",
                   "const int bf16 = M == 1 ? 4 * kGvSliceMax : kGvSliceMax;")],
    # how the GEMV sums its K splits: by ticket in the same launch at every
    # grid, or in a second launch at every grid; four outputs a thread of
    # the ticket sum at every M
    "tk_all": [_gv("kGvTicketBlocks = 4;", "kGvTicketBlocks = 1 << 20;")],
    "tk_none": [_gv("kGvTicketBlocks = 4;", "kGvTicketBlocks = 0;")],
    "sum4": [_gv("  switch ((M * kGvWarps * 16 + kGvWarps * 32 - 1) / (kGvWarps * 32)) {",
                 "  switch (4) {")],
    # no split sum: the splits' partials stay in the workspace, no ticket is taken
    "ab_gv_nosum": [_gv("  if (tickets == nullptr) return;", "  return;"),
                    _gv("  if (p.splits > 1 && !ticket) {", "  if (false) {")],
    # the K-quants' scale decode (`prepare`): the table keeps what it held
    "ab_gv_noprep": [_gv("      F::prepare(ring + (st % kS) * F::kStage, table, lane, n0, K, "
                         "klo + st * F::kStageK);", "")],
    # the f32 GEMV (f32 x at M <= 8, mode gemv32): x in two bf16 parts (x
    # rounded to 16 bits: 1e-5 held on random data, PERF.md), or x0 alone
    # (misses 1e-5), each slice widened by its smaller planes
    "xf32_p2": [_gv("  static constexpr int kParts = 3, kFrags = kParts;",
                    "  static constexpr int kParts = 2, kFrags = kParts;")],
    "ab_xf32_p1": [_gv("  static constexpr int kParts = 3, kFrags = kParts;",
                       "  static constexpr int kParts = 1, kFrags = kParts;")],
    # the TF32 tile (f32 x, mode tf32): hi rounded by the cvt instruction
    # (which checks for infinities and NaN first), not by two integer ops
    "tf_cvt": [(TF, "  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;",
                "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : \"f\"(v));\n  return r;")],
    # lo rounded to nearest as hi is, not truncated
    "tf_lorna": [(TF, "  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xFFFFE000u;",
                  "  lo = tf32_rna(v - __uint_as_float(hi));")],
    # a row's four raw quarters over four lanes (the bf16 tile's mapping):
    # a warp's lanes branch on the quarter
    "tf_quarters": [(TF, "F::copy(w, rdst + (it % BN) * F::kRaw, n0 + it % BN, N, K, k0, it / BN);",
                     "F::copy(w, rdst + (it / 4) * F::kRaw, n0 + it / 4, N, K, k0, it % 4);")],
    # four ring stages (q6_k's rows then take 64-wide tiles at two blocks an SM)
    "tf_st4": [(TF, "constexpr int kTfStages = 3;", "constexpr int kTfStages = 4;")],
    # at most 8 K splits of at least 4 steps (the bf16 tile's limits)
    "tf_sp8": [(TF, "constexpr int kTfMaxSplits = 16;", "constexpr int kTfMaxSplits = 8;"),
               (TF, "constexpr int kTfMinSplitSteps = 2;", "constexpr int kTfMinSplitSteps = 4;")],
    # the TF32 tile's K splits by the rule before the grid's rounds:
    # doubled while the split grid holds at most 16 warps an SM
    "tf_fill16": [(TF, """  int splits = 1;
  if (tiles >= slots) return splits;
  long best = steps + 2;  // one round, unsplit
  for (int z = 2; z <= kTfMaxSplits && steps % z == 0 && steps / z >= kTfMinSplitSteps; z *= 2) {
    const long cost = (tiles * z + slots - 1) / slots * (steps / z + 2);
    if (cost < best) {
      best = cost;
      splits = z;
    }
  }
  return splits;""", """  int splits = 1;
  while (dq_warps(M, N, kTfBM, bn) * 2 * splits <= 16L * sm_count() && splits < kTfMaxSplits &&
         steps % (2 * splits) == 0 && steps / (2 * splits) >= kTfMinSplitSteps)
    splits *= 2;
  return splits;""")],
    # ablations of the TF32 tile: one pass (hi only), no group scaling, no
    # weight conversion (constant B fragments)
    "ab_tf_hi": [(TF, "          for (int j = 0; j < TN; ++j) mma_1688_tf32(part[i][j], lo, b[j][2 * s], "
                      "b[j][2 * s + 1]);\n", "")],
    "ab_tf_noscale": [(TF, f"acc[i][j][{c}] = fmaf(d.{'xy'[c % 2]}, part[i][j][{c}], acc[i][j][{c}]);",
                       f"acc[i][j][{c}] += part[i][j][{c}];") for c in range(4)],
    "ab_tf_noB": [(TF, "for (int j = 0; j < TN; ++j) F::weights(rb + 8 * j * F::kRaw, k0, u, t, b[j]);",
                   "for (int j = 0; j < TN; ++j) b[j][0] = b[j][1] = b[j][2] = b[j][3] = 0x3F800000u + u;")],
}

# the main path's shapes (chip_smoke.py MATMUL_SHAPES): q4_0 Gemma-2B, q8_0
# Gemma-7B, q4_k and q6_k Gemma-2B q4_k_m (and q6_k's deep-K shape)
SHAPES = {
    "q4_0": [("qkv", 2560, 2048), ("attn_out", 2048, 2048), ("gate_up", 32768, 2048),
             ("down", 2048, 16384), ("head", 256000, 2048)],
    "q8_0": [("qkv", 12288, 3072), ("attn_out", 3072, 4096), ("gate_up", 49152, 3072),
             ("down", 3072, 24576), ("head", 256000, 3072)],
    "q4_k": [("attn_q", 2048, 2048), ("attn_k", 256, 2048), ("attn_out", 2048, 2048),
             ("gate_up", 32768, 2048), ("down", 2048, 16384)],
    "q6_k": [("attn_v", 256, 2048), ("deep_k", 2048, 16384), ("head", 256000, 2048)],
}
# the entry points a variant run calls (through ops/quant_matmul.py): all a
# parent tree's library binds
MATMUL_ENTRIES = ("gt_q4_0_matmul", "gt_q8_0_matmul", "gt_q4_k_matmul", "gt_q6_k_matmul")


# name -> substitutions that plant a fault in an attention kernel
MUTANTS: dict[str, list[tuple[str, str, str]]] = {
    # the decode kernel's last block merges every split but split 1
    "drop_split_1": [("decode_tc.cuh",
                      "const float w = ls > 0.f ? expf(sw[sp_ * G + h] - mx) : 0.f;",
                      "const float w = ls > 0.f && sp_ != 1 ? expf(sw[sp_ * G + h] - mx) : 0.f;")],
    # the flash kernel loads ring step 5 (64 keys at D = 256) but never multiplies it
    # (the skeleton's step loop, in the bf16 policy's instances only)
    "drop_step_5": [("flash_attention.cu", "    compute(i);\n    __syncthreads();  // stage i % 2",
                     "    if (i != 5 || sizeof(T) != 2) compute(i);\n    __syncthreads();  // stage i % 2")],
    # the f32 (TF32) flash kernel loads ring step 3 (32 keys at D = 256) but never multiplies it
    "drop_tf32_step_3": [("flash_attention.cu", "    compute(i);\n    __syncthreads();  // stage i % 2",
                          "    if (i != 3 || sizeof(T) != 4) compute(i);\n    __syncthreads();  // stage i % 2")],
    # the f32 flash and decode kernels' products leave out lo(a) . hi(b): 2 of 3xTF32's passes
    "drop_tf32_lo_hi": [("attn_tc.cuh", "  mma_1688_tf32(c, al, bh0, bh1);\n", "")],
    # the G = 1 core's block merge leaves out warp 3's keys
    "g1_drop_warp_3": [("decode_g1.cuh", "acc += red[w * D + d] * f[w];",
                        "acc += w == 3 ? 0.f : red[w * D + d] * f[w];")],
    # the tensor-core core reads a tile's int8 V scales at the dense slab
    # offset: through pages, the logical page's rows, not the physical one's
    "paged_v_scale_logical": [("decode_tc.cuh", "w *= ok[e] ? v_scale[srow + 8 * (e / 2)] : 0.f;",
                               "w *= ok[e] ? v_scale[static_cast<size_t>(bh) * S + key0 + g + "
                               "8 * (e / 2)] : 0.f;")],
    # f32 q over an int8 cache (`DecTf32Int8`) reads its raw K tile at the
    # int8 arm's pitch D, not the pitch D + 16 it was staged at
    "tf32_int8_k_pitch": [("decode_tc.cuh", "const unsigned char* kl = kt + g * kLdK8 + 4 * t;",
                           "const unsigned char* kl = kt + g * D + 4 * t;")],
}


def patched_sources(name: str) -> dict[str, str]:
    """The text of each source file variant or mutant `name` changes; raises
    unless every substitution's old text occurs exactly once."""
    out: dict[str, str] = {}
    for f, old, new in {**VARIANTS, **MUTANTS}[name]:
        text = out.get(f) or (build.CSRC / f).read_text()
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} occurs {text.count(old)} times in {f}")
        out[f] = text.replace(old, new)
    return out


def build_variant(name: str):
    """The kernel library of variant or mutant `name`, built from a patched
    copy."""
    root = build.BUILD_DIR / "variants" / name
    csrc = root / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(build.CSRC, csrc)
    for f, text in patched_sources(name).items():
        (csrc / f).write_text(text)
    return build.build_library(csrc, root)


def run(mode: str, names: list[str], fmts: list[str], ms: list[int], dev: torch.device,
        parent: str | None = None) -> None:
    f32 = mode in ("tf32", "gemv32")  # f32 x, the f32 library yardstick, 1e-5
    libs = {name: build_variant(name) for name in names}
    if parent:  # the parent commit's kernels, timed and held like a variant
        libs["parent"] = build.build_library(Path(parent) / "gemma_tpu_torch" / "csrc",
                                             build.BUILD_DIR / "variants" / "parent", MATMUL_ENTRIES)
    gen = T.generator(dev)
    for fmt in fmts:
        for sname, N, K in SHAPES[fmt]:
            if mode == "tile" and sname == "head":
                continue  # a prefill runs the head at its last row only
            qt = T.random_qtensor(fmt, N, K, gen, dev)
            for M in ms:
                x = (torch.randn(M, K, generator=gen, device=dev) if f32 else
                     T.bf16_x(M, K, gen, dev))
                ref = qmm.PLAIN[fmt](x, qt)
                w16 = dequant(qt, torch.float32 if f32 else torch.bfloat16)
                lib_ms = T.time_us(lambda a, b: torch.matmul(a, b.T),
                                   T.replicate((x, w16), T.copies_for(T.nbytes(x, w16), dev)),
                                   dev) / 1e3
                del w16
                readings = []
                for name, lib in libs.items():
                    with build.using(lib):
                        if not name.startswith("ab_"):
                            T.check(f"{fmt} {sname} M={M} variant {name}", qmm.MATMULS[fmt](x, qt),
                                    ref, 1e-5 if f32 else 1e-4)
                        args = T.replicate((x, qt), T.copies_for(T.nbytes(x, qt), dev))
                        readings.append(f"{name} {T.time_us(qmm.MATMULS[fmt], args, dev) / 1e3:.4f}")
                        del args
                print(f"{fmt} {sname} M={M} N={N} K={K}: library {lib_ms:.4f}; " + "; ".join(readings),
                      flush=True)
            del qt


# attention shapes: flash (name, T, first position, S, kv_limit, Hq, Hkv),
# decode (name, S, kv_limits, Hq, Hkv); Gemma-2B's heads (8, 1), Gemma-7B's (16, 16)
SERVE_LIMITS = [1, 64, 65, 203, 300, 512, 203, 64]  # chip_smoke.py's serving rows
FLASH_SHAPES = (("Gemma-2B T=203", 203, 0, 512, 203, 8, 1),
                ("Gemma-7B T=203", 203, 0, 512, 203, 16, 16),
                ("Gemma-2B T=2048", 2048, 0, 4096, 2048, 8, 1),
                ("Gemma-7B T=2048", 2048, 0, 4096, 2048, 16, 16),
                ("Gemma-2B chunk 3584-4095", 512, 3584, 4096, 4096, 8, 1))
DECODE_SHAPES = (("Gemma-2B", 512, [204], 8, 1), ("Gemma-2B", 512, [512], 8, 1),
                 ("Gemma-2B", 4096, [2048], 8, 1), ("Gemma-2B", 4096, [4096], 8, 1),
                 ("Gemma-2B serving", 512, SERVE_LIMITS, 8, 1), ("Gemma-7B", 512, [204], 16, 16),
                 ("Gemma-7B serving", 512, SERVE_LIMITS, 16, 16), ("Gemma-7B", 4096, [4096], 16, 16),
                 # the other groups of the Gemma family: G = 2 (Gemma-2 2B), G = 4 (Gemma-3 1B)
                 ("G=2 heads", 512, [204], 8, 4), ("G=2 serving", 512, SERVE_LIMITS, 8, 4),
                 ("G=4 heads", 512, [204], 4, 1), ("G=4 serving", 512, SERVE_LIMITS, 4, 1))
# paged shapes (name, S = maxp * ps, kv_limits, ps, Hq, Hkv, pool pages): chip_smoke.py's
# serving rows over a 65-page pool, and two rows of a 4096-key cache (four pages a block)
PAGED_SHAPES = (("Gemma-2B serving", 512, SERVE_LIMITS, 64, 8, 1, 65),
                ("Gemma-2B long", 4096, [2048, 4096], 64, 8, 1, 129))
SPLITS = (32, 64, 128, 256)
G1_SPLITS = (16, 32, 64, 128, 256, 512)  # keys a block of the G = 1 core (decode_tc_split)
ATT_TOL = 2e-2


def _held(name: str, got, ref, tol: float = ATT_TOL) -> None:
    """Raise unless got is within tol of each row's scale of ref."""
    ratio = T.attn_err(got, ref, tol)[1]
    if ratio > 1.0:
        raise RuntimeError(f"{name}: |diff| {ratio:.3f} x {tol} of its row's scale")


def c_params(csrc: Path, name: str) -> list[str]:
    """The parameter names of the `extern "C"` entry `name` in the sources
    under `csrc`, in order."""
    import re

    for src in sorted(csrc.glob("*.cu")):
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src.read_text())
        if m:
            return [p_.split()[-1].lstrip("*") for p_ in m.group(1).split(",")]
    raise ValueError(f"no entry point {name} under {csrc}")


def run_attention(dev: torch.device, parent: str | None = None) -> None:
    import ctypes

    from ..ops import attention as att
    from ..runtime.kv_cache import quantize_kv

    gen = T.generator(dev)
    D = 256
    lib = build.load()
    plib, parent_q = None, True
    if parent:
        pcsrc = Path(parent) / "gemma_tpu_torch" / "csrc"
        plib = build.build_library(pcsrc, build.BUILD_DIR / "variants" / "parent",
                                   ("gt_flash_attention_tc", "gt_decode_attention_tc"))
        # a parent before f32 queries over int8 reached the core takes no q dtype
        params = c_params(pcsrc, "gt_decode_attention_tc")
        parent_q = "q_dtype" in params
        plib.gt_decode_attention_tc.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * (len(params) - 11)
                                                + [ctypes.c_float, ctypes.c_void_p])

    def rnd(*shape):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.3).to(torch.bfloat16)

    def ms(fn):
        return T.time_us(lambda: fn(), [()], dev) / 1e3

    for name, T_, p0, S, limit, hq, hkv in FLASH_SHAPES:
        q, k, v = rnd(1, T_, hq, D), rnd(1, hkv, S, D), rnd(1, hkv, S, D)
        pos = torch.arange(p0, p0 + T_, dtype=torch.int32, device=dev)[None]
        lim = torch.tensor([limit], dtype=torch.int32, device=dev)
        ref = att.flash_attention_plain(q, k, v, pos, lim)
        flops = 4 * hq * D * sum(min(p + 1, limit) for p in range(p0, p0 + T_))
        readings = []
        for rw in (1, 2, 4):
            _held(f"flash {name} {rw} row warps", _launch.flash(lib, q, k, v, pos, lim, rw), ref)
            t = ms(lambda: _launch.flash(lib, q, k, v, pos, lim, rw))
            readings.append(f"{rw} row warps x {4 // rw} key groups {t:.4f} "
                            f"({flops / t / 1e9:.1f} TFLOP/s)")
            if plib:
                equal = torch.equal(_launch.flash(lib, q, k, v, pos, lim, rw),
                                    _launch.flash(plib, q, k, v, pos, lim, rw))
                tp = [ms(lambda: _launch.flash(plib, q, k, v, pos, lim, rw)) for _ in range(2)]
                readings[-1] += (f", parent {tp[0]:.4f} / {tp[1]:.4f}, this again "
                                 f"{ms(lambda: _launch.flash(lib, q, k, v, pos, lim, rw)):.4f}, outputs "
                                 f"{'equal' if equal else 'differ from this'} bit for bit")
        print(f"flash {name} S={S}: device ms, warm: " + "; ".join(readings), flush=True)
        del q, k, v, ref

    for name, S, limits, hq, hkv in DECODE_SHAPES:
        B = len(limits)
        q, k, v = rnd(B, 1, hq, D), rnd(B, hkv, S, D), rnd(B, hkv, S, D)
        lim = torch.tensor(limits, dtype=torch.int32, device=dev)
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        G = hq // hkv
        arms = [("bf16", q, (k, v), ATT_TOL), ("int8", q, (k8, v8, ks, vs), ATT_TOL)]
        if att.decode_route(torch.float32, G, S)[0] in ("g1", "tf32"):  # f32 q over f32 and int8
            arms += [("f32", q.float(), (k.float(), v.float()), F32_TOL),
                     ("f32 int8", q.float(), (k8, v8, ks, vs), ATT_TOL)]
        for arm, qa, args, tol in arms:
            ref = att.decode_attention_plain(qa, args[0], args[1], lim, 0.0, 0, *args[2:])
            readings = []
            # the split-S kernel; the tensor-core core (f32 q: where its
            # policies are the route); at G = 1 the core for one query row
            kinds = [("split", att.DECODE_SPLIT)]
            kinds += [("tc", sp) for sp in SPLITS if not arm.startswith("f32") or G > 1]
            kinds += [("g1", sp) for sp in G1_SPLITS if G == 1]
            for kind, split in kinds:
                def call(split=split, kind=kind):
                    return _launch.decode(lib, split, qa, args[0], args[1], lim, *args[2:], kind=kind)

                _held(f"decode {name} {arm} {kind} split {split}", call(), ref, tol)
                readings.append(f"split-S kernel {ms(call):.4f}" if kind == "split"
                                else f"{kind} {split} keys a block {ms(call):.4f}")
                # the parent's tensor-core core on the same inputs (a parent
                # without the q dtype argument: f32 q over an int8 cache was not its)
                if plib and kind == "tc" and (parent_q or arm != "f32 int8"):
                    same = torch.equal(call(), _launch.decode(plib, split, qa, args[0], args[1], lim,
                                                              *args[2:], q_code=parent_q))
                    readings[-1] += f" ({'equal' if same else 'NOT equal'} to the parent's bit for bit)"
            print(f"decode {name} {arm} S={S} Hq={hq} Hkv={hkv} limits={limits}: device ms, warm "
                  f"(route: {att.decode_route(qa.dtype, hq // hkv, S)}): " + "; ".join(readings),
                  flush=True)
        del q, k, v, k8, v8


# f32 flash at chip_smoke.py phase 8's shapes (T = S = 512 from position 0),
# Gemma-2B's heads (8, 1) and Gemma-7B's (16, 16), held to its 1e-4 of each row's scale
F32_FLASH_SHAPES = (("Gemma-2B", 8, 1), ("Gemma-7B", 16, 16))
# f32-q decode on the TF32 decode core (name, S, kv_limits, Hq, Hkv): a full
# 4096-slot cache (16 splits) and the serving rows, at the same tolerance
F32_DECODE_SHAPES = (("Gemma-2B", 4096, [4096], 8, 1), ("Gemma-2B serving", 512, SERVE_LIMITS, 8, 1))
F32_TOL = 1e-4


def run_mutants(dev: torch.device) -> None:
    """The unpatched attention kernels and each of MUTANTS against the plain
    versions at the S = 4096 shapes of FLASH_SHAPES and DECODE_SHAPES
    (decode: both arms) and at PAGED_SHAPES (bf16 and int8 pages), at
    ATT_TOL of each row's scale, and f32 flash at F32_FLASH_SHAPES and f32
    decode at F32_DECODE_SHAPES at F32_TOL, through the public wrappers; one
    line a reading, with max|diff| beside the row-scaled ratio."""
    from ..ops import attention as att
    from ..ops import paged_attention as pat
    from ..runtime.kv_cache import quantize_kv
    from .parent_turn import paged_inputs

    D = 256
    libs = {"unpatched": build.load(), **{name: build_variant(name) for name in MUTANTS}}
    gen = T.generator(dev)

    def rnd(*shape, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.3).to(dtype)

    cases = []  # (reading, kernel call, plain output, tolerance of the row's scale)
    for name, T_, p0, S, limit, hq, hkv in FLASH_SHAPES:
        if S == 4096:
            q, k, v = rnd(1, T_, hq, D), rnd(1, hkv, S, D), rnd(1, hkv, S, D)
            pos = torch.arange(p0, p0 + T_, dtype=torch.int32, device=dev)[None]
            lim = torch.tensor([limit], dtype=torch.int32, device=dev)
            cases.append((f"flash {name}", lambda q=q, k=k, v=v, pos=pos, lim=lim:
                          att.flash_attention(q, k, v, pos, lim),
                          att.flash_attention_plain(q, k, v, pos, lim), ATT_TOL))
    for name, S, limits, hq, hkv in DECODE_SHAPES:
        if S == 4096 and att.decode_route(torch.bfloat16, hq // hkv, S)[0] in ("tc", "g1"):
            B = len(limits)
            q, k, v = rnd(B, 1, hq, D), rnd(B, hkv, S, D), rnd(B, hkv, S, D)
            lim = torch.tensor(limits, dtype=torch.int32, device=dev)
            (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
            for arm, (kk, vv, sk, sv) in (("bf16", (k, v, None, None)), ("int8", (k8, v8, ks, vs))):
                cases.append((f"decode {name} S={S} limits={limits} {arm}",
                              lambda q=q, kk=kk, vv=vv, lim=lim, sk=sk, sv=sv:
                              att.decode_attention(q, kk, vv, lim, k_scale=sk, v_scale=sv),
                              att.decode_attention_plain(q, kk, vv, lim, k_scale=sk, v_scale=sv), ATT_TOL))
    for name, S, limits, ps, hq, hkv, pool in PAGED_SHAPES:
        # bf16 q over bf16 and int8 pages; f32 q over f32 (1e-4) and int8 pages
        for dtype, quantized, tol in ((torch.bfloat16, False, ATT_TOL), (torch.bfloat16, True, ATT_TOL),
                                      (torch.float32, False, F32_TOL), (torch.float32, True, ATT_TOL)):
            q, cache, lim = paged_inputs(gen, dev, len(limits), hq, hkv, D, ps, limits, pool, S,
                                         quantized, dtype)
            if quantized and dtype == torch.float32:  # f32 q beside int8 pages: not bf16 values
                q = rnd(*q.shape, dtype=dtype)
            cases.append((f"paged{' int8' if quantized else ''} {'f32 q ' if dtype == torch.float32 else ''}"
                          f"{name} S={S} ps={ps} limits={limits}",
                          lambda q=q, cache=cache, lim=lim: pat.paged_decode_attention(q, cache, 0, lim),
                          pat.paged_decode_attention_plain(q, cache, 0, lim), tol))
    for name, hq, hkv in F32_FLASH_SHAPES:
        T_ = S = 512
        q, k, v = (rnd(*shape, dtype=torch.float32) for shape in ((1, T_, hq, D), (1, hkv, S, D),
                                                                  (1, hkv, S, D)))
        pos = torch.arange(T_, dtype=torch.int32, device=dev)[None]
        lim = torch.tensor([S], dtype=torch.int32, device=dev)
        cases.append((f"f32 flash {name} T=S={S}", lambda q=q, k=k, v=v, pos=pos, lim=lim:
                      att.flash_attention(q, k, v, pos, lim),
                      att.flash_attention_plain(q, k, v, pos, lim), F32_TOL))
    for name, S, limits, hq, hkv in F32_DECODE_SHAPES:
        B = len(limits)
        q, k, v = (rnd(*shape, dtype=torch.float32) for shape in ((B, 1, hq, D), (B, hkv, S, D),
                                                                  (B, hkv, S, D)))
        lim = torch.tensor(limits, dtype=torch.int32, device=dev)
        cases.append((f"f32 decode {name} S={S} limits={limits}", lambda q=q, k=k, v=v, lim=lim:
                      att.decode_attention(q, k, v, lim), att.decode_attention_plain(q, k, v, lim), F32_TOL))
        # f32 q over the same cache in int8 (p * vs rounds to bf16: ATT_TOL)
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        cases.append((f"f32 decode {name} S={S} limits={limits} int8 cache",
                      lambda q=q, k8=k8, v8=v8, ks=ks, vs=vs, lim=lim:
                      att.decode_attention(q, k8, v8, lim, k_scale=ks, v_scale=vs),
                      att.decode_attention_plain(q, k8, v8, lim, k_scale=ks, v_scale=vs), ATT_TOL))
    failed = {}
    for lname, lib in libs.items():
        with build.using(lib):
            for reading, call, ref, tol in cases:
                err, ratio, lo, hi = T.attn_err(call(), ref, tol)
                failed.setdefault(lname, []).append(ratio > 1.0)
                print(f"{lname} {reading}: max|diff| {err:.3e} (an absolute {tol} "
                      f"{'fails' if err > tol else 'passes'}); worst |diff| / ({tol} x row "
                      f"scale) {ratio:.3f} ({'fails' if ratio > 1.0 else 'passes'}); row scales "
                      f"{lo:.3e}-{hi:.3e}", flush=True)
    if any(failed["unpatched"]) or not all(any(failed[name]) for name in MUTANTS):
        raise SystemExit("mutants: the unpatched kernels must pass and every mutant must fail")
    print("mutants: the unpatched kernels pass; every mutant fails", flush=True)


# each format's tensor-core GEMV with bf16 x, by a part of its mangled
# name: this tree's instance takes the element policy XBf16
GEMV_BF16_KERNELS = {"q4_0": "BlockGemvILi16E", "q8_0": "BlockGemvILi32E", "q4_k": "Q4KGemv",
                     "q6_k": "Q6KGemv"}
GEMV_POLICIES = ("XBf16", "XF32", "XF32Packed")  # the element policies of x in a GEMV's name
# the f32 TF32 tile's functors held to the parent's code (each instance: BN
# 64 and 128), by a part of their mangled names
TF32_KERNELS = {"q8_0": "Q8_0Tf32", "q4_k": "Q4KTf32", "q6_k": "Q6KTf32"}
# the decode core's instances by (D, arm, rows), from a mangled name: since
# the element policy (`DecBf16`, `DecInt8`, `DecTf32`) took the place of
# `bool kInt8` in its template, or before
_DECODE_TC = (r"decode_tc_kernelILi(\d+)ENS\d*_\d+Dec(Bf16|Int8|Tf32)ENS\d*_\d+(Dense|Paged)Rows",
              r"decode_tc_kernelILi(\d+)ELb([01])ENS\d*_\d+(Dense|Paged)Rows")


def _decode_tc_key(name: str) -> tuple[str, str, str] | None:
    """(D, "bf16", "int8" or "tf32", "Dense" or "Paged") of a bf16, int8 or
    f32-over-f32 instance of `decode_tc_kernel`, else None."""
    import re

    arms = {"Bf16": "bf16", "0": "bf16", "Int8": "int8", "1": "int8", "Tf32": "tf32"}
    for pattern in _DECODE_TC:
        m = re.search(pattern, name)
        if m:
            return m.group(1), arms[m.group(2)], m.group(3)
    return None


def _sass(csrc: Path, build_dir: Path) -> dict[str, list[str]]:
    """The instructions of every kernel of the library built from `csrc`, by
    mangled name: each instruction's text, branch labels renumbered in the
    order the kernel uses them."""
    import re
    import subprocess

    path = build.library_path(csrc, build_dir)
    if not path.exists():
        build._compile(path, csrc)
    cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    kernels: dict[str, list[str]] = {}
    code: list[str] = []
    for line in text.splitlines():
        if line.strip().startswith("Function : "):
            code = kernels.setdefault(line.split(":", 1)[1].strip(), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m:
            code.append(" ".join(m.group(1).split()))
    for name, code in kernels.items():
        labels: dict[str, str] = {}
        kernels[name] = [re.sub(r"\.L_x_\d+", lambda m: labels.setdefault(m.group(0), f"L{len(labels)}"), c)
                         for c in code]
    return kernels


def _ptxas(csrc: Path, build_dir: Path) -> dict[str, str]:
    """Each kernel's registers and spill bytes from the ptxas log
    (`-Xptxas=-v`) that `kernels/build.py` keeps beside the library built
    from `csrc`, by mangled name."""
    import re

    out: dict[str, list[str]] = {}
    name = None
    for line in build.library_path(csrc, build_dir).with_suffix(".log").read_text().splitlines():
        if m := re.search(r"(?:Compiling entry function '|Function properties for )([^' ]+)", line):
            name = m.group(1)
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out.setdefault(name, []).append(f"spill stores/loads {m.group(1)}/{m.group(2)} bytes")
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out.setdefault(name, []).insert(0, f"{m.group(1)} registers")
    return {k: ", ".join(v) for k, v in out.items()}


def _gemv_policy(name: str) -> str | None:
    """The element policy of x (GEMV_POLICIES) of a `dq_gemv_kernel`
    instance, from its mangled name."""
    import re

    m = re.search(r"\d+(XBf16|XF32|XF32Packed)E", name) if "dq_gemv_kernel" in name else None
    return m.group(1) if m else None


def _demangled(name: str) -> str:
    import shutil
    import subprocess

    cxxfilt = shutil.which("c++filt")
    if not cxxfilt:
        return name
    return subprocess.run([cxxfilt, name], capture_output=True, text=True).stdout.strip() or name


def run_sass(parent: str) -> None:
    """Mode sass: the GEMVs with bf16 and f32 x, the TF32_KERNELS tiles and
    the decode cores the parent has (bf16 and int8, dense and paged; f32
    over f32) of this tree and of the parent, compared instruction by
    instruction; then this tree's other GEMV instances, listed."""
    import difflib
    import re

    here = (build.CSRC, build.BUILD_DIR / "variants" / "sass")
    trees = {"this": _sass(*here),
             "parent": _sass(Path(parent) / "gemma_tpu_torch" / "csrc",
                             build.BUILD_DIR / "variants" / "parent")}
    pairs = []  # (label, this tree's kernel name, the parent's)
    for fmt, token in GEMV_BF16_KERNELS.items():
        for policy in GEMV_POLICIES:
            names = {}
            for tree, kernels in trees.items():
                found = [n for n in kernels if token in n and _gemv_policy(n) == policy]
                if len(found) != 1:
                    raise SystemExit(f"sass: {tree} has {len(found)} {policy} GEMVs of {fmt}: {found}")
                names[tree] = found[0]
            pairs.append((f"{fmt} {policy} GEMV", names["this"], names["parent"]))
    for fmt, token in TF32_KERNELS.items():
        # by instance: the names less their unnamed namespace's hash, which follows the source
        names = {tree: {re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", n): n for n in kernels
                        if "dq_tile_tf32_kernel" in n and token in n} for tree, kernels in trees.items()}
        if not names["this"] or names["this"].keys() != names["parent"].keys():
            raise SystemExit(f"sass: the TF32 tiles of {fmt} differ: {names}")
        for key, n in sorted(names["this"].items()):
            bn = re.search(r"Tf32ELi(\d+)E", key).group(1)
            pairs.append((f"{fmt} TF32 tile BN={bn}", n, names["parent"][key]))
    # every instance the parent has (bf16 and int8 dense and paged, and f32
    # dense where it has one); this tree's others may be new
    cores = {tree: {key: n for n in kernels if (key := _decode_tc_key(n))} for tree, kernels in trees.items()}
    if (sum(key[1] != "tf32" for key in cores["this"]) != 8
            or not cores["parent"].keys() <= cores["this"].keys()):
        raise SystemExit(f"sass: the bf16 and int8 decode cores differ: {cores}")
    for key, n in sorted(cores["parent"].items()):
        pairs.append((f"decode core D={key[0]} {key[1]} {key[2]}Rows", cores["this"][key], n))
    regs = _ptxas(*here)
    differ = []
    for label, this, par in pairs:
        a, b = trees["this"][this], trees["parent"][par]
        same = sum(x == y for x, y in zip(a, b))
        ops = [sorted(c.split()[1] if c.startswith("@") else c.split()[0] for c in k) for k in (a, b)]
        verdict = ("the same code" if a == b else
                   f"{len(a) - same} of {len(a)} instructions differ in place; "
                   f"{'the same' if ops[0] == ops[1] else 'not the same'} opcodes in another order")
        print(f"sass {label}: this {len(a)} instructions, parent {len(b)}: {verdict}; ptxas "
              f"{regs.get(this, 'not in the log')}", flush=True)
        if a != b:
            differ.append(label)
            diff = difflib.unified_diff(b, a, "parent", "this", lineterm="", n=2)
            print("\n".join(list(diff)[:60]), flush=True)
    compared = {this for _, this, _ in pairs}
    for name in sorted(n for n in trees["this"] if _gemv_policy(n) and n not in compared):
        print(f"sass new GEMV instance {_demangled(name)}: {len(trees['this'][name])} instructions; "
              f"ptxas {regs.get(name, 'not in the log')}", flush=True)
    if differ:
        raise SystemExit(f"sass: {differ} are not the parent's code")
    print("sass: every bf16 or f32 GEMV, TF32 tile and bf16, int8 or f32 decode core compared is the "
          "parent's code", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("gemv", "tile", "tf32", "gemv32", "attn", "mutants", "sass"))
    ap.add_argument("--variants", default="base,tw4,tw16,st3,st6,w2,w8,sl1024,sk256,nosplit",
                    help="comma-separated names of VARIANTS")
    ap.add_argument("--fmt", default="q4_0,q8_0")
    ap.add_argument("--ms", default=None, help="rows of x (gemv: 1,8; tile: 17,64,203; tf32: 17,512)")
    ap.add_argument("--parent", help="the parent commit unpacked here: its kernels timed beside the variants")
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    if args.mode == "sass":
        if not args.parent:
            raise SystemExit("probe_variants sass: --parent DIR is required")
        run_sass(args.parent)
        return
    if not torch.cuda.is_available():
        raise SystemExit("probe_variants: no CUDA device (it times builds of the kernels on the card)")
    dev = torch.device("cuda", 0)
    if args.mode in ("attn", "mutants"):
        print(T.card_line(dev), flush=True)
        run_attention(dev, args.parent) if args.mode == "attn" else run_mutants(dev)
        return
    ms = [int(m) for m in (args.ms or {"gemv": "1,8", "tile": "17,64,203", "tf32": "17,512",
                                       "gemv32": "1,8"}[args.mode]).split(",")]
    if args.mode in ("tf32", "gemv32"):
        torch.backends.cuda.matmul.allow_tf32 = False  # the library yardstick in f32
    print(T.card_line(dev), flush=True)
    run(args.mode, names, args.fmt.split(","), ms, dev, args.parent)


if __name__ == "__main__":
    main()
