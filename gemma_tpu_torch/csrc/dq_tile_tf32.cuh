// The tensor-core tile of the quantized matmuls' f32 evaluation route: y[M,
// N] (f32) = x[M, K] (f32) . dequant(W)^T at M > 8 with f32 activations
// (perplexity, the f32 caches of --verify, f32 serving), held to 1e-5 of the
// output's scale against the f32 dot.
//
// Replaces on that route the Pallas kernels `_q4_0_kernel`, `_q4_k_kernel`,
// `_q6_k_kernel` and `_q8_0_kernel` of gemma_tpu/ops/quant_matmul.py (whose
// dispatch sends f32 activations to an f32 dequant and dot,
// quant_matmul.py:373-380), in place of the f32 plain-FMA tiles
// `q4_0_tiled_kernel`, `q4_k_tiled_kernel`, `q6_k_tiled_kernel` and
// `q8_0_tiled_kernel` that ran there: every format's f32 x above M = 8.
//
// Accuracy: TF32 keeps 10 mantissa bits (~5e-4 relative), so one TF32 pass
// cannot hold 1e-5. Chosen here: two passes with the weight exact.
// * The weight enters the product as its integer, q4_0's and q4_k's q - 8
//   (-8..7), q6_k's q - 32 (-32..31) and q8_0's q (-128..127): exact in
//   TF32. No scale is folded into it.
// * x splits into hi = tf32(x), rounded to nearest as `cvt.rna.tf32.f32`
//   rounds, and lo = x - hi (exact in f32) truncated to TF32: hi + lo is x
//   within 2^-21 of |x|, and each of hi * q, lo * q is exact in the f32
//   accumulators. Two `mma.sync` m16n8k8 TF32 products a k8 step, not
//   3xTF32's three: the weight needs no lo part.
// * Each scale group (q4_0, q4_k and q8_0: 32 weights, q6_k: 16) sums into a fresh
//   fragment, which is scaled by its f32 group scale (d*sc) into the
//   accumulators with fmaf: the pattern of the bf16 GEMV (dq_gemv.cuh).
//   The scale is per weight row, that is per column of the C fragment, so
//   each lane scales its two columns.
// * q4_k's affine part stays in f32, as dq_tile.cuh's kAffine path does it:
//   y += sum over 32-groups g of xsum[m, g] * (8 d*sc - dmin*mn)_g, with
//   xsum the sum of the f32 x over the group, formed once a K-step from the
//   x tile in shared memory.
// So the kernel differs from the plain f32 version (x @ dequant(W)^T with
// f32 weights) by the 2^-21 of the split and the order and grouping of f32
// sums: ~1e-6 of the output's scale.
//
// A template over a per-format functor F that reuses the bf16 tile's raw
// layout and copies (`Q4_0Tile`, `Q4KTile`, `Q6KTile`, `Q8_0Tile`: one row's
// raw bytes of a 64-wide K-step, in quarters):
//
//   struct F : <the bf16 tile's functor> {
//     static constexpr int kGroupUnits;  // 16-wide units a scale covers: 2 or 1
//     // the f32 scale (and with kAffine the offset) of scale group grp of
//     // the step at k0 from row n's raw bytes
//     static void prepare(const uint8_t* raw, float* scale, float* off, int n, int K, int k0, int grp);
//     // weights 16u + 4t .. 16u + 4t + 3 of the step, as exact f32 integers
//     static void weights(const uint8_t* raw, int k0, int u, int t, uint32_t (&b)[4]);
//   };
//
// Design (sm_90a, `mma.sync` m16n8k8 TF32 -> f32):
// * 64-row tiles, 256 threads: 2 warps along M x 4 along N, each warp 32 x
//   (BN / 4) outputs (BN = 128 at N >= 1024, else 64), two blocks an SM.
// * K steps of 64. x (f32) and the raw weight bytes go global -> shared by
//   cp.async into a ring of kTfStages = 3, issued two steps ahead: a step's
//   loads land behind a step of products. One barrier a step. Three stages
//   let q6_k's 112-byte raw rows take 128-wide tiles at two blocks an SM,
//   and read faster than four at the perplexity window's M = 512, q4_k's
//   too (q6_k at M = 17 reads faster at four: PERF.md). Each step's group
//   scales (and q4_k's offsets and per-32 sums of x) are formed once a
//   block into a ring of two tables while the step before runs its
//   products. The shared memory limit is raised once a device and size
//   (`raise_smem_limit`).
// * The order of K within a 16-wide unit is the kernel's choice, as long
//   as x and W follow the same one: at k8 step s of unit u, lane (g, t)'s
//   fragment slots k = t and k = t + 4 take elements 16u + 4t + 2s and
//   16u + 4t + 2s + 1. So a lane's A values for both k8 steps of a unit are
//   one 16-byte shared load a row, and its B values are four consecutive
//   weights of its row: one 32-bit word of q4_0's or q4_k's nibbles (q6_k:
//   one ql and one qh word; q8_0: one payload word, sign bits flipped), turned
//   into f32 integers by a byte perm and a subtract (2^23 + u less 2^23 +
//   bias), with no conversion instruction.
// * K is a multiple of 32. Where it is not one of 64 (q4_0, q8_0), the last step
//   is half a step, as in dq_tile.cuh: x columns at or past K are
//   zero-filled by cp.async (nothing past K is read), the functor copies
//   zero weights there and `prepare` gives the group past K the scale 0.
//   q4_k and q6_k (K a multiple of 256) never meet it.
// * x rows are padded to 80 floats (320 bytes): the 8 lanes of a 16-byte
//   load phase, rows g and g + 1 at chunks 4u + t, fall on distinct banks,
//   and each lane's loads sit at fixed offsets from one address (no
//   per-load address math, as an XOR swizzle would need). The raw rows'
//   pitches (q4_0 and q4_k 48, q6_k 112, q8_0 80 bytes) put the 32-bit
//   weight words of a warp's 8 rows x 4 lanes on distinct banks.
// * Grid fill: where the output tiles hold fewer than two blocks an SM
//   (q4_k attn_k and q6_k attn_v, [256 x 2048], at any M; attn_q, attn_out
//   and down at M <= 512; q8_0's qkv at M <= 64, attn_out and down), the K
//   steps split over up to 16 blocks a tile (grid z, by the count with the
//   fewest rounds: `dq_tile_tf32_splits`), each writing f32 partial sums to
//   the caller's workspace
//   (`dq_tile_tf32_work_bytes`), and dq_tile.cuh's second kernel adds the
//   splits in order: the sums are deterministic at fixed shapes.
//
// What bounds it on the H100: operations. A Gemma-2B prefill window (M =
// 512) does 2 M N K flops a matrix on weights of a few MB: gate_up [32768 x
// 2048] 68.7 GFLOP, 0.139 ms at 495 TFLOP/s of TF32 against 0.016 ms of
// bytes; the head [256000 x 2048] 537 GFLOP, 1.085 ms. That is the bound of
// the function; the tile's two passes are its way to f32 accuracy, and run
// at best in twice that (0.278, 2.17 ms). The f32 FMA tile it replaces was
// held to 67 TFLOP/s (1.026 and 8.01 ms at best). Expected before it ran:
// every q4_k and q6_k f32 row at or below f32 torch.matmul on the
// dequantized weight, gate_up and head at 40 % or more of the two-pass
// figure. Measured (chip_smoke.py phase 3, PERF.md section 6): every row at
// 0.45-0.86x the library call; gate_up and head at 12-13 % of the bound
// (24-26 % of the two-pass figure); the products take about half the time
// and the weights' load and conversion a third (`probe_variants tf32`
// ablations).
#pragma once

#include "dq_tile.cuh"  // cp.async, smem_u32, dq_steps, dq_warps, sm_count, dq_split_sum_kernel

namespace gt {
// launches of dq_tile_tf32_kernel in this process, every format, counted
// where they are issued; gt_dq_tile_tf32_launches (q4_k_matmul.cu) reads
// it, and the wrappers count a launch as the tile's by its change
inline std::atomic<unsigned long long> dq_tile_tf32_launch_count{0};
}  // namespace gt

namespace {

using namespace gt;

constexpr int kTfBM = 64;         // rows of a tile
constexpr int kTfBK = kDqBK;      // K per step: four 16-wide units
constexpr int kTfLd = kTfBK + 16; // x row pitch in floats (320 bytes)
constexpr int kTfStages = 3;      // ring of x tiles and raw weight bytes
constexpr int kTfThreads = 256;   // 2 warps along M x 4 along N
constexpr int kTfMaxSplits = 16;      // K splits (grid z) at most
constexpr int kTfMinSplitSteps = 2;   // K steps a split at least
// a block's shared memory at which two share an SM (228 KB, 1 KB reserved each)
constexpr size_t kTfTwoBlockSmem = 113 * 1024;

// `cvt.rna.tf32.f32` for finite v (nearest, ties away from zero: half an
// ulp of TF32 added to the magnitude, the 13 low bits cleared) in two
// integer instructions; the cvt instruction also handles infinities and
// NaN, which x never holds here, and reads slower (`probe_variants tf32`,
// `tf_cvt`: PERF.md)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo, each exact in TF32, to 2^-21 of |v|: hi = tf32(v) rounded,
// v - hi exact in f32 and truncated to TF32 (CUTLASS's 3xTF32 takes its
// small part the same way)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xFFFFE000u;
}

// c += a (16x8, row) . b (8x8, col), TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_1688_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the four bytes of w (each < 2^8) less `bias`, as f32 bits: byte i of w in
// the low mantissa of 2^23 (0x4B000000), then 2^23 + bias subtracted
__device__ __forceinline__ void bytes_minus(uint32_t w, float bias, uint32_t (&b)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    b[i] = __float_as_uint(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 + i)) - (8388608.f + bias));
}

// byte offsets of the tile's shared buffers: x [S][64][kTfLd] f32, raw
// [S][BN][F::kRaw], scales [2][4][BN] f32, offs [2][2][BN] f32, xsum
// [2][64][2] f32 (the last two with kAffine only)
template <class F, int BN>
struct TfTileSmem {
  static constexpr size_t kX = 0;
  static constexpr size_t kRaw = kX + size_t{kTfStages} * kTfBM * kTfLd * 4;
  static constexpr size_t kScale = kRaw + size_t{kTfStages} * BN * F::kRaw;
  static constexpr size_t kOffs = kScale + 2 * 4 * BN * 4;
  static constexpr size_t kXsum = kOffs + (F::kAffine ? 2 * 2 * BN * 4 : 0);
  static constexpr size_t kBytes = kXsum + (F::kAffine ? 2 * kTfBM * 2 * 4 : 0);
};

// y (one split), or split blockIdx.z's partial sums [M][N] at y + blockIdx.z
// * M * N: K steps blockIdx.z * steps / gridDim.z ..
template <class F, int BN>
__global__ void __launch_bounds__(kTfThreads, 2)
dq_tile_tf32_kernel(const float* __restrict__ x, const typename F::Weight w, float* __restrict__ y,
                    int M, int N, int K) {
  constexpr int S = kTfStages, BM = kTfBM;
  constexpr int WN = BN / 4;               // a warp's outputs: 32 x WN
  constexpr int TM = 2, TN = WN / 8;       // its m16 and n8 tiles
  constexpr int GU = F::kGroupUnits;       // units a scale group
  constexpr int G = 4 / GU;                // scale groups a step
  constexpr bool kAffine = F::kAffine;
  static_assert(F::kRaw % 16 == 0 && (GU == 1 || GU == 2) && (!kAffine || G == 2), "functor");
  using L = TfTileSmem<F, BN>;

  extern __shared__ __align__(128) unsigned char tf_smem[];
  float* xs = reinterpret_cast<float*>(tf_smem + L::kX);
  unsigned char* raw = tf_smem + L::kRaw;
  float* scales = reinterpret_cast<float*>(tf_smem + L::kScale);
  float* offs = reinterpret_cast<float*>(tf_smem + L::kOffs);
  float* xsum = reinterpret_cast<float*>(tf_smem + L::kXsum);

  const int tid = threadIdx.x;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = (tid / 32) / 4, wn = (tid / 32) % 4;  // warp row, column
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int steps = dq_steps(K) / gridDim.z;  // this split's
  const int kbase = blockIdx.z * steps * kTfBK;
  const bool rows = m0 + wm * 32 < M;  // the warp has rows below M
  y += static_cast<size_t>(blockIdx.z) * M * N;

  // x tile and raw weight bytes of `step` into ring slot step % S; rows of
  // x at or past M, its columns at or past K (the half step) and weight
  // rows at or past N are zeros. A thread copies
  // chunk tid % 16 of x rows tid / 16 + 16 i, and quarter (tid + 256 i) / BN
  // of weight row tid % BN: the lanes of a warp take one quarter of 32 rows,
  // so the functor's branches on the quarter do not diverge.
  constexpr int kXRows = kTfThreads / (kTfBK / 4);  // x rows a pass: 16
  const float* xsrc = x + static_cast<size_t>(m0 + tid / 16) * K + 4 * (tid % 16);
  const int xdst_off = (tid / 16) * kTfLd + 4 * (tid % 16);
  auto issue = [&](int step) {
    const int k0 = kbase + step * kTfBK;
    float* xdst = xs + (step % S) * BM * kTfLd + xdst_off;
#pragma unroll
    for (int i = 0; i < BM / kXRows; ++i) {
      const bool ok = m0 + tid / 16 + kXRows * i < M && k0 + 4 * (tid % 16) < K;
      cp_async16(smem_u32(xdst + kXRows * i * kTfLd),
                 ok ? xsrc + static_cast<size_t>(kXRows * i) * K + k0 : x, ok);
    }
    const uint32_t rdst = smem_u32(raw + (step % S) * BN * F::kRaw);
#pragma unroll
    for (int it = tid; it < 4 * BN; it += kTfThreads)
      F::copy(w, rdst + (it % BN) * F::kRaw, n0 + it % BN, N, K, k0, it / BN);
  };
  // the step's group scales (and offsets) of each row, [group][BN], into
  // table slot step % 2
  auto prepare = [&](int step) {
    const unsigned char* src = raw + (step % S) * BN * F::kRaw;
    float* sc = scales + (step % 2) * 4 * BN;
    float* of = offs + (step % 2) * 2 * BN;
#pragma unroll
    for (int it = tid; it < G * BN; it += kTfThreads) {
      const int r = it % BN, grp = it / BN;
      F::prepare(src + r * F::kRaw, sc + grp * BN + r, of + grp * BN + r, n0 + r, K,
                 kbase + step * kTfBK, grp);
    }
  };
  // each x row's f32 sums over the step's two 32-groups: four lanes a
  // group, eight values each, then two shuffles
  auto sum_x = [&](int step) {
    const float* src = xs + (step % S) * BM * kTfLd;
    float* dst = xsum + (step % 2) * BM * 2;
#pragma unroll
    for (int i = tid; i < BM * 8; i += kTfThreads) {
      const int r = i / 8, gq = (i / 4) % 2, q = i % 4;
      const float4 a = *reinterpret_cast<const float4*>(src + r * kTfLd + 32 * gq + 8 * q);
      const float4 b = *reinterpret_cast<const float4*>(src + r * kTfLd + 32 * gq + 8 * q + 4);
      float s = ((a.x + a.y) + (a.z + a.w)) + ((b.x + b.y) + (b.z + b.w));
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (q == 0) dst[r * 2 + gq] = s;
    }
  };

  float acc[TM][TN][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  // a lane's A rows (wm * 32 + 16 i + g, and + 8) at its chunk t of a unit,
  // and its B row (wn * WN + 8 j + g), as offsets into a stage
  const int a_off = (wm * 32 + g) * kTfLd + 4 * t;
  const int b_off = (wn * WN + g) * F::kRaw;
  auto mma_step = [&](int step) {
    const float* xa = xs + (step % S) * BM * kTfLd + a_off;
    const unsigned char* rb = raw + (step % S) * BN * F::kRaw + b_off;
    const float* sc = scales + (step % 2) * 4 * BN;
    const int k0 = kbase + step * kTfBK;
    float part[TM][TN][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u % GU == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) part[i][j][c] = 0.f;
      }
      uint32_t b[TN][4];  // b0, b1 of k8 step 0, then of step 1
#pragma unroll
      for (int j = 0; j < TN; ++j) F::weights(rb + 8 * j * F::kRaw, k0, u, t, b[j]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v0 = *reinterpret_cast<const float4*>(xa + 16 * i * kTfLd + 16 * u);
        const float4 v1 = *reinterpret_cast<const float4*>(xa + (16 * i + 8) * kTfLd + 16 * u);
        // k8 step s: a0 = (r, slot t) = element 4t + 2s, a1 = (r + 8, t),
        // a2 = (r, t + 4) = element 4t + 2s + 1, a3 = (r + 8, t + 4)
        const float vs[2][4] = {{v0.x, v1.x, v0.y, v1.y}, {v0.z, v1.z, v0.w, v1.w}};
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(vs[s][e], hi[e], lo[e]);
#pragma unroll
          for (int j = 0; j < TN; ++j) mma_1688_tf32(part[i][j], lo, b[j][2 * s], b[j][2 * s + 1]);
#pragma unroll
          for (int j = 0; j < TN; ++j) mma_1688_tf32(part[i][j], hi, b[j][2 * s], b[j][2 * s + 1]);
        }
      }
      if (u % GU == GU - 1) {
        // fragment c0/c1: row g, cols 2t + {0, 1}; c2/c3: row g + 8
        const float* scg = sc + (u / GU) * BN + wn * WN + 2 * t;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float2 d = *reinterpret_cast<const float2*>(scg + 8 * j);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            acc[i][j][0] = fmaf(d.x, part[i][j][0], acc[i][j][0]);
            acc[i][j][1] = fmaf(d.y, part[i][j][1], acc[i][j][1]);
            acc[i][j][2] = fmaf(d.x, part[i][j][2], acc[i][j][2]);
            acc[i][j][3] = fmaf(d.y, part[i][j][3], acc[i][j][3]);
          }
        }
      }
    }
    if constexpr (kAffine) {
      const float* xsm = xsum + (step % 2) * BM * 2;
      const float* off = offs + (step % 2) * 2 * BN;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = wn * WN + j * 8 + 2 * t;
        const float2 o0 = *reinterpret_cast<const float2*>(off + col);
        const float2 o1 = *reinterpret_cast<const float2*>(off + BN + col);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 s = *reinterpret_cast<const float2*>(xsm + (wm * 32 + i * 16 + g + 8 * h) * 2);
            float& c0 = acc[i][j][2 * h];
            float& c1 = acc[i][j][2 * h + 1];
            c0 = fmaf(s.y, o1.x, fmaf(s.x, o0.x, c0));
            c1 = fmaf(s.y, o1.y, fmaf(s.x, o0.y, c1));
          }
      }
    }
  };

  // prologue: steps 0 .. S - 2 in flight; wait for steps 0 and 1, then
  // form step 0's scales (and sums of x)
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  cp_async_wait<S - 3>();
  __syncthreads();
  prepare(0);
  if constexpr (kAffine) sum_x(0);
  __syncthreads();

  for (int k = 0; k < steps; ++k) {
    // writes: ring slot k + S - 1 (freed at the last barrier), table slot
    // k + 1; reads: ring slots k and k + 1, table slot k
    if (k + S - 1 < steps) issue(k + S - 1);
    cp_async_commit();
    if (k + 1 < steps) {
      prepare(k + 1);
      if constexpr (kAffine) sum_x(k + 1);
    }
    if (rows) mma_step(k);
    cp_async_wait<S - 3>();  // step k + 2 has landed (S = 3: every copy issued)
    __syncthreads();
  }

  if (!rows) return;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + i * 16 + g + 8 * h;
      if (m >= M) continue;
      float* yrow = y + static_cast<size_t>(m) * N;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + wn * WN + j * 8 + 2 * t;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (n + 1 < N && N % 2 == 0) {
          *reinterpret_cast<float2*>(yrow + n) = make_float2(v0, v1);
        } else {
          if (n < N) yrow[n] = v0;
          if (n + 1 < N) yrow[n + 1] = v1;
        }
      }
    }
}

struct TfTilePlan {
  int bn;      // 64 or 128
  int splits;  // K splits (grid z), 1 to kTfMaxSplits
};

// K splits of (64 x bn)-tiles at (M, N, K). A grid of two blocks an SM or
// more runs unsplit. A smaller one takes the split count (a power of two up
// to kTfMaxSplits that divides the steps, each split kTfMinSplitSteps steps
// or more) with the fewest rounds of two blocks an SM x (steps a split +
// 2, for a block's prologue and the sum of its partials), the fewer splits
// on a tie. Narrow and deep rows at small M (q4_k's attn_k, attn_v and down
// at M = 17) take 16 splits of 2 steps, where the bf16 tile's limits stop
// at 8 of 4 (`probe_variants tf32`, `tf_sp8`); q8_0's attn_out and down at
// M = 203 and 512 take 8 and 4, 0.71-0.82x the time of the 1 or 2 that
// doubling while the split grid held at most 16 warps an SM gave them, and
// q4_k_m's Gemma-2B rows keep that rule's plans (`tf_fill16`: PERF.md).
inline int dq_tile_tf32_splits(int M, int N, int K, int bn) {
  const int steps = dq_steps(K);
  const long tiles = dq_warps(M, N, kTfBM, bn) / (kTfThreads / 32), slots = 2L * sm_count();
  int splits = 1;
  if (tiles >= slots) return splits;
  long best = steps + 2;  // one round, unsplit
  for (int z = 2; z <= kTfMaxSplits && steps % z == 0 && steps / z >= kTfMinSplitSteps; z *= 2) {
    const long cost = (tiles * z + slots - 1) / slots * (steps / z + 2);
    if (cost < best) {
      best = cost;
      splits = z;
    }
  }
  return splits;
}

// The tile's plan at (M, N, K): 128-wide tiles where N >= 1024 and the
// format's raw step lets two blocks share an SM (every format at three
// stages), else 64
template <class F>
TfTilePlan dq_tile_tf32_plan(int M, int N, int K) {
  const int bn = N >= 1024 && TfTileSmem<F, 128>::kBytes <= kTfTwoBlockSmem ? 128 : 64;
  return {bn, dq_tile_tf32_splits(M, N, K, bn)};
}

// bytes of the workspace the launch of a (M, N, K) tile needs (0: none)
template <class F>
size_t dq_tile_tf32_work_bytes(int M, int N, int K) {
  const TfTilePlan p = dq_tile_tf32_plan<F>(M, N, K);
  return p.splits > 1 ? static_cast<size_t>(p.splits) * M * N * sizeof(float) : 0;
}

template <class F, int BN>
cudaError_t launch_tf32_shape(const float* x, const typename F::Weight& w, float* y, float* work,
                              int M, int N, int K, int splits, cudaStream_t s) {
  static std::atomic<int> limits[kSmemDevices];  // bytes set so far, 0 on start
  constexpr size_t smem = TfTileSmem<F, BN>::kBytes;
  const cudaError_t e = raise_smem_limit(dq_tile_tf32_kernel<F, BN>, limits, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BN - 1) / BN, (M + kTfBM - 1) / kTfBM, splits);
  dq_tile_tf32_kernel<F, BN><<<grid, kTfThreads, smem, s>>>(x, w, splits > 1 ? work : y, M, N, K);
  dq_tile_tf32_launch_count.fetch_add(1, std::memory_order_relaxed);
  if (splits > 1) {
    const size_t MN = static_cast<size_t>(M) * N;
    const size_t blocks = (MN + 255) / 256;
    dq_split_sum_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
        work, y, MN, splits);
  }
  return cudaGetLastError();
}

// work: dq_tile_tf32_work_bytes<F>(M, N, K) bytes (may be null when that is
// 0); K a multiple of 32, x 16-byte aligned
template <class F>
cudaError_t launch_dq_tile_tf32(const float* x, const typename F::Weight& w, float* y, float* work,
                                int M, int N, int K, cudaStream_t s) {
  const TfTilePlan p = dq_tile_tf32_plan<F>(M, N, K);
  if (K % 32 != 0 || (p.splits > 1 && work == nullptr)) return cudaErrorInvalidValue;
  if constexpr (TfTileSmem<F, 128>::kBytes <= kTfTwoBlockSmem) {
    if (p.bn == 128) return launch_tf32_shape<F, 128>(x, w, y, work, M, N, K, p.splits, s);
  }
  return launch_tf32_shape<F, 64>(x, w, y, work, M, N, K, p.splits, s);
}

}  // namespace
