// The tensor-core GEMV of the quantized matmuls: y[M, N] (f32) = x[M, K]
// (bf16) . dequant(W)^T at M <= 8 with bf16 x, the decode and serving steps'
// shape. What launches it (each format's launcher, M <= 8 and bf16 x):
// * q4_k and q6_k at 1 <= M <= 8 (`Q4KGemv` in q4_k_matmul.cu, `Q6KGemv` in
//   q6_k_matmul.cu): every matmul of a q4_k_m decode step;
// * q4_0 and q8_0 at 2 <= M <= 8 (`Q4_0Gemv`, `Q8_0Gemv` below); at M = 1
//   they still run their SIMT GEMV (ROADMAP step 2 names that next).
// f32 x (evaluation mode) runs each format's SIMT GEMV at M <= 8.
//
// Replaces, at that shape, the Pallas kernels `_q4_0_kernel`, `_q8_0_kernel`,
// `_q4_k_kernel` and `_q6_k_kernel` (`_q6_k_v4_kernel` on its layout) of
// gemma_tpu/ops/quant_matmul.py at f32dot=True (M <= 8, `quant_matmul.py:315`):
// f32 weights and x, f32 sums. Here the weight enters the product as its
// integer, u - 8 (q4_0, q4_k), q (q8_0) or q - 32 (q6_k), exact in bf16, x is
// exact in bf16, so every product is exact in f32. Each scale group (32
// values; q6_k's sub-blocks: 16) sums into a fresh fragment, which is scaled
// by the group's f32 scale (d, d * sc) into the accumulator; q4_k adds its
// affine part (8 d*sc - dmin*mn) * sum(x) per 32-group in f32, never rounded
// to bf16. Only the order of f32 sums differs from the plain version.
//
// What bounds it on the H100: weight bytes. Each weight is used M <= 8
// times, far below the card's ~295 flop/byte balance point (ffn_down q4_0
// at M = 8: 0.0057 ms of bytes). The design keeps many weight bytes in
// flight and spends few instructions a byte:
// * `mma.sync` m16n8k16 bf16 -> f32 with W as the A operand (16 weight rows
//   a warp) and x as the B operand: the n8 side is the <= 8 rows of x, rows
//   at or past M read as zeros (at M = 1 seven of eight columns: bytes, not
//   the tensor cores, bound the kernel). One mma does 16 x 8 x 16 products.
// * x is copied once a block, as bf16, by 16-byte cp.async: the block's
//   K-slice of its M rows (<= kGvSliceMax values a row) and, below M = 8,
//   one zero row that the lanes of rows >= M read, in shared memory,
//   one barrier (q4_k: two, around the per-32 sums of x), then no
//   block-level barrier at all.
// * Each warp streams its 16 rows through its own ring of kGvStages stages
//   (F::kStageK values a row: 16-byte cp.async of the payload, coalesced, and
//   the format's scale bytes), so three stages are in flight while one is
//   multiplied; a warp waits only on its own copies (`__syncwarp`).
// * ldmatrix on the raw payload bytes gives lane (g, t) the 32-bit word
//   4t..4t+3 of rows g and g + 8 of a 16-byte piece: exactly the bytes its A
//   fragment needs under this k order within a k16 step:
//     slot 2t -> byte 4t, 2t + 1 -> 4t + 2, 2t + 8 -> 4t + 1, 2t + 9 -> 4t + 3
//   A and B use the same order, so the x fragment is one 8-byte shared load
//   and two byte perms. No weight is converted on its own: a nibble pair
//   becomes bf16x2 by one mask-or (128 + u) and a bf16x2 subtract of 136
//   (`nibble_pair`), q6_k's 6-bit pairs the same way less 160
//   (`six_bit_pair`), an int8 pair by the f32 magic 2^23 + 128 and a perm
//   that keeps the high halves (`int8_pair`; exact: |q| <= 128).
// * Scales: q4_0's and q8_0's f16 words are read where they landed; q4_k's
//   6-bit table and q6_k's int8 scales are decoded once a row and
//   superblock, by one lane each, into a warp's f32 table (`prepare`).
// * K splits over blocks (grid y) where the row tiles hold too few warps to
//   fill the card (q4_0, q8_0: 8 warps an SM; q4_k and q6_k, whose stages
//   are a whole superblock, read fastest at 4, with twice the stages a
//   warp). Each split writes its f32 partials to a workspace the caller
//   allocates, and they are added in split order, so a row's sums do not
//   depend on the other rows or on M: serving stays batch-invariant and
//   deterministic. Where the grid holds at most kGvTicketBlocks blocks an
//   SM (every split the plan makes to fill the card), the last block of a
//   row tile to finish, found by a ticket a tile in a persistent buffer
//   that the kernel leaves at 0, adds them in the same launch, all its
//   loads in flight at once (`gemv_split_sum`); a wider grid (q8_0's splits
//   to fit K = 3072 or 24576 in shared memory) adds them in a second
//   launch, `dq_split_sum_kernel`, as every block's fence and ticket would
//   lengthen each of its waves (PERF.md).
//
// A format is a functor F:
//   struct F {
//     struct Weight;                 // the format's device pointers
//     static constexpr int kStageK;  // K values a row a ring stage
//     static constexpr int kGran;    // K splits cut K in multiples of this
//     static constexpr int kTargetWarps;  // warps an SM the K splits aim for
//     static constexpr int kGroupK;  // K values of one scale group
//     static constexpr int kStage;   // bytes of a warp's ring stage (a multiple of 16)
//     static constexpr int kPieces, kGroups, kSteps;  // ldmatrix pieces a stage,
//                                    // scale groups a piece, k16 steps a group
//     static constexpr int kWords;   // ldmatrix words a piece
//     static constexpr int kTable;   // f32 of a warp's decoded scales (0: none)
//     static constexpr bool kAffine; // q4_k's per-32 affine part
//     // cp.async of the warp's 16 rows' K values kb .. kb + kStageK (below
//     // khi) into `stage`; rows >= N and values past khi read as zeros
//     static void copy(const Weight&, unsigned char* stage, int lane, int n0, int N, int K,
//                      int kb, int khi);
//     // the landed stage's scales -> the warp's f32 table (kTable > 0)
//     static void prepare(const unsigned char* stage, float* table, int lane, int n0, int K, int kb);
//     static void load(const unsigned char* stage, int lane, int p, uint32_t (&r)[kWords]);
//     // the A fragment of step s of group gi of piece p, from its words
//     static void a_frag(const uint32_t (&r)[kWords], int gi, int s, uint32_t (&a)[4]);
//     static int x_off(int p, int gi, int s);  // the step's first K value in the stage
//     // group grp's scales (d) and affine offsets (off) of rows g and g + 8
//     static void scales(const unsigned char* stage, const float* table, int g, int n0, int K,
//                        int kb, int grp, float (&d)[2], float (&off)[2]);
//   };
#pragma once

#include "dq_tile.cuh"

namespace {

using namespace gt;

// the weight of q4_0 and q8_0: payload bytes [N, K * kBlockBytes / 32] and
// f16 scales [N, K / 32], N-major (gemma_tpu_torch/quant/qtensor.py)
struct BlockWeight {
  const uint8_t* qs;
  const __half* scales;
};

constexpr int kGvWarps = 4;         // warps a block, 16 weight rows each
constexpr int kGvStageK = 128;      // K of q4_0's and q8_0's ring stage: four 32-blocks
constexpr int kGvSuperK = 256;      // q4_k's and q6_k's superblock: their stage and split unit
constexpr int kGvStages = 4;        // depth of each warp's ring
constexpr int kGvScaleWords = 3;    // f16 words a row a stage: its 4 scales at any parity
constexpr int kGvSliceMax = 2048;   // K of x a block holds in shared memory
constexpr int kGvSliceMin = 512;    // K splits stop above this slice
constexpr int kGvTargetWarps = 8;   // warps an SM the K splits aim for (q4_0, q8_0)
constexpr int kGvSuperTargetWarps = 4;  // the same for q4_k and q6_k (measured: PERF.md)
constexpr int kGvTicketBlocks = 4;  // blocks an SM up to which a launch sums its own splits (measured)

// the plan's constants: q4_0's and q8_0's (whole 32-blocks), and q4_k's
// and q6_k's (whole superblocks)
struct BlockPlan {
  static constexpr int kGran = 32;
  static constexpr int kTargetWarps = kGvTargetWarps;
};
struct SuperPlan {
  static constexpr int kGran = kGvSuperK;
  static constexpr int kTargetWarps = kGvSuperTargetWarps;
};

// bf16x2 (u0 - 8, u1 - 8) of the nibbles in bits 0-3 and 16-19 of v
__device__ __forceinline__ uint32_t nibble_pair(uint32_t v) {
  const uint32_t b = (v & 0x000F000Fu) | 0x43004300u;  // bf16 128 + u, exactly
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&b),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// bf16x2 (u0 - 32, u1 - 32) of the 6-bit values in bits 0-5 and 16-21 of v
__device__ __forceinline__ uint32_t six_bit_pair(uint32_t v) {
  const uint32_t b = (v & 0x003F003Fu) | 0x43004300u;  // bf16 128 + u, exactly
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&b),
                                   __floats2bfloat162_rn(160.f, 160.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// bf16x2 (q_i, q_j) of the int8 bytes i and j of w, given u = w ^ 0x80808080
__device__ __forceinline__ uint32_t int8_pair(uint32_t u, int i, int j) {
  // 2^23 + (q + 128) as f32, then exactly q
  const float a = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
  const float b = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) - 8388736.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// ldmatrix.x4 of 32 bytes at column `col` of a [16][pitch] byte tile: r[0] /
// r[1]: rows g / g + 8, bytes 4t.. of the first 16; r[2] / r[3]: of the second
__device__ __forceinline__ void ldmatrix_rows16(uint32_t (&r)[4], const unsigned char* tile,
                                                int pitch, int col, int lane) {
  ldmatrix_x4(r, smem_u32(tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * pitch + col +
                          (lane >> 4) * 16));
}

// q4_0 (kBlockBytes 16) and q8_0 (32). A stage is four 32-blocks: payload
// [16][kPitch] (16 bytes of padding a row, so the 8 rows an ldmatrix phase
// reads fall on distinct banks), then the aligned f16 words that hold each
// row's four scales, [16][3] words. A piece is 32 payload bytes: q4_0's
// blocks 2p, 2p + 1 (step s of a block is nibble s of its 16 bytes, since
// byte j holds w[j] and w[j + 16]), or q8_0's block p (step s its half s).
template <int kBlockBytes>
struct BlockGemv : BlockPlan {
  using Weight = BlockWeight;
  static constexpr int kStageK = kGvStageK;
  static constexpr int kGroupK = 32;
  static constexpr int kRowBytes = kStageK / 32 * kBlockBytes;
  static constexpr int kPitch = kRowBytes + 16;
  static constexpr int kScales = 16 * kPitch;
  static constexpr int kStage = kScales + 16 * kGvScaleWords * 4;
  static constexpr int kPieces = kRowBytes / 32, kGroups = 32 / kBlockBytes, kSteps = 2;
  static constexpr int kWords = 4;
  static constexpr int kTable = 0;
  static constexpr bool kAffine = false;

  __device__ __forceinline__ static void copy(const Weight& w, unsigned char* stage, int lane, int n0,
                                              int N, int K, int kb, int khi) {
    constexpr int kChunks = 16 * kRowBytes / 16;  // 16-byte payload copies a stage
    const size_t row_bytes = static_cast<size_t>(K) / 32 * kBlockBytes;
    const size_t nscales = static_cast<size_t>(N) * (K / 32);
#pragma unroll
    for (int i = lane; i < kChunks; i += 32) {
      const int r = i / (kChunks / 16), c = i % (kChunks / 16);
      const bool ok = n0 + r < N && kb + c * 16 / kBlockBytes * 32 < khi;
      const uint8_t* src = w.qs + static_cast<size_t>(n0 + r) * row_bytes +
                           static_cast<size_t>(kb) / 32 * kBlockBytes + c * 16;
      cp_async16(smem_u32(stage + r * kPitch + c * 16), ok ? src : w.qs, ok);
    }
#pragma unroll
    for (int i = lane; i < 16 * kGvScaleWords; i += 32) {
      const int r = i / kGvScaleWords, j = i % kGvScaleWords;
      const size_t h = ((static_cast<size_t>(n0 + r) * (K / 32) + kb / 32) & ~size_t{1}) + 2 * j;
      cp_async_half2(smem_u32(stage + kScales + 4 * i), w.scales, h, nscales);
    }
  }

  __device__ __forceinline__ static void prepare(const unsigned char*, float*, int, int, int, int) {}

  __device__ __forceinline__ static void load(const unsigned char* stage, int lane, int p,
                                              uint32_t (&r)[kWords]) {
    ldmatrix_rows16(r, stage, kPitch, 32 * p, lane);
  }

  __device__ __forceinline__ static void a_frag(const uint32_t (&r)[kWords], int gi, int s,
                                                uint32_t (&a)[4]) {
    if constexpr (kBlockBytes == 16) {
      const uint32_t w0 = r[2 * gi], w1 = r[2 * gi + 1];
      a[0] = nibble_pair(w0 >> (4 * s));
      a[1] = nibble_pair(w1 >> (4 * s));
      a[2] = nibble_pair(w0 >> (4 * s + 8));
      a[3] = nibble_pair(w1 >> (4 * s + 8));
    } else {
      const uint32_t u0 = r[2 * s] ^ 0x80808080u, u1 = r[2 * s + 1] ^ 0x80808080u;
      a[0] = int8_pair(u0, 0, 2);
      a[1] = int8_pair(u1, 0, 2);
      a[2] = int8_pair(u0, 1, 3);
      a[3] = int8_pair(u1, 1, 3);
    }
  }

  __device__ __forceinline__ static int x_off(int p, int gi, int s) {
    return 32 * (p * kGroups + gi) + 16 * s;
  }

  __device__ __forceinline__ static void scales(const unsigned char* stage, const float*, int g, int n0,
                                                int K, int kb, int grp, float (&d)[2], float (&)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __half* sc = reinterpret_cast<const __half*>(stage + kScales + (g + 8 * h) * 4 * kGvScaleWords) +
                         ((static_cast<size_t>(n0 + g + 8 * h) * (K / 32) + kb / 32) & 1);
      d[h] = __half2float(sc[grp]);
    }
  }
};

using Q4_0Gemv = BlockGemv<16>;
using Q8_0Gemv = BlockGemv<32>;

// rows of the x slice in shared memory: M, and below 8 one row of zeros
__host__ __device__ constexpr int gemv_x_rows(int M) { return M < 8 ? M + 1 : 8; }

// shared bytes of a block at M rows of x and a K-slice: x [gemv_x_rows(M)]
// [slice + 16] bf16 (a pitch of 32 mod 128 bytes, so the 8-byte x reads of
// a half warp fall on distinct banks); with kAffine each 32-group's x sums
// [slice / 32][8] f32; then each warp's f32 scale table and its ring of
// stages
template <class F>
__host__ __device__ constexpr size_t gemv_warps_offset(int M, int slice) {
  return 2 * static_cast<size_t>(gemv_x_rows(M)) * (slice + 16) +
         (F::kAffine ? size_t{32} * (slice / 32) : 0);
}
template <class F>
__host__ __device__ constexpr size_t gemv_warp_bytes() {
  return 4 * size_t{F::kTable} + size_t{kGvStages} * F::kStage;
}
template <class F>
__host__ __device__ constexpr size_t gemv_smem_bytes(int M, int slice) {
  return gemv_warps_offset<F>(M, slice) + kGvWarps * gemv_warp_bytes<F>();
}

// The sums y = work[0] + work[1] + ... (in split order) of row tile
// blockIdx.x's M x 64 outputs, kOut a thread: split 0 of each, then four
// splits of each at once. kOut is fixed at compile time, so that M <= 2
// (one output a thread) carries no idle loads: a loop over outputs read
// 0.6-0.9 us slower at M = 8, four outputs at M <= 2 up to 0.8 us slower
// (PERF.md).
template <int kOut>
__device__ __forceinline__ void gemv_split_sum(const float* __restrict__ work, float* __restrict__ y, int M,
                                               int N) {
  constexpr int kTileN = kGvWarps * 16;
  const size_t MN = static_cast<size_t>(M) * N;
  const int splits = gridDim.y;
  const float* p[kOut];
  float v[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    const int i = threadIdx.x + j * kGvWarps * 32, n = blockIdx.x * kTileN + i % kTileN;
    p[j] = i < M * kTileN && n < N ? work + static_cast<size_t>(i / kTileN) * N + n : nullptr;
    v[j] = p[j] ? __ldcg(p[j]) : 0.f;
  }
  for (int z = 1; z < splits; z += 4) {
    float u[4][kOut];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int j = 0; j < kOut; ++j) u[s][j] = p[j] && z + s < splits ? __ldcg(p[j] + (z + s) * MN) : 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int j = 0; j < kOut; ++j)
        if (z + s < splits) v[j] += u[s][j];
  }
#pragma unroll
  for (int j = 0; j < kOut; ++j)
    if (p[j]) y[p[j] - work] = v[j];
}

// Block (x, z) multiplies K values z * slice .. + slice of row tile x and
// writes y, or with splits its partial sums [M][N] at work + z * M * N;
// given tickets (one a tile, 0 on entry and on return), the tile's last
// block then writes y from them
template <class F>
__global__ void __launch_bounds__(kGvWarps * 32, 4)
dq_gemv_kernel(const __nv_bfloat16* __restrict__ x, const typename F::Weight w, float* __restrict__ y,
               float* __restrict__ work, int* __restrict__ tickets, int M, int N, int K, int slice) {
  constexpr int kS = kGvStages;
  static_assert(F::kStage % 16 == 0 && F::kStageK % 32 == 0, "stage shape");

  extern __shared__ __align__(128) unsigned char gv_smem[];
  const int xpitch = slice + 16;  // bf16
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(gv_smem);
  const int xrows = gemv_x_rows(M);
  float* xsum = reinterpret_cast<float*>(gv_smem + 2 * static_cast<size_t>(xrows) * xpitch);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float* table = reinterpret_cast<float*>(gv_smem + gemv_warps_offset<F>(M, slice) +
                                          warp * gemv_warp_bytes<F>());
  unsigned char* ring = reinterpret_cast<unsigned char*>(table + F::kTable);
  const int n0 = (blockIdx.x * kGvWarps + warp) * 16;
  const int klo = blockIdx.y * slice, khi = min(K, klo + slice);
  const int nstages = n0 < N ? (khi - klo + F::kStageK - 1) / F::kStageK : 0;

  // the block's x slice: its rows, zeros at rows >= M and at k >= K
  for (int i = threadIdx.x; i < xrows * (slice / 8); i += kGvWarps * 32) {
    const int r = i / (slice / 8), c = i % (slice / 8);
    const bool ok = r < M && klo + c * 8 < khi;
    cp_async16(smem_u32(xs + r * xpitch + c * 8), ok ? x + static_cast<size_t>(r) * K + klo + c * 8 : x,
               ok);
  }
  cp_async_commit();

  // stage st of this warp's rows into ring slot st % kS
  auto issue = [&](int st) {
    F::copy(w, ring + (st % kS) * F::kStage, lane, n0, N, K, klo + st * F::kStageK, khi);
  };

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  // the products of stage st: per piece its ldmatrix words; per scale group
  // kSteps mma into a fresh fragment, scaled into acc by the rows' scales
  auto compute = [&](int st) {
    const unsigned char* src = ring + (st % kS) * F::kStage;
    const int kb = klo + st * F::kStageK;
    const __nv_bfloat16* xrow = xs + min(g, M) * xpitch + (kb - klo) + 4 * t;  // rows >= M: zeros
#pragma unroll
    for (int p = 0; p < F::kPieces; ++p) {
      uint32_t r[F::kWords];
      F::load(src, lane, p, r);
#pragma unroll
      for (int gi = 0; gi < F::kGroups; ++gi) {
        const int grp = p * F::kGroups + gi;  // scale group of the stage
        if constexpr (F::kGran < F::kStageK) {
          if (kb + F::kGroupK * grp >= khi) break;
        }
        float f[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < F::kSteps; ++s) {
          uint32_t a[4];
          F::a_frag(r, gi, s, a);
          const uint2 xv = *reinterpret_cast<const uint2*>(xrow + F::x_off(p, gi, s));
          mma_16816(f, a, __byte_perm(xv.x, xv.y, 0x5410), __byte_perm(xv.x, xv.y, 0x7632));
        }
        // c0, c1: row g, x rows 2t, 2t + 1; c2, c3: row g + 8
        float d[2], off[2];
        F::scales(src, table, g, n0, K, kb, grp, d, off);
        acc[0] = fmaf(d[0], f[0], acc[0]);
        acc[1] = fmaf(d[0], f[1], acc[1]);
        acc[2] = fmaf(d[1], f[2], acc[2]);
        acc[3] = fmaf(d[1], f[3], acc[3]);
        if constexpr (F::kAffine) {
          const float2 xg = *reinterpret_cast<const float2*>(
              xsum + ((kb - klo) / 32 + grp * F::kGroupK / 32) * 8 + 2 * t);
          acc[0] = fmaf(off[0], xg.x, acc[0]);
          acc[1] = fmaf(off[0], xg.y, acc[1]);
          acc[2] = fmaf(off[1], xg.x, acc[2]);
          acc[3] = fmaf(off[1], xg.y, acc[3]);
        }
      }
    }
  };

  // prologue: the x slice and stages 0 .. kS - 2 in flight; wait for x and
  // stage 0, and for every thread's part of x
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < nstages) issue(s);
    cp_async_commit();
  }
  cp_async_wait<kS - 2>();
  __syncthreads();
  if constexpr (F::kAffine) {
    // each x row's sum over each 32-group of the slice, in a fixed order;
    // rows at or past M sum to 0
    for (int i = threadIdx.x; i < slice / 32 * 8; i += kGvWarps * 32) {
      const int grp = i / 8, m = i % 8;
      float s = 0.f;
      if (m < M) {
        const uint4* v = reinterpret_cast<const uint4*>(xs + m * xpitch + 32 * grp);
        s = (sum8_bf16(v[0]) + sum8_bf16(v[1])) + (sum8_bf16(v[2]) + sum8_bf16(v[3]));
      }
      xsum[i] = s;
    }
    __syncthreads();
  }

  for (int st = 0; st < nstages; ++st) {
    // writes ring slot st - 1 (freed by the last __syncwarp); reads slot st
    if (st + kS - 1 < nstages) issue(st + kS - 1);
    cp_async_commit();
    if constexpr (F::kTable > 0) {
      F::prepare(ring + (st % kS) * F::kStage, table, lane, n0, K, klo + st * F::kStageK);
      __syncwarp();  // the table is read by every lane
    }
    compute(st);
    cp_async_wait<kS - 2>();  // stage st + 1 has landed: this lane's copies,
    __syncwarp();             // and, after the warp's barrier, every lane's
  }
  float* out = gridDim.y > 1 ? work + static_cast<size_t>(blockIdx.y) * M * N : y;
  const int m = 2 * t;
  if (nstages > 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + g + 8 * h;
      if (n >= N) continue;
      if (m < M) out[static_cast<size_t>(m) * N + n] = acc[2 * h];
      if (m + 1 < M) out[static_cast<size_t>(m + 1) * N + n] = acc[2 * h + 1];
    }
  }
  if (tickets == nullptr) return;  // no splits, or a second launch sums them
  // the last block of this row tile to finish sums its splits in order
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(tickets + blockIdx.x, 1) == static_cast<int>(gridDim.y) - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  switch ((M * kGvWarps * 16 + kGvWarps * 32 - 1) / (kGvWarps * 32)) {  // outputs a thread
    case 1: gemv_split_sum<1>(work, y, M, N); break;
    case 2: gemv_split_sum<2>(work, y, M, N); break;
    case 3: gemv_split_sum<3>(work, y, M, N); break;
    default: gemv_split_sum<4>(work, y, M, N); break;
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0;
}

struct GemvPlan {
  int slice;   // K of each split, a multiple of the format's kGran
  int splits;  // grid y
};

// The plan at (N, K), whatever M: the fewest splits whose slice (whole
// multiples of P::kGran) fits kGvSliceMax, doubled while the row tiles hold
// fewer than P::kTargetWarps warps an SM and each slice keeps at least
// kGvSliceMin.
template <class P>
GemvPlan dq_gemv_plan(int N, int K) {
  const long tiles = (N + 15) / 16;
  auto slice_of = [K](int splits) { return (K / P::kGran + splits - 1) / splits * P::kGran; };
  int splits = 1;
  while (slice_of(splits) > kGvSliceMax) splits *= 2;
  while (tiles * splits < static_cast<long>(P::kTargetWarps) * sm_count() &&
         slice_of(2 * splits) >= kGvSliceMin)
    splits *= 2;
  const int slice = slice_of(splits);
  return {slice, (K + slice - 1) / slice};
}

// bytes of the workspace of a (M, N, K) GEMV of plan P (0: none)
template <class P>
size_t dq_gemv_work_bytes(int M, int N, int K) {
  const GemvPlan p = dq_gemv_plan<P>(N, K);
  return p.splits > 1 ? static_cast<size_t>(p.splits) * M * N * sizeof(float) : 0;
}

// Whether a launch of plan p at N sums its splits by ticket: where its grid
// holds at most kGvTicketBlocks blocks an SM; a wider one takes a second
// launch.
inline bool dq_gemv_ticket_sum(const GemvPlan& p, int N) {
  const long tiles = ((N + 15) / 16 + kGvWarps - 1) / kGvWarps;
  return p.splits > 1 && tiles * p.splits <= static_cast<long>(kGvTicketBlocks) * sm_count();
}

// tickets of a (N, K) GEMV of plan P: one a row tile where it sums its
// splits by ticket (0: none)
template <class P>
int dq_gemv_tickets(int N, int K) {
  return dq_gemv_ticket_sum(dq_gemv_plan<P>(N, K), N) ? ((N + 15) / 16 + kGvWarps - 1) / kGvWarps : 0;
}

// work: dq_gemv_work_bytes<F>(M, N, K) bytes, tickets: dq_gemv_tickets<F>(N,
// K) ints, 0 (each may be null when its size is 0)
template <class F>
cudaError_t launch_dq_gemv(const __nv_bfloat16* x, const typename F::Weight& w, float* y, float* work,
                           int* tickets, int M, int N, int K, cudaStream_t s) {
  const GemvPlan p = dq_gemv_plan<F>(N, K);
  const bool ticket = dq_gemv_ticket_sum(p, N);
  if (p.splits > 1 && (work == nullptr || (ticket && tickets == nullptr))) return cudaErrorInvalidValue;
  const size_t smem = gemv_smem_bytes<F>(M, p.slice);
  const cudaError_t e = cudaFuncSetAttribute(dq_gemv_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(((N + 15) / 16 + kGvWarps - 1) / kGvWarps, p.splits);
  dq_gemv_kernel<F><<<grid, kGvWarps * 32, smem, s>>>(x, w, y, work, ticket ? tickets : nullptr, M, N, K,
                                                      p.slice);
  if (p.splits > 1 && !ticket) {
    const size_t MN = static_cast<size_t>(M) * N;
    const size_t blocks = (MN + 255) / 256;
    dq_split_sum_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
        work, y, MN, p.splits);
  }
  return cudaGetLastError();
}

}  // namespace
