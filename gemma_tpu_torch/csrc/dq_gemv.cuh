// The tensor-core GEMV of q4_0 and q8_0: y[M, N] (f32) = x[M, K] (bf16) .
// dequant(W)^T at 2 <= M <= 8 with bf16 x, the serving step's shape.
//
// Replaces, at that shape, the Pallas kernels `_q4_0_kernel` and
// `_q8_0_kernel` of gemma_tpu/ops/quant_matmul.py at f32dot=True (M <= 8,
// `quant_matmul.py:315`): f32 weights and x, f32 sums. Here the weight
// enters the product as its integer, u - 8 (q4_0) or q (q8_0), exact in
// bf16, x is exact in bf16, so every product is exact in f32; each 32-block
// sums into a fresh fragment, which is scaled by the block's f32 d into the
// accumulator: d * sum_32(q * x), the SIMT GEMV's gdot form. Only the order
// of f32 sums differs from the plain version.
//
// What bounds it on the H100: weight bytes. Each weight is used M <= 8
// times, far below the card's ~295 flop/byte balance point (ffn_down q4_0
// at M = 8: 0.0057 ms of bytes). The design keeps many weight bytes in
// flight and spends few instructions a byte:
// * `mma.sync` m16n8k16 bf16 -> f32 with W as the A operand (16 weight rows
//   a warp) and x as the B operand: the n8 side is the <= 8 rows of x, rows
//   at or past M zero. One mma does 16 x 8 x 16 products, where the SIMT
//   GEMV spent a shared-memory float4 read of x per 4 products.
// * x is copied once a block, as bf16, by 16-byte cp.async: the block's
//   K-slice of all 8 rows (<= kGvSliceMax values a row) in shared memory,
//   one barrier, then no block-level barrier at all.
// * Each warp streams its 16 rows through its own ring of kGvStages stages
//   (kGvStageK = 128 values a row: 16-byte cp.async of the payload, coalesced
//   64 or 128 bytes a row, and the f16 scale words), so three stages (3-6 KB
//   a warp) are in flight while one is multiplied; a warp waits only on its
//   own copies (`__syncwarp`).
// * ldmatrix on the raw payload bytes gives lane (g, t) the 32-bit word
//   4t..4t+3 of rows g and g + 8 of a 16-byte piece: exactly the bytes its A
//   fragment needs under this k order within a k16 step:
//     slot 2t -> byte 4t, 2t + 1 -> 4t + 2, 2t + 8 -> 4t + 1, 2t + 9 -> 4t + 3
//   (q4_0: nibble s of those bytes in step s of a block, since byte j holds
//   w[j] and w[j + 16]; q8_0: half s of the block). A and B use the same
//   order, so the x fragment is one 8-byte shared load and two byte perms.
//   A nibble pair becomes bf16x2 by one mask-or (128 + u) and a bf16x2
//   subtract of 136; an int8 pair by the f32 magic 2^23 + 128 and a perm
//   that keeps the high halves (exact: |q| <= 128 has 8 significant bits).
// * K splits over blocks (grid y) where the row tiles hold too few warps to
//   fill the card; the splits' f32 partials are added in order by
//   `dq_split_sum_kernel`, so a row's sums do not depend on the other rows
//   or on M: serving stays batch-invariant and deterministic.
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
constexpr int kGvStageK = 128;      // K of a warp's ring stage: four 32-blocks
constexpr int kGvStages = 4;        // depth of each warp's ring
constexpr int kGvScaleWords = 3;    // f16 words a row a stage: its 4 scales at any parity
constexpr int kGvSliceMax = 2048;   // K of x a block holds in shared memory
constexpr int kGvSliceMin = 512;    // K splits stop above this slice
constexpr int kGvTargetWarps = 8;   // warps an SM the K splits aim for

// shared bytes: x [8][slice + 16] bf16 (a pitch of 32 mod 128 bytes, so the
// 8-byte x reads of a half warp fall on distinct banks), then each warp's
// ring of stages: payload [16][kPitch] (16 bytes of padding a row, so the 8
// rows an ldmatrix phase reads fall on distinct banks), scales [16][3] words
template <int kBlockBytes>
struct GemvSmem {
  static constexpr int kRowBytes = kGvStageK / 32 * kBlockBytes;
  static constexpr int kPitch = kRowBytes + 16;
  static constexpr int kScales = 16 * kPitch;
  static constexpr int kStage = kScales + 16 * kGvScaleWords * 4;
  static constexpr int kRing = kGvStages * kStage;
  static size_t bytes(int slice) { return 16 * static_cast<size_t>(slice + 16) + kGvWarps * kRing; }
};

// bf16x2 (u0 - 8, u1 - 8) of the nibbles in bits 0-3 and 16-19 of v
__device__ __forceinline__ uint32_t nibble_pair(uint32_t v) {
  const uint32_t b = (v & 0x000F000Fu) | 0x43004300u;  // bf16 128 + u, exactly
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&b),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// bf16x2 (q_i, q_j) of the int8 bytes i and j of w, given u = w ^ 0x80808080
__device__ __forceinline__ uint32_t int8_pair(uint32_t u, int i, int j) {
  // 2^23 + (q + 128) as f32, then exactly q
  const float a = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
  const float b = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) - 8388736.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// The A fragment of k16 step s of block `blk` (0-3) of a stage, from the
// ldmatrix words r of its 32-byte piece (r[0] / r[1]: rows g / g + 8, bytes
// 4t.. of the piece's first 16 bytes; r[2] / r[3]: of its second 16)
template <int kBlockBytes>
__device__ __forceinline__ void gemv_a_frag(const uint32_t (&r)[4], int blk, int s, uint32_t (&a)[4]) {
  if constexpr (kBlockBytes == 16) {  // q4_0: a piece is blocks 2p, 2p + 1
    const uint32_t w0 = r[2 * (blk % 2)], w1 = r[2 * (blk % 2) + 1];
    a[0] = nibble_pair(w0 >> (4 * s));
    a[1] = nibble_pair(w1 >> (4 * s));
    a[2] = nibble_pair(w0 >> (4 * s + 8));
    a[3] = nibble_pair(w1 >> (4 * s + 8));
  } else {  // q8_0: a piece is one block, step s its half s
    const uint32_t u0 = r[2 * s] ^ 0x80808080u, u1 = r[2 * s + 1] ^ 0x80808080u;
    a[0] = int8_pair(u0, 0, 2);
    a[1] = int8_pair(u1, 0, 2);
    a[2] = int8_pair(u0, 1, 3);
    a[3] = int8_pair(u1, 1, 3);
  }
}

// y (one split), or split blockIdx.y's partial sums [M][N] at
// y + blockIdx.y * M * N: K values blockIdx.y * slice .. + slice
template <int kBlockBytes>
__global__ void __launch_bounds__(kGvWarps * 32, 4)
dq_gemv_kernel(const __nv_bfloat16* __restrict__ x, const BlockWeight w, float* __restrict__ y,
               int M, int N, int K, int slice) {
  using L = GemvSmem<kBlockBytes>;
  constexpr int kS = kGvStages;
  constexpr int kChunks = 16 * L::kRowBytes / 16;  // 16-byte payload copies a stage

  extern __shared__ __align__(128) unsigned char gv_smem[];
  const int xpitch = slice + 16;  // bf16
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(gv_smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  unsigned char* ring = gv_smem + 16 * static_cast<size_t>(xpitch) + warp * L::kRing;
  const int n0 = (blockIdx.x * kGvWarps + warp) * 16;
  const int klo = blockIdx.y * slice, khi = min(K, klo + slice);
  const int nstages = n0 < N ? (khi - klo + kGvStageK - 1) / kGvStageK : 0;
  const size_t row_bytes = static_cast<size_t>(K) / 32 * kBlockBytes;
  const size_t nscales = static_cast<size_t>(N) * (K / 32);
  y += static_cast<size_t>(blockIdx.y) * M * N;

  // the block's x slice: 8 rows, zeros at rows >= M and at k >= K
  for (int i = threadIdx.x; i < slice; i += kGvWarps * 32) {
    const int r = i / (slice / 8), c = i % (slice / 8);
    const bool ok = r < M && klo + c * 8 < khi;
    cp_async16(smem_u32(xs + r * xpitch + c * 8), ok ? x + static_cast<size_t>(r) * K + klo + c * 8 : x,
               ok);
  }
  cp_async_commit();

  // stage st of this warp's rows into ring slot st % kS: payload of blocks
  // below khi (rows >= N and blocks past khi: zeros, nothing read), and the
  // aligned scale words that hold each row's four scales
  auto issue = [&](int st) {
    unsigned char* dst = ring + (st % kS) * L::kStage;
    const int kb = klo + st * kGvStageK;
#pragma unroll
    for (int i = lane; i < kChunks; i += 32) {
      const int r = i / (kChunks / 16), c = i % (kChunks / 16);
      const bool ok = n0 + r < N && kb + c * 16 / kBlockBytes * 32 < khi;
      const uint8_t* src = w.qs + static_cast<size_t>(n0 + r) * row_bytes +
                           static_cast<size_t>(kb) / 32 * kBlockBytes + c * 16;
      cp_async16(smem_u32(dst + r * L::kPitch + c * 16), ok ? src : w.qs, ok);
    }
#pragma unroll
    for (int i = lane; i < 16 * kGvScaleWords; i += 32) {
      const int r = i / kGvScaleWords, j = i % kGvScaleWords;
      const size_t h = ((static_cast<size_t>(n0 + r) * (K / 32) + kb / 32) & ~size_t{1}) + 2 * j;
      cp_async_half2(smem_u32(dst + L::kScales + 4 * i), w.scales, h, nscales);
    }
  };

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  // the products of stage st: per 32-byte piece one ldmatrix.x4; per block
  // two mma into a fresh fragment, scaled into acc by the rows' d
  auto compute = [&](int st) {
    const unsigned char* src = ring + (st % kS) * L::kStage;
    const int kb = klo + st * kGvStageK;
    const __nv_bfloat16* xrow = xs + g * xpitch + (kb - klo) + 4 * t;
    const __half* sc0 = reinterpret_cast<const __half*>(src + L::kScales + g * 4 * kGvScaleWords) +
                        ((static_cast<size_t>(n0 + g) * (K / 32) + kb / 32) & 1);
    const __half* sc1 = reinterpret_cast<const __half*>(src + L::kScales +
                                                        (g + 8) * 4 * kGvScaleWords) +
                        ((static_cast<size_t>(n0 + g + 8) * (K / 32) + kb / 32) & 1);
#pragma unroll
    for (int p = 0; p < L::kRowBytes / 32; ++p) {
      uint32_t r[4];
      ldmatrix_x4(r, smem_u32(src + ((lane & 7) + ((lane >> 3) & 1) * 8) * L::kPitch + p * 32 +
                              (lane >> 4) * 16));
#pragma unroll
      for (int b = 0; b < 32 / kBlockBytes; ++b) {
        const int blk = p * (32 / kBlockBytes) + b;  // block of the stage
        if (kb + 32 * blk >= khi) break;
        float f[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t a[4];
          gemv_a_frag<kBlockBytes>(r, blk, s, a);
          const uint2 xv = *reinterpret_cast<const uint2*>(xrow + 32 * blk + 16 * s);
          mma_16816(f, a, __byte_perm(xv.x, xv.y, 0x5410), __byte_perm(xv.x, xv.y, 0x7632));
        }
        // c0, c1: row g, x rows 2t, 2t + 1; c2, c3: row g + 8
        const float d0 = __half2float(sc0[blk]), d1 = __half2float(sc1[blk]);
        acc[0] = fmaf(d0, f[0], acc[0]);
        acc[1] = fmaf(d0, f[1], acc[1]);
        acc[2] = fmaf(d1, f[2], acc[2]);
        acc[3] = fmaf(d1, f[3], acc[3]);
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

  for (int st = 0; st < nstages; ++st) {
    // writes ring slot st - 1 (freed by the last __syncwarp); reads slot st
    if (st + kS - 1 < nstages) issue(st + kS - 1);
    cp_async_commit();
    compute(st);
    cp_async_wait<kS - 2>();  // stage st + 1 has landed: this lane's copies,
    __syncwarp();             // and, after the warp's barrier, every lane's
  }
  if (nstages == 0) return;

  const int m = 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + g + 8 * h;
    if (n >= N) continue;
    if (m < M) y[static_cast<size_t>(m) * N + n] = acc[2 * h];
    if (m + 1 < M) y[static_cast<size_t>(m + 1) * N + n] = acc[2 * h + 1];
  }
}

struct GemvPlan {
  int slice;   // K of each split, a multiple of 32
  int splits;  // grid y
};

// The plan at (N, K), whatever M: the fewest splits whose slice fits
// kGvSliceMax, doubled while the row tiles hold fewer than kGvTargetWarps
// warps an SM and each slice keeps at least kGvSliceMin.
inline GemvPlan dq_gemv_plan(int N, int K) {
  const long tiles = (N + 15) / 16;
  auto slice_of = [K](int splits) { return (K / 32 + splits - 1) / splits * 32; };
  int splits = 1;
  while (slice_of(splits) > kGvSliceMax) splits *= 2;
  while (tiles * splits < static_cast<long>(kGvTargetWarps) * sm_count() &&
         slice_of(2 * splits) >= kGvSliceMin)
    splits *= 2;
  const int slice = slice_of(splits);
  return {slice, (K + slice - 1) / slice};
}

// bytes of the workspace of a (M, N, K) GEMV (0: none)
inline size_t dq_gemv_work_bytes(int M, int N, int K) {
  const GemvPlan p = dq_gemv_plan(N, K);
  return p.splits > 1 ? static_cast<size_t>(p.splits) * M * N * sizeof(float) : 0;
}

// work: dq_gemv_work_bytes(M, N, K) bytes (may be null when that is 0)
template <int kBlockBytes>
cudaError_t launch_dq_gemv(const __nv_bfloat16* x, const BlockWeight& w, float* y, float* work,
                           int M, int N, int K, cudaStream_t s) {
  const GemvPlan p = dq_gemv_plan(N, K);
  if (p.splits > 1 && work == nullptr) return cudaErrorInvalidValue;
  const size_t smem = GemvSmem<kBlockBytes>::bytes(p.slice);
  const cudaError_t e = cudaFuncSetAttribute(dq_gemv_kernel<kBlockBytes>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(((N + 15) / 16 + kGvWarps - 1) / kGvWarps, p.splits);
  dq_gemv_kernel<kBlockBytes><<<grid, kGvWarps * 32, smem, s>>>(x, w, p.splits > 1 ? work : y, M, N,
                                                                K, p.slice);
  if (p.splits > 1) {
    const size_t MN = static_cast<size_t>(M) * N;
    const size_t blocks = (MN + 255) / 256;
    dq_split_sum_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
        work, y, MN, p.splits);
  }
  return cudaGetLastError();
}

}  // namespace
