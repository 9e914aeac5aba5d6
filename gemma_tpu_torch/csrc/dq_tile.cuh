// The tensor-core prefill tile of the quantized matmuls: y[M, N] (f32) =
// x[M, K] (bf16) . W^T, W dequantized to bf16 in shared memory, at M > 8
// with bf16 activations. A template over a per-format functor F that copies
// and dequantizes one weight item (a quarter of a row's K-step: 16 weights)
// at a time:
//
//   struct F {
//     struct Weight;                  // the format's device pointers
//     static constexpr int kRaw;      // bytes of one row's raw step (a multiple of 16)
//     static constexpr bool kAffine;  // the format adds an f32 per-32 part
//     // cp.async of quarter `part` (0-3) of the copies of row n's raw step
//     // at k0 into the raw row at shared address `raw`; n >= N copies zeros
//     static void copy(const Weight&, uint32_t raw, int n, int N, int K, int k0, int part);
//     // raw row -> bf16 weights k0 + 16 part .. + 15 of row n into the
//     // tile's K-contiguous `row`; with kAffine, items of even `part` also
//     // write the f32 offset of their 32-group (part / 2) into *off
//     static void store(const uint8_t* raw, __nv_bfloat16* row, float* off, int n, int K,
//                       int k0, int part);
//   };
//
// K is a multiple of 32. Where it is not one of 64 (q4_0 and q8_0), the last
// step is half a step: the tile reads no x past K (zeros in shared memory),
// and the functors copy nothing past K and store zero weights there.
//
// The affine part of a format like q4_k (y += sum over 32-groups g of
// xsum[m, g] * off[n, g], the reference kernel's rank-reduced xsum32 @ offs)
// stays in f32: the tile sums each x row's 32-groups once per K-step from the
// bf16 x tile in shared memory and adds xsum x off into every accumulator
// fragment with fmaf.
//
// Design (sm_90a, `mma.sync` m16n8k16 bf16 -> f32):
// * BM / 32 warps along M x 4 along N (BM = 64: 256 threads, 128: 512); a
//   warp owns 32 x (BN / 4) outputs as m16n8 accumulator fragments in
//   registers. Warps whose rows all lie at or past M skip the products.
// * K steps of 64. Each step's x tile (bf16, row-major [BM][64], rows >= M
//   zero-filled by the src-size-0 form) and the weight's raw bytes go
//   global -> shared by cp.async into a ring of kDqStages, issued
//   kDqStages - 1 steps ahead, so a step's loads have two steps of work to
//   land behind. The raw bytes of step k + 1 are dequantized into an
//   N-major, K-contiguous [BN][64] bf16 tile (the `.col` B operand; a ring
//   of two) while step k's products run, 16 weights a thread at BN = 64.
//   One barrier a step.
// * The work is latency-bound per step (a step's dequant and products run
//   in a few hundred dependent instructions a thread), so the card needs
//   many warps in flight: where the output tiles hold fewer than 16 warps
//   an SM, the K steps split over up to 8 blocks a tile (grid z), each
//   writing f32 partial sums to a workspace the caller allocates
//   (`dq_tile_work_bytes`), and a second kernel adds the splits in order:
//   the sums are deterministic at fixed shapes.
// * Rows of the bf16 tiles are padded to 72 bf16 (144 bytes): the 8 rows an
//   ldmatrix phase reads fall on distinct banks. Both operands load with
//   plain ldmatrix.x4.
// * f32 sums in the tensor cores: bf16 x bf16 products are exact in f32, so
//   the tile differs from the plain version only in the order of f32 sums.
#pragma once

#include "common.cuh"

namespace {

using namespace gt;

constexpr int kDqBK = 64;          // K per step: two 32-groups
constexpr int kDqLd = kDqBK + 8;   // shared row pitch of the bf16 tiles (144 bytes)
constexpr int kDqStages = 4;       // ring of x tiles and raw weight bytes
constexpr int kDqWStages = 2;      // ring of dequantized weight tiles

// K steps of the tile: the last one is half a step where K % 64 == 32
__host__ __device__ constexpr int dq_steps(int K) { return (K + kDqBK - 1) / kDqBK; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; valid == false writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; valid == false writes zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// the aligned f16 word that holds element h of a [total] f16 array (h even)
// -> 4 bytes of shared memory, asynchronously: zeros for h >= total, and
// only the low half for h == total - 1, which ends the array
__device__ __forceinline__ void cp_async_half2(uint32_t dst, const __half* a, size_t h,
                                               size_t total) {
  const int n = h < total ? (h + 1 < total ? 4 : 2) : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(n ? a + h : a), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `Pending` committed groups are in flight
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a (16x16, row) . b (16x8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// u - bias for a small unsigned integer u (< 2^22), exactly, without an
// int-to-float conversion: 2^23 + u has u as its low mantissa bits
__device__ __forceinline__ float small_int_minus(uint32_t u, float bias) {
  return __uint_as_float(0x4B000000u | u) - (8388608.f + bias);
}

// the sum of 8 bf16 values, in a fixed order
__device__ __forceinline__ float sum8_bf16(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    s[i] = f.x + f.y;
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// byte offsets of the tile's shared buffers: x [S][BM][kDqLd] bf16, raw
// [S][BN][F::kRaw], W [2][BN][kDqLd] bf16, offs [2][2][BN] f32, xsum
// [2][BM][2] f32. q8_0's 80-byte raw step keeps the blocks the launch
// bounds ask for within an SM's 228 KB: 75776 bytes at 64 x 64 (3 blocks),
// 114688 at 64 x 128 (2), 151552 at 128 x 128 (1).
template <class F, int BM, int BN>
struct DqTileSmem {
  static constexpr size_t kX = 0;
  static constexpr size_t kRaw = kX + size_t{kDqStages} * BM * kDqLd * 2;
  static constexpr size_t kW = kRaw + size_t{kDqStages} * BN * F::kRaw;
  static constexpr size_t kOffs = kW + size_t{kDqWStages} * BN * kDqLd * 2;
  static constexpr size_t kXsum = kOffs + (F::kAffine ? kDqWStages * 2 * BN * 4 : 0);
  static constexpr size_t kBytes = kXsum + (F::kAffine ? kDqWStages * BM * 2 * 4 : 0);
};

// y (one split), or split blockIdx.z's partial sums [M][N] at
// y + blockIdx.z * M * N: K steps blockIdx.z * steps / gridDim.z ..
// threads of a BM-row tile: BM / 32 warps along M x 4 along N
template <int BM>
__host__ __device__ constexpr int dq_threads() {
  return BM * 4;
}

template <class F, int BM, int BN>
__global__ void __launch_bounds__(dq_threads<BM>(), BM > 64 ? 1 : (BN == 64 ? 3 : 2))
dq_tile_kernel(const __nv_bfloat16* __restrict__ x, const typename F::Weight w,
               float* __restrict__ y, int M, int N, int K) {
  constexpr int S = kDqStages;
  constexpr int kThreads = dq_threads<BM>();
  constexpr int WM = 32, WN = BN / 4;  // a warp's outputs
  constexpr int TM = WM / 16, TN = WN / 8;  // its m16 and n8 tiles
  static_assert(TM >= 1 && TN % 2 == 0 && F::kRaw % 16 == 0, "tile shape");
  constexpr bool kAffine = F::kAffine;
  using L = DqTileSmem<F, BM, BN>;

  extern __shared__ __align__(128) unsigned char dq_smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(dq_smem + L::kX);
  unsigned char* raw = dq_smem + L::kRaw;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(dq_smem + L::kW);
  float* offs = reinterpret_cast<float*>(dq_smem + L::kOffs);
  float* xsum = reinterpret_cast<float*>(dq_smem + L::kXsum);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wm = (tid / 32) / 4, wn = (tid / 32) % 4;  // warp row, column
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int steps = dq_steps(K) / gridDim.z;  // this split's
  const int kbase = blockIdx.z * steps * kDqBK;
  const bool rows = m0 + wm * WM < M;  // the warp has rows below M
  y += static_cast<size_t>(blockIdx.z) * M * N;

  // x tile and raw weight bytes of `step` into ring slot step % S
  auto issue = [&](int step) {
    const int k0 = kbase + step * kDqBK;
    __nv_bfloat16* xdst = xs + (step % S) * BM * kDqLd;
#pragma unroll
    for (int i = tid; i < BM * (kDqBK / 8); i += kThreads) {
      const int r = i / (kDqBK / 8), c = i % (kDqBK / 8);
      const bool ok = m0 + r < M && k0 + c * 8 < K;
      const __nv_bfloat16* src = ok ? x + static_cast<size_t>(m0 + r) * K + k0 + c * 8 : x;
      cp_async16(smem_u32(xdst + r * kDqLd + c * 8), src, ok);
    }
    const uint32_t rdst = smem_u32(raw + (step % S) * BN * F::kRaw);
#pragma unroll
    for (int it = tid; it < 4 * BN; it += kThreads)
      F::copy(w, rdst + (it / 4) * F::kRaw, n0 + it / 4, N, K, k0, it % 4);
  };
  // raw bytes of `step` -> bf16 tile (and offsets) of slot step % 2
  auto dequant = [&](int step) {
    const unsigned char* src = raw + (step % S) * BN * F::kRaw;
    __nv_bfloat16* dst = ws + (step % kDqWStages) * BN * kDqLd;
    float* off = offs + (step % kDqWStages) * 2 * BN;
#pragma unroll
    for (int it = tid; it < 4 * BN; it += kThreads) {
      const int r = it / 4, part = it % 4;
      F::store(src + r * F::kRaw, dst + r * kDqLd, off + (part / 2) * BN + r, n0 + r, K,
               kbase + step * kDqBK, part);
    }
  };
  // each x row's sums over the step's two 32-groups: four lanes a group,
  // eight values each, then two shuffles
  auto sum_x = [&](int step) {
    const __nv_bfloat16* src = xs + (step % S) * BM * kDqLd;
    float* dst = xsum + (step % kDqWStages) * BM * 2;
#pragma unroll
    for (int i = tid; i < BM * 8; i += kThreads) {
      const int r = i / 8, g = (i / 4) % 2, q = i % 4;
      float s = sum8_bf16(*reinterpret_cast<const uint4*>(src + r * kDqLd + g * 32 + q * 8));
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (q == 0) dst[r * 2 + g] = s;
    }
  };

  float acc[TM][TN][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  auto mma_step = [&](int step) {
    const __nv_bfloat16* xa = xs + (step % S) * BM * kDqLd;
    const __nv_bfloat16* wb = ws + (step % kDqWStages) * BN * kDqLd;
#pragma unroll
    for (int kk = 0; kk < kDqBK; kk += 16) {
      uint32_t a[TM][4];
      uint32_t b[TN][2];
#pragma unroll
      for (int i = 0; i < TM; ++i)  // lanes 0-15: rows at k, 16-31: rows at k + 8
        ldmatrix_x4(a[i], smem_u32(xa + (wm * WM + i * 16 + (lane & 15)) * kDqLd + kk +
                                   (lane >> 4) * 8));
#pragma unroll
      for (int j = 0; j < TN; j += 2) {  // b0, b1 of n8 tiles j and j + 1
        uint32_t r[4];
        ldmatrix_x4(r, smem_u32(wb + (wn * WN + j * 8 + (lane & 7) + ((lane >> 4) << 3)) * kDqLd +
                                kk + ((lane >> 3) & 1) * 8));
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) mma_16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    if constexpr (kAffine) {
      // fragment c0/c1: row lane / 4, cols 2 (lane % 4) + {0, 1}; c2/c3: 8 rows down
      const float* xsm = xsum + (step % kDqWStages) * BM * 2;
      const float* off = offs + (step % kDqWStages) * 2 * BN;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = wn * WN + j * 8 + 2 * (lane % 4);
        const float2 o0 = *reinterpret_cast<const float2*>(off + col);
        const float2 o1 = *reinterpret_cast<const float2*>(off + BN + col);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 s = *reinterpret_cast<const float2*>(
                xsm + (wm * WM + i * 16 + lane / 4 + 8 * h) * 2);
            float& c0 = acc[i][j][2 * h];
            float& c1 = acc[i][j][2 * h + 1];
            c0 = fmaf(s.y, o1.x, fmaf(s.x, o0.x, c0));
            c1 = fmaf(s.y, o1.y, fmaf(s.x, o0.y, c1));
          }
      }
    }
  };

  // prologue: steps 0 .. S - 2 in flight; wait for steps 0 and 1, then
  // dequantize and sum step 0
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  cp_async_wait<S - 3>();
  __syncthreads();
  dequant(0);
  if constexpr (kAffine) sum_x(0);
  __syncthreads();

  // odd warps run a step's products before its dequant, even warps after,
  // so the tensor cores and the ALUs work at the same time
  const bool mma_first = (tid / 32) % 2;
  for (int k = 0; k < steps; ++k) {
    // writes: ring slot k + S - 1 (freed at the last barrier), W, offs and
    // xsum slot k + 1; reads: ring slots k and k + 1, W, offs and xsum slot k
    if (k + S - 1 < steps) issue(k + S - 1);
    cp_async_commit();
    if (rows && mma_first) mma_step(k);
    if (k + 1 < steps) {
      dequant(k + 1);
      if constexpr (kAffine) sum_x(k + 1);
    }
    if (rows && !mma_first) mma_step(k);
    cp_async_wait<S - 3>();  // step k + 2 has landed
    __syncthreads();
  }

  if (!rows) return;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WM + i * 16 + lane / 4 + 8 * h;
      if (m >= M) continue;
      float* yrow = y + static_cast<size_t>(m) * N;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + wn * WN + j * 8 + 2 * (lane % 4);
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

// y[i] = the sum of the splits' partials work[z][i], z in order
__global__ void __launch_bounds__(256)
dq_split_sum_kernel(const float* __restrict__ work, float* __restrict__ y, size_t MN, int splits) {
  for (size_t i = blockIdx.x * size_t{256} + threadIdx.x; i < MN; i += size_t{gridDim.x} * 256) {
    float v = work[i];
    for (int z = 1; z < splits; ++z) v += work[z * MN + i];
    y[i] = v;
  }
}

template <class F, int BM, int BN>
cudaError_t launch_dq_tile_shape(const __nv_bfloat16* x, const typename F::Weight& w, float* y,
                                 float* work, int M, int N, int K, int splits, cudaStream_t s) {
  constexpr size_t smem = DqTileSmem<F, BM, BN>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(dq_tile_kernel<F, BM, BN>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  dq_tile_kernel<F, BM, BN><<<grid, dq_threads<BM>(), smem, s>>>(x, w, splits > 1 ? work : y, M, N,
                                                                   K);
  if (splits > 1) {
    const size_t MN = static_cast<size_t>(M) * N;
    const size_t blocks = (MN + 255) / 256;
    dq_split_sum_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
        work, y, MN, splits);
  }
  return cudaGetLastError();
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return n;
}

struct DqTilePlan {
  int bm;      // 64 or 128
  int bn;      // 64 or 128
  int splits;  // K splits (grid z), 1 to 8
};

// warps of a grid of (bm x bn)-tiles over M x N
inline long dq_warps(int M, int N, int bm, int bn) {
  return static_cast<long>((M + bm - 1) / bm) * ((N + bn - 1) / bn) * (bm / 8);
}

// K splits of (bm x bn)-tiles at (M, N, K): doubled, while each split keeps
// at least 4 steps, until the grid holds 16 warps an SM
inline int dq_splits(int M, int N, int K, int bm, int bn) {
  const int steps = dq_steps(K);
  int splits = 1;
  while (dq_warps(M, N, bm, bn) * splits < 16L * sm_count() && splits < 8 &&
         steps % (2 * splits) == 0 && steps / (2 * splits) >= 4)
    splits *= 2;
  return splits;
}

// The tile's shape at M > 8, as measured on the H100
// at Gemma-2B's prefill shapes (PERF.md): 128 x 128 above M = 64 (a weight
// tile serves twice the rows), except on narrow weights (N < 1024: 64 x 64,
// more blocks); at M <= 64, 64 x 128 on wide weights (N >= 4096), else
// 64 x 64.
inline DqTilePlan dq_tile_plan(int M, int N, int K) {
  const int bm = M > 64 && N >= 1024 ? 128 : 64;
  const int bn = bm == 128 || N >= 4096 ? 128 : 64;
  return {bm, bn, dq_splits(M, N, K, bm, bn)};
}

// bytes of the workspace the launch of a (M, N, K) tile needs (0: none)
inline size_t dq_tile_work_bytes(int M, int N, int K) {
  const DqTilePlan p = dq_tile_plan(M, N, K);
  return p.splits > 1 ? static_cast<size_t>(p.splits) * M * N * sizeof(float) : 0;
}

// work: dq_tile_work_bytes(M, N, K) bytes (may be null when that is 0)
template <class F>
cudaError_t launch_dq_tile(const __nv_bfloat16* x, const typename F::Weight& w, float* y,
                           float* work, int M, int N, int K, cudaStream_t s) {
  const DqTilePlan p = dq_tile_plan(M, N, K);
  if (p.splits > 1 && work == nullptr) return cudaErrorInvalidValue;
  const int z = p.splits;
  if (p.bm == 64 && p.bn == 64) return launch_dq_tile_shape<F, 64, 64>(x, w, y, work, M, N, K, z, s);
  if (p.bm == 64) return launch_dq_tile_shape<F, 64, 128>(x, w, y, work, M, N, K, z, s);
  if (p.bn == 64) return launch_dq_tile_shape<F, 128, 64>(x, w, y, work, M, N, K, z, s);
  return launch_dq_tile_shape<F, 128, 128>(x, w, y, work, M, N, K, z, s);
}

}  // namespace
