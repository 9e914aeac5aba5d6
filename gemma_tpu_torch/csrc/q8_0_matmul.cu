// q8_0 dequant-matmul: y[M, N] (f32) = x[M, K] . dequant(W)^T.
//
// Replaces the Pallas kernel `_q8_0_kernel` of gemma_tpu/ops/quant_matmul.py
// (launched by `_qmm_call`). W is q8_0 in the port's layout
// (gemma_tpu_torch/quant/qtensor.py): qs i8 [N, K] holding ggml's 32 payload
// bytes per 32-block in order, scales f16 [N, K/32] (ggml's exact d). One
// 32-block dequantizes as w[j] = d * q[j].
//
// What bounds it on the H100:
//
// * Decode (M <= 8) is bound by weight bytes, 8.5 bits per weight: each
//   weight is used M times, far below the card's ~295 flop/byte balance
//   point (Gemma-7B reads 9.07 GB of q8_0 weights per token, 2.71 ms at
//   3.35 TB/s). At M = 1, and with f32 x at any M <= 8, `q8_0_gemv_kernel`
//   (SIMT) gives each warp one output row; a lane takes one 32-byte block
//   as two 16-byte loads, so a warp reads 1 KB contiguous per step. The
//   int8 values widen in registers, FMA into f32 against x, and the block's
//   sum is scaled by d once; a warp shuffle reduces. x is staged in shared
//   memory in K-chunks of 1024 (all of K = 24576 at M = 8 in f32 would not
//   fit), padded to 36 floats per block so the lanes' float4 reads do not
//   conflict on banks. Numerics follow the reference kernel at M <= 8:
//   weights and x in f32.
// * Serving (2 <= M <= 8) with bf16 x runs on the tensor cores:
//   `dq_gemv_kernel<Q8_0Gemv>` of dq_gemv.cuh (W the A operand of bf16 mma.sync
//   as its int8 values, x the n8 operand, each block's fragment scaled by d
//   in f32: the same numerics), with x copied once a block and each warp's
//   rows streamed through its own cp.async ring.
// * Prefill (M > 8) with bf16 x does 2 M N K flops on the same bytes and is
//   bound by operations: the shared tensor-core tile of dq_tile.cuh
//   (`dq_tile_kernel<Q8_0Tile>`: bf16 mma.sync, f32 accumulators, x and the
//   raw bytes staged by cp.async). `Q8_0Tile` rounds each weight to
//   bf16(d * q), as the reference kernel rounds its weight above M = 8.
//   Where K % 64 == 32 the tile's last K-step is half a step, zero-filled.
// * Prefill with f32 x (evaluation mode) runs an f32 plain-FMA tile
//   (`q8_0_tiled_kernel`): 64 x 64 outputs per block, K stepped one
//   32-block at a time, both tiles in shared memory in f32.
//
// Any N and any K that is a multiple of 32 (ragged edges masked). Every
// launch is checked: the entry point returns cudaGetLastError().
#include "dq_gemv.cuh"

using namespace gt;

namespace {

constexpr int kGemvWarps = 8;
constexpr int kGemvKChunk = 1024;  // K elements of x staged per pass: one block per lane
constexpr int kGemvBlocks = kGemvKChunk / 32;
constexpr int kXPad = 36;  // floats per staged 32-block (bank-conflict-free)

// the signed byte j (0..3) of a 32-bit word, as f32
__device__ __forceinline__ float sbyte(uint32_t word, int j) {
  return static_cast<float>(static_cast<int32_t>(word << (24 - 8 * j)) >> 24);
}

__device__ __forceinline__ void unpack16(uint4 raw, float* w) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = sbyte(words[i / 4], i % 4);
}

template <int M, typename TX>
__global__ void __launch_bounds__(kGemvWarps * 32)
q8_0_gemv_kernel(const TX* __restrict__ x, const int8_t* __restrict__ qs,
                 const __half* __restrict__ scales, float* __restrict__ y, int N, int K) {
  __shared__ __align__(16) float xs[M][kGemvBlocks][kXPad];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * kGemvWarps + warp;
  const int nblk = K / 32;
  const int8_t* qrow = qs + static_cast<size_t>(n) * K;
  const __half* srow = scales + static_cast<size_t>(n) * nblk;

  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kGemvKChunk) {
    const int klen = min(kGemvKChunk, K - k0);
    __syncthreads();  // previous chunk fully consumed
    for (int i = threadIdx.x; i < M * kGemvKChunk; i += blockDim.x) {
      const int m = i / kGemvKChunk;
      const int kk = i % kGemvKChunk;
      xs[m][kk / 32][kk % 32] = kk < klen ? to_f32(x[static_cast<size_t>(m) * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    const int b = k0 / 32 + lane;
    if (n < N && lane < klen / 32) {
      const uint4* blk = reinterpret_cast<const uint4*>(qrow + static_cast<size_t>(b) * 32);
      const uint4 lo = blk[0];
      const uint4 hi = blk[1];
      const float d = __half2float(srow[b]);
      float w[32];
      unpack16(lo, w);
      unpack16(hi, w + 16);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4* xv = reinterpret_cast<const float4*>(&xs[m][lane][0]);
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 t = xv[i];
          s = fmaf(w[4 * i + 0], t.x, s);
          s = fmaf(w[4 * i + 1], t.y, s);
          s = fmaf(w[4 * i + 2], t.z, s);
          s = fmaf(w[4 * i + 3], t.w, s);
        }
        acc[m] = fmaf(d, s, acc[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = warp_sum(acc[m]);
  if (lane == 0 && n < N) {
#pragma unroll
    for (int m = 0; m < M; ++m) y[static_cast<size_t>(m) * N + n] = acc[m];
  }
}

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 32;  // one q8_0 block
constexpr int kTiledThreads = 256;

// f32 x (evaluation mode): f32 weights, plain FMA
__global__ void __launch_bounds__(kTiledThreads)
q8_0_tiled_kernel(const float* __restrict__ x, const int8_t* __restrict__ qs,
                  const __half* __restrict__ scales, float* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(16) float xs[kTileK][kTileM + 4];  // x tile, K-major
  __shared__ __align__(16) float ws[kTileK][kTileN + 4];  // dequantized W tile, K-major
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output cols tx*4 .. +3
  const int ty = tid / 16;  // output rows ty*4 .. +3
  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;
  const int nblk = K / 32;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    for (int i = tid; i < kTileM * kTileK; i += kTiledThreads) {
      const int r = i / kTileK;
      const int c = i % kTileK;
      const int m = m0 + r;
      xs[c][r] = m < M ? x[static_cast<size_t>(m) * K + k0 + c] : 0.f;
    }
    {
      // 64 weight rows x 4 parts of 8 payload bytes: 8 values per thread
      const int r = tid / 4;
      const int part = tid % 4;
      const int n = n0 + r;
      uint2 word = make_uint2(0u, 0u);
      float d = 0.f;
      if (n < N) {
        word = *reinterpret_cast<const uint2*>(qs + static_cast<size_t>(n) * K + k0 + part * 8);
        d = __half2float(scales[static_cast<size_t>(n) * nblk + k0 / 32]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ws[part * 8 + j][r] = d * sbyte(word.x, j);
        ws[part * 8 + 4 + j][r] = d * sbyte(word.y, j);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) y[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

// bf16 x takes the SIMT GEMV at M = 1 only (the tensor cores above)
template <typename TX>
void launch_gemv(const TX* x, const int8_t* qs, const __half* sc, float* y, int M, int N, int K,
                 cudaStream_t s) {
  const dim3 grid((N + kGemvWarps - 1) / kGemvWarps);
  const dim3 block(kGemvWarps * 32);
  if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
    q8_0_gemv_kernel<1, TX><<<grid, block, 0, s>>>(x, qs, sc, y, N, K);
  } else {
    switch (M) {
      case 1: q8_0_gemv_kernel<1, TX><<<grid, block, 0, s>>>(x, qs, sc, y, N, K); break;
      case 2: q8_0_gemv_kernel<2, TX><<<grid, block, 0, s>>>(x, qs, sc, y, N, K); break;
      case 3: q8_0_gemv_kernel<3, TX><<<grid, block, 0, s>>>(x, qs, sc, y, N, K); break;
      case 4: q8_0_gemv_kernel<4, TX><<<grid, block, 0, s>>>(x, qs, sc, y, N, K); break;
      case 5: q8_0_gemv_kernel<5, TX><<<grid, block, 0, s>>>(x, qs, sc, y, N, K); break;
      case 6: q8_0_gemv_kernel<6, TX><<<grid, block, 0, s>>>(x, qs, sc, y, N, K); break;
      case 7: q8_0_gemv_kernel<7, TX><<<grid, block, 0, s>>>(x, qs, sc, y, N, K); break;
      default: q8_0_gemv_kernel<8, TX><<<grid, block, 0, s>>>(x, qs, sc, y, N, K); break;
    }
  }
}

// The tensor-core tile's q8_0 item (dq_tile.cuh): 16 weights of one row in
// one 64-element step, blocks b0 = k0 / 32 and b0 + 1. Quarter p is payload
// bytes 16p .. 16p + 15 of the step (half p % 2 of block p / 2). A row's raw
// step: the two blocks' 64 payload bytes, and the two aligned f16 words that
// hold their scales (b0's at half b0 % 2 of the first word: row * (K / 32)
// + b0 may be odd where K % 64 == 32).
struct Q8_0Tile {
  using Weight = BlockWeight;
  static constexpr int kRaw = 80;  // qs [0, 64), scale words [64, 72)
  static constexpr bool kAffine = false;

  __device__ __forceinline__ static void copy(const Weight& w, uint32_t raw, int n, int N, int K,
                                              int k0, int part) {
    const bool ok = n < N;
    const size_t row = ok ? n : 0;
    cp_async16(raw + 16 * part, w.qs + row * K + k0 + 16 * part, ok && k0 + 32 * (part / 2) < K);
    if (part < 2) {
      const size_t s = row * (K / 32) + k0 / 32;
      cp_async_half2(raw + 64 + 4 * part, w.scales, (s & ~size_t{1}) + 2 * part,
                     ok ? static_cast<size_t>(N) * (K / 32) : 0);
    }
  }

  __device__ __forceinline__ static void store(const uint8_t* raw, __nv_bfloat16* row, float*,
                                               int n, int K, int k0, int part) {
    uint4* dst = reinterpret_cast<uint4*>(row + 16 * part);
    const int b = part / 2;
    if (k0 + 32 * b >= K) {  // the half step past K
      dst[0] = dst[1] = make_uint4(0u, 0u, 0u, 0u);
      return;
    }
    const int odd = (static_cast<size_t>(n) * (K / 32) + k0 / 32) & 1;
    const float d = __half2float(reinterpret_cast<const __half*>(raw + 64)[odd + b]);
    const uint4 q = *reinterpret_cast<const uint4*>(raw + 16 * part);
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
    uint32_t p[8];
#pragma unroll
    for (int i = 0; i < 16; i += 2)
      p[i / 2] = pack_bf16(d * sbyte(words[i / 4], i % 4), d * sbyte(words[i / 4], i % 4 + 1));
    dst[0] = make_uint4(p[0], p[1], p[2], p[3]);
    dst[1] = make_uint4(p[4], p[5], p[6], p[7]);
  }
};

template <typename TX>
cudaError_t launch_q8_0(const void* x, const void* qs, const void* scales, void* y, void* work,
                        void* tickets, int M, int N, int K, cudaStream_t s) {
  const TX* xp = static_cast<const TX*>(x);
  const BlockWeight w{static_cast<const uint8_t*>(qs), static_cast<const __half*>(scales)};
  const int8_t* qp = static_cast<const int8_t*>(qs);
  float* yp = static_cast<float*>(y);
  if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
    if (M > 8) return launch_dq_tile<Q8_0Tile>(xp, w, yp, static_cast<float*>(work), M, N, K, s);
    if (M > 1)
      return launch_dq_gemv<Q8_0Gemv>(xp, w, yp, static_cast<float*>(work), static_cast<int*>(tickets), M,
                                      N, K, s);
  } else if (M > 8) {
    const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
    q8_0_tiled_kernel<<<grid, kTiledThreads, 0, s>>>(xp, qp, w.scales, yp, M, N, K);
    return cudaGetLastError();
  }
  launch_gemv<TX>(xp, qp, w.scales, yp, M, N, K, s);
  return cudaGetLastError();
}

}  // namespace

// x: [M, K] f32 or bf16 (x_dtype), row-major contiguous, 16-byte aligned;
// qs/scales: the port's q8_0 layout (qs 16-byte aligned); y: [M, N] f32;
// work and tickets: the f32 scratch and the ints (0 on entry and on
// return) that gt_matmul_work_bytes(1, x_dtype, M, N, K, &tickets) gives
// (each null when its size is 0). Returns a cudaError_t value.
extern "C" int gt_q8_0_matmul(const void* x, int x_dtype, const void* qs, const void* scales,
                              void* y, void* work, void* tickets, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kBF16)
    return static_cast<int>(launch_q8_0<__nv_bfloat16>(x, qs, scales, y, work, tickets, M, N, K, s));
  if (x_dtype == kF32)
    return static_cast<int>(launch_q8_0<float>(x, qs, scales, y, work, tickets, M, N, K, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
