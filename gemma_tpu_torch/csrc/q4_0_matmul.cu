// q4_0 dequant-matmul: y[M, N] (f32) = x[M, K] . dequant(W)^T.
//
// Replaces the Pallas kernel `_q4_0_kernel` of gemma_tpu/ops/quant_matmul.py
// (launched by `_qmm_call`). W is q4_0 in the port's layout
// (gemma_tpu_torch/quant/qtensor.py): qs u8 [N, K/2] holding ggml's 16
// payload bytes per 32-block in ggml's in-block order, scales f16 [N, K/32].
// One 32-block dequantizes as w[j] = d * ((byte[j] & 15) - 8) and
// w[j + 16] = d * ((byte[j] >> 4) - 8), j < 16.
//
// Four launch shapes, one op:
//
// * Decode (M <= 8) is bound by weight bytes: each weight is used M times,
//   far below the card's ~295 flop/byte balance point. With bf16 x it runs
//   on the tensor cores, the batch-1 decode step (M = 1) and serving (2 <=
//   M <= 8) alike: `dq_gemv_kernel<Q4_0Gemv>` of dq_gemv.cuh (W the A
//   operand of bf16 mma.sync as its integers u - 8, x the n8 operand, each
//   block's fragment scaled by d in f32: the gdot numerics below), with x
//   copied once a block, each warp's rows streamed through its own cp.async
//   ring, and at M = 1 K split only to fill the card.
// * With f32 x (evaluation mode) at M <= 8, `q4_0_gemv_kernel` (SIMT)
//   gives each warp one output row; a lane's 16-byte load along K is
//   exactly one block (32 nibbles + one scale), so a warp reads 512
//   contiguous bytes per step. Nibbles
//   unpack and scale in registers, FMA into f32, and a warp shuffle reduces.
//   x is staged in shared memory in K-chunks of 1024 (all of K = 16384 at
//   M = 8 in f32 would not fit), padded to 36 floats per block so the
//   lanes' float4 reads do not conflict on banks. Numerics follow the
//   reference kernel at M <= 8: weights and x in f32. Rows per block
//   (warps), the dot form (Mode) and the scale type are template
//   parameters; f32 x launches kGemvWarps = 8, kGDot, f16 scales.
//   Two bench entry points launch the same kernel with bf16 x (a shape the
//   main path runs on the tensor cores):
//   `gt_q4_0_gemv_warps` with 4, 8, 16 or 32 warps (replaces `call` of
//   tools/bench_bn_sweep.py, the reference kernel at a forced N tile) and
//   `gt_qmm_variant` in the modes below with f32, bf16 or f16 scales
//   (replaces `_kernel` of tools/bench_qmm_variants.py and
//   `kernel`/`kernel2` of tools/probe_int4.py). A mode differs only in how
//   a weight meets x:
//     kF32Dot   w = (u - 8) * d                  (the tool's f32dot)
//     kRsc      w = bf16((u - 8) * d)            (its f32sc, rsc, u16sc)
//     kRscb     w = bf16(bf16(u - 8) * bf16(d))  (its bf16sc, rscb)
//     kNoScale  w = u - 8
//     kGDot     d * sum_32((u - 8) * x)          (f32 x's, gdot)
//   On the TPU f32sc/rsc and bf16sc/rscb differed only in where the
//   scale's broadcast lived; here each pair is one instantiation.
// * Prefill (M > 8) with bf16 x does 2 M N K flops on the same bytes and is
//   bound by operations: the shared tensor-core tile of dq_tile.cuh
//   (`dq_tile_kernel<Q4_0Tile>`: bf16 mma.sync, f32 accumulators, x and the
//   raw bytes staged by cp.async), the counterpart of the reference
//   kernel's bf16 MXU operands above M = 8. `Q4_0Tile` rounds each weight
//   to bf16(d * (u - 8)), the reference kernel's rounding point. Where K %
//   64 == 32 the tile's last K-step is half a step, zero-filled.
// * Prefill with f32 x (evaluation mode) runs an f32 plain-FMA tile
//   (`q4_0_tiled_kernel`): 64 x 64 outputs per block, K stepped one
//   32-block at a time, both tiles in shared memory in f32.
//
// Every launch is checked: the entry point returns cudaGetLastError().
#include "dq_gemv.cuh"

using namespace gt;

namespace {

constexpr int kGemvWarps = 8;
constexpr int kGemvKChunk = 1024;  // K elements of x staged per pass
constexpr int kGemvBlocks = kGemvKChunk / 32;
constexpr int kXPad = 36;  // floats per staged 32-block (bank-conflict-free)

// GEMV modes (ops/qmm_variants.py VARIANT_MODES); see the header
constexpr int kF32Dot = 0;
constexpr int kRsc = 1;
constexpr int kRscb = 2;
constexpr int kNoScale = 3;
constexpr int kGDot = 4;
// scale dtypes of gt_qmm_variant (ops/qmm_variants.py SCALE_CODES)
constexpr int kScF32 = 0;
constexpr int kScBF16 = 1;
constexpr int kScF16 = 2;

__device__ __forceinline__ void unpack_block(uint4 raw, float w[32]) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t byte = (words[i / 4] >> (8 * (i % 4))) & 0xffu;
    w[i] = static_cast<float>(static_cast<int>(byte & 0xfu) - 8);
    w[i + 16] = static_cast<float>(static_cast<int>(byte >> 4) - 8);
  }
}

template <int M, typename TX, int Warps = kGemvWarps, int Mode = kGDot, typename SC = __half>
__global__ void __launch_bounds__(Warps * 32)
q4_0_gemv_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ qs,
                 const SC* __restrict__ scales, float* __restrict__ y, int N, int K) {
  __shared__ __align__(16) float xs[M][kGemvBlocks][kXPad];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * Warps + warp;
  const int nblk = K / 32;
  const uint8_t* qrow = qs + static_cast<size_t>(n) * (K / 2);
  const SC* srow = scales + static_cast<size_t>(n) * nblk;

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
      const uint4 raw = *reinterpret_cast<const uint4*>(qrow + static_cast<size_t>(b) * 16);
      const float d = to_f32(srow[b]);
      float w[32];
      unpack_block(raw, w);
      if constexpr (Mode == kF32Dot || Mode == kRsc || Mode == kRscb) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if constexpr (Mode == kF32Dot) {
            w[i] *= d;
          } else if constexpr (Mode == kRsc) {
            w[i] = round_to<__nv_bfloat16>(w[i] * d);
          } else {
            w[i] = __bfloat162float(__hmul(__float2bfloat16_rn(w[i]), __float2bfloat16_rn(d)));
          }
        }
      }
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
        acc[m] = Mode == kGDot ? fmaf(d, s, acc[m]) : acc[m] + s;
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
constexpr int kTileK = 32;  // one q4_0 block
constexpr int kTiledThreads = 256;

// f32 x (evaluation mode): f32 weights, plain FMA
__global__ void __launch_bounds__(kTiledThreads)
q4_0_tiled_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
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
      // 64 weight rows x 4 words of 4 payload bytes: 8 values per thread
      const int r = tid / 4;
      const int part = tid % 4;
      const int n = n0 + r;
      uint32_t word = 0x88888888u;  // nibbles of 8 dequantize to 0
      float d = 0.f;
      if (n < N) {
        const int b = k0 / 32;
        word = *reinterpret_cast<const uint32_t*>(qs + static_cast<size_t>(n) * (K / 2) + b * 16 + part * 4);
        d = __half2float(scales[static_cast<size_t>(n) * nblk + b]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t byte = (word >> (8 * j)) & 0xffu;
        const float lo = d * static_cast<float>(static_cast<int>(byte & 0xfu) - 8);
        const float hi = d * static_cast<float>(static_cast<int>(byte >> 4) - 8);
        ws[part * 4 + j][r] = lo;
        ws[16 + part * 4 + j][r] = hi;
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

template <typename TX>
void launch_gemv(const TX* x, const uint8_t* qs, const __half* sc, float* y, int M, int N, int K,
                 cudaStream_t s) {
  const dim3 grid((N + kGemvWarps - 1) / kGemvWarps);
  const dim3 block(kGemvWarps * 32);
  switch (M) {
    case 1: q4_0_gemv_kernel<1, TX><<<grid, block, 0, s>>>(x, qs, sc, y, N, K); break;
    case 2: q4_0_gemv_kernel<2, TX><<<grid, block, 0, s>>>(x, qs, sc, y, N, K); break;
    case 3: q4_0_gemv_kernel<3, TX><<<grid, block, 0, s>>>(x, qs, sc, y, N, K); break;
    case 4: q4_0_gemv_kernel<4, TX><<<grid, block, 0, s>>>(x, qs, sc, y, N, K); break;
    case 5: q4_0_gemv_kernel<5, TX><<<grid, block, 0, s>>>(x, qs, sc, y, N, K); break;
    case 6: q4_0_gemv_kernel<6, TX><<<grid, block, 0, s>>>(x, qs, sc, y, N, K); break;
    case 7: q4_0_gemv_kernel<7, TX><<<grid, block, 0, s>>>(x, qs, sc, y, N, K); break;
    default: q4_0_gemv_kernel<8, TX><<<grid, block, 0, s>>>(x, qs, sc, y, N, K); break;
  }
}

// The tensor-core tile's q4_0 item (dq_tile.cuh): 16 weights of one row in
// one 64-element step, blocks b0 = k0 / 32 and b0 + 1. Quarter p is nibble
// p % 2 of block p / 2's 16 payload bytes: elements 16p .. 16p + 15 of the
// step. A row's raw step: the two blocks' payload, and the two aligned f16
// words that hold their scales (b0's at half b0 % 2 of the first word:
// row * (K / 32) + b0 may be odd where K % 64 == 32).
struct Q4_0Tile {
  using Weight = BlockWeight;
  static constexpr int kRaw = 48;  // qs [0, 32), scale words [32, 40)
  static constexpr bool kAffine = false;

  __device__ __forceinline__ static void copy(const Weight& w, uint32_t raw, int n, int N, int K,
                                              int k0, int part) {
    const bool ok = n < N;
    const size_t row = ok ? n : 0;
    if (part < 2) {
      cp_async16(raw + 16 * part, w.qs + row * (K / 2) + k0 / 2 + 16 * part,
                 ok && k0 + 32 * part < K);
    } else {
      const size_t s = row * (K / 32) + k0 / 32;
      cp_async_half2(raw + 32 + 4 * (part - 2), w.scales, (s & ~size_t{1}) + 2 * (part - 2),
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
    const float d = __half2float(reinterpret_cast<const __half*>(raw + 32)[odd + b]);
    const uint4 q = *reinterpret_cast<const uint4*>(raw + 16 * b);
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
    uint32_t p[8];
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const uint32_t v = words[i / 4] >> (8 * (i % 4) + 4 * (part % 2));  // nibbles of bytes i, i + 1
      p[i / 2] = pack_bf16(d * small_int_minus(v & 0xfu, 8.f), d * small_int_minus((v >> 8) & 0xfu, 8.f));
    }
    dst[0] = make_uint4(p[0], p[1], p[2], p[3]);
    dst[1] = make_uint4(p[4], p[5], p[6], p[7]);
  }
};

template <typename TX>
cudaError_t launch_q4_0(const void* x, const void* qs, const void* scales, void* y, void* work,
                        void* tickets, int M, int N, int K, cudaStream_t s) {
  const TX* xp = static_cast<const TX*>(x);
  const BlockWeight w{static_cast<const uint8_t*>(qs), static_cast<const __half*>(scales)};
  float* yp = static_cast<float*>(y);
  if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
    if (M > 8) return launch_dq_tile<Q4_0Tile>(xp, w, yp, static_cast<float*>(work), M, N, K, s);
    return launch_dq_gemv<Q4_0Gemv>(xp, w, yp, static_cast<float*>(work), static_cast<int*>(tickets), M, N,
                                    K, s);
  } else {
    if (M > 8) {
      const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
      q4_0_tiled_kernel<<<grid, kTiledThreads, 0, s>>>(xp, w.qs, w.scales, yp, M, N, K);
    } else {
      launch_gemv<TX>(xp, w.qs, w.scales, yp, M, N, K, s);
    }
    return cudaGetLastError();
  }
}

}  // namespace

// x: [M, K] f32 or bf16 (x_dtype), row-major contiguous, 16-byte aligned;
// qs/scales: the port's q4_0 layout; y: [M, N] f32; work and tickets: the
// f32 scratch and the ints (0 on entry and on return) that
// gt_matmul_work_bytes(0, x_dtype, M, N, K, &tickets) gives (each null when
// its size is 0). Returns a cudaError_t value.
extern "C" int gt_q4_0_matmul(const void* x, int x_dtype, const void* qs, const void* scales,
                              void* y, void* work, void* tickets, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kBF16)
    return static_cast<int>(launch_q4_0<__nv_bfloat16>(x, qs, scales, y, work, tickets, M, N, K, s));
  if (x_dtype == kF32)
    return static_cast<int>(launch_q4_0<float>(x, qs, scales, y, work, tickets, M, N, K, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" size_t gt_q4_k_f32_work_bytes(int M, int N, int K);  // q4_k_matmul.cu
extern "C" size_t gt_q6_k_f32_work_bytes(int M, int N, int K);  // q6_k_matmul.cu

// The scratch a quantized matmul of format `fmt` (0 q4_0, 1 q8_0, 2 q4_k,
// 3 q6_k: kernels/build.py FORMAT_CODES) takes at (x_dtype, M, N, K):
// returns the bytes of its f32 scratch, the K-split partial sums of its
// bf16 prefill tile (M > 8), of its tensor-core GEMV (M <= 8) or of q4_k's
// and q6_k's f32 TF32 tile (M > 8), and sets *tickets to the count of
// ints (0 between launches) the GEMV's last block a row tile takes to sum
// the splits; each 0 where there is none.
extern "C" size_t gt_matmul_work_bytes(int fmt, int x_dtype, int M, int N, int K, int* tickets) {
  *tickets = 0;
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0) return 0;
  if (x_dtype == kF32 && M > 8 && K % 256 == 0 && (fmt == 2 || fmt == 3))
    return fmt == 2 ? gt_q4_k_f32_work_bytes(M, N, K) : gt_q6_k_f32_work_bytes(M, N, K);
  if (x_dtype != kBF16) return 0;
  if (M > 8) return dq_tile_work_bytes(M, N, K);
  if (fmt <= 1) {
    *tickets = dq_gemv_tickets<BlockPlan>(M, N, K);
    return dq_gemv_work_bytes<BlockPlan>(M, N, K);
  }
  if (K % kGvSuperK != 0) return 0;
  *tickets = dq_gemv_tickets<SuperPlan>(M, N, K);
  return dq_gemv_work_bytes<SuperPlan>(M, N, K);
}

namespace {

template <int Warps>
void launch_gemv_m8(const __nv_bfloat16* x, const uint8_t* qs, const __half* sc, float* y, int N,
                    int K, cudaStream_t s) {
  q4_0_gemv_kernel<8, __nv_bfloat16, Warps><<<(N + Warps - 1) / Warps, Warps * 32, 0, s>>>(x, qs, sc, y, N, K);
}

template <int Mode>
bool launch_variant(int sc_dtype, const void* x, const void* qs, const void* sc, void* y, int N,
                    int K, cudaStream_t s) {
  const dim3 grid((N + kGemvWarps - 1) / kGemvWarps);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const uint8_t*>(qs);
  auto* yp = static_cast<float*>(y);
  switch (sc_dtype) {
    case kScF32:
      q4_0_gemv_kernel<8, __nv_bfloat16, kGemvWarps, Mode, float><<<grid, kGemvWarps * 32, 0, s>>>(
          xp, qp, static_cast<const float*>(sc), yp, N, K);
      return true;
    case kScBF16:
      q4_0_gemv_kernel<8, __nv_bfloat16, kGemvWarps, Mode, __nv_bfloat16><<<grid, kGemvWarps * 32, 0, s>>>(
          xp, qp, static_cast<const __nv_bfloat16*>(sc), yp, N, K);
      return true;
    case kScF16:
      q4_0_gemv_kernel<8, __nv_bfloat16, kGemvWarps, Mode, __half><<<grid, kGemvWarps * 32, 0, s>>>(
          xp, qp, static_cast<const __half*>(sc), yp, N, K);
      return true;
    default:
      return false;
  }
}

}  // namespace

// The q4_0 SIMT GEMV in `mode` (kF32Dot .. kGDot) with bf16 x [M, K],
// scales [N, K/32] of sc_dtype (0 f32, 1 bf16, 2 f16) and y [M, N] f32:
// M = 8 in every mode; kGDot on f16 scales at any M <= 8 (the kernel f32 x
// launches, here on bf16 x). Returns a cudaError_t value.
extern "C" int gt_qmm_variant(const void* x, int mode, const void* qs, const void* scales,
                              int sc_dtype, void* y, int M, int N, int K, void* stream) {
  if (M <= 0 || M > 8 || N <= 0 || K <= 0 || K % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kGDot && sc_dtype == kScF16) {
    launch_gemv<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qs),
                               static_cast<const __half*>(scales), static_cast<float*>(y), M, N, K, s);
    return static_cast<int>(cudaGetLastError());
  }
  bool launched = false;
  if (M == 8) {
    switch (mode) {
      case kF32Dot: launched = launch_variant<kF32Dot>(sc_dtype, x, qs, scales, y, N, K, s); break;
      case kRsc: launched = launch_variant<kRsc>(sc_dtype, x, qs, scales, y, N, K, s); break;
      case kRscb: launched = launch_variant<kRscb>(sc_dtype, x, qs, scales, y, N, K, s); break;
      case kNoScale: launched = launch_variant<kNoScale>(sc_dtype, x, qs, scales, y, N, K, s); break;
      case kGDot: launched = launch_variant<kGDot>(sc_dtype, x, qs, scales, y, N, K, s); break;
      default: break;
    }
  }
  return launched ? static_cast<int>(cudaGetLastError()) : static_cast<int>(cudaErrorInvalidValue);
}

// The q4_0 SIMT GEMV (kGDot, f16 scales) at M = 8 with bf16 x and `warps`
// (4, 8, 16 or 32) rows per block; y: [8, N] f32. Returns a cudaError_t
// value.
extern "C" int gt_q4_0_gemv_warps(const void* x, const void* qs, const void* scales, void* y,
                                  int N, int K, int warps, void* stream) {
  if (N <= 0 || K <= 0 || K % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const uint8_t*>(qs);
  const auto* sp = static_cast<const __half*>(scales);
  auto* yp = static_cast<float*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (warps) {
    case 4: launch_gemv_m8<4>(xp, qp, sp, yp, N, K, s); break;
    case 8: launch_gemv_m8<8>(xp, qp, sp, yp, N, K, s); break;
    case 16: launch_gemv_m8<16>(xp, qp, sp, yp, N, K, s); break;
    case 32: launch_gemv_m8<32>(xp, qp, sp, yp, N, K, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
