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
//   far below the card's ~295 flop/byte balance point. It runs on the
//   tensor cores, the batch-1 decode step (M = 1) and serving (2 <= M <= 8)
//   alike, bf16 and f32 x: `dq_gemv_kernel<Q4_0Gemv, X>` of dq_gemv.cuh (W
//   the A operand of bf16 mma.sync as its integers u - 8, x the n8 operand,
//   each block's fragment scaled by d in f32: the gdot numerics below),
//   with x copied once a block, each warp's rows streamed through its own
//   cp.async ring, and at M = 1 K split only to fill the card. f32 x
//   (evaluation mode) enters as three bf16 parts (`XF32`: three mma a k16
//   step; `XF32Packed` at M <= 2: one, the parts as its columns): the
//   reference kernel's f32 weights and x at M <= 8, to the order of f32
//   sums.
// * `q4_0_gemv_kernel` (SIMT, bf16 x, M = 8) is an instrument only: each
//   warp one output row; a lane's 16-byte load along K is exactly one block
//   (32 nibbles + one scale), so a warp reads 512 contiguous bytes per step.
//   Nibbles unpack and scale in registers, FMA into f32, and a warp shuffle
//   reduces. x is staged in shared memory as f32 in K-chunks of 1024,
//   padded to 36 floats per block so the lanes' float4 reads do not
//   conflict on banks. Rows per block (warps), the dot form (Mode) and the
//   scale type are template parameters. Two bench entry points launch it:
//   `gt_q4_0_gemv_warps` (kGDot, f16 scales) with 4, 8, 16 or 32 warps
//   (replaces `call` of tools/bench_bn_sweep.py, the reference kernel at a
//   forced N tile) and `gt_qmm_variant` on f32 scales (replaces `kernel`
//   and `kernel2` of tools/probe_int4.py) in its two modes:
//     kRscb     w = bf16(bf16(u - 8) * bf16(d))  (probe_int4's kernel)
//     kNoScale  w = u - 8                        (its kernel2)
//     kGDot     d * sum_32((u - 8) * x)          (bench_bn_sweep's)
// * `Q4_0Variant` (below) puts those dot forms and scale dtypes on the
//   tensor-core GEMV, as instances of `dq_gemv_kernel` beside the main
//   path's `Q4_0Gemv` (`gt_qmm_tc_variant`, bf16 x at M <= 8; replaces
//   `_kernel` of tools/bench_qmm_variants.py, which varied the reference's
//   production q4_0 kernel): the group-scaled fragment (gdot, f32dot; with
//   f16 scales `Q4_0Gemv` itself), the rounded-weight operand (rsc, f32sc,
//   u16sc; rscb, bf16sc) and the integer operand unscaled (noscale). It
//   keeps Q4_0Gemv's plan, rings, copies and fragments.
// * Prefill (M > 8) with bf16 x does 2 M N K flops on the same bytes and is
//   bound by operations: the shared tensor-core tile of dq_tile.cuh
//   (`dq_tile_kernel<Q4_0Tile>`: bf16 mma.sync, f32 accumulators, x and the
//   raw bytes staged by cp.async), the counterpart of the reference
//   kernel's bf16 MXU operands above M = 8. `Q4_0Tile` rounds each weight
//   to bf16(d * (u - 8)), the reference kernel's rounding point. Where K %
//   64 == 32 the tile's last K-step is half a step, zero-filled.
// * Prefill with f32 x (evaluation mode: perplexity, the f32 caches of
//   --verify, f32 serving) runs the TF32 tensor-core tile of
//   dq_tile_tf32.cuh (`dq_tile_tf32_kernel<Q4_0Tf32>`) on Q4_0Tile's raw
//   copies (48 bytes a row and step), held to 1e-5 of the output's scale:
//   the integers u - 8, exact in TF32, against x split into two TF32 parts
//   (two m16n8k8 products a k8 step), each 32-block's fragment scaled by
//   its f32 d. Where K % 64 == 32 the last K-step is half a step: x past K
//   zero-filled, the second block's scale 0. It bounds on operations:
//   Gemma-2B's gate_up at the perplexity window (M = 512) is 68.7 GFLOP,
//   0.139 ms at 495 TFLOP/s of TF32. The f32 plain-FMA tile it replaced
//   read 21-29 TFLOP/s there (gate_up 2.4669 ms, head 18.5751; PERF.md).
//   Expected before it ran (q4_k's rows on the same tile and shapes as the
//   guide): at M = 512 gate_up 1.0-1.15 ms, down 0.55-0.65, attn_out
//   ~0.08, qkv 0.09-0.11, head 8.5-9.5, every row at or below f32
//   torch.matmul on the dequantized weight (1.3861, 0.6885, 0.1002,
//   0.1287, 10.5792), and a Gemma-2B q4_0 f32 perplexity window from
//   105.6-111.6 ms to about 50-60.
//
// Every launch is checked: the entry point returns cudaGetLastError().
#include "dq_gemv.cuh"
#include "dq_tile_tf32.cuh"

using namespace gt;

namespace {

constexpr int kGemvWarps = 8;
constexpr int kGemvKChunk = 1024;  // K elements of x staged per pass
constexpr int kGemvBlocks = kGemvKChunk / 32;
constexpr int kXPad = 36;  // floats per staged 32-block (bank-conflict-free)

// SIMT GEMV modes (ops/qmm_variants.py SIMT_MODES); see the header
constexpr int kRscb = 2;
constexpr int kNoScale = 3;
constexpr int kGDot = 4;
// scale dtypes of gt_qmm_tc_variant (ops/qmm_variants.py SCALE_CODES)
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

template <int M, int Warps = kGemvWarps, int Mode = kGDot, typename SC = __half>
__global__ void __launch_bounds__(Warps * 32)
q4_0_gemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qs,
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
      if constexpr (Mode == kRscb) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          w[i] = __bfloat162float(__hmul(__float2bfloat16_rn(w[i]), __float2bfloat16_rn(d)));
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

// The f32 route's TF32 tile (dq_tile_tf32.cuh): Q4_0Tile's raw step and
// copies. A 16-wide unit u of the step is Q4_0Tile's quarter u, nibble u % 2
// of block u / 2's 16 payload bytes (the reverse of Q4KTf32's order), so
// lane t's four weights are the nibbles of the payload word at 16 (u / 2) +
// 4t, less 8 by `bytes_minus`. `prepare` writes the exact f16 d of the
// step's two blocks as f32, 0 for the half step past K (whose payload and x
// are zero-filled too).
struct Q4_0Tf32 : Q4_0Tile {
  static constexpr int kGroupUnits = 2;

  __device__ __forceinline__ static void prepare(const uint8_t* raw, float* scale, float*, int n,
                                                 int K, int k0, int grp) {
    const int odd = (static_cast<size_t>(n) * (K / 32) + k0 / 32) & 1;
    *scale = k0 + 32 * grp < K ? __half2float(reinterpret_cast<const __half*>(raw + 32)[odd + grp]) : 0.f;
  }

  __device__ __forceinline__ static void weights(const uint8_t* raw, int, int u, int t,
                                                 uint32_t (&b)[4]) {
    const uint32_t word = *reinterpret_cast<const uint32_t*>(raw + 16 * (u / 2) + 4 * t);
    bytes_minus((word >> (4 * (u % 2))) & 0x0F0F0F0Fu, 8.f, b);
  }
};

// The instruments' q4_0 GEMV variants (bench_qmm_variants): Q4_0Gemv with
// the scales in the tool's dtype SC and one of its dot forms
// (ops/qmm_variants.py TC_FORMS):
//   kFormGroup    each 32-group's fragment of the integers u - 8 scaled by
//                 d in f32 (gdot, f32dot; on f16 scales this is Q4_0Gemv,
//                 launched as itself)
//   kFormRound    A = bf16((u - 8) * d), products into one accumulator
//                 across groups (rsc, f32sc, u16sc)
//   kFormRoundB   A = bf16(bf16(u - 8) * bf16(d)), one accumulator (rscb,
//                 bf16sc)
//   kFormNoScale  A = u - 8, one accumulator, no scale copied or read
// A 2-byte SC lies in the stage as Q4_0Gemv's f16 words (three aligned words
// a row, at any parity); f32 as the row's four scales, 4 bytes a group more.
constexpr int kFormGroup = 0;
constexpr int kFormRound = 1;
constexpr int kFormRoundB = 2;
constexpr int kFormNoScale = 3;

template <int Form, class SC>
struct Q4_0Variant : Q4_0Gemv {
  struct Weight {
    const uint8_t* qs;
    const SC* scales;  // [N, K / 32]
  };
  static constexpr bool kOneAcc = Form != kFormGroup;
  static constexpr int kScaleWords = Form == kFormNoScale ? 0 : sizeof(SC) == 4 ? 4 : kGvScaleWords;
  static constexpr int kStage = kScales + 16 * kScaleWords * 4;

  __device__ __forceinline__ static void copy(const Weight& w, unsigned char* stage, int lane, int n0,
                                              int N, int K, int kb, int khi) {
    if constexpr (Form != kFormNoScale && sizeof(SC) == 2) {  // Q4_0Gemv's copies, scale words too
      Q4_0Gemv::copy(BlockWeight{w.qs, reinterpret_cast<const __half*>(w.scales)}, stage, lane, n0, N, K,
                     kb, khi);
    } else {
      Q4_0Gemv::copy<false>(w, stage, lane, n0, N, K, kb, khi);
    }
    if constexpr (kScaleWords == 4) {  // f32: the row's four scales, those past K as zeros
      const size_t groups = static_cast<size_t>(K) / 32;
#pragma unroll
      for (int i = lane; i < 16 * 4; i += 32) {
        const int r = i / 4, j = i % 4;
        const bool ok = n0 + r < N && kb / 32 + j < static_cast<int>(groups);
        cp_async4(smem_u32(stage + kScales + 4 * i),
                  ok ? w.scales + static_cast<size_t>(n0 + r) * groups + kb / 32 + j : w.scales, ok);
      }
    }
  }

  __device__ __forceinline__ static void scales(const unsigned char* stage, const float*, int g, int n0,
                                                int K, int kb, int grp, float (&d)[2], float (&)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (kScaleWords == 0) {
        d[h] = 1.f;
      } else if constexpr (kScaleWords == 4) {
        d[h] = reinterpret_cast<const float*>(stage + kScales + 16 * (g + 8 * h))[grp];
      } else {
        const SC* sc = reinterpret_cast<const SC*>(stage + kScales + (g + 8 * h) * 4 * kGvScaleWords) +
                       ((static_cast<size_t>(n0 + g + 8 * h) * (K / 32) + kb / 32) & 1);
        d[h] = to_f32(sc[grp]);
      }
    }
  }

  __device__ __forceinline__ static void weigh(const float (&d)[2], uint32_t (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a[0], a[2]: row g; a[1], a[3]: row g + 8
      if constexpr (Form == kFormRound) {
        const float2 q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[i]));
        a[i] = pack_bf16(q.x * d[i & 1], q.y * d[i & 1]);  // the f32 product, then bf16
      } else if constexpr (Form == kFormRoundB) {
        const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a[i]),
                                         __float2bfloat162_rn(d[i & 1]));
        a[i] = *reinterpret_cast<const uint32_t*>(&r);
      }
    }
  }
};

template <int Form, class SC>
cudaError_t launch_q4_0_variant(const void* x, const void* qs, const void* scales, void* y, void* work,
                                void* tickets, int M, int N, int K, cudaStream_t s) {
  using F = Q4_0Variant<Form, SC>;
  const typename F::Weight w{static_cast<const uint8_t*>(qs), static_cast<const SC*>(scales)};
  return launch_dq_gemv<F>(static_cast<const __nv_bfloat16*>(x), w, static_cast<float*>(y),
                           static_cast<float*>(work), static_cast<int*>(tickets), M, N, K, s);
}

template <typename TX>
cudaError_t launch_q4_0(const void* x, const void* qs, const void* scales, void* y, void* work,
                        void* tickets, int M, int N, int K, cudaStream_t s) {
  const TX* xp = static_cast<const TX*>(x);
  const BlockWeight w{static_cast<const uint8_t*>(qs), static_cast<const __half*>(scales)};
  float* yp = static_cast<float*>(y);
  if (M <= 8) {
    float* wk = static_cast<float*>(work);
    int* tk = static_cast<int*>(tickets);
    if constexpr (std::is_same<TX, float>::value)
      return launch_dq_gemv_f32<Q4_0Gemv>(xp, w, yp, wk, tk, M, N, K, s);
    else
      return launch_dq_gemv<Q4_0Gemv>(xp, w, yp, wk, tk, M, N, K, s);
  }
  if constexpr (std::is_same<TX, __nv_bfloat16>::value)
    return launch_dq_tile<Q4_0Tile>(xp, w, yp, static_cast<float*>(work), M, N, K, s);
  else
    return launch_dq_tile_tf32<Q4_0Tf32>(xp, w, yp, static_cast<float*>(work), M, N, K, s);
}

// Q4_0Variant<Form, SC> by the scales' dtype code; the group form on f16
// scales is the main path's Q4_0Gemv, launched as itself
template <int Form>
cudaError_t dispatch_q4_0_variant(int sc_dtype, const void* x, const void* qs, const void* scales, void* y,
                                  void* work, void* tickets, int M, int N, int K, cudaStream_t s) {
  if (sc_dtype == kScF32) return launch_q4_0_variant<Form, float>(x, qs, scales, y, work, tickets, M, N, K, s);
  if (sc_dtype == kScBF16)
    return launch_q4_0_variant<Form, __nv_bfloat16>(x, qs, scales, y, work, tickets, M, N, K, s);
  if (sc_dtype != kScF16) return cudaErrorInvalidValue;
  if constexpr (Form == kFormGroup)
    return launch_q4_0<__nv_bfloat16>(x, qs, scales, y, work, tickets, M, N, K, s);
  else
    return launch_q4_0_variant<Form, __half>(x, qs, scales, y, work, tickets, M, N, K, s);
}

}  // namespace

// bytes of the f32 route's K-split scratch (gt_matmul_work_bytes): the
// GEMV's at M <= 8, which sets *tickets, and the TF32 tile's above
extern "C" size_t gt_q4_0_f32_work_bytes(int M, int N, int K, int* tickets) {
  if (M > 8) return dq_tile_tf32_work_bytes<Q4_0Tf32>(M, N, K);
  *tickets = dq_gemv_tickets<Q4_0Gemv, XF32>(M, N, K);
  return dq_gemv_work_bytes<Q4_0Gemv, XF32>(M, N, K);
}

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

extern "C" size_t gt_q8_0_f32_work_bytes(int M, int N, int K, int* tickets);  // q8_0_matmul.cu
extern "C" size_t gt_q4_k_f32_work_bytes(int M, int N, int K, int* tickets);  // q4_k_matmul.cu
extern "C" size_t gt_q6_k_f32_work_bytes(int M, int N, int K, int* tickets);  // q6_k_matmul.cu

// The scratch a quantized matmul of format `fmt` (0 q4_0, 1 q8_0, 2 q4_k,
// 3 q6_k: kernels/build.py FORMAT_CODES) takes at (x_dtype, M, N, K):
// returns the bytes of its f32 scratch, the K-split partial sums of its
// bf16 prefill tile (M > 8), of its tensor-core GEMV (M <= 8, bf16 or f32
// x) or of its f32 TF32 tile (M > 8), and sets
// *tickets to the count of ints (0 between launches) the GEMV's last block
// a row tile takes to sum the splits; each 0 where there is none.
extern "C" size_t gt_matmul_work_bytes(int fmt, int x_dtype, int M, int N, int K, int* tickets) {
  *tickets = 0;
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0) return 0;
  if (x_dtype == kF32 && fmt == 0) return gt_q4_0_f32_work_bytes(M, N, K, tickets);
  if (x_dtype == kF32 && fmt == 1) return gt_q8_0_f32_work_bytes(M, N, K, tickets);
  if (x_dtype == kF32 && K % 256 == 0 && fmt == 2) return gt_q4_k_f32_work_bytes(M, N, K, tickets);
  if (x_dtype == kF32 && K % 256 == 0 && fmt == 3) return gt_q6_k_f32_work_bytes(M, N, K, tickets);
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
  q4_0_gemv_kernel<8, Warps><<<(N + Warps - 1) / Warps, Warps * 32, 0, s>>>(x, qs, sc, y, N, K);
}

}  // namespace

// The q4_0 SIMT GEMV at M = 8 in `mode` (kRscb or kNoScale) with bf16 x
// [8, K], f32 scales [N, K/32] and y [8, N] f32. Returns a cudaError_t
// value.
extern "C" int gt_qmm_variant(const void* x, int mode, const void* qs, const void* scales, void* y,
                              int N, int K, void* stream) {
  if (N <= 0 || K <= 0 || K % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kGemvWarps - 1) / kGemvWarps);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const uint8_t*>(qs);
  const auto* sp = static_cast<const float*>(scales);
  auto* yp = static_cast<float*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kRscb:
      q4_0_gemv_kernel<8, kGemvWarps, kRscb, float><<<grid, kGemvWarps * 32, 0, s>>>(xp, qp, sp, yp, N, K);
      break;
    case kNoScale:
      q4_0_gemv_kernel<8, kGemvWarps, kNoScale, float><<<grid, kGemvWarps * 32, 0, s>>>(xp, qp, sp, yp, N, K);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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

// The instruments' q4_0 GEMV on the tensor cores in `form` (kFormGroup ..
// kFormNoScale) with bf16 x [M <= 8, K], scales [N, K/32] of sc_dtype (0
// f32, 1 bf16, 2 f16; kFormNoScale reads none) and y [M, N] f32; work and
// tickets: the main path's bf16 q4_0 scratch (gt_matmul_work_bytes(0, bf16,
// M, N, K, &tickets)). kFormGroup on f16 scales launches the main path's
// instance. Returns a cudaError_t value.
extern "C" int gt_qmm_tc_variant(const void* x, int form, const void* qs, const void* scales, int sc_dtype,
                                 void* y, void* work, void* tickets, int M, int N, int K, void* stream) {
  if (M <= 0 || M > 8 || N <= 0 || K <= 0 || K % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (form) {
    case kFormGroup:
      e = dispatch_q4_0_variant<kFormGroup>(sc_dtype, x, qs, scales, y, work, tickets, M, N, K, s);
      break;
    case kFormRound:
      e = dispatch_q4_0_variant<kFormRound>(sc_dtype, x, qs, scales, y, work, tickets, M, N, K, s);
      break;
    case kFormRoundB:
      e = dispatch_q4_0_variant<kFormRoundB>(sc_dtype, x, qs, scales, y, work, tickets, M, N, K, s);
      break;
    case kFormNoScale:  // reads no scale, whatever their dtype
      e = launch_q4_0_variant<kFormNoScale, float>(x, qs, scales, y, work, tickets, M, N, K, s);
      break;
    default: break;
  }
  return static_cast<int>(e);
}

// launches of the tensor-core GEMV with f32 x (dq_gemv.cuh), every
// format's, so far in this process
extern "C" unsigned long long gt_dq_gemv_f32_launches() {
  return dq_gemv_f32_launch_count.load(std::memory_order_relaxed);
}

extern "C" const char* gt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
