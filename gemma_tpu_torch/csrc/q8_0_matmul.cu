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
//   3.35 TB/s). With bf16 x, the batch-1 decode step (M = 1) and serving
//   (2 <= M <= 8) run on the tensor cores: `dq_gemv_kernel<Q8_0Gemv>` of
//   dq_gemv.cuh (W the A operand of bf16 mma.sync as its int8 values, two
//   mask-ors and a bf16x2 subtract a pair, x the n8 operand, each block's
//   fragment scaled by d in f32: the reference's numerics at M <= 8), with
//   x copied once a block, each warp's rows streamed through its own
//   cp.async ring, and at M = 1 K split only to fill the card. f32 x
//   (evaluation mode: f32 serving's decode step, --verify's f32 cache)
//   takes the same kernel with x in three bf16 parts (`XF32`: three mma a
//   k16 step; `XF32Packed` at M <= 2: one, the parts as its columns), 1e-5
//   of the output's scale: the reference kernel's f32 weights and x at
//   M <= 8, to the order of f32 sums. Three planes of x are three times
//   bf16's bytes beside q8_0's wide ring, so the policy's slice is a
//   quarter of bf16's (512 at M = 2-8, M = 4's 1024 aside; 4096 at M = 1)
//   and K splits further.
//   The SIMT GEMV it replaced read 10 % of its byte bound at M = 8 (gate_up
//   0.4791 ms against 0.0484; PERF.md): one warp a row, M FMAs and M
//   shared reads of x a weight. Expected before it ran (bf16's M = 8 rows,
//   gate_up 0.0765, down 0.0432, head 0.3424, times q4_0's and q4_k's f32
//   / bf16 ratio, 1.3-1.7): at M = 8 gate_up 0.10-0.13 ms, down 0.056-0.075,
//   head 0.45-0.58, well under f32 torch.matmul on the dequantized weight
//   (0.3337, 0.2676, 1.6971); at M = 1 near bf16's (0.0654, 0.0379,
//   0.2968): down below the SIMT's 0.0679, gate_up and head up to ~1.1x
//   the SIMT's 0.0610 and 0.2859.
// * Prefill (M > 8) with bf16 x does 2 M N K flops on the same bytes and is
//   bound by operations: the shared tensor-core tile of dq_tile.cuh
//   (`dq_tile_kernel<Q8_0Tile>`: bf16 mma.sync, f32 accumulators, x and the
//   raw bytes staged by cp.async). `Q8_0Tile` rounds each weight to
//   bf16(d * q), as the reference kernel rounds its weight above M = 8.
//   Where K % 64 == 32 the tile's last K-step is half a step, zero-filled.
// * Prefill with f32 x (evaluation mode: perplexity, the f32 caches of
//   --verify, f32 serving) runs the TF32 tensor-core tile of
//   dq_tile_tf32.cuh (`dq_tile_tf32_kernel<Q8_0Tf32>`) on Q8_0Tile's raw
//   copies, held to 1e-5 of the output's scale: the integers q (-128..127),
//   exact in TF32, against x split into two TF32 parts (two m16n8k8
//   products a k8 step), each 32-block's fragment scaled by its f32 d. Where
//   K % 64 == 32 the last K-step is half a step: x past K zero-filled, the
//   second block's scale 0. It bounds on operations: Gemma-7B's gate_up at
//   the perplexity window (M = 512) is 155 GFLOP, 0.312 ms at 495 TFLOP/s
//   of TF32 (twice that at two passes) against 0.10 ms of bytes; the f32
//   FMA tile it replaced read 27.7 TFLOP/s there (5.5745 ms; PERF.md).
//   Expected before it ran: every Gemma-7B f32 row at M = 17-512 at or
//   below f32 torch.matmul, gate_up near 2.4-2.8 ms and the head near
//   13-14 ms at M = 512 (q4_k's and q6_k's rows on the same tile: 59-64
//   TFLOP/s). Measured (chip_smoke.py phase 3, PERF.md section 6): every
//   row 0.26-0.91x the library call, gate_up 2.12 ms and the head 11.19 at
//   M = 512 (73 and 72 TFLOP/s, 14.7 and 14.5 % of the bound); attn_out
//   and down need their K split by the grid's rounds (dq_tile_tf32.cuh
//   `dq_tile_tf32_splits`) to stay below the library.
//
// Any N and any K that is a multiple of 32 (ragged edges masked). Every
// launch is checked: the entry point returns cudaGetLastError().
#include "dq_gemv.cuh"
#include "dq_tile_tf32.cuh"

using namespace gt;

namespace {

// the signed byte j (0..3) of a 32-bit word, as f32
__device__ __forceinline__ float sbyte(uint32_t word, int j) {
  return static_cast<float>(static_cast<int32_t>(word << (24 - 8 * j)) >> 24);
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

// The f32 route's TF32 tile (dq_tile_tf32.cuh): Q8_0Tile's raw step and
// copies. A 16-wide unit u of the step is Q8_0Tile's quarter u, payload
// bytes 16u .. 16u + 15 (half u % 2 of block u / 2), so lane t's four
// weights are the payload word at 16u + 4t: signed bytes, whose sign bits
// flipped give q + 128 (0..255), less 128 by `bytes_minus`. `prepare`
// writes the exact f16 d of the step's two blocks as f32, 0 for the half
// step past K (whose payload and x are zero-filled too).
struct Q8_0Tf32 : Q8_0Tile {
  static constexpr int kGroupUnits = 2;

  __device__ __forceinline__ static void prepare(const uint8_t* raw, float* scale, float*, int n,
                                                 int K, int k0, int grp) {
    const int odd = (static_cast<size_t>(n) * (K / 32) + k0 / 32) & 1;
    *scale = k0 + 32 * grp < K ? __half2float(reinterpret_cast<const __half*>(raw + 64)[odd + grp]) : 0.f;
  }

  __device__ __forceinline__ static void weights(const uint8_t* raw, int, int u, int t,
                                                 uint32_t (&b)[4]) {
    bytes_minus(*reinterpret_cast<const uint32_t*>(raw + 16 * u + 4 * t) ^ 0x80808080u, 128.f, b);
  }
};

template <typename TX>
cudaError_t launch_q8_0(const void* x, const void* qs, const void* scales, void* y, void* work,
                        void* tickets, int M, int N, int K, cudaStream_t s) {
  const TX* xp = static_cast<const TX*>(x);
  const BlockWeight w{static_cast<const uint8_t*>(qs), static_cast<const __half*>(scales)};
  float* yp = static_cast<float*>(y);
  if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
    if (M > 8) return launch_dq_tile<Q8_0Tile>(xp, w, yp, static_cast<float*>(work), M, N, K, s);
    return launch_dq_gemv<Q8_0Gemv>(xp, w, yp, static_cast<float*>(work), static_cast<int*>(tickets), M, N,
                                    K, s);
  } else {
    if (M > 8) return launch_dq_tile_tf32<Q8_0Tf32>(xp, w, yp, static_cast<float*>(work), M, N, K, s);
    return launch_dq_gemv_f32<Q8_0Gemv>(xp, w, yp, static_cast<float*>(work), static_cast<int*>(tickets), M,
                                        N, K, s);
  }
}

}  // namespace

// bytes of the f32 route's K-split scratch (gt_matmul_work_bytes): the
// GEMV's at M <= 8, which sets *tickets, and the TF32 tile's above
extern "C" size_t gt_q8_0_f32_work_bytes(int M, int N, int K, int* tickets) {
  if (M > 8) return dq_tile_tf32_work_bytes<Q8_0Tf32>(M, N, K);
  *tickets = dq_gemv_tickets<Q8_0Gemv, XF32>(M, N, K);
  return dq_gemv_work_bytes<Q8_0Gemv, XF32>(M, N, K);
}

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
