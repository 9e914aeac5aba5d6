// q6_k dequant-matmul: y[M, N] (f32) = x[M, K] . dequant(W)^T.
//
// Replaces the Pallas kernels `_q6_k_kernel` (split-plane layout) and
// `_q6_k_v4_kernel` (deep-K int8 layout) of gemma_tpu/ops/quant_matmul.py:
// both compute this function, and the port has one q6_k layout
// (gemma_tpu_torch/quant/qtensor.py), per row and 256-superblock: ql u8
// [N, K/2], qh u8 [N, K/4], sc i8 [N, K/16], d f16 [N, K/256], each in
// ggml's in-block byte order. A weight dequantizes as w = (d * sc) * q,
// q = (low 4 bits | high 2 bits << 4) - 32, one int8 scale per 16 weights.
// Within each 128-element half of a superblock, ql[l] (l < 64) holds the
// low bits of elements l and 64 + l (low and high nibble), and qh[l % 32]
// holds their high bits at bit 2 * (e / 32) for element e of the half.
//
// What launches where, one op:
//
// * Decode and serving (M <= 8) with bf16 x are bound by weight bytes
//   (6.5625 bits a weight, used M times). They run on the tensor cores
//   through the shared GEMV of dq_gemv.cuh (`dq_gemv_kernel<Q6KGemv>`): each
//   k16 step one 16-element sub-block, its 6-bit values formed four at a
//   time from the ql and qh words by 32-bit mask, shift and or and turned
//   into bf16 pairs of q - 32 by one mask-or and one subtract (no conversion
//   per weight), multiplied against x on bf16 mma.sync, each sub-block's
//   fragment scaled by d * sc in f32 (formed once a row and sub-block); x
//   copied once a block, each warp's 16 rows streamed a superblock a stage
//   through its own cp.async ring, K split in whole superblocks where the
//   rows alone do not fill the card.
// * With f32 x (evaluation mode) M <= 8 runs the SIMT `q6_k_gemv_kernel`:
//   each warp one output row. Lane l's 16-byte ql load is bytes 16l..16l+15
//   of a 512-byte span (four superblocks), so a warp's ql reads are
//   contiguous; with o = 16 (l % 8) the lane owns half h = o / 64 and p = o %
//   64 of its superblock, that is elements 128h + p + i (low nibbles) and
//   128h + 64 + p + i (high nibbles), i < 16. Their high bits are the 16
//   aligned qh bytes at 32h + p % 32, fields 2 (p / 32) and 2 (p / 32) + 4
//   (two lanes read each qh line). The lane reads the two int8 scales of its
//   two 16-element sub-blocks, 8h + p / 16 and 8h + p / 16 + 4, and d, and
//   accumulates (d*sc) * sum(x*q) per sub-block in f32. x is staged per
//   K-chunk of 1024 in shared memory in lane order, padded to 36 floats a
//   lane against bank conflicts; all math f32. The 6-bit value is combined
//   in int32 and converted once: the `split_int` mode of
//   tools/bench_q6k_variants.py. For the layout ablation that replaces that
//   tool's `_kernel` (`gt_q6_k_variant`, M = 8, bf16 x), a template flag
//   combines the two planes in f32 instead (`split_f32`: lo + 16 * hi - 32),
//   and `q6_k_int8_gemv_kernel` reads an int8 payload q [N, K] with the same
//   sc and d (`prod`, 8.5625 bits a weight against 6.5625: a lane's two
//   16-byte loads are its 32 weights, two 16-element sub-blocks).
// * Prefill (M > 8) with bf16 x does 2 M N K flops on the same bytes and
//   is bound by operations (the deep-K (2048, 16384) shape at M = 203:
//   0.0138 ms at 989 TFLOP/s against 0.0082 ms of bytes). It runs on the
//   tensor cores through the shared tile of dq_tile.cuh
//   (`dq_tile_kernel<Q6KTile>`: bf16 mma.sync, f32 accumulators, x and the
//   raw q6_k bytes staged by cp.async a few steps ahead), the counterpart of
//   the reference kernels' bf16 MXU operands above M = 8. `Q6KTile`
//   dequantizes 16 weights a thread from shared memory into the bf16 tile:
//   bf16((d*sc) * q), the true weight rounded once with d*sc formed in f32
//   first (the reference's -24 fold exists only for its int4 bitcast).
// * Prefill with f32 x (evaluation mode: perplexity, the f32 caches of
//   --verify, f32 serving) runs the TF32 tensor-core tile of
//   dq_tile_tf32.cuh (`dq_tile_tf32_kernel<Q6KTf32>`), held to 1e-5 of the
//   output's scale: the integers q - 32, exact in TF32, against x split
//   into two TF32 parts (two m16n8k8 products a k8 step), each 16-element
//   sub-block's fragment scaled by d*sc in f32.
//
// Every launch is checked: the entry point returns cudaGetLastError().
#include "dq_gemv.cuh"
#include "dq_tile_tf32.cuh"

using namespace gt;

namespace {

constexpr int kQK = 256;  // superblock
constexpr int kGemvWarps = 8;
constexpr int kGemvKChunk = 1024;  // K elements of x staged per pass (4 superblocks)
constexpr int kXPad = 36;          // floats per lane's 32 staged values (bank-conflict-free)

// 6-bit value q - 32 of one weight from its ql byte and qh byte
__device__ __forceinline__ float q6(uint32_t ql_byte, int nibble_shift, uint32_t qh_byte, int qh_shift) {
  const uint32_t u = ((ql_byte >> nibble_shift) & 0xfu) | (((qh_byte >> qh_shift) & 3u) << 4);
  return static_cast<float>(static_cast<int>(u) - 32);
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t w[4], int i) {
  return (w[i / 4] >> (8 * (i % 4))) & 0xffu;
}

// GEMV lane order: element e (< 1024) of a staged K-chunk -> lane * kXPad + slot
__device__ __forceinline__ int gemv_slot(int e) {
  const int sb = e >> 8, r = e & 255;
  const int h = r >> 7, s = r & 127;  // half, position in half
  const int hi = s >> 6, p16 = (s & 63) >> 4;
  return (sb * 8 + h * 4 + p16) * kXPad + hi * 16 + (s & 15);
}

// the same in f32: low nibble + 16 * high bits - 32
__device__ __forceinline__ float q6_f32(uint32_t ql_byte, int nibble_shift, uint32_t qh_byte, int qh_shift) {
  return static_cast<float>((ql_byte >> nibble_shift) & 0xfu) +
         16.f * static_cast<float>((qh_byte >> qh_shift) & 3u) - 32.f;
}

template <int M, typename TX, bool F32Combine = false>
__global__ void __launch_bounds__(kGemvWarps * 32)
q6_k_gemv_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ ql,
                 const uint8_t* __restrict__ qh, const int8_t* __restrict__ sc,
                 const __half* __restrict__ d, float* __restrict__ y, int N, int K) {
  __shared__ __align__(16) float xs[M][32 * kXPad];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * kGemvWarps + warp;
  const int nsb = K / kQK;
  const uint8_t* qlrow = ql + static_cast<size_t>(n) * (K / 2);
  const uint8_t* qhrow = qh + static_cast<size_t>(n) * (K / 4);
  const int8_t* scrow = sc + static_cast<size_t>(n) * (K / 16);
  const __half* drow = d + static_cast<size_t>(n) * nsb;
  const int o = (lane % 8) * 16;
  const int h = o / 64;
  const int p = o % 64;
  const int qh_shift = 2 * (p / 32);  // low nibbles; high nibbles + 4

  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kGemvKChunk) {
    const int klen = min(kGemvKChunk, K - k0);  // a multiple of 256
    __syncthreads();  // previous chunk fully consumed
    for (int i = threadIdx.x; i < M * kGemvKChunk; i += blockDim.x) {
      const int m = i / kGemvKChunk;
      const int e = i % kGemvKChunk;
      xs[m][gemv_slot(e)] = e < klen ? to_f32(x[static_cast<size_t>(m) * K + k0 + e]) : 0.f;
    }
    __syncthreads();
    if (n < N && lane < klen / 32) {
      const int sb = k0 / kQK + lane / 8;
      const uint4 l4 = *reinterpret_cast<const uint4*>(qlrow + static_cast<size_t>(sb) * 128 + o);
      const uint4 h4 = *reinterpret_cast<const uint4*>(qhrow + static_cast<size_t>(sb) * 64 + 32 * h + p % 32);
      const float dd = __half2float(drow[sb]);
      const float dsc_lo = dd * static_cast<float>(scrow[sb * 16 + 8 * h + p / 16]);
      const float dsc_hi = dd * static_cast<float>(scrow[sb * 16 + 8 * h + p / 16 + 4]);
      const uint32_t lw[4] = {l4.x, l4.y, l4.z, l4.w};
      const uint32_t hw[4] = {h4.x, h4.y, h4.z, h4.w};
      float qlo[16], qhi[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if constexpr (F32Combine) {
          qlo[i] = q6_f32(byte_of(lw, i), 0, byte_of(hw, i), qh_shift);
          qhi[i] = q6_f32(byte_of(lw, i), 4, byte_of(hw, i), qh_shift + 4);
        } else {
          qlo[i] = q6(byte_of(lw, i), 0, byte_of(hw, i), qh_shift);
          qhi[i] = q6(byte_of(lw, i), 4, byte_of(hw, i), qh_shift + 4);
        }
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4* xv = reinterpret_cast<const float4*>(&xs[m][lane * kXPad]);
        float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a = xv[i];
          const float4 b = xv[4 + i];
          s_lo = fmaf(qlo[4 * i + 0], a.x, s_lo);
          s_lo = fmaf(qlo[4 * i + 1], a.y, s_lo);
          s_lo = fmaf(qlo[4 * i + 2], a.z, s_lo);
          s_lo = fmaf(qlo[4 * i + 3], a.w, s_lo);
          s_hi = fmaf(qhi[4 * i + 0], b.x, s_hi);
          s_hi = fmaf(qhi[4 * i + 1], b.y, s_hi);
          s_hi = fmaf(qhi[4 * i + 2], b.z, s_hi);
          s_hi = fmaf(qhi[4 * i + 3], b.w, s_hi);
        }
        acc[m] = fmaf(dsc_lo, s_lo, acc[m]);
        acc[m] = fmaf(dsc_hi, s_hi, acc[m]);
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

// int8 payload q [N, K] (-32..31), sc i8 [N, K/16], d f16 [N, K/256], M = 8,
// bf16 x: lane l of a K-chunk owns elements 32l..32l+31 (x staged in that
// order, 36 floats a lane) and scales their two 16-sums by d*sc in f32
__global__ void __launch_bounds__(kGemvWarps * 32)
q6_k_int8_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ qs,
                      const int8_t* __restrict__ sc, const __half* __restrict__ d,
                      float* __restrict__ y, int N, int K) {
  constexpr int M = 8;
  __shared__ __align__(16) float xs[M][32 * kXPad];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * kGemvWarps + warp;
  const int8_t* qrow = qs + static_cast<size_t>(n) * K;
  const int8_t* scrow = sc + static_cast<size_t>(n) * (K / 16);
  const __half* drow = d + static_cast<size_t>(n) * (K / kQK);
  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kGemvKChunk) {
    const int klen = min(kGemvKChunk, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < M * kGemvKChunk; i += blockDim.x) {
      const int m = i / kGemvKChunk;
      const int e = i % kGemvKChunk;
      xs[m][(e / 32) * kXPad + e % 32] = e < klen ? __bfloat162float(x[static_cast<size_t>(m) * K + k0 + e]) : 0.f;
    }
    __syncthreads();
    if (n < N && lane < klen / 32) {
      const int k = k0 + 32 * lane;
      const uint4 a4 = *reinterpret_cast<const uint4*>(qrow + k);
      const uint4 b4 = *reinterpret_cast<const uint4*>(qrow + k + 16);
      const float dd = __half2float(drow[k / kQK]);
      const float dsc_lo = dd * static_cast<float>(scrow[k / 16]);
      const float dsc_hi = dd * static_cast<float>(scrow[k / 16 + 1]);
      const uint32_t aw[4] = {a4.x, a4.y, a4.z, a4.w};
      const uint32_t bw[4] = {b4.x, b4.y, b4.z, b4.w};
      float qlo[16], qhi[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        qlo[i] = static_cast<float>(static_cast<int8_t>(byte_of(aw, i)));
        qhi[i] = static_cast<float>(static_cast<int8_t>(byte_of(bw, i)));
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4* xv = reinterpret_cast<const float4*>(&xs[m][lane * kXPad]);
        float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a = xv[i];
          const float4 b = xv[4 + i];
          s_lo = fmaf(qlo[4 * i + 0], a.x, s_lo);
          s_lo = fmaf(qlo[4 * i + 1], a.y, s_lo);
          s_lo = fmaf(qlo[4 * i + 2], a.z, s_lo);
          s_lo = fmaf(qlo[4 * i + 3], a.w, s_lo);
          s_hi = fmaf(qhi[4 * i + 0], b.x, s_hi);
          s_hi = fmaf(qhi[4 * i + 1], b.y, s_hi);
          s_hi = fmaf(qhi[4 * i + 2], b.z, s_hi);
          s_hi = fmaf(qhi[4 * i + 3], b.w, s_hi);
        }
        acc[m] = fmaf(dsc_lo, s_lo, acc[m]);
        acc[m] = fmaf(dsc_hi, s_hi, acc[m]);
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

// The tensor-core tile's q6_k item (dq_tile.cuh): 16 weights of one row in
// one 64-element step, quarter t = (k0 % 128) / 64 of half h = (k0 % 256) /
// 128 of superblock k0 / 256. Item p is elements e = 64t + 16p + i (i < 16)
// of the half: ql byte 16p + i of the half's 64 (nibble t), qh byte
// 16 (p % 2) + i of its 32 (field 2t + p / 2), sub-block 8h + 4t + p. A
// row's raw step: the half's 64 ql and 32 qh bytes, the quarter's four int8
// scales, and the aligned 4-byte word that holds d.
struct Q6KTile {
  struct Weight {
    const uint8_t* ql;
    const uint8_t* qh;
    const int8_t* sc;
    const __half* d;
  };
  static constexpr int kRaw = 112;  // ql [0, 64), qh [64, 96), sc [96, 100), d word [100, 104)
  static constexpr bool kAffine = false;

  __device__ __forceinline__ static void copy(const Weight& w, uint32_t raw, int n, int N, int K,
                                              int k0, int part) {
    const bool ok = n < N;
    const size_t row = ok ? n : 0;
    const int sb = k0 / kQK, h = (k0 % kQK) / 128, t = (k0 % 128) / 64;
    cp_async16(raw + 16 * part, w.ql + row * (K / 2) + sb * 128 + 64 * h + 16 * part, ok);
    if (part < 2) {
      cp_async16(raw + 64 + 16 * part, w.qh + row * (K / 4) + sb * 64 + 32 * h + 16 * part, ok);
    } else if (part == 2) {
      cp_async4(raw + 96, w.sc + row * (K / 16) + sb * 16 + 8 * h + 4 * t, ok);
    } else {
      cp_async4(raw + 100, w.d + ((row * (K / kQK) + sb) & ~size_t{1}), ok);
    }
  }

  __device__ __forceinline__ static void store(const uint8_t* raw, __nv_bfloat16* row, float*,
                                               int n, int K, int k0, int part) {
    const int sb = k0 / kQK, t = (k0 % 128) / 64;
    const int qh_shift = 4 * t + 2 * (part / 2);
    const __half2 dword = *reinterpret_cast<const __half2*>(raw + 100);
    const bool odd = (static_cast<size_t>(n) * (K / kQK) + sb) & 1;  // d is the word's high half
    const float d = __half2float(odd ? __high2half(dword) : __low2half(dword));
    const float dsc = d * static_cast<float>(static_cast<int8_t>(raw[96 + part]));
    const uint4 l = *reinterpret_cast<const uint4*>(raw + 16 * part);
    const uint4 q = *reinterpret_cast<const uint4*>(raw + 64 + 16 * (part % 2));
    const uint32_t lw[4] = {l.x, l.y, l.z, l.w};
    const uint32_t hw[4] = {q.x, q.y, q.z, q.w};
    uint32_t p[8];
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const uint32_t lv = lw[i / 4] >> (8 * (i % 4) + 4 * t);    // nibbles in bits 0-3, 8-11
      const uint32_t hv = hw[i / 4] >> (8 * (i % 4) + qh_shift);  // fields in bits 0-1, 8-9
      const uint32_t u0 = (lv & 0xfu) | ((hv & 3u) << 4);
      const uint32_t u1 = ((lv >> 8) & 0xfu) | (((hv >> 8) & 3u) << 4);
      p[i / 2] = pack_bf16(dsc * small_int_minus(u0, 32.f), dsc * small_int_minus(u1, 32.f));
    }
    uint4* dst = reinterpret_cast<uint4*>(row + 16 * part);
    dst[0] = make_uint4(p[0], p[1], p[2], p[3]);
    dst[1] = make_uint4(p[4], p[5], p[6], p[7]);
  }
};

// The tensor-core GEMV's q6_k (dq_gemv.cuh): a stage is one superblock of
// the warp's 16 rows: ql [16][kQlPitch] (128 bytes a row), qh [16][kQhPitch]
// (64), the 16 int8 scales and the aligned word that holds d (16 bytes of
// padding a ql or qh row against ldmatrix bank conflicts). Piece h is half h
// of the superblock: ldmatrix of its 64 ql bytes (two 32-byte columns) and
// its 32 qh bytes, 12 words. Each k16 step is one 16-element sub-block, in
// `Q6KTile`'s item order: group gi = 4t + p of the half is elements 64t +
// 16p + i, ql byte 16p + i (nibble t) and qh byte 16 (p % 2) + i (field 2t +
// p / 2). The 6-bit values of four bytes form at once by 32-bit mask, shift
// and or; `six_bit_pair` turns each pair into bf16 q - 32. `prepare` forms
// d * sc once a row and sub-block: lane l takes row l % 16 and sub-blocks
// l / 16 + 2i, into the warp's table [sub-block][row].
struct Q6KGemv : SuperPlan {
  using Weight = Q6KTile::Weight;
  static constexpr int kStageK = kGvSuperK;
  static constexpr int kGroupK = 16;
  static constexpr int kQlPitch = kQK / 2 + 16, kQhPitch = kQK / 4 + 16;
  static constexpr int kQh = 16 * kQlPitch;
  static constexpr int kSc = kQh + 16 * kQhPitch;
  static constexpr int kD = kSc + 16 * 16;
  static constexpr int kStage = kD + 16 * 4;
  static constexpr int kPieces = 2, kGroups = 8, kSteps = 1;
  static constexpr int kWords = 12;
  static constexpr int kTable = 16 * 16;  // d * sc [16 sub-blocks][16 rows]
  static constexpr bool kAffine = false;

  __device__ __forceinline__ static void copy(const Weight& w, unsigned char* stage, int lane, int n0,
                                              int N, int K, int kb, int) {
    const int nsb = K / kQK, sb = kb / kQK;
#pragma unroll
    for (int i = lane; i < 16 * 8; i += 32) {  // ql: 8 pieces of 16 bytes a row
      const int r = i / 8, c = i % 8;
      const bool ok = n0 + r < N;
      const size_t row = ok ? n0 + r : 0;
      cp_async16(smem_u32(stage + r * kQlPitch + 16 * c), w.ql + row * (K / 2) + sb * 128 + 16 * c, ok);
    }
#pragma unroll
    for (int i = lane; i < 16 * 4; i += 32) {  // qh: 4 pieces a row
      const int r = i / 4, c = i % 4;
      const bool ok = n0 + r < N;
      const size_t row = ok ? n0 + r : 0;
      cp_async16(smem_u32(stage + kQh + r * kQhPitch + 16 * c), w.qh + row * (K / 4) + sb * 64 + 16 * c,
                 ok);
    }
    const int r = lane % 16;
    const bool ok = n0 + r < N;
    const size_t row = ok ? n0 + r : 0;
    if (lane < 16) {
      cp_async16(smem_u32(stage + kSc + 16 * r), w.sc + row * (K / 16) + sb * 16, ok);
    } else {
      cp_async_half2(smem_u32(stage + kD + 4 * r), w.d, (row * nsb + sb) & ~size_t{1},
                     ok ? static_cast<size_t>(N) * nsb : 0);
    }
  }

  __device__ __forceinline__ static void prepare(const unsigned char* stage, float* table, int lane,
                                                 int n0, int K, int kb) {
    const int r = lane % 16;
    const __half2 dword = *reinterpret_cast<const __half2*>(stage + kD + 4 * r);
    const bool odd = (static_cast<size_t>(n0 + r) * (K / kQK) + kb / kQK) & 1;  // d is the high half
    const float d = __half2float(odd ? __high2half(dword) : __low2half(dword));
    const uint4 sv = *reinterpret_cast<const uint4*>(stage + kSc + 16 * r);
    const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = 2 * i + lane / 16;  // byte j % 4 of word i / 2
      const int sc = static_cast<int8_t>(sw[i / 2] >> (8 * (j % 4)));
      table[16 * j + r] = d * static_cast<float>(sc);
    }
  }

  __device__ __forceinline__ static void load(const unsigned char* stage, int lane, int p,
                                              uint32_t (&r)[kWords]) {
    uint32_t q0[4], q1[4], h[4];
    ldmatrix_rows16(q0, stage, kQlPitch, 64 * p, lane);
    ldmatrix_rows16(q1, stage, kQlPitch, 64 * p + 32, lane);
    ldmatrix_rows16(h, stage + kQh, kQhPitch, 32 * p, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[i] = q0[i];
      r[4 + i] = q1[i];
      r[8 + i] = h[i];
    }
  }

  // the four 6-bit values of ql word l (nibble t) and qh word h (field f)
  __device__ __forceinline__ static uint32_t six_bits(uint32_t l, uint32_t h, int t, int f) {
    return ((l >> (4 * t)) & 0x0F0F0F0Fu) | (((h >> (2 * f)) & 0x03030303u) << 4);
  }

  __device__ __forceinline__ static void a_frag(const uint32_t (&r)[kWords], int gi, int,
                                                uint32_t (&a)[4]) {
    const int t = gi / 4, p = gi % 4;
    const int lw = 4 * (p / 2) + 2 * (p % 2), hw = 8 + 2 * (p % 2), f = 2 * t + p / 2;
    const uint32_t u0 = six_bits(r[lw], r[hw], t, f), u1 = six_bits(r[lw + 1], r[hw + 1], t, f);
    a[0] = six_bit_pair(u0);
    a[1] = six_bit_pair(u1);
    a[2] = six_bit_pair(u0 >> 8);
    a[3] = six_bit_pair(u1 >> 8);
  }

  __device__ __forceinline__ static int x_off(int p, int gi, int) { return 128 * p + 16 * gi; }

  __device__ __forceinline__ static void scales(const unsigned char*, const float* table, int g, int,
                                                int, int, int grp, float (&d)[2], float (&)[2]) {
    d[0] = table[16 * grp + g];
    d[1] = table[16 * grp + g + 8];
  }
};

// The f32 route's TF32 tile (dq_tile_tf32.cuh): Q6KTile's raw step and
// copies. A 16-wide unit u of the step is Q6KTile's item u: sub-block u of
// the step, elements 16u + i at ql byte 16u + i (nibble t64, the step's
// 64-wide half of its 128) and qh byte 16 (u % 2) + i (field 2 t64 + u /
// 2), so lane t's four weights are one ql word and one qh word, their 6-bit
// values formed four at a time. `prepare` writes d*sc of the step's four
// sub-blocks.
struct Q6KTf32 : Q6KTile {
  static constexpr int kGroupUnits = 1;

  __device__ __forceinline__ static void prepare(const uint8_t* raw, float* scale, float*, int n,
                                                 int K, int k0, int grp) {
    const __half2 dword = *reinterpret_cast<const __half2*>(raw + 100);
    const bool odd = (static_cast<size_t>(n) * (K / kQK) + k0 / kQK) & 1;  // d is the word's high half
    const float d = __half2float(odd ? __high2half(dword) : __low2half(dword));
    *scale = d * static_cast<float>(static_cast<int8_t>(raw[96 + grp]));
  }

  __device__ __forceinline__ static void weights(const uint8_t* raw, int k0, int u, int t,
                                                 uint32_t (&b)[4]) {
    const int t64 = (k0 % 128) / 64;
    const uint32_t l = *reinterpret_cast<const uint32_t*>(raw + 16 * u + 4 * t);
    const uint32_t h = *reinterpret_cast<const uint32_t*>(raw + 64 + 16 * (u % 2) + 4 * t);
    bytes_minus(((l >> (4 * t64)) & 0x0F0F0F0Fu) |
                    (((h >> (4 * t64 + 2 * (u / 2))) & 0x03030303u) << 4),
                32.f, b);
  }
};

template <typename TX>
cudaError_t launch_q6_k(const void* x, const void* ql, const void* qh, const void* sc,
                        const void* d, void* y, void* work, void* tickets, int M, int N, int K,
                        cudaStream_t s) {
  const TX* xp = static_cast<const TX*>(x);
  const Q6KTile::Weight w{static_cast<const uint8_t*>(ql), static_cast<const uint8_t*>(qh),
                          static_cast<const int8_t*>(sc), static_cast<const __half*>(d)};
  float* yp = static_cast<float*>(y);
  if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
    if (M > 8) return launch_dq_tile<Q6KTile>(xp, w, yp, static_cast<float*>(work), M, N, K, s);
    return launch_dq_gemv<Q6KGemv>(xp, w, yp, static_cast<float*>(work), static_cast<int*>(tickets), M,
                                   N, K, s);
  } else if (M > 8) {
    return launch_dq_tile_tf32<Q6KTf32>(xp, w, yp, static_cast<float*>(work), M, N, K, s);
  } else {
    const dim3 grid((N + kGemvWarps - 1) / kGemvWarps);
    const dim3 block(kGemvWarps * 32);
    switch (M) {
      case 1: q6_k_gemv_kernel<1, TX><<<grid, block, 0, s>>>(xp, w.ql, w.qh, w.sc, w.d, yp, N, K); break;
      case 2: q6_k_gemv_kernel<2, TX><<<grid, block, 0, s>>>(xp, w.ql, w.qh, w.sc, w.d, yp, N, K); break;
      case 3: q6_k_gemv_kernel<3, TX><<<grid, block, 0, s>>>(xp, w.ql, w.qh, w.sc, w.d, yp, N, K); break;
      case 4: q6_k_gemv_kernel<4, TX><<<grid, block, 0, s>>>(xp, w.ql, w.qh, w.sc, w.d, yp, N, K); break;
      case 5: q6_k_gemv_kernel<5, TX><<<grid, block, 0, s>>>(xp, w.ql, w.qh, w.sc, w.d, yp, N, K); break;
      case 6: q6_k_gemv_kernel<6, TX><<<grid, block, 0, s>>>(xp, w.ql, w.qh, w.sc, w.d, yp, N, K); break;
      case 7: q6_k_gemv_kernel<7, TX><<<grid, block, 0, s>>>(xp, w.ql, w.qh, w.sc, w.d, yp, N, K); break;
      default: q6_k_gemv_kernel<8, TX><<<grid, block, 0, s>>>(xp, w.ql, w.qh, w.sc, w.d, yp, N, K); break;
    }
  }
  return cudaGetLastError();
}

}  // namespace

// bytes of the f32 route's K-split scratch at M > 8 (gt_matmul_work_bytes)
extern "C" size_t gt_q6_k_f32_work_bytes(int M, int N, int K) {
  return dq_tile_tf32_work_bytes<Q6KTf32>(M, N, K);
}

// x: [M, K] f32 or bf16 (x_dtype), row-major contiguous; ql/qh/sc/d: the
// port's q6_k layout; y: [M, N] f32; work and tickets: the f32 scratch
// and the ints (0 on entry and on return) that gt_matmul_work_bytes(3,
// x_dtype, M, N, K, &tickets) gives (each null when its size is 0).
// Returns a cudaError_t value.
extern "C" int gt_q6_k_matmul(const void* x, int x_dtype, const void* ql, const void* qh,
                              const void* sc, const void* d, void* y, void* work, void* tickets, int M,
                              int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kQK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kBF16)
    return static_cast<int>(launch_q6_k<__nv_bfloat16>(x, ql, qh, sc, d, y, work, tickets, M, N, K, s));
  if (x_dtype == kF32)
    return static_cast<int>(launch_q6_k<float>(x, ql, qh, sc, d, y, work, tickets, M, N, K, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The layout ablation at M = 8 with bf16 x; y: [8, N] f32. mode 0 (prod):
// a0 = q i8 [N, K], a1 = sc, a2 = d, a3 unused; mode 1 (split_f32) and 2
// (split_int, the SIMT GEMV of f32 x): a0..a3 = ql, qh, sc, d of the port's
// q6_k layout. Returns a cudaError_t value.
extern "C" int gt_q6_k_variant(const void* x, int mode, const void* a0, const void* a1,
                               const void* a2, const void* a3, void* y, int N, int K,
                               void* stream) {
  if (N <= 0 || K <= 0 || K % kQK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* yp = static_cast<float*>(y);
  const dim3 grid((N + kGemvWarps - 1) / kGemvWarps);
  const dim3 block(kGemvWarps * 32);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* u0 = static_cast<const uint8_t*>(a0);
  const auto* u1 = static_cast<const uint8_t*>(a1);
  switch (mode) {
    case 0:
      q6_k_int8_gemv_kernel<<<grid, block, 0, s>>>(xp, static_cast<const int8_t*>(a0),
                                                   static_cast<const int8_t*>(a1),
                                                   static_cast<const __half*>(a2), yp, N, K);
      break;
    case 1:
      q6_k_gemv_kernel<8, __nv_bfloat16, true><<<grid, block, 0, s>>>(
          xp, u0, u1, static_cast<const int8_t*>(a2), static_cast<const __half*>(a3), yp, N, K);
      break;
    case 2:
      q6_k_gemv_kernel<8, __nv_bfloat16, false><<<grid, block, 0, s>>>(
          xp, u0, u1, static_cast<const int8_t*>(a2), static_cast<const __half*>(a3), yp, N, K);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
