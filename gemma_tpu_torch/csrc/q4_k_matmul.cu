// q4_k dequant-matmul: y[M, N] (f32) = x[M, K] . dequant(W)^T.
//
// Replaces the Pallas kernel `_q4_k_kernel` of gemma_tpu/ops/quant_matmul.py
// (launched by `_qmm_call`). W is q4_k in the port's layout
// (gemma_tpu_torch/quant/qtensor.py), per row and 256-superblock: qs u8
// [N, K/2] with ggml's 128 payload bytes (32-byte chunk c holds sub-block 2c
// in its low nibbles, 2c + 1 in its high nibbles), scales u8 [N, K/256, 12]
// with ggml's packed 6-bit sc/mn table, dm f16 [N, K/256, 2] with ggml's d
// and dmin. Sub-block j dequantizes as w = (d * sc_j) * q - dmin * mn_j.
//
// What launches where, one op:
//
// * Decode and serving (M <= 8) are bound by weight bytes: 4.5 bits a
//   weight used M times, far below the card's ~295 flop/byte balance point.
//   They run on the tensor cores through the shared GEMV of dq_gemv.cuh
//   (`dq_gemv_kernel<Q4KGemv, X>`), bf16 and f32 x: the weight's integers
//   q - 8 as the A operand of bf16 mma.sync (a nibble pair to bf16x2 by one
//   mask-or and one subtract, no conversion per weight), x the n8 operand, each
//   32-group's fragment scaled by d*sc in f32 and the affine part (8 d*sc -
//   dmin*mn) * sum(x) added in f32 (the reference's `xs_ref` side input,
//   quant_matmul.py:110-143); x copied once a block with its per-32 sums,
//   each warp's 16 rows streamed a superblock a stage through its own
//   cp.async ring, the 6-bit table decoded once a row and superblock, K
//   split in whole superblocks where the rows alone do not fill the card.
//   f32 x (evaluation mode) enters as three bf16 parts (`XF32`: three mma
//   a k16 step; `XF32Packed` at M <= 2: one, the parts as its columns), its
//   per-32 sums taken from the f32 x: the reference kernel's f32 weights
//   and x at M <= 8, to the order of f32 sums.
// * `Q4KAblation` (below) is an instrument only: the metadata ablations
//   that replace `_kernel` of tools/bench_q4k_variants.py, which dropped
//   terms from the reference's production q4_k kernel, as instances of the
//   same tensor-core GEMV (`gt_q4_k_ablation`, bf16 x at M <= 8): noaffine
//   forms d*sc * (q - 8) (no per-32 sums of x, no offsets, no affine add),
//   nosub d * (q - 8) (no 6-bit table decoded or copied, no affine part).
// * Prefill (M > 8) with bf16 x does 2 M N K flops on the same bytes and
//   is bound by operations (gate_up at M = 203: 0.0275 ms at 989 TFLOP/s
//   against 0.0113 ms of bytes). It runs on the tensor cores through the
//   shared tile of dq_tile.cuh (`dq_tile_kernel<Q4KTile>`: bf16 mma.sync,
//   f32 accumulators, x and the raw q4_k bytes staged by cp.async a few
//   steps ahead), the counterpart of the reference kernel's bf16 MXU
//   operands above M = 8. `Q4KTile` dequantizes 16 weights a thread from
//   shared memory into the bf16 tile: bf16(d*sc * (q - 8)), the reference
//   kernel's rounding point. The per-32 affine part sum(x) * (8 d*sc -
//   dmin*mn) stays in f32 (a bf16-rounded offset is a perplexity bias): the
//   tile adds it from the x tile's group sums into the accumulators.
// * Prefill with f32 x (evaluation mode: perplexity, the f32 caches of
//   --verify, f32 serving) runs the TF32 tensor-core tile of
//   dq_tile_tf32.cuh (`dq_tile_tf32_kernel<Q4KTf32>`), held to 1e-5 of the
//   output's scale: the integers q - 8, exact in TF32, against x split
//   into two TF32 parts (two m16n8k8 products a k8 step), each 32-group's
//   fragment scaled by d*sc in f32 and the affine part (8 d*sc - dmin*mn) *
//   sum(x) added in f32 from the f32 x tile's group sums.
//
// Every launch is checked: the entry point returns cudaGetLastError().
#include "dq_gemv.cuh"
#include "dq_tile_tf32.cuh"

using namespace gt;

namespace {

constexpr int kQK = 256;  // superblock

// byte i (0..11) of the packed 6-bit table held as three words
__device__ __forceinline__ uint32_t table_byte(uint32_t t0, uint32_t t1, uint32_t t2, int i) {
  const uint32_t w = i < 4 ? t0 : (i < 8 ? t1 : t2);
  return (w >> (8 * (i & 3))) & 0xffu;
}

// ggml get_scale_min_k4: the 6-bit scale and min of sub-block j (0..7)
__device__ __forceinline__ void scale_min_k4(uint32_t t0, uint32_t t1, uint32_t t2, int j,
                                             float& sc, float& mn) {
  uint32_t s, m;
  if (j < 4) {
    s = table_byte(t0, t1, t2, j) & 63u;
    m = table_byte(t0, t1, t2, j + 4) & 63u;
  } else {
    const uint32_t c = table_byte(t0, t1, t2, j + 4);
    s = (c & 15u) | ((table_byte(t0, t1, t2, j - 4) >> 6) << 4);
    m = (c >> 4) | ((table_byte(t0, t1, t2, j) >> 6) << 4);
  }
  sc = static_cast<float>(s);
  mn = static_cast<float>(m);
}

// The tensor-core tile's q4_k item (dq_tile.cuh): 16 weights of one row in
// one 64-element step, chunk c = (k0 % 256) / 64 of superblock k0 / 256.
// Quarter p is elements 16p .. 16p + 15 of the chunk: nibble p / 2 (sub-block
// 2c + p / 2) of payload bytes 16 (p % 2) .. + 15. A row's raw step: the
// chunk's 32 payload bytes, the superblock's 12-byte table and its d, dmin.
struct Q4KTile {
  struct Weight {
    const uint8_t* qs;
    const uint8_t* table;
    const __half2* dm;
  };
  static constexpr int kRaw = 48;  // qs [0, 32), table [32, 44), dm [44, 48)
  static constexpr bool kAffine = true;

  __device__ __forceinline__ static void copy(const Weight& w, uint32_t raw, int n, int N, int K,
                                              int k0, int part) {
    const bool ok = n < N;
    const size_t sbi = static_cast<size_t>(ok ? n : 0) * (K / kQK) + k0 / kQK;  // superblock index
    if (part < 2) {
      cp_async16(raw + 16 * part, w.qs + sbi * 128 + (k0 % kQK) / 2 + 16 * part, ok);
    } else if (part == 2) {
#pragma unroll
      for (int i = 0; i < 3; ++i) cp_async4(raw + 32 + 4 * i, w.table + sbi * 12 + 4 * i, ok);
    } else {
      cp_async4(raw + 44, w.dm + sbi, ok);
    }
  }

  __device__ __forceinline__ static void store(const uint8_t* raw, __nv_bfloat16* row, float* off,
                                               int, int, int k0, int part) {
    const int g = part / 2;  // 32-group of the chunk
    const uint32_t* t = reinterpret_cast<const uint32_t*>(raw + 32);
    const float2 dmf = __half22float2(*reinterpret_cast<const __half2*>(raw + 44));
    float sc, mn;
    scale_min_k4(t[0], t[1], t[2], 2 * ((k0 % kQK) / 64) + g, sc, mn);
    const float dsc = dmf.x * sc;
    const uint4 q = *reinterpret_cast<const uint4*>(raw + 16 * (part % 2));
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
    uint32_t p[8];
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const uint32_t v = words[i / 4] >> (8 * (i % 4) + 4 * g);  // nibbles of bytes i, i + 1
      p[i / 2] = pack_bf16(dsc * small_int_minus(v & 0xfu, 8.f),
                           dsc * small_int_minus((v >> 8) & 0xfu, 8.f));
    }
    uint4* dst = reinterpret_cast<uint4*>(row + 16 * part);
    dst[0] = make_uint4(p[0], p[1], p[2], p[3]);
    dst[1] = make_uint4(p[4], p[5], p[6], p[7]);
    if (part % 2 == 0) *off = 8.f * dsc - dmf.y * mn;
  }
};

// The tensor-core GEMV's q4_k (dq_gemv.cuh): a stage is one superblock of
// the warp's 16 rows, its 128 payload bytes a row ([16][kPitch], 16 bytes of
// padding a row against ldmatrix bank conflicts), then each row's 12-byte
// table and d, dmin ([16][16]). Piece c is chunk c: byte j holds element 64c
// + j in its low nibble (group 2c) and 64c + 32 + j in its high nibble
// (group 2c + 1), q4_0's "byte j holds w[j] and w[j + 16]" at twice the
// stride: step s of a group is bytes 16s..16s + 15 (words r[2s], r[2s + 1]),
// nibble gi of each, so `nibble_pair` gives q - 8 exactly. `prepare` decodes
// the table once a row and superblock: lane l takes row l % 16 and groups
// l / 16 + 2i, writing d*sc and the affine offset 8 d*sc - dmin*mn to the
// warp's table ([group][row] each, so the reads of rows g and g + 8 fall on
// distinct banks).
struct Q4KGemv : SuperPlan {
  using Weight = Q4KTile::Weight;
  static constexpr int kStageK = kGvSuperK;
  static constexpr int kGroupK = 32;
  static constexpr int kPitch = kQK / 2 + 16;
  static constexpr int kMeta = 16 * kPitch;
  static constexpr int kStage = kMeta + 16 * 16;
  static constexpr int kPieces = 4, kGroups = 2, kSteps = 2;
  static constexpr int kWords = 4;
  static constexpr int kTable = 2 * 8 * 16;  // d*sc [8][16], then offsets [8][16]
  static constexpr bool kAffine = true;

  __device__ __forceinline__ static void copy(const Weight& w, unsigned char* stage, int lane, int n0,
                                              int N, int K, int kb, int) {
    const int nsb = K / kQK, sb = kb / kQK;
    copy_payload(w, stage, lane, n0, N, K, kb);
#pragma unroll
    for (int i = lane; i < 16 * 4; i += 32) {  // the table's 3 words and d, dmin a row
      const int r = i / 4, j = i % 4;
      const bool ok = n0 + r < N;
      const size_t sbi = static_cast<size_t>(ok ? n0 + r : 0) * nsb + sb;
      const void* src = j < 3 ? static_cast<const void*>(w.table + sbi * 12 + 4 * j)
                              : static_cast<const void*>(w.dm + sbi);
      cp_async4(smem_u32(stage + kMeta + 16 * r + 4 * j), src, ok);
    }
  }

  // the 16 rows' payload of superblock kb / 256: 8 pieces of 16 bytes a row
  __device__ __forceinline__ static void copy_payload(const Weight& w, unsigned char* stage, int lane, int n0,
                                                      int N, int K, int kb) {
    const int sb = kb / kQK;
#pragma unroll
    for (int i = lane; i < 16 * 8; i += 32) {
      const int r = i / 8, c = i % 8;
      const bool ok = n0 + r < N;
      const size_t row = ok ? n0 + r : 0;
      cp_async16(smem_u32(stage + r * kPitch + 16 * c), w.qs + row * (K / 2) + sb * 128 + 16 * c, ok);
    }
  }

  __device__ __forceinline__ static void prepare(const unsigned char* stage, float* table, int lane, int,
                                                 int, int) {
    const int r = lane % 16;
    const uint32_t* t = reinterpret_cast<const uint32_t*>(stage + kMeta + 16 * r);
    const float2 dmf = __half22float2(*reinterpret_cast<const __half2*>(t + 3));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = lane / 16 + 2 * i;
      float sc, mn;
      scale_min_k4(t[0], t[1], t[2], j, sc, mn);
      const float dsc = dmf.x * sc;
      table[16 * j + r] = dsc;
      table[128 + 16 * j + r] = 8.f * dsc - dmf.y * mn;
    }
  }

  __device__ __forceinline__ static void load(const unsigned char* stage, int lane, int p,
                                              uint32_t (&r)[kWords]) {
    ldmatrix_rows16(r, stage, kPitch, 32 * p, lane);
  }

  __device__ __forceinline__ static void a_frag(const uint32_t (&r)[kWords], int gi, int s,
                                                uint32_t (&a)[4]) {
    const uint32_t w0 = r[2 * s], w1 = r[2 * s + 1];
    a[0] = nibble_pair(w0 >> (4 * gi));
    a[1] = nibble_pair(w1 >> (4 * gi));
    a[2] = nibble_pair(w0 >> (4 * gi + 8));
    a[3] = nibble_pair(w1 >> (4 * gi + 8));
  }

  __device__ __forceinline__ static int x_off(int p, int gi, int s) { return 64 * p + 32 * gi + 16 * s; }

  __device__ __forceinline__ static void scales(const unsigned char*, const float* table, int g, int,
                                                int, int, int grp, float (&d)[2], float (&off)[2]) {
    d[0] = table[16 * grp + g];
    d[1] = table[16 * grp + g + 8];
    off[0] = table[128 + 16 * grp + g];
    off[1] = table[128 + 16 * grp + g + 8];
  }
};

// The instruments' q4_k ablations (bench_q4k_variants; ops/qmm_variants.py
// Q4_K_MODES): Q4KGemv with terms of its metadata math dropped. Neither has
// an affine part, so the block takes no per-32 sums of x and one barrier
// where Q4KGemv takes two.
//   kNoAffine  d*sc * (q - 8): `prepare` decodes the 6-bit scales alone into
//              a table of d*sc [8][16], no offsets
//   kNoSub     d * (q - 8): a stage copies the payload and each row's d,
//              dmin word, nothing is decoded, every group's scale is d
constexpr int kNoAffine = 1;
constexpr int kNoSub = 2;

template <int Mode>
struct Q4KAblation : Q4KGemv {
  static constexpr int kTable = Mode == kNoAffine ? 8 * 16 : 0;
  static constexpr bool kAffine = false;

  __device__ __forceinline__ static void copy(const Weight& w, unsigned char* stage, int lane, int n0,
                                              int N, int K, int kb, int khi) {
    if constexpr (Mode == kNoAffine) {
      Q4KGemv::copy(w, stage, lane, n0, N, K, kb, khi);
    } else {
      const int nsb = K / kQK, sb = kb / kQK;
      copy_payload(w, stage, lane, n0, N, K, kb);
      if (lane < 16) {  // d, dmin of row lane, where Q4KGemv puts it
        const bool ok = n0 + lane < N;
        cp_async4(smem_u32(stage + kMeta + 16 * lane + 12),
                  w.dm + static_cast<size_t>(ok ? n0 + lane : 0) * nsb + sb, ok);
      }
    }
  }

  __device__ __forceinline__ static void prepare(const unsigned char* stage, float* table, int lane, int,
                                                 int, int) {
    const int r = lane % 16;
    const uint32_t* t = reinterpret_cast<const uint32_t*>(stage + kMeta + 16 * r);
    const float d = __low2float(*reinterpret_cast<const __half2*>(t + 3));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = lane / 16 + 2 * i;
      float sc, mn;
      scale_min_k4(t[0], t[1], t[2], j, sc, mn);
      table[16 * j + r] = d * sc;
    }
  }

  __device__ __forceinline__ static void scales(const unsigned char* stage, const float* table, int g, int,
                                                int, int, int grp, float (&d)[2], float (&)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (Mode == kNoAffine)
        d[h] = table[16 * grp + g + 8 * h];
      else
        d[h] = __low2float(*reinterpret_cast<const __half2*>(stage + kMeta + 16 * (g + 8 * h) + 12));
    }
  }
};

// The f32 route's TF32 tile (dq_tile_tf32.cuh): Q4KTile's raw step and
// copies. A 16-wide unit u of the step is quarter u of Q4KTile's item
// order: nibble u / 2 (32-group 2c + u / 2) of payload bytes 16 (u % 2)
// .. + 15, so lane t's four weights are the nibbles of one payload word.
// `prepare` writes d*sc and the offset 8 d*sc - dmin*mn of the step's two
// 32-groups.
struct Q4KTf32 : Q4KTile {
  static constexpr int kGroupUnits = 2;

  __device__ __forceinline__ static void prepare(const uint8_t* raw, float* scale, float* off, int,
                                                 int, int k0, int grp) {
    const uint32_t* t = reinterpret_cast<const uint32_t*>(raw + 32);
    const float2 dmf = __half22float2(*reinterpret_cast<const __half2*>(raw + 44));
    float sc, mn;
    scale_min_k4(t[0], t[1], t[2], 2 * ((k0 % kQK) / 64) + grp, sc, mn);
    const float dsc = dmf.x * sc;
    *scale = dsc;
    *off = fmaf(-dmf.y, mn, 8.f * dsc);
  }

  __device__ __forceinline__ static void weights(const uint8_t* raw, int, int u, int t,
                                                 uint32_t (&b)[4]) {
    const uint32_t word = *reinterpret_cast<const uint32_t*>(raw + 16 * (u % 2) + 4 * t);
    bytes_minus((word >> (4 * (u / 2))) & 0x0F0F0F0Fu, 8.f, b);
  }
};

template <typename TX>
cudaError_t launch_q4_k(const void* x, const void* qs, const void* table, const void* dm, void* y,
                        void* work, void* tickets, int M, int N, int K, cudaStream_t s) {
  const TX* xp = static_cast<const TX*>(x);
  const Q4KTile::Weight w{static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(table),
                          static_cast<const __half2*>(dm)};
  float* yp = static_cast<float*>(y);
  if (M <= 8) {
    float* wk = static_cast<float*>(work);
    int* tk = static_cast<int*>(tickets);
    if constexpr (std::is_same<TX, float>::value)
      return launch_dq_gemv_f32<Q4KGemv>(xp, w, yp, wk, tk, M, N, K, s);
    else
      return launch_dq_gemv<Q4KGemv>(xp, w, yp, wk, tk, M, N, K, s);
  }
  if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
    return launch_dq_tile<Q4KTile>(xp, w, yp, static_cast<float*>(work), M, N, K, s);
  } else {
    return launch_dq_tile_tf32<Q4KTf32>(xp, w, yp, static_cast<float*>(work), M, N, K, s);
  }
}

}  // namespace

// launches of the TF32 tile (dq_tile_tf32.cuh), every format's, so far in
// this process
extern "C" unsigned long long gt_dq_tile_tf32_launches() {
  return dq_tile_tf32_launch_count.load(std::memory_order_relaxed);
}

// bytes of the f32 route's K-split scratch (gt_matmul_work_bytes): the
// GEMV's at M <= 8, which sets *tickets, and the TF32 tile's above
extern "C" size_t gt_q4_k_f32_work_bytes(int M, int N, int K, int* tickets) {
  if (M > 8) return dq_tile_tf32_work_bytes<Q4KTf32>(M, N, K);
  *tickets = dq_gemv_tickets<Q4KGemv, XF32>(M, N, K);
  return dq_gemv_work_bytes<Q4KGemv, XF32>(M, N, K);
}

// x: [M, K] f32 or bf16 (x_dtype), row-major contiguous; qs/scales/dm: the
// port's q4_k layout; y: [M, N] f32; work and tickets: the f32 scratch
// and the ints (0 on entry and on return) that gt_matmul_work_bytes(2,
// x_dtype, M, N, K, &tickets) gives (each null when its size is 0).
// Returns a cudaError_t value.
extern "C" int gt_q4_k_matmul(const void* x, int x_dtype, const void* qs, const void* scales,
                              const void* dm, void* y, void* work, void* tickets, int M, int N, int K,
                              void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kQK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kBF16)
    return static_cast<int>(launch_q4_k<__nv_bfloat16>(x, qs, scales, dm, y, work, tickets, M, N, K, s));
  if (x_dtype == kF32)
    return static_cast<int>(launch_q4_k<float>(x, qs, scales, dm, y, work, tickets, M, N, K, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The instruments' q4_k GEMV on the tensor cores with bf16 x [M <= 8, K] in
// `mode` (0 prod: the main path's instance, 1 noaffine, 2 nosub); y [M, N]
// f32; work and tickets: the main path's bf16 q4_k scratch
// (gt_matmul_work_bytes(2, bf16, M, N, K, &tickets)). Returns a cudaError_t
// value.
extern "C" int gt_q4_k_ablation(const void* x, int mode, const void* qs, const void* scales,
                                const void* dm, void* y, void* work, void* tickets, int M, int N, int K,
                                void* stream) {
  if (M <= 0 || M > 8 || N <= 0 || K <= 0 || K % kQK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const Q4KTile::Weight w{static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(scales),
                          static_cast<const __half2*>(dm)};
  auto* yp = static_cast<float*>(y);
  auto* wk = static_cast<float*>(work);
  auto* tk = static_cast<int*>(tickets);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (mode) {
    case 0: e = launch_q4_k<__nv_bfloat16>(x, qs, scales, dm, y, work, tickets, M, N, K, s); break;
    case kNoAffine: e = launch_dq_gemv<Q4KAblation<kNoAffine>>(xp, w, yp, wk, tk, M, N, K, s); break;
    case kNoSub: e = launch_dq_gemv<Q4KAblation<kNoSub>>(xp, w, yp, wk, tk, M, N, K, s); break;
    default: break;
  }
  return static_cast<int>(e);
}
