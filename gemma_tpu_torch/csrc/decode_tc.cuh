// The tensor-core decode (T = 1) attention core, shared by the dense cache
// (decode_attention.cu) and the page pools (paged_attention.cu).
//
// `decode_tc_kernel<D, E, Rows>`: 2 <= G = Hq / Hkv <= 8 (Gemma-2B's G = 8)
// over an element policy E: bf16 q over bf16 K/V (`DecBf16`) or int8 K/V
// with f32 scales a key, read in place (`DecInt8`), f32 q over f32 K/V
// (`DecTf32`, below the bf16 design), or f32 q over int8 K/V (`DecTf32Int8`,
// below that).
// The GEMV-on-tensor-cores pattern of dq_gemv.cuh with the cache in place
// of the weight: `mma.sync.m16n8k16` with the cache on the m16 side and the
// G query heads, zero-padded to 8 as the reference pads to MIN_DECODE_G, on
// the n8 side.
// * Scores: 16 keys of K (ldmatrix) are the A operand, q (held in
//   registers) the B operand: s [16 keys x 8 heads] over D / 16 k-steps.
//   The int8 arm's integers are exact in bf16; ks scales each score row
//   after the dot, s = (q . k8) * ks.
// * p . v: V^T (16 d x 16 keys, ldmatrix.trans) is the A operand, P (16
//   keys x 8 heads, bf16(p), int8: bf16(p * vs)) the B operand, through a
//   384-byte tile a warp in shared memory (the score fragment holds P
//   transposed): out [D x 8] in D / 16 m-tiles of f32 registers.
// * A block of kDecWarps warps takes `split` keys of one (b, kv head) (grid
//   ceil(S / split) x B * Hkv; split from ops/attention.py
//   `decode_tc_split`, measured: 64 keys up to S = 1024, up to 256 at S =
//   4096); its warps take the 16-key tiles in turn, each with its own
//   running max and sum, through 16-byte cp.async copies (int8: the raw
//   bytes, then widened to bf16 in shared memory) into a ring of two
//   stages where a warp has more than one tile, so the next tile loads
//   while this one multiplies; one stage at 64 keys a block keeps a
//   block's shared memory at 69 KB (D = 256: three blocks an SM). Keys
//   outside [max(limit - window, 0), limit) are masked; a split with no
//   live key reads nothing. The limit stays on the device, so the launch
//   can be captured in a CUDA graph once its workspace is sized beforehand
//   (kernels/build.py `workspace` grows it on demand).
// * Where a tile's 16 key rows lie is the policy `Rows`: the row of the
//   tile's first key (a multiple of 16), its rows consecutive from there.
//   `DenseRows`: the cache [B, Hkv, S, D], (b, kv head) bh's keys from row
//   bh * S. `PagedRows`: pools [P, Hkv, ps, D] through page_table [B,
//   maxp], with ps a multiple of 16 so that no tile straddles two pages:
//   the tile at logical key key0 reads page page_table[b, key0 / ps] at
//   row (page * Hkv + h) * ps + key0 % ps. The K/V copies and both int8
//   scale reads take the row from the policy, and only for a tile that
//   holds a live key: tiles past the limit, dead splits and the trash page
//   0 that dead table entries point at are never read.
// * The block merges its warps in shared memory, writes its partial (max,
//   sum, unnormalized output) and takes a ticket from a per-(b, kv head)
//   counter; the last block of the row merges all partials in split order
//   and resets the counter to 0 (`merge_splits_last`, which the G = 1 core
//   of decode_g1.cuh shares). One launch; the result does not depend on
//   which block finished last, so serving stays batch-invariant and
//   deterministic. The counters must start at 0 and launches that share
//   them must not overlap: `workspace` keeps one a stream.
// With the same S and split, both row policies run the same tiles in the
// same order with the same arithmetic, so paged attention equals dense
// decode attention on the gathered view bit for bit.
//
// `DecTf32`: f32 q over an f32 cache (f32 serving, --verify's f32 cache;
// the reference kernel's f32 arm: f32 scores, p kept in f32 as v's dtype).
// The skeleton above (tiles, ring, masks, softmax, both merges, tickets) is
// unchanged; the policy changes the operands:
// * both products on `mma.sync` m16n8k8 TF32 -> f32 in 3xTF32, each operand
//   split as `split_tf32` does (hi rounded, lo = v - hi truncated), lo.hi,
//   hi.lo, then hi.hi into the same accumulators (`mma_3xtf32`): neither
//   operand is an exact integer, so both need their small part, and the
//   products carry ~2^-21 of relative error: the output differs from the
//   plain f32 version by that and the order of f32 sums, ~1e-6 of each
//   row's scale;
// * the cache stays on the m16 side, the query heads on n8. Scores: D is
//   permuted within each 16-wide unit u the same way for K and q (k8 step
//   s, slot t: element 16u + 4t + 2s; slot t + 4: + 1, as the TF32 flash
//   kernel), so a lane's A values of both k8 steps are one 16-byte load of
//   K row g and one of g + 8 at pitch D + 16 floats (the 2 rows x 4 chunks
//   of a load phase on distinct banks), its B values one 16-byte load of
//   q's hi and one of its lo: q split once a block into two planes [8
//   heads][D + 16] in shared memory (heads >= G: 0);
// * p . v: V^T (16 d x 8 keys, slot t = key t, slot t + 4 = key t + 4) is
//   the A operand, read as scalars at pitch D + 8 floats (the 8 x 4 lanes
//   of V row t, column g, on distinct banks), and P the B operand through
//   an f32 tile [8 heads][20] a warp (rows and columns on distinct banks),
//   so the output fragment is the bf16 design's and its merges are shared;
// * f32 tiles are twice the bytes: a ring stage of 16 keys is 34 KB at D =
//   256, so each warp holds one (154 KB a block with q's planes: one an
//   SM), its K and V in cp.async groups of their own: the next tile's K
//   loads once the scores have read this one's, its V once P . V has; at D
//   = 128 two stages where a warp has more than one tile (152 KB), as bf16.
// Expected (written before the first run on the card; the bf16 core's
// 0.0120 ms at S = 512, limit 204, and 0.0189 / 0.0204 at S = 4096, with
// twice the bytes and three times the products): at Gemma-2B's heads S =
// 512, limit 204 0.015-0.025 ms (the split-S kernel it replaces there
// 0.0370, f32 SDPA 0.0480), S = 4096 full 0.03-0.06 (0.1706, SDPA 0.1398,
// plain 0.0752), within 1e-4 of each row's scale; rows without a live key
// exactly 0. What the card measured: PERF.md section 6.
//
// `DecTf32Int8`: f32 q over an int8 cache (f32 serving with --kv-quant;
// the reference kernel's int8 arm with f32 queries: s = (q . k8) * ks, out
// = bf16(p * vs) . v8). The skeleton is unchanged; the operands:
// * scores in TF32 on m16n8k8 as `DecTf32` lays them out (the same D
//   permutation, q's hi and lo planes staged once a block), but an int8 key
//   is exact in one TF32 part, so a k8 step takes two products, K . lo(q)
//   then K . hi(q), into the same accumulators: each product carries ~2^-21
//   of relative error, as 3xTF32's. The raw int8 K tile stays in shared
//   memory at a pitch of D + 16 bytes (a lane's four keys of a unit one
//   32-bit load, the 8 rows x 4 lanes of a load on distinct banks) and
//   each byte becomes its f32 value in registers (`bytes_minus`: a byte
//   permute and a subtract); ks scales each score after the dot;
// * p . v as `DecInt8` takes it: the raw V tile widened to bf16 in shared
//   memory, P = bf16(p * vs), bf16 `mma.sync` m16n8k16 into f32, so the
//   output fragment and both merges are the bf16 design's;
// * a ring stage of 16 keys is 8.3 KB at D = 256 (K at its pitch, V raw),
//   with a bf16 V tile and P a warp and q's planes (17 KB) a block: 86 KB a
//   block at one stage (two blocks an SM), 120 KB at two.
// Expected (written before the first run on the card): at Gemma-2B's heads
// S = 512, limit 204 0.014-0.02 ms (the split-S kernel it replaces there
// 0.0363, the bf16-q int8 core 0.0134), within 2e-2 of each row's scale
// (p * vs rounds to bf16, as in the int8 arm); through 64-key pages over
// the 8 serving rows equal to the dense core on the gathered pages bit for
// bit. With `PagedRows`, `DecTf32` likewise (f32 pages: 0.013-0.02 ms over
// the serving rows against the split-S kernel's 0.0441). What the card
// measured: PERF.md section 6.
#pragma once

#include "attn_tc.cuh"

namespace {

using namespace gt;

constexpr int kDecWarps = 4;

// the element policies: the query's and the cache's element types
struct DecBf16 {
  using TQ = __nv_bfloat16;
  using TKV = __nv_bfloat16;
  static constexpr bool kInt8 = false, kF32 = false;
};
struct DecInt8 {
  using TQ = __nv_bfloat16;
  using TKV = int8_t;
  static constexpr bool kInt8 = true, kF32 = false;
};
struct DecTf32 {
  using TQ = float;
  using TKV = float;
  static constexpr bool kInt8 = false, kF32 = true;
};
struct DecTf32Int8 {
  using TQ = float;
  using TKV = int8_t;
  static constexpr bool kInt8 = true, kF32 = false;
};

// ring stages a warp: one where each warp has one 16-key tile a split
__host__ __device__ constexpr int decode_tc_stages(int split) { return split > 16 * kDecWarps ? 2 : 1; }

template <int D, class E>
struct DecodeTc {
  static constexpr bool kInt8 = E::kInt8;
  // f32 q (`DecTf32`, `DecTf32Int8`): its hi and lo planes in shared memory
  static constexpr bool kQ32 = sizeof(typename E::TQ) == 4;
  static constexpr bool kQ32Int8 = kQ32 && kInt8;  // `DecTf32Int8`
  static constexpr int kLdK8 = D + 16;  // DecTf32Int8: byte pitch of a raw K row
  static constexpr int kLd = D + 8;          // bf16 pitch of a staged K or V row (ldmatrix
                                             // phases on distinct banks)
  static constexpr int kTile = 16 * kLd * 2;  // bytes of a 16-key bf16 K or V tile
  static constexpr int kRawTile = 16 * D;     // bytes of a 16-key int8 K or V tile
  static constexpr int kPLd = 24;             // bf16 pitch of a warp's P [8 heads][16 keys]
  // DecTf32: f32 pitches of K and q's planes, of V, and of P [8 heads][16 keys]
  static constexpr int kLdK = D + 16, kLdV = D + 8, kPLd32 = 20;
  static constexpr int kVOff = 16 * kLdK * 4;  // bytes of a stage's K tile (DecTf32)
  // a warp's share: `stages` ring stages of K and V (bf16, or int8 raw
  // bytes and then one bf16 pair they widen into, or f32; DecTf32Int8: raw K
  // at kLdK8 and raw V, then the bf16 V tile V widens into), and P
  static constexpr int kStage = E::kF32 ? 16 * (kLdK + kLdV) * 4
                                : kQ32Int8 ? 16 * kLdK8 + kRawTile
                                : kInt8 ? 2 * kRawTile : 2 * kTile;
  static constexpr int kWiden = kQ32Int8 ? kTile : kInt8 ? 2 * kTile : 0;  // the widened bf16 tiles
  static constexpr int kQ = kQ32 ? 2 * 8 * kLdK * 4 : 0;  // q's hi and lo planes, before the warps'
  __host__ __device__ static constexpr int warp_bytes(int stages) {
    return E::kF32 ? stages * kStage + 8 * kPLd32 * 4 : stages * kStage + kWiden + 8 * kPLd * 2;
  }
  // ring stages a warp at `split` keys a block: f32 at D = 256, one
  __host__ __device__ static constexpr int stages(int split) {
    return E::kF32 && D == 256 ? 1 : decode_tc_stages(split);
  }
  // q's planes and the warps' shares, reused for the block's merge
  // ([kDecWarps][8][D] f32) and the last block's ([2][n_splits][G] f32)
  static size_t bytes(int stages, int n_splits, int G) {
    const size_t warps = kQ + static_cast<size_t>(kDecWarps) * warp_bytes(stages);
    const size_t merge = static_cast<size_t>(kDecWarps) * 8 * D * 4;
    const size_t last = static_cast<size_t>(2) * n_splits * G * 4;
    return warps > merge ? (warps > last ? warps : last) : (merge > last ? merge : last);
  }
};

// the dense cache [B, Hkv, S, D] (scales [B, Hkv, S])
struct DenseRows {
  int S;
  __device__ __forceinline__ size_t operator()(int bh, int key0) const {
    return static_cast<size_t>(bh) * S + key0;
  }
};

// pools [P, Hkv, ps, D] (scales [P, Hkv, ps]) through table [B, maxp]; the
// row of key key0 (decode_tc_kernel: a tile's first, key0 % 16 == 0 and ps
// % 16 == 0, so the tile lies in one page; decode_g1.cuh: any key, any ps)
struct PagedRows {
  const int* table;
  int Hkv, ps, maxp;
  __device__ __forceinline__ size_t operator()(int bh, int key0) const {
    const int b = bh / Hkv, h = bh % Hkv;
    const int page = __ldg(table + static_cast<size_t>(b) * maxp + key0 / ps);
    return (static_cast<size_t>(page) * Hkv + h) * ps + key0 % ps;
  }
};

// 16 int8 values -> 16 bf16 values (exact), as 8 words
__device__ __forceinline__ void widen_int8x16(const int4 raw, uint32_t (&w)[8]) {
  const uint32_t in[4] = {static_cast<uint32_t>(raw.x), static_cast<uint32_t>(raw.y),
                          static_cast<uint32_t>(raw.z), static_cast<uint32_t>(raw.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const auto q = [&](int j) { return static_cast<float>(static_cast<int8_t>((in[i] >> (8 * j)) & 0xFF)); };
    w[2 * i] = pack_bf16(q(0), q(1));
    w[2 * i + 1] = pack_bf16(q(2), q(3));
  }
}

// The f32 policy's products on one 16-key tile (`DecTf32`, header).
template <int D>
struct DecTf32Ops {
  using L = DecodeTc<D, DecTf32>;
  static constexpr int kLdK = L::kLdK, kLdV = L::kLdV;

  // q [G][D] f32 -> its hi and lo planes [8][kLdK] (heads >= G: 0), by the block
  static __device__ __forceinline__ void stage_q(const float* __restrict__ q, uint32_t* qhi, uint32_t* qlo,
                                                 int G) {
    for (int i = threadIdx.x; i < 8 * D; i += kDecWarps * 32) {
      const int h = i / D, d = i % D;
      uint32_t hi, lo;
      split_tf32(h < G ? __ldg(q + i) : 0.f, hi, lo);
      qhi[h * kLdK + d] = hi;
      qlo[h * kLdK + d] = lo;
    }
  }

  // sa, sb += K q on the tile kt [16][kLdK] (two chains over the units): k8
  // step s of unit u takes elements 16u + 4t + 2s (slot t) and + 1 (slot t
  // + 4): a0 = (key g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8,
  // t + 4); b0 = (slot t, head g), b1 = (slot t + 4, head g)
  static __device__ __forceinline__ void scores(float (&sa)[4], float (&sb)[4], const float* kt,
                                                const uint32_t* qhi, const uint32_t* qlo, int lane) {
    const int g = lane / 4, t = lane % 4;
    const float* kl = kt + g * kLdK + 4 * t;
    const uint32_t* qh = qhi + g * kLdK + 4 * t;
    const uint32_t* ql = qlo + g * kLdK + 4 * t;
#pragma unroll
    for (int u = 0; u < D / 16; ++u) {
      const float4 x0 = *reinterpret_cast<const float4*>(kl + 16 * u);
      const float4 x1 = *reinterpret_cast<const float4*>(kl + 8 * kLdK + 16 * u);
      const uint4 bh = *reinterpret_cast<const uint4*>(qh + 16 * u);
      const uint4 bl = *reinterpret_cast<const uint4*>(ql + 16 * u);
      uint32_t ah[2][4], al[2][4];
      split_tf32(x0.x, ah[0][0], al[0][0]);
      split_tf32(x1.x, ah[0][1], al[0][1]);
      split_tf32(x0.y, ah[0][2], al[0][2]);
      split_tf32(x1.y, ah[0][3], al[0][3]);
      split_tf32(x0.z, ah[1][0], al[1][0]);
      split_tf32(x1.z, ah[1][1], al[1][1]);
      split_tf32(x0.w, ah[1][2], al[1][2]);
      split_tf32(x1.w, ah[1][3], al[1][3]);
      mma_3xtf32(u % 2 ? sb : sa, ah[0], al[0], bh.x, bh.y, bl.x, bl.y);
      mma_3xtf32(u % 2 ? sb : sa, ah[1], al[1], bh.z, bh.w, bl.z, bl.w);
    }
  }

  // o += V^T P on the tile vt [16][kLdV] and the warp's P pt [8][kPLd32]:
  // k8 step kk takes keys 8 kk + t (slot t) and + 4 (slot t + 4); a0 = (d
  // 16 mt + g, slot t), a1 = (d + 8, t), a2 = (d, t + 4), a3 = (d + 8, t +
  // 4); b0 = (slot t, head g), b1 = (slot t + 4, head g); o scaled by al
  // first (c0, c2: head 2t; c1, c3: head 2t + 1)
  static __device__ __forceinline__ void pv(float (&o)[D / 16][4], const float (&al)[2], const float* vt,
                                            const float* pt, int lane) {
    const int g = lane / 4, t = lane % 4;
    uint32_t bh[2][2], bl[2][2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      split_tf32(pt[g * L::kPLd32 + 8 * kk + t], bh[kk][0], bl[kk][0]);
      split_tf32(pt[g * L::kPLd32 + 8 * kk + t + 4], bh[kk][1], bl[kk][1]);
    }
    const float* vl = vt + t * kLdV + g;
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      o[mt][0] *= al[0];
      o[mt][1] *= al[1];
      o[mt][2] *= al[0];
      o[mt][3] *= al[1];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float* vk = vl + 8 * kk * kLdV + 16 * mt;
        uint32_t ah[4], alo[4];
        split_tf32(vk[0], ah[0], alo[0]);
        split_tf32(vk[8], ah[1], alo[1]);
        split_tf32(vk[4 * kLdV], ah[2], alo[2]);
        split_tf32(vk[4 * kLdV + 8], ah[3], alo[3]);
        mma_3xtf32(o[mt], ah, alo, bh[kk][0], bh[kk][1], bl[kk][0], bl[kk][1]);
      }
    }
  }
};

// The `DecTf32Int8` policy's scores on one 16-key tile (header).
template <int D>
struct DecTf32Int8Ops {
  static constexpr int kLdK8 = DecodeTc<D, DecTf32Int8>::kLdK8, kLdQ = DecodeTc<D, DecTf32Int8>::kLdK;

  // sa, sb += K q on the raw int8 tile kt [16][kLdK8] and q's planes [8][kLdQ]
  // (two chains over the units): the elements of `DecTf32Ops::scores`, a
  // lane's four bytes of key g (and g + 8) in unit u one 32-bit word, each
  // byte its f32 value (exact: one TF32 part, no lo); K . lo(q), then K .
  // hi(q), a k8 step
  static __device__ __forceinline__ void scores(float (&sa)[4], float (&sb)[4], const unsigned char* kt,
                                                const uint32_t* qhi, const uint32_t* qlo, int lane) {
    const int g = lane / 4, t = lane % 4;
    const unsigned char* kl = kt + g * kLdK8 + 4 * t;
    const uint32_t* qh = qhi + g * kLdQ + 4 * t;
    const uint32_t* ql = qlo + g * kLdQ + 4 * t;
#pragma unroll
    for (int u = 0; u < D / 16; ++u) {
      uint32_t x0[4], x1[4];  // elements 16u + 4t + i of keys g and g + 8
      bytes_minus(*reinterpret_cast<const uint32_t*>(kl + 16 * u) ^ 0x80808080u, 128.f, x0);
      bytes_minus(*reinterpret_cast<const uint32_t*>(kl + 8 * kLdK8 + 16 * u) ^ 0x80808080u, 128.f, x1);
      const uint4 bh = *reinterpret_cast<const uint4*>(qh + 16 * u);
      const uint4 bl = *reinterpret_cast<const uint4*>(ql + 16 * u);
      const uint32_t a0[4] = {x0[0], x1[0], x0[1], x1[1]}, a1[4] = {x0[2], x1[2], x0[3], x1[3]};
      float(&c)[4] = u % 2 ? sb : sa;
      mma_1688_tf32(c, a0, bl.x, bl.y);
      mma_1688_tf32(c, a0, bh.x, bh.y);
      mma_1688_tf32(c, a1, bl.z, bl.w);
      mma_1688_tf32(c, a1, bh.z, bh.w);
    }
  }
};

// The merge of a decode core's splits, in the same launch: the splits
// sp_lo .. sp_hi - 1 of (b, kv head) bh's n_splits each write a partial
// (part_m, part_l [B * Hkv][n_splits][G], part_o [..][G][D], f32) and take
// a ticket from bh's counter; the last of them to arrive merges their
// partials in split order into out [.., G, D] (the splits' statistics
// staged in smem, 2 * (sp_hi - sp_lo) * G floats, by all its threads; a
// warp a head for the weights; four splits' loads in flight a thread for
// the outputs) and resets the counter to 0. The result does not depend on
// which block finished last. `decode_tc_kernel` runs every split (sp_lo =
// 0, sp_hi = n_splits; a split without a live key writes an empty
// partial), `decode_g1_kernel` (decode_g1.cuh) only those that hold a live
// key. kMaxG: the largest G of the caller, so a thread holds kMaxG * D /
// kThreads outputs.
template <int D, int kMaxG, int kThreads, typename TQ>
__device__ __forceinline__ void merge_splits_last(const float* __restrict__ part_m,
                                                  const float* __restrict__ part_l,
                                                  const float* __restrict__ part_o, TQ* __restrict__ out,
                                                  int* __restrict__ tickets, int bh, int G, int n_splits,
                                                  int sp_lo, int sp_hi, float* smem) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int s_last;
  __shared__ float s_inv[kMaxG];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __threadfence();
  __syncthreads();
  const int n = sp_hi - sp_lo;  // the splits merged
  if (threadIdx.x == 0) s_last = atomicAdd(tickets + bh, 1) == n - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const size_t base = (static_cast<size_t>(bh) * n_splits + sp_lo) * G;
  float* sw = smem;        // [n][G]: m, then each split's weight
  float* sl = sw + n * G;  // [n][G]: l
  for (int i = threadIdx.x; i < n * G; i += kThreads) {
    sw[i] = __ldcg(part_m + base + i);
    sl[i] = __ldcg(part_l + base + i);
  }
  __syncthreads();
  // a warp a head: the max over live splits, each split's weight, and the
  // sum of weight x l in a fixed order (lane-strided, then a shuffle tree)
  for (int h = warp; h < G; h += kWarps) {
    float mx = -INFINITY;
    for (int sp_ = lane; sp_ < n; sp_ += 32)
      if (sl[sp_ * G + h] > 0.f) mx = fmaxf(mx, sw[sp_ * G + h]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int sp_ = lane; sp_ < n; sp_ += 32) {
      const float ls = sl[sp_ * G + h];
      const float w = ls > 0.f ? expf(sw[sp_ * G + h] - mx) : 0.f;
      sw[sp_ * G + h] = w;
      sum = fmaf(w, ls, sum);
    }
    sum = warp_sum(sum);
    if (lane == 0) s_inv[h] = sum == 0.f ? 1.f : 1.f / sum;
  }
  __syncthreads();
  // outputs i = threadIdx.x + kThreads * e of this thread, summed over the
  // splits in order, four splits' loads in flight at a time (dead splits:
  // weight 0, nothing read)
  constexpr int kE = kMaxG * D / kThreads;
  const int NE = G * D / kThreads;
  float acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = 0.f;
  for (int s4 = 0; s4 < n; s4 += 4) {
    float val[4][kE], wt[4][kE];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int i = threadIdx.x + e * kThreads;
        const bool in = e < NE && s4 + u < n;
        wt[u][e] = in ? sw[(s4 + u) * G + i / D] : 0.f;
        val[u][e] = wt[u][e] > 0.f ? __ldcg(part_o + (base + (s4 + u) * G) * D + i) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = fmaf(wt[u][e], val[u][e], acc[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int i = threadIdx.x + e * kThreads;
    if (e < NE) out[static_cast<size_t>(bh) * G * D + i] = from_f32<TQ>(acc[e] * s_inv[i / D]);
  }
  if (threadIdx.x == 0) tickets[bh] = 0;
}

// q [B * Hkv, G, D]; S: the logical keys of a row (the dense cache's S, or
// maxp * ps); work: part_m, part_l [B * Hkv][n_splits][G] then part_o
// [..][G][D], f32
template <int D, class E, class Rows>
__global__ void __launch_bounds__(kDecWarps * 32)
decode_tc_kernel(const typename E::TQ* __restrict__ q, const void* __restrict__ k,
                 const void* __restrict__ v, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale, const int* __restrict__ kv_limit,
                 float* __restrict__ work, int* __restrict__ tickets,
                 typename E::TQ* __restrict__ out, const Rows rows, int Hkv, int G, int S,
                 int split, int n_splits, int window, float softcap) {
  using L = DecodeTc<D, E>;
  using TKV = typename E::TKV;
  constexpr bool kInt8 = E::kInt8;
  constexpr int kLd = L::kLd, kThreads = kDecWarps * 32;
  extern __shared__ __align__(128) unsigned char dec_smem[];
  __shared__ float s_m[kDecWarps][8], s_l[kDecWarps][8];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int sp = blockIdx.x, bh = blockIdx.y, b = bh / Hkv;
  const int limit = min(kv_limit[b], S);
  const int live_lo = window > 0 ? max(limit - window, 0) : 0;
  const int s0 = sp * split;
  const int kbeg = max(s0, live_lo), kend = min(s0 + split, limit);  // live keys [kbeg, kend)
  const size_t npart = static_cast<size_t>(gridDim.y) * n_splits * G;
  float* part_m = work;
  float* part_l = work + npart;
  float* part_o = work + 2 * npart;
  const size_t pidx = (static_cast<size_t>(bh) * n_splits + sp) * G;

  if (kbeg < kend) {
    const TKV* kp = static_cast<const TKV*>(k);
    const TKV* vp = static_cast<const TKV*>(v);
    // q as the B operand: lane (g, t) holds q[head g][16 kk + 2t (+8) + {0, 1}]; heads >= G: 0
    // (DecTf32: q's planes in shared memory, staged below)
    uint32_t qf[D / 16][2];
    if constexpr (!L::kQ32) {
      const uint32_t* qh = reinterpret_cast<const uint32_t*>(q + (static_cast<size_t>(bh) * G + g) * D) + t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qf[kk][0] = g < G ? __ldg(qh + kk * 8) : 0u;
        qf[kk][1] = g < G ? __ldg(qh + kk * 8 + 4) : 0u;
      }
    }
    const int kb0 = s0 + (kbeg - s0) / 16 * 16;
    const int ntile = (kend - kb0 + 15) / 16;  // the block's 16-key tiles; the warp's: warp, warp + W, ..
    const int mine = ntile > warp ? (ntile - warp + kDecWarps - 1) / kDecWarps : 0;
    const int stages = L::stages(split);
    unsigned char* wbase = dec_smem + L::kQ + warp * L::warp_bytes(stages);
    __nv_bfloat16* pt = reinterpret_cast<__nv_bfloat16*>(wbase + stages * L::kStage + L::kWiden);
    float* pt32 = reinterpret_cast<float*>(wbase + stages * L::kStage);  // DecTf32's P
    uint32_t* qhi = reinterpret_cast<uint32_t*>(dec_smem);  // f32 q's planes
    uint32_t* qlo = qhi + 8 * L::kLdK;

    // DecTf32: K (which 0, at pitch kLdK) or V (1, at kLdV) of the warp's
    // j-th tile into stage j % stages
    auto issue_f32 = [&](int j, int which) {
      const int key0 = kb0 + 16 * (warp + j * kDecWarps);
      const size_t row0 = rows(bh, key0);
      unsigned char* st = wbase + (j % stages) * L::kStage + (which ? L::kVOff : 0);
      const TKV* src = which ? vp : kp;
      const int ld = which ? L::kLdV : L::kLdK;
#pragma unroll 8
      for (int c = lane; c < 16 * (D / 4); c += 32) {
        const int r = c / (D / 4), d = (c % (D / 4)) * 4;
        const bool ok = key0 + r < kend;
        cp_async16(smem_u32(st + (r * ld + d) * 4), ok ? src + (row0 + r) * D + d : src, ok);
      }
    };
    // the warp's j-th tile (keys past kend: zeros, nothing read) into stage j % stages
    auto issue = [&](int j) {
      const int key0 = kb0 + 16 * (warp + j * kDecWarps);
      const size_t row0 = rows(bh, key0);  // key0 < kend: the tile holds a live key
      unsigned char* st = wbase + (j % stages) * L::kStage;
      constexpr int kChunks = D * static_cast<int>(sizeof(TKV)) / 16;  // 16-byte pieces a row
      if constexpr (E::kF32) {
        issue_f32(j, 0);
        issue_f32(j, 1);
      } else if constexpr (L::kQ32Int8) {  // K at pitch kLdK8, then V at D
#pragma unroll
        for (int c = lane; c < 16 * kChunks; c += 32) {
          const int r = c / kChunks, d = (c % kChunks) * 16;
          const bool ok = key0 + r < kend;
          const size_t off = (row0 + r) * D + d;
          cp_async16(smem_u32(st + r * L::kLdK8 + d), ok ? kp + off : kp, ok);
          cp_async16(smem_u32(st + 16 * L::kLdK8 + r * D + d), ok ? vp + off : vp, ok);
        }
      } else {
#pragma unroll
        for (int c = lane; c < 16 * kChunks; c += 32) {
          const int r = c / kChunks, d = (c % kChunks) * (16 / static_cast<int>(sizeof(TKV)));
          const bool ok = key0 + r < kend;
          const size_t off = (row0 + r) * D + d;
          const int dst = kInt8 ? r * D + d : (r * kLd + d) * 2;
          cp_async16(smem_u32(st + dst), ok ? kp + off : kp, ok);
          cp_async16(smem_u32(st + L::kStage / 2 + dst), ok ? vp + off : vp, ok);
        }
      }
    };

    float o[D / 16][4];
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // heads 2t, 2t + 1 (l: this lane's keys)

    // DecTf32 at one stage a warp: K and V of a tile in cp.async groups of
    // their own, so the next tile's K loads once the scores have read this
    // one's and its V once P . V has read this one's
    constexpr bool kOneStage = E::kF32 && L::stages(1 << 20) == 1;
    if constexpr (kOneStage) {
      if (mine > 0) issue_f32(0, 0);
      cp_async_commit();
      if (mine > 0) issue_f32(0, 1);
      cp_async_commit();
    } else {
      if (mine > 0) issue(0);
      cp_async_commit();
    }
    if constexpr (L::kQ32) {  // q's planes, while the first tiles land
      DecTf32Ops<D>::stage_q(q + static_cast<size_t>(bh) * G * D, qhi, qlo, G);
      __syncthreads();
    }
    for (int j = 0; j < mine; ++j) {
      if constexpr (kOneStage) {
        cp_async_wait<1>();  // K of tile j landed (its V may be in flight)
        __syncwarp();
      } else {
        if (j + 1 < mine) issue(j + 1);  // into the stage tile j - 1 freed (stages == 2)
        cp_async_commit();
        cp_async_wait<1>();  // tile j landed: this lane's copies,
        __syncwarp();        // and the warp's
      }
      const int key0 = kb0 + 16 * (warp + j * kDecWarps);
      const unsigned char* st = wbase + (j % stages) * L::kStage;
      const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(st);
      const __nv_bfloat16* vt = reinterpret_cast<const __nv_bfloat16*>(st + L::kTile);
      if constexpr (L::kQ32Int8) {  // widen V's integers to bf16, exactly (K is read raw)
        __nv_bfloat16* cv = reinterpret_cast<__nv_bfloat16*>(wbase + stages * L::kStage);
#pragma unroll
        for (int c = lane; c < 16 * (D / 16); c += 32) {
          const int r = c / (D / 16), d = (c % (D / 16)) * 16;
          uint32_t w[8];
          widen_int8x16(*reinterpret_cast<const int4*>(st + 16 * L::kLdK8 + r * D + d), w);
          uint4* dst = reinterpret_cast<uint4*>(cv + r * kLd + d);
          dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
          dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
        }
        __syncwarp();
        vt = cv;
      } else if constexpr (kInt8) {  // widen the tile's integers to bf16, exactly
        __nv_bfloat16* cv = reinterpret_cast<__nv_bfloat16*>(wbase + stages * L::kStage);
#pragma unroll
        for (int c = lane; c < 2 * 16 * (D / 16); c += 32) {
          const int which = c / (16 * (D / 16)), cc = c % (16 * (D / 16));
          const int r = cc / (D / 16), d = (cc % (D / 16)) * 16;
          uint32_t w[8];
          widen_int8x16(*reinterpret_cast<const int4*>(st + which * L::kRawTile + r * D + d), w);
          uint4* dst = reinterpret_cast<uint4*>(cv + which * (L::kTile / 2) + r * kLd + d);
          dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
          dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
        }
        __syncwarp();
        kt = cv;
        vt = cv + L::kTile / 2;
      }
      // s = K q: two accumulator chains over the k16 steps
      float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (L::kQ32Int8) {
        DecTf32Int8Ops<D>::scores(sa, sb, st, qhi, qlo, lane);
      } else if constexpr (E::kF32) {
        DecTf32Ops<D>::scores(sa, sb, reinterpret_cast<const float*>(st), qhi, qlo, lane);
        if constexpr (kOneStage) {
          __syncwarp();  // K of tile j consumed: tile j + 1's K into it
          if (j + 1 < mine) issue_f32(j + 1, 0);
          cp_async_commit();
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(a, smem_u32(kt + (lane % 16) * kLd + kk * 16 + (lane / 16) * 8));
          mma_16816(kk % 2 ? sb : sa, a, qf[kk][0], qf[kk][1]);
        }
      }
      // the tile's scale rows (int8); c0: key g, head 2t; c1: key g, head
      // 2t + 1; c2, c3: key g + 8
      const size_t srow = kInt8 ? rows(bh, key0) + g : 0;
      float sc[4], tmx[2] = {kMaskValue, kMaskValue};
      bool ok[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + g + 8 * (e / 2);
        ok[e] = key >= kbeg && key < kend && 2 * t + e % 2 < G;
        float x = sa[e] + sb[e];
        if constexpr (kInt8) x *= ok[e] ? k_scale[srow + 8 * (e / 2)] : 0.f;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        sc[e] = ok[e] ? x : kMaskValue;
        tmx[e % 2] = fmaxf(tmx[e % 2], sc[e]);
      }
      float al[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mn = fmaxf(m[h], col_max(tmx[h]));
        al[h] = expf(m[h] - mn);
        m[h] = mn;
      }
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ok[e] ? expf(sc[e] - m[e % 2]) : 0.f;
        float w = p[e];
        if constexpr (kInt8) w *= ok[e] ? v_scale[srow + 8 * (e / 2)] : 0.f;
        if constexpr (E::kF32) {
          pt32[(2 * t + e % 2) * L::kPLd32 + g + 8 * (e / 2)] = w;
        } else {
          pt[(2 * t + e % 2) * L::kPLd + g + 8 * (e / 2)] = __float2bfloat16_rn(w);
        }
      }
      l[0] = l[0] * al[0] + (p[0] + p[2]);
      l[1] = l[1] * al[1] + (p[1] + p[3]);
      __syncwarp();
      if constexpr (E::kF32) {
        if constexpr (kOneStage) {
          cp_async_wait<1>();  // V of tile j landed (tile j + 1's K may be in flight)
          __syncwarp();
        }
        DecTf32Ops<D>::pv(o, al, reinterpret_cast<const float*>(st + L::kVOff), pt32, lane);
      } else {
        // P as the B operand: P[keys 2t (+8) + {0, 1}][head g]
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(pt + g * L::kPLd + 2 * t);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(pt + g * L::kPLd + 8 + 2 * t);
        // out += V^T P: m-tile mt is d 16 mt.., c0: (d g, head 2t), c1: head 2t + 1, c2, c3: d g + 8
#pragma unroll
        for (int mt = 0; mt < D / 16; ++mt) {
          o[mt][0] *= al[0];
          o[mt][1] *= al[1];
          o[mt][2] *= al[0];
          o[mt][3] *= al[1];
          uint32_t a[4];
          ldmatrix_x4_trans(a, smem_u32(vt + ((lane / 16) * 8 + lane % 8) * kLd + mt * 16 +
                                        ((lane / 8) % 2) * 8));
          mma_16816(o[mt], a, b0, b1);
        }
      }
      __syncwarp();  // stage j % stages and P consumed
      if constexpr (kOneStage) {
        if (j + 1 < mine) issue_f32(j + 1, 1);
        cp_async_commit();
      }
    }
    cp_async_wait<0>();

    // merge the warps: each scaled to the block's max, summed in warp order
    l[0] = col_sum(l[0]);
    l[1] = col_sum(l[1]);
    if (g == 0) {
      s_m[warp][2 * t] = m[0];
      s_m[warp][2 * t + 1] = m[1];
      s_l[warp][2 * t] = l[0];
      s_l[warp][2 * t + 1] = l[1];
    }
    __syncthreads();  // every warp is done with its ring: the merge buffer reuses it
    float f[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, s_m[w][2 * t + h]);
      f[h] = expf(m[h] - mx);
    }
    float* red = reinterpret_cast<float*>(dec_smem);  // [kDecWarps][8][D]
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * 8 + 2 * t + e % 2) * D + mt * 16 + g + 8 * (e / 2)] = o[mt][e] * f[e % 2];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * D; i += kThreads) {
      const int h = i / D, d = i % D;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) acc += red[(w * 8 + h) * D + d];
      part_o[pidx * D + i] = acc;
    }
    if (threadIdx.x < G) {
      const int h = threadIdx.x;
      float mx = -INFINITY, sum = 0.f;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, s_m[w][h]);
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) sum += s_l[w][h] * expf(s_m[w][h] - mx);
      part_m[pidx + h] = mx;
      part_l[pidx + h] = sum;
    }
  } else {
    write_dead_split(part_m + pidx, part_l + pidx, G);
  }

  // the last block of (b, kv head) to finish merges the partials in split order
  merge_splits_last<D, 8, kThreads>(part_m, part_l, part_o, out, tickets, bh, G, n_splits, 0, n_splits,
                                    reinterpret_cast<float*>(dec_smem));
}

// One launch of the core: q [B, Hq, D] (E::TQ) with G = Hq / Hkv <= 8; k/v
// and their scales where `rows` finds them; S logical keys a row; work: B *
// Hkv * n_splits * G * (D + 2) f32, n_splits = ceil(S / split); tickets: B
// * Hkv ints, 0 on entry and on return; split: a multiple of 16. The
// kernel's shared memory limit is raised once a device and size
// (`raise_smem_limit`).
template <int D, class E, class Rows>
int launch_decode_tc(const void* q, const void* k, const void* v, const float* k_scale,
                     const float* v_scale, const int* kv_limit, void* out, float* work, int* tickets,
                     const Rows& rows, int B, int Hq, int Hkv, int S, int split, int window,
                     float softcap, cudaStream_t s) {
  using L = DecodeTc<D, E>;
  using TQ = typename E::TQ;
  static std::atomic<int> limits[kSmemDevices];
  const int G = Hq / Hkv;
  const int n_splits = (S + split - 1) / split;
  const size_t smem = L::bytes(L::stages(split), n_splits, G);
  if (G > 8 || split % 16 != 0 || smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = raise_smem_limit(decode_tc_kernel<D, E, Rows>, limits, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_splits, B * Hkv);
  decode_tc_kernel<D, E, Rows><<<grid, kDecWarps * 32, smem, s>>>(
      static_cast<const TQ*>(q), k, v, k_scale, v_scale, kv_limit, work, tickets, static_cast<TQ*>(out),
      rows, Hkv, G, S, split, n_splits, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// launch_decode_tc at the q dtype code (kBF16 or kF32), kv dtype code
// (kBF16, kF32 or kI8) and head dim (128 or 256) of a call: bf16 q over bf16
// or int8 K/V, f32 q over f32 or int8 K/V
template <class Rows>
int dispatch_decode_tc(int q_dtype, int kv_dtype, int D, const void* q, const void* k, const void* v,
                       const float* k_scale, const float* v_scale, const int* kv_limit, void* out,
                       float* work, int* tickets, const Rows& rows, int B, int Hq, int Hkv, int S,
                       int split, int window, float softcap, cudaStream_t s) {
#define GT_DECODE_TC(DIM, POL)                                                                   \
  return launch_decode_tc<DIM, POL, Rows>(q, k, v, k_scale, v_scale, kv_limit, out, work, tickets, \
                                          rows, B, Hq, Hkv, S, split, window, softcap, s)
  if (q_dtype == kBF16 && kv_dtype == kBF16 && D == 256) GT_DECODE_TC(256, DecBf16);
  if (q_dtype == kBF16 && kv_dtype == kBF16 && D == 128) GT_DECODE_TC(128, DecBf16);
  if (q_dtype == kBF16 && kv_dtype == kI8 && D == 256) GT_DECODE_TC(256, DecInt8);
  if (q_dtype == kBF16 && kv_dtype == kI8 && D == 128) GT_DECODE_TC(128, DecInt8);
  if (q_dtype == kF32 && kv_dtype == kF32 && D == 256) GT_DECODE_TC(256, DecTf32);
  if (q_dtype == kF32 && kv_dtype == kF32 && D == 128) GT_DECODE_TC(128, DecTf32);
  if (q_dtype == kF32 && kv_dtype == kI8 && D == 256) GT_DECODE_TC(256, DecTf32Int8);
  if (q_dtype == kF32 && kv_dtype == kI8 && D == 128) GT_DECODE_TC(128, DecTf32Int8);
#undef GT_DECODE_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
