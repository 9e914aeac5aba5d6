// Prefill attention: online-softmax attention of q [B, T, Hq, D] against
// the dense cache k/v [B, Hkv, S, D], without materializing [T, S] scores.
//
// Replaces the Pallas kernel `_flash_kernel` of gemma_tpu/ops/attention.py
// (launched by `_flash_call` via `flash_attention`). Semantics per query
// row at position pos (arbitrary per row) of batch row b:
//   key s is valid iff s <= pos, s < kv_limit[b] and, with a window,
//   s > pos - window; scores get the softcap before the mask; online
//   softmax in f32 with p rounded to the cache dtype before p . v; a row
//   with no valid key outputs 0.
//
// One kernel, `flash_mma_kernel`, over an element policy, routed by dtype
// (ops/attention.py `flash_attention`): `FlashBf16` for bf16 (the main
// path), `FlashTf32` for f32 (perplexity, the f32 caches of --verify, f32
// serving). The skeleton both share:
// * Rows share K/V within a group. A block's rows are (position, query
//   head) pairs of one (batch row, KV head), packed position-major (row r:
//   position r / G, head r % G), 16 rows a warp. One K/V tile in shared
//   memory serves all G heads of the group (8 under Gemma-2B's MQA); a
//   warp's rows span 16 / G positions, so the causal key range of a warp
//   stays narrow.
// * K and V arrive by 16-byte cp.async into a ring of two stages: the next
//   stage loads while this one computes.
// * Softmax in registers: softcap, mask on each row's own position, the
//   batch row's limit and the window, an online max and sum a row over
//   its quad by shuffles; l sums the unrounded p. O stays in f32 registers
//   (D / 2 a lane: 128 at D = 256, which bounds a warp to 16 rows), rescaled
//   by alpha each tile; P goes from the S accumulators straight into the A
//   fragment of P . V (the C-to-A register reuse of FlashAttention-2).
// * A block is 4 warps: kR row warps (16 rows each) x kH key groups. A
//   ring stage holds one tile of keys for each key group, and each group
//   keeps its own running max, sum and O over its tiles; at the end group
//   0 merges the others in group order through shared memory. The plan
//   (`flash_tc_shape`) takes the most row warps whose grid still holds
//   kFlashTargetBlocks blocks: long prompts (T = 2048: 256 blocks of 4 row
//   warps) share each K/V tile among 64 rows; a 203-token prompt (1624
//   rows at Gemma-2B heads) runs 102 blocks of one row warp whose 4 key
//   groups walk a quarter of the keys each, so latency, not the 26 blocks
//   of 64 rows, sets its time. Blocks run the latest rows (the longest key
//   ranges) first. The block reads only its live key range (its rows' min
//   and max position, the limit and the window); a warp skips the
//   products of a tile none of its rows can see. Ragged T and S are
//   masked, never padded.
// A policy gives the element type, a warp's tile of keys, the row pitches
// of Q, K and V in shared memory, the two products on a warp's 16 rows
// (`scores`: S = Q . K^T; `pv`: O += P . V) and the store of two outputs.
//
// `FlashBf16`. What bounds it on the H100: at long prompts the operations
// (T = 2048 from position 0 is 17 GFLOP at Gemma-2B heads, 0.017 ms at the
// bf16 peak, against 0.006 ms of bytes); at T ~ 200 latency: a 203-token
// prompt is 0.17 GFLOP, a few microseconds of work spread over too few rows
// to fill 132 SMs. Products by `mma.sync.m16n8k16` bf16 -> f32: Q and K
// fragments by ldmatrix, V by ldmatrix.trans; a warp's tile is 32 keys at
// D = 256. Numerics: exact bf16 products, f32 sums (in the kernel's
// order), p rounded to bf16 against the tile-local running max.
//
// `FlashTf32`. What bounds it on the H100: a 512-token window from position
// 0 is 1.08 GFLOP at Gemma-2B heads (2.15 at Gemma-7B's), 0.0022 (0.0043)
// ms at 495 TFLOP/s of TF32, against 0.0028 (0.010) ms of HBM bytes: bytes
// bound the function at this length, operations at longer ones, and the
// three TF32 passes take three times the flops' figure. The FMA kernel it
// replaced read 3.6 and 4.3 TFLOP/s (0.3015 and 0.4962 ms), SDPA in f32
// 0.1276 and 0.1271 ms (PERF.md). The policy:
// * f32 tiles are twice the bytes, so a ring stage holds half the keys: 32
//   at D = 256 (two stages of K and V: 136 KB), 64 at D = 128;
// * both products on `mma.sync` m16n8k8 TF32 -> f32 with 3xTF32: each
//   operand split as `split_tf32` does (hi rounded, lo = v - hi truncated),
//   lo.hi, hi.lo, then hi.hi into the same f32 accumulators. Neither
//   operand is an exact integer here (unlike the quantized tile), so both
//   need their small part: the products then carry ~2^-21 of relative
//   error, and the output differs from the plain f32 version by the order
//   of f32 sums, ~1e-6 of each row's scale;
// * fragment order, Q.K^T: D is permuted within each 16-wide unit u the
//   same way for Q and K (k8 step s, slot t: element 16u + 4t + 2s; slot
//   t + 4: + 1), so a lane's A values of both k8 steps are one 16-byte
//   load a row, its B values one 16-byte load of key row g. Q and K rows
//   are padded to D + 16 floats: the 2 rows x 4 chunks of a load phase
//   fall on distinct banks;
// * P.V: P's A fragment is S's C fragment as it stands, keys permuted
//   within each 8: slot t is key 2t (c0, c2) and slot t + 4 key 2t + 1
//   (c1, c3), so V's B values are rows 2t and 2t + 1 at column g. V rows
//   are padded to D + 4 floats: the 8 x 4 lanes' scalar loads hit distinct
//   banks;
// * p stays f32 (the cache is f32: the plain version rounds p to v's
//   dtype, a no-op).
// Expected before it ran: both heads' rows at T = S = 512 at or below SDPA
// f32 (0.1276 and 0.1271 ms), within 1e-4 of each row's scale. Measured
// (chip_smoke.py phase 8, PERF.md section 6): 0.0745 and 0.1133 ms, 0.58x
// and 0.89x SDPA f32, at most 0.17 of 1e-4 of a row's scale; dropping any
// one small-part product misses 1e-4 (tests/test_torch_tc_emulation.py).
#include "attn_tc.cuh"

using namespace gt;

namespace {

__device__ __forceinline__ bool key_valid(int s, int pos, int limit, int window) {
  return pos >= 0 && s <= pos && s < limit && (window <= 0 || s > pos - window);
}

constexpr int kFlashWarps = 4;           // warps a block: kR row warps x kH key groups
constexpr int kFlashTargetBlocks = 99;   // the grid a shape must reach: 3/4 of 132 SMs (measured)

// ---------------------------------------------------------------------------
// The element policies
// ---------------------------------------------------------------------------
// bf16: keys a warp's tile: 32 (D = 256) or 64 (D = 128) with one key
// group; a block's ring stage holds kH tiles, at most 64 (128) keys
template <int D, int kH>
struct FlashBf16 {
  using T = __nv_bfloat16;
  static constexpr int kBK = (D == 256 ? 64 : 128) / (kH == 1 ? 2 : kH);
  static constexpr int kLd = D + 8;  // pitch of Q, K and V rows: 16 bytes of padding,
  static constexpr int kLdV = kLd;   // so an ldmatrix phase's 8 rows hit distinct banks

  // sc += Q K^T on the warp's rows qw [16][kLd] and tile kt [kBK][kLd]: per
  // k16 step one ldmatrix.x4 of Q (A), one of K per 16 keys (B of two n8 tiles)
  static __device__ __forceinline__ void scores(float (&sc)[kBK / 8][4], const T* qw, const T* kt,
                                                int lane) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_u32(qw + (lane % 16) * kLd + kk * 16 + (lane / 16) * 8));
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_u32(kt + (np * 16 + (lane / 16) * 8 + lane % 8) * kLd + kk * 16 +
                                 ((lane / 8) % 2) * 8));
        mma_16816(sc[2 * np], a, bk[0], bk[1]);
        mma_16816(sc[2 * np + 1], a, bk[2], bk[3]);
      }
    }
  }

  // o += P V on the tile vt [kBK][kLdV]: P's A fragment of keys 16 kk.. is
  // S's n8 tiles 2 kk and 2 kk + 1, p rounded to bf16
  static __device__ __forceinline__ void pv(float (&o)[D / 8][4], const float (&p)[kBK / 8][4],
                                            const T* vt, int lane) {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                             pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_u32(vt + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * kLd +
                                       dp * 16 + (lane / 16) * 8));
        mma_16816(o[2 * dp], a, bv[0], bv[1]);
        mma_16816(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
  }

  static __device__ __forceinline__ void store(T* dst, float a, float b) {
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
  }
};

// f32 on TF32: keys a warp's tile: a ring stage holds 32 keys (D = 256) or
// 64 (D = 128), one tile a key group
template <int D, int kH>
struct FlashTf32 {
  using T = float;
  static constexpr int kBK = (D == 256 ? 32 : 64) / kH;
  static constexpr int kLd = D + 16;  // pitch of Q and K rows: a 16-byte load phase's
                                      // rows g, g + 1 x chunks t on distinct banks
  static constexpr int kLdV = D + 4;  // of V rows: rows 2t, 2t + 1 at column g on distinct banks
  static_assert(kBK % 8 == 0, "tile");

  // sc += Q K^T on the warp's rows qw [16][kLd] and tile kt [kBK][kLd]: k8
  // step s of unit u takes elements 16u + 4t + 2s (slot t) and + 1 (slot
  // t + 4): a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t +
  // 4); b0 = (slot t, key g), b1 = (slot t + 4, key g)
  static __device__ __forceinline__ void scores(float (&sc)[kBK / 8][4], const T* qw, const T* kt,
                                                int lane) {
    const int g = lane / 4, t = lane % 4;
    const float* qa = qw + g * kLd + 4 * t;
    const float* kl = kt + g * kLd + 4 * t;
#pragma unroll 2
    for (int u = 0; u < D / 16; ++u) {
      const float4 x0 = *reinterpret_cast<const float4*>(qa + 16 * u);
      const float4 x1 = *reinterpret_cast<const float4*>(qa + 8 * kLd + 16 * u);
      uint32_t ah[2][4], al[2][4];
      split_tf32(x0.x, ah[0][0], al[0][0]);
      split_tf32(x1.x, ah[0][1], al[0][1]);
      split_tf32(x0.y, ah[0][2], al[0][2]);
      split_tf32(x1.y, ah[0][3], al[0][3]);
      split_tf32(x0.z, ah[1][0], al[1][0]);
      split_tf32(x1.z, ah[1][1], al[1][1]);
      split_tf32(x0.w, ah[1][2], al[1][2]);
      split_tf32(x1.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        const float4 y = *reinterpret_cast<const float4*>(kl + n * 8 * kLd + 16 * u);
        uint32_t bh[4], bl[4];
        split_tf32(y.x, bh[0], bl[0]);
        split_tf32(y.y, bh[1], bl[1]);
        split_tf32(y.z, bh[2], bl[2]);
        split_tf32(y.w, bh[3], bl[3]);
        mma_3xtf32(sc[n], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
        mma_3xtf32(sc[n], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
      }
    }
  }

  // o += P V on the tile vt [kBK][kLdV]: k8 step n is S's n8 tile n with
  // keys permuted, slot t = key 2t (a0 = c0, a1 = c2), slot t + 4 = key 2t
  // + 1 (a2 = c1, a3 = c3); b0, b1: V rows 8n + 2t, 8n + 2t + 1 at column 8j + g
  static __device__ __forceinline__ void pv(float (&o)[D / 8][4], const float (&p)[kBK / 8][4],
                                            const T* vt, int lane) {
    const float* vl = vt + 2 * (lane % 4) * kLdV + lane / 4;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      uint32_t ph[4], pl[4];
      split_tf32(p[n][0], ph[0], pl[0]);
      split_tf32(p[n][2], ph[1], pl[1]);
      split_tf32(p[n][1], ph[2], pl[2]);
      split_tf32(p[n][3], ph[3], pl[3]);
      const float* vn = vl + 8 * n * kLdV;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(vn[8 * j], bh0, bl0);
        split_tf32(vn[kLdV + 8 * j], bh1, bl1);
        mma_3xtf32(o[j], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
  }

  static __device__ __forceinline__ void store(T* dst, float a, float b) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  }
};

// ---------------------------------------------------------------------------
// The skeleton
// ---------------------------------------------------------------------------
// shared memory of policy P at kR row warps: Q [kR * 16][kLd], then the
// ring's K [2][kSK][kLd] and V [2][kSK][kLdV]
template <class P, int D, int kR, int kH>
struct FlashSmem {
  static constexpr int kSK = P::kBK * kH;   // keys a ring stage
  static constexpr int kK = kSK * P::kLd;   // elements of one stage's K
  static constexpr int kV = kSK * P::kLdV;  // and V
  static constexpr size_t kBytes = sizeof(typename P::T) * (static_cast<size_t>(kR) * 16 * P::kLd + 2 * kK + 2 * kV);
  // the key groups' (m, l) and O in fragment order, [kH - 1][kR][D * 16 + 128] f32, in the ring
  static_assert((kH - 1) * kR * (D * 16 + 128) * 4 <= 2 * (kK + kV) * sizeof(typename P::T), "merge buffer");
};

// rows (position, head) of a group -> blocks of kR warps of 16 rows
inline int flash_tc_blocks(int T_len, int G, int kR) { return (T_len * G + 16 * kR - 1) / (16 * kR); }

// row warps kR: the most whose grid holds kFlashTargetBlocks blocks, the
// rest of the block's 4 warps splitting the keys
inline int flash_tc_shape(int B, int Hkv, int T_len, int G) {
  for (int r = kFlashWarps; r > 1; r /= 2)
    if (static_cast<long>(B) * Hkv * flash_tc_blocks(T_len, G, r) >= kFlashTargetBlocks) return r;
  return 1;
}

template <template <int, int> class Pol, int D, int kR, int kH>
__global__ void __launch_bounds__(kR * kH * 32)
flash_mma_kernel(const typename Pol<D, kH>::T* __restrict__ q, const typename Pol<D, kH>::T* __restrict__ k,
                 const typename Pol<D, kH>::T* __restrict__ v, const int* __restrict__ positions,
                 const int* __restrict__ kv_limit, typename Pol<D, kH>::T* __restrict__ out, int T_len,
                 int Hq, int Hkv, int S, int window, float softcap) {
  using P = Pol<D, kH>;
  using T = typename P::T;
  using L = FlashSmem<P, D, kR, kH>;
  constexpr int kBK = P::kBK, kSK = L::kSK, kLd = P::kLd, kLdV = P::kLdV, kRows = kR * 16,
                kThreads = kR * kH * 32;
  constexpr int kC = 16 / sizeof(T);  // elements a 16-byte copy
  constexpr int kNT = kBK / 8;        // n8 tiles of S
  constexpr int kDT = D / 8;          // n8 tiles of O
  extern __shared__ __align__(128) unsigned char fa_smem[];
  T* qs = reinterpret_cast<T*>(fa_smem);  // [kRows][kLd]
  T* ks = qs + kRows * kLd;               // [2][kSK][kLd]
  T* vs = ks + 2 * L::kK;                 // [2][kSK][kLdV]
  __shared__ int s_lo[kR], s_hi[kR];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rw = warp % kR, kg = warp / kR;  // row warp, key group
  const int G = Hq / Hkv;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int rows = T_len * G;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // latest rows first
  const int limit = min(kv_limit[b], S);
  const T* kb = k + (static_cast<size_t>(b) * Hkv + hk) * S * D;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hk) * S * D;
  // packed row pr of the group -> its q / out row
  auto row_off = [&](int pr) {
    return ((static_cast<size_t>(b) * T_len + pr / G) * Hq + hk * G + pr % G) * D;
  };

  for (int i = threadIdx.x; i < kRows * (D / kC); i += kThreads) {
    const int r = i / (D / kC), c = i % (D / kC);
    const bool ok = r0 + r < rows;
    cp_async16(smem_u32(qs + r * kLd + c * kC), ok ? q + row_off(r0 + r) + c * kC : q, ok);
  }

  // this lane's rows g and g + 8 of its row warp: positions (-1: padding)
  const int pr0 = r0 + rw * 16 + g, pr1 = pr0 + 8;
  const int pos0 = pr0 < rows ? positions[static_cast<size_t>(b) * T_len + pr0 / G] : -1;
  const int pos1 = pr1 < rows ? positions[static_cast<size_t>(b) * T_len + pr1 / G] : -1;
  // the row warp's and the block's live key ranges [lo, hi]
  const int w_hi = warp_max_i(max(pos0, pos1));
  const int w_pos_lo = warp_min_i(min(pos0 < 0 ? INT_MAX : pos0, pos1 < 0 ? INT_MAX : pos1));
  const int w_lo = w_hi < 0 ? INT_MAX : (window > 0 ? max(0, w_pos_lo - window + 1) : 0);
  if (lane == 0 && kg == 0) {
    s_lo[rw] = w_lo;
    s_hi[rw] = min(w_hi, limit - 1);
  }
  __syncthreads();
  int lo = INT_MAX, hi = -1;
#pragma unroll
  for (int w = 0; w < kR; ++w) {
    lo = min(lo, s_lo[w]);
    hi = max(hi, s_hi[w]);
  }
  const int s_beg = hi >= lo ? lo / kSK * kSK : 0;
  const int nst = hi >= lo ? (hi + 1 - s_beg + kSK - 1) / kSK : 0;  // ring steps
  const int w_hi_lim = s_hi[rw];

  // step i's kSK keys of K and V (keys past hi: zeros, nothing read) into stage i % 2
  auto issue = [&](int i) {
    const int s0 = s_beg + i * kSK;
    T* kd = ks + (i % 2) * L::kK;
    T* vd = vs + (i % 2) * L::kV;
    for (int c = threadIdx.x; c < kSK * (D / kC); c += kThreads) {
      const int j = c / (D / kC), d = (c % (D / kC)) * kC;
      const bool ok = s0 + j <= hi;
      const size_t off = static_cast<size_t>(s0 + j) * D + d;
      cp_async16(smem_u32(kd + j * kLd + d), ok ? kb + off : kb, ok);
      cp_async16(smem_u32(vd + j * kLdV + d), ok ? vb + off : vb, ok);
    }
  };

  float o[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g, g + 8 (l: this lane's keys)

  // the warp's tile of step i: keys s0 .. s0 + kBK - 1 of its key group
  auto compute = [&](int i) {
    const int s0 = s_beg + i * kSK + kg * kBK;
    if (s0 > w_hi_lim || s0 + kBK - 1 < w_lo) return;  // no row of the warp sees the tile
    float sc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    P::scores(sc, qs + rw * 16 * kLd, ks + (i % 2) * L::kK + kg * kBK * kLd, lane);
    // softcap, mask, online softmax: c0, c1 row g, keys 2t, 2t + 1 of n8 tile n; c2, c3 row g + 8
    uint32_t valid = 0;
    float mx0 = kMaskValue, mx1 = kMaskValue;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = s0 + n * 8 + 2 * t + (e & 1);
        float x = sc[n][e];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool ok = key_valid(key, e < 2 ? pos0 : pos1, limit, window);
        valid |= static_cast<uint32_t>(ok) << (4 * n + e);
        x = ok ? x : kMaskValue;
        sc[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;  // sc becomes p
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[n][e] = (valid >> (4 * n + e)) & 1u ? expf(sc[n][e] - (e < 2 ? mn0 : mn1)) : 0.f;
      ps0 += sc[n][0] + sc[n][1];
      ps1 += sc[n][2] + sc[n][3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }
    P::pv(o, sc, vs + (i % 2) * L::kV + kg * kBK * kLdV, lane);
  };

  if (nst > 0) issue(0);
  cp_async_commit();  // group: Q and step 0
  for (int i = 0; i < nst; ++i) {
    if (i + 1 < nst) issue(i + 1);  // into the stage step i - 1 freed
    cp_async_commit();
    cp_async_wait<1>();  // step i (and Q) landed: this thread's copies,
    __syncthreads();     // and every thread's
    compute(i);
    __syncthreads();  // stage i % 2 consumed before step i + 2 overwrites it
  }
  cp_async_wait<0>();

  if constexpr (kH > 1) {
    // key groups 1.. hand (m, l, O) to group 0 through the ring, in fragment
    // order; group 0 merges them in group order
    float* buf = reinterpret_cast<float*>(ks);
    constexpr int kPer = D * 16 + 128;  // floats a warp
    if (kg > 0) {
      float* dst = buf + ((kg - 1) * kR + rw) * kPer;
#pragma unroll
      for (int n = 0; n < kDT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[(n * 4 + e) * 32 + lane] = o[n][e];
      dst[D * 16 + lane] = m0;
      dst[D * 16 + 32 + lane] = m1;
      dst[D * 16 + 64 + lane] = l0;
      dst[D * 16 + 96 + lane] = l1;
    }
    __syncthreads();
    if (kg > 0) return;
#pragma unroll 1
    for (int h = 1; h < kH; ++h) {
      const float* src = buf + ((h - 1) * kR + rw) * kPer;
      const float hm0 = src[D * 16 + lane], hm1 = src[D * 16 + 32 + lane];
      const float mn0 = fmaxf(m0, hm0), mn1 = fmaxf(m1, hm1);
      // a group that saw no tile has m = -inf: weight 0 (and 0 for both if neither did)
      const float a0 = m0 == -INFINITY ? 0.f : expf(m0 - mn0), b0 = hm0 == -INFINITY ? 0.f : expf(hm0 - mn0);
      const float a1 = m1 == -INFINITY ? 0.f : expf(m1 - mn1), b1 = hm1 == -INFINITY ? 0.f : expf(hm1 - mn1);
      l0 = l0 * a0 + src[D * 16 + 64 + lane] * b0;
      l1 = l1 * a1 + src[D * 16 + 96 + lane] * b1;
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
        o[n][0] = o[n][0] * a0 + src[(n * 4) * 32 + lane] * b0;
        o[n][1] = o[n][1] * a0 + src[(n * 4 + 1) * 32 + lane] * b0;
        o[n][2] = o[n][2] * a1 + src[(n * 4 + 2) * 32 + lane] * b1;
        o[n][3] = o[n][3] * a1 + src[(n * 4 + 3) * 32 + lane] * b1;
      }
      m0 = mn0;
      m1 = mn1;
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0, inv1 = l1 == 0.f ? 1.f : 1.f / l1;
  if (pr0 < rows) {
    T* dst = out + row_off(pr0) + 2 * t;
#pragma unroll
    for (int n = 0; n < kDT; ++n) P::store(dst + n * 8, o[n][0] * inv0, o[n][1] * inv0);
  }
  if (pr1 < rows) {
    T* dst = out + row_off(pr1) + 2 * t;
#pragma unroll
    for (int n = 0; n < kDT; ++n) P::store(dst + n * 8, o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <template <int, int> class Pol, int D, int kR>
int launch_shape(const void* q, const void* k, const void* v, const int* positions, const int* kv_limit,
                 void* out, int B, int T_len, int Hq, int Hkv, int S, int window, float softcap,
                 cudaStream_t s) {
  constexpr int kH = kFlashWarps / kR;
  using T = typename Pol<D, kH>::T;
  static std::atomic<int> limits[kSmemDevices];  // bytes set so far, 0 on start
  constexpr size_t smem = FlashSmem<Pol<D, kH>, D, kR, kH>::kBytes;
  const cudaError_t err = raise_smem_limit(flash_mma_kernel<Pol, D, kR, kH>, limits, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(flash_tc_blocks(T_len, Hq / Hkv, kR), Hkv, B);
  flash_mma_kernel<Pol, D, kR, kH><<<grid, kR * kH * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), positions, kv_limit,
      static_cast<T*>(out), T_len, Hq, Hkv, S, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// row_warps: 0 for the plan (`flash_tc_shape`), or 1, 2 or 4
template <template <int, int> class Pol>
int launch(const void* q, const void* k, const void* v, const void* positions, const void* kv_limit,
           void* out, int B, int T_len, int Hq, int Hkv, int S, int D, int row_warps, int window,
           float softcap, void* stream) {
  if (B <= 0 || T_len <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(positions);
  const int* lim = static_cast<const int*>(kv_limit);
  const int kR = row_warps > 0 ? row_warps : flash_tc_shape(B, Hkv, T_len, Hq / Hkv);
#define GT_FLASH(DIM, R) \
  if (D == DIM && kR == R) return launch_shape<Pol, DIM, R>(q, k, v, pos, lim, out, B, T_len, Hq, Hkv, S, window, softcap, s)
  GT_FLASH(256, 1);
  GT_FLASH(256, 2);
  GT_FLASH(256, 4);
  GT_FLASH(128, 1);
  GT_FLASH(128, 2);
  GT_FLASH(128, 4);
#undef GT_FLASH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// bf16 q [B, T, Hq, D], k/v [B, Hkv, S, D], out [B, T, Hq, D] (contiguous),
// positions i32 [B, T], kv_limit i32 [B]; row_warps: 0 for the plan
// (`flash_tc_shape`), or 1, 2 or 4 row warps, the block's other warps
// splitting the keys. Returns a cudaError_t.
extern "C" int gt_flash_attention_tc(const void* q, const void* k, const void* v,
                                     const void* positions, const void* kv_limit, void* out, int B,
                                     int T_len, int Hq, int Hkv, int S, int D, int row_warps,
                                     int window, float softcap, void* stream) {
  return launch<FlashBf16>(q, k, v, positions, kv_limit, out, B, T_len, Hq, Hkv, S, D, row_warps, window,
                           softcap, stream);
}

// The same on f32 q, k, v and out, at the plan's row warps. Returns a cudaError_t.
extern "C" int gt_flash_attention_tf32(const void* q, const void* k, const void* v,
                                       const void* positions, const void* kv_limit, void* out, int B,
                                       int T_len, int Hq, int Hkv, int S, int D, int window,
                                       float softcap, void* stream) {
  return launch<FlashTf32>(q, k, v, positions, kv_limit, out, B, T_len, Hq, Hkv, S, D, 0, window, softcap,
                           stream);
}
