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
// Two kernels, routed by dtype (ops/attention.py `flash_attention`):
//
// `flash_tc_kernel`, bf16 (the main path). What bounds it on the H100: at
// long prompts the operations (T = 2048 from position 0 is 17 GFLOP at
// Gemma-2B heads, 0.017 ms at the bf16 peak, against 0.006 ms of bytes); at
// T ~ 200 latency: a 203-token prompt is 0.17 GFLOP, a few microseconds of
// work spread over too few rows to fill 132 SMs. The design:
// * Rows share K/V within a group. A block's rows are (position, query
//   head) pairs of one (batch row, KV head), packed position-major (row r:
//   position r / G, head r % G), 16 rows a warp. One K/V tile in shared
//   memory serves all G heads of the group (8 under Gemma-2B's MQA); a
//   warp's rows span 16 / G positions, so the causal key range of a warp
//   stays narrow.
// * Products on the tensor cores: S = Q . K^T and O += P . V by
//   `mma.sync.m16n8k16` bf16 -> f32. Q and K fragments by ldmatrix, V by
//   ldmatrix.trans; P goes from the S accumulators straight into the A
//   fragment of P . V (the C-to-A register reuse of FlashAttention-2); O
//   stays in f32 registers (D / 2 a lane: 128 at D = 256, which bounds a
//   warp to 16 rows and its tile to 32 keys), rescaled by alpha each tile.
// * K and V arrive by 16-byte cp.async into a ring of two stages: the next
//   stage loads while this one computes.
// * Softmax in registers: softcap, mask on each row's own position, the
//   batch row's limit and the window, an online max and sum a row over
//   its quad by shuffles.
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
// Numerics as the FMA kernel's: exact bf16 products, f32 sums (in another
// order), p rounded to bf16 against the tile-local running max, l summing
// the unrounded p.
//
// `flash_kernel`, f32: FMA only. A block
// owns 16 query rows of one head (grid: T/16 x Hq x B) and walks the keys
// in tiles of 32 from the first tile any of its rows can see (window) to
// min(kv_limit, max row position + 1), so whole dead tiles are never read.
// Q, K and V tiles are staged in shared memory in f32 (rows padded by one
// float so the score loop is bank-conflict-free); scores and p . v are
// plain FMA with f32 accumulation. At D = 256 the tiles need ~84 KB of
// shared memory, so the launch opts in with
// cudaFuncSetAttribute(MaxDynamicSharedMemorySize). f32 x f32 products are
// not exact on bf16 tensor cores, so f32 stays here.
#include "attn_tc.cuh"

using namespace gt;

namespace {

constexpr int kBQ = 16;  // query rows per block
constexpr int kBS = 32;  // keys per tile (one per lane in the softmax step)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBS * (D + 1) + kBS * D + kBQ * (kBS + 1) + 3 * kBQ) +
         sizeof(int) * kBQ;
}

__device__ __forceinline__ bool key_valid(int s, int pos, int limit, int window) {
  return pos >= 0 && s <= pos && s < limit && (window <= 0 || s > pos - window);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             const int* __restrict__ positions, const int* __restrict__ kv_limit,
             float* __restrict__ out, int T_len, int Hq, int Hkv, int S, int window, float softcap) {
  extern __shared__ float smem[];
  float* Qs = smem;                           // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);             // [kBS][D + 1]
  float* Vs = Ks + kBS * (D + 1);             // [kBS][D]
  float* Ps = Vs + kBS * D;                   // [kBQ][kBS + 1]
  float* row_m = Ps + kBQ * (kBS + 1);        // running max
  float* row_l = row_m + kBQ;                 // running sum
  float* row_alpha = row_l + kBQ;             // rescale of the current tile
  int* row_pos = reinterpret_cast<int*>(row_alpha + kBQ);  // -1: padding row
  __shared__ int s_minpos;
  __shared__ int s_maxpos;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int limit = min(kv_limit[b], S);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const int t = t0 + r;
    Qs[r * (D + 1) + d] =
        t < T_len ? q[((static_cast<size_t>(b) * T_len + t) * Hq + h) * D + d] : 0.f;
  }
  if (tid < kBQ) {
    const int t = t0 + tid;
    row_pos[tid] = t < T_len ? positions[static_cast<size_t>(b) * T_len + t] : -1;
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int lo = 0x7fffffff;
    int hi = -1;
    for (int r = 0; r < kBQ; ++r) {
      if (t0 + r >= T_len) break;
      lo = min(lo, row_pos[r]);
      hi = max(hi, row_pos[r]);
    }
    s_minpos = lo;
    s_maxpos = hi;
  }
  __syncthreads();

  // live key range of this block: tiles outside it are never read
  const int s_end = min(limit, s_maxpos + 1);
  int s_beg = window > 0 ? max(0, s_minpos - window + 1) : 0;
  s_beg = (s_beg / kBS) * kBS;

  constexpr int kRowsPerThread = kBQ * D / kThreads;
  const int d_own = tid % D;
  const int r_own = (tid / D) * kRowsPerThread;
  float o[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) o[i] = 0.f;

  const float* kb = k + (static_cast<size_t>(b) * Hkv + hk) * S * D;
  const float* vb = v + (static_cast<size_t>(b) * Hkv + hk) * S * D;
  for (int s0 = s_beg; s0 < s_end; s0 += kBS) {
    __syncthreads();  // previous tile's Ks/Vs/Ps fully consumed
    for (int i = tid; i < kBS * D; i += kThreads) {
      const int j = i / D;
      const int d = i % D;
      const int s = s0 + j;
      const bool in = s < S;
      Ks[j * (D + 1) + d] = in ? kb[static_cast<size_t>(s) * D + d] : 0.f;
      Vs[j * D + d] = in ? vb[static_cast<size_t>(s) * D + d] : 0.f;
    }
    __syncthreads();
    {
      // scores: thread -> row tid / 16, keys tid % 16 and tid % 16 + 16
      const int r = tid / 16;
      const int pos = row_pos[r];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = tid % 16 + 16 * c;
        const float* qr = Qs + r * (D + 1);
        const float* kr = Ks + j * (D + 1);
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
        if (softcap > 0.f) acc = softcap * tanhf(acc / softcap);
        Ps[r * (kBS + 1) + j] = key_valid(s0 + j, pos, limit, window) ? acc : kMaskValue;
      }
    }
    __syncthreads();
    // online softmax update, one warp per row, one lane per key
    for (int r = warp; r < kBQ; r += kWarps) {
      const float s = Ps[r * (kBS + 1) + lane];
      const bool valid = key_valid(s0 + lane, row_pos[r], limit, window);
      const float m_prev = row_m[r];
      const float m_next = fmaxf(m_prev, warp_max(s));
      const float alpha = expf(m_prev - m_next);
      const float p = valid ? expf(s - m_next) : 0.f;
      const float psum = warp_sum(p);
      Ps[r * (kBS + 1) + lane] = p;
      if (lane == 0) {
        row_m[r] = m_next;
        row_l[r] = alpha * row_l[r] + psum;
        row_alpha[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = r_own + i;
      const float* pr = Ps + r * (kBS + 1);
      float acc = o[i] * row_alpha[r];
#pragma unroll 8
      for (int j = 0; j < kBS; ++j) acc = fmaf(pr[j], Vs[j * D + d_own], acc);
      o[i] = acc;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = r_own + i;
    const int t = t0 + r;
    if (t >= T_len) continue;
    const float l = row_l[r];
    const float l_inv = l == 0.f ? 1.f : 1.f / l;
    out[((static_cast<size_t>(b) * T_len + t) * Hq + h) * D + d_own] = o[i] * l_inv;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* positions, const int* kv_limit,
           void* out, int B, int T_len, int Hq, int Hkv, int S, int window, float softcap,
           cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_len + kBQ - 1) / kBQ, Hq, B);
  flash_kernel<D><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      positions, kv_limit, static_cast<float*>(out), T_len, Hq, Hkv, S, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16)
// ---------------------------------------------------------------------------
constexpr int kFlashWarps = 4;           // warps a block: kR row warps x kH key groups
constexpr int kFlashTargetBlocks = 99;   // the grid a shape must reach: 3/4 of 132 SMs (measured)

// keys a warp's tile: 32 (D = 256) or 64 (D = 128) with one key group;
// a block's ring stage holds kH tiles, at most 64 (128) keys
__host__ __device__ constexpr int flash_tile_keys(int D, int kH) {
  return (D == 256 ? 64 : 128) / (kH == 1 ? 2 : kH);
}

template <int D, int kR, int kH>
struct FlashTc {
  static constexpr int kBK = flash_tile_keys(D, kH);  // keys a warp's tile (S: kBK / 2 f32 a lane)
  static constexpr int kSK = kBK * kH;                // keys a ring stage
  static constexpr int kLd = D + 8;  // bf16 pitch of Q, K and V rows: 16 bytes of padding,
                                     // so an ldmatrix phase's 8 rows hit distinct banks
  static constexpr int kKV = kSK * kLd;  // bf16 of one stage's K or V
  static constexpr size_t kBytes = 2 * (static_cast<size_t>(kR) * 16 * kLd + 4 * kKV);
  // the key groups' (m, l) and O in fragment order, [kH - 1][kR][D * 16 + 128] f32
  static_assert((kH - 1) * kR * (D * 16 + 128) * 4 <= 4 * kKV * 2, "merge buffer");
};

// rows (position, head) of a group -> blocks of kR warps of 16 rows
inline int flash_tc_blocks(int T_len, int G, int kR) { return (T_len * G + 16 * kR - 1) / (16 * kR); }

// (kR, kH): the most row warps whose grid holds kFlashTargetBlocks blocks,
// the rest of the block's 4 warps splitting the keys
inline void flash_tc_shape(int B, int Hkv, int T_len, int G, int* kR, int* kH) {
  *kR = 1;
  for (int r = kFlashWarps; r > 1; r /= 2)
    if (static_cast<long>(B) * Hkv * flash_tc_blocks(T_len, G, r) >= kFlashTargetBlocks) {
      *kR = r;
      break;
    }
  *kH = kFlashWarps / *kR;
}

template <int D, int kR, int kH>
__global__ void __launch_bounds__(kR * kH * 32)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const int* __restrict__ positions,
                const int* __restrict__ kv_limit, __nv_bfloat16* __restrict__ out, int T_len,
                int Hq, int Hkv, int S, int window, float softcap) {
  using L = FlashTc<D, kR, kH>;
  constexpr int kBK = L::kBK, kSK = L::kSK, kLd = L::kLd, kRows = kR * 16, kThreads = kR * kH * 32;
  constexpr int kNT = kBK / 8;  // n8 tiles of S
  constexpr int kDT = D / 8;    // n8 tiles of O
  extern __shared__ __align__(128) unsigned char fa_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(fa_smem);  // [kRows][kLd]
  __nv_bfloat16* ks = qs + kRows * kLd;                            // [2][kSK][kLd]
  __nv_bfloat16* vs = ks + 2 * L::kKV;                             // [2][kSK][kLd]
  __shared__ int s_lo[kR], s_hi[kR];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rw = warp % kR, kg = warp / kR;  // row warp, key group
  const int G = Hq / Hkv;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int rows = T_len * G;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // latest rows first
  const int limit = min(kv_limit[b], S);
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Hkv + hk) * S * D;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Hkv + hk) * S * D;
  // packed row pr of the group -> its q / out row
  auto row_off = [&](int pr) {
    return ((static_cast<size_t>(b) * T_len + pr / G) * Hq + hk * G + pr % G) * D;
  };

  for (int i = threadIdx.x; i < kRows * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = i % (D / 8);
    const bool ok = r0 + r < rows;
    cp_async16(smem_u32(qs + r * kLd + c * 8), ok ? q + row_off(r0 + r) + c * 8 : q, ok);
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
    __nv_bfloat16* kd = ks + (i % 2) * L::kKV;
    __nv_bfloat16* vd = vs + (i % 2) * L::kKV;
    for (int c = threadIdx.x; c < kSK * (D / 8); c += kThreads) {
      const int j = c / (D / 8), d = (c % (D / 8)) * 8;
      const bool ok = s0 + j <= hi;
      const size_t off = static_cast<size_t>(s0 + j) * D + d;
      cp_async16(smem_u32(kd + j * kLd + d), ok ? kb + off : kb, ok);
      cp_async16(smem_u32(vd + j * kLd + d), ok ? vb + off : vb, ok);
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
    const __nv_bfloat16* kt = ks + (i % 2) * L::kKV + kg * kBK * kLd;
    const __nv_bfloat16* vt = vs + (i % 2) * L::kKV + kg * kBK * kLd;
    float sc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    // S = Q K^T: per k16 step one ldmatrix.x4 of Q (A), one of K per 16 keys (B of two n8 tiles)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_u32(qs + (rw * 16 + lane % 16) * kLd + kk * 16 + (lane / 16) * 8));
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_u32(kt + (np * 16 + (lane / 16) * 8 + lane % 8) * kLd + kk * 16 +
                                 ((lane / 8) % 2) * 8));
        mma_16816(sc[2 * np], a, bk[0], bk[1]);
        mma_16816(sc[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    // softcap, mask, online softmax: c0, c1 row g, keys 2t, 2t + 1 of n8 tile n; c2, c3 row g + 8
    uint32_t valid = 0;
    float mx0 = kMaskValue, mx1 = kMaskValue;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = s0 + n * 8 + 2 * t + (e & 1);
        float s = sc[n][e];
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const bool ok = key_valid(key, e < 2 ? pos0 : pos1, limit, window);
        valid |= static_cast<uint32_t>(ok) << (4 * n + e);
        s = ok ? s : kMaskValue;
        sc[n][e] = s;
        if (e < 2) mx0 = fmaxf(mx0, s); else mx1 = fmaxf(mx1, s);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
    uint32_t pa[kNT][2];  // p rounded to bf16, pairs: rows g and g + 8
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = (valid >> (4 * n + e)) & 1u ? expf(sc[n][e] - (e < 2 ? mn0 : mn1)) : 0.f;
      ps0 += p[0] + p[1];
      ps1 += p[2] + p[3];
      pa[n][0] = pack_bf16(p[0], p[1]);
      pa[n][1] = pack_bf16(p[2], p[3]);
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
    // O += P V: P's A fragment of keys 16 kk.. is S's n8 tiles 2 kk and 2 kk + 1
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0], pa[2 * kk + 1][1]};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_u32(vt + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * kLd +
                                       dp * 16 + (lane / 16) * 8));
        mma_16816(o[2 * dp], a, bv[0], bv[1]);
        mma_16816(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
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
    __nv_bfloat16* dst = out + row_off(pr0) + 2 * t;
#pragma unroll
    for (int n = 0; n < kDT; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) = pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
  }
  if (pr1 < rows) {
    __nv_bfloat16* dst = out + row_off(pr1) + 2 * t;
#pragma unroll
    for (int n = 0; n < kDT; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) = pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int D, int kR, int kH>
int launch_tc(const void* q, const void* k, const void* v, const int* positions,
              const int* kv_limit, void* out, int B, int T_len, int Hq, int Hkv, int S, int window,
              float softcap, cudaStream_t s) {
  constexpr size_t smem = FlashTc<D, kR, kH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<D, kR, kH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(flash_tc_blocks(T_len, Hq / Hkv, kR), Hkv, B);
  flash_tc_kernel<D, kR, kH><<<grid, kR * kH * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), positions, kv_limit, static_cast<__nv_bfloat16*>(out),
      T_len, Hq, Hkv, S, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The FMA kernel: f32 q [B, T, Hq, D], k/v [B, Hkv, S, D], out [B, T, Hq, D]
// (contiguous), positions i32 [B, T], kv_limit i32 [B]. Returns a cudaError_t.
extern "C" int gt_flash_attention(const void* q, const void* k, const void* v,
                                  const void* positions, const void* kv_limit, void* out, int B,
                                  int T_len, int Hq, int Hkv, int S, int D, int window,
                                  float softcap, void* stream) {
  if (B <= 0 || T_len <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(positions);
  const int* lim = static_cast<const int*>(kv_limit);
  if (D == 256) return launch<256>(q, k, v, pos, lim, out, B, T_len, Hq, Hkv, S, window, softcap, s);
  if (D == 128) return launch<128>(q, k, v, pos, lim, out, B, T_len, Hq, Hkv, S, window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core kernel: bf16 q [B, T, Hq, D], k/v [B, Hkv, S, D], out
// [B, T, Hq, D] (contiguous), positions i32 [B, T], kv_limit i32 [B];
// row_warps: 0 for the plan (`flash_tc_shape`), or 1, 2 or 4 row warps,
// the block's other warps splitting the keys. Returns a cudaError_t.
extern "C" int gt_flash_attention_tc(const void* q, const void* k, const void* v,
                                     const void* positions, const void* kv_limit, void* out, int B,
                                     int T_len, int Hq, int Hkv, int S, int D, int row_warps,
                                     int window, float softcap, void* stream) {
  if (B <= 0 || T_len <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(positions);
  const int* lim = static_cast<const int*>(kv_limit);
  int kR = row_warps, kH = row_warps > 0 ? kFlashWarps / row_warps : 0;
  if (row_warps == 0) flash_tc_shape(B, Hkv, T_len, Hq / Hkv, &kR, &kH);
#define GT_FLASH_TC(DIM, R)                                                                    \
  if (D == DIM && kR == R)                                                                     \
  return launch_tc<DIM, R, kFlashWarps / R>(q, k, v, pos, lim, out, B, T_len, Hq, Hkv, S, window, \
                                            softcap, s)
  GT_FLASH_TC(256, 1);
  GT_FLASH_TC(256, 2);
  GT_FLASH_TC(256, 4);
  GT_FLASH_TC(128, 1);
  GT_FLASH_TC(128, 2);
  GT_FLASH_TC(128, 4);
#undef GT_FLASH_TC
  return static_cast<int>(cudaErrorInvalidValue);
}
