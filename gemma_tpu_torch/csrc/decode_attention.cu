// Decode (T = 1) attention over the dense per-layer KV cache.
//
// Replaces the Pallas kernel `_decode_kernel` of gemma_tpu/ops/attention.py
// (launched by `_decode_call` via `decode_attention`), both its arms: K/V in
// the query's dtype (bf16 or f32), and int8 K/V with f32 scales [B, Hkv, S]
// read in place. Semantics, per batch row b with limit = kv_limit[b] (the
// query sits at position limit - 1):
//   s = q . k (f32), int8: s = (q . k8) * ks[j]; then softcap:
//   s = cap * tanh(s / cap);
//   key col is valid iff col < limit and, with a window, col > limit-1-window;
//   online softmax in f32; the weight is p rounded to the cache dtype, or
//   bf16(p * vs[j]) for int8 (also with f32 queries), before weight . v;
//   out = acc / l (0 where no key is valid), returned in q's dtype.
//
// What bounds it on the H100: launch and latency at today's lengths (a
// Gemma-2B row at limit 204 reads 0.2 MB of K and V, 0.06 us of HBM), the
// live K/V bytes at long ones (int8 halves them). The TPU kernel walks S in
// sequence per batch row and skips dead tiles with `tile_map`; here the
// work is split along S, so one (b, kv head) spreads over many SMs. Two
// kernels, routed in ops/attention.py `decode_attention`:
//
// `decode_tc_kernel`: bf16 q over a bf16 or int8 cache, 2 <= G = Hq / Hkv
// <= 8 (Gemma-2B's G = 8; the main path). The GEMV-on-tensor-cores
// pattern of dq_gemv.cuh with the cache in place of the weight:
// `mma.sync.m16n8k16` with the cache on the m16 side and the G query
// heads, zero-padded to 8 as the reference pads to MIN_DECODE_G, on the
// n8 side.
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
// * The block merges its warps in shared memory, writes its partial (max,
//   sum, unnormalized output) and takes a ticket from a per-(b, kv head)
//   counter; the last block of the row merges all partials in split order
//   (the splits' statistics staged in shared memory by all its threads, a
//   warp a head for the weights, four splits' loads in flight a thread for
//   the outputs) and resets the counter to 0. One launch; the result does
//   not depend on which block finished last, so serving stays
//   batch-invariant and deterministic. The counters must start at 0 and launches that share
//   them must not overlap: `workspace` keeps one a stream.
// The paged kernel (paged_attention.cu) could take this core with a page
// table in place of the slab offset; it still runs `attend_split`.
//
// `decode_split_kernel`: f32 queries (both arms), G = 1 and G > 8, with FMA
// only (f32 x f32 products are not exact on bf16 tensor cores). At G = 1
// (Gemma-7B) the tensor-core kernel, whose n8 side then carries 7 zero
// columns, measured faster at batch 1 and slower over 8 serving rows,
// where its 1024 blocks of 69 KB run in three waves against the split-S
// kernel's one (PERF.md).
// `decode_split_kernel` gives each block `split` keys of one (b, kv head)
// for all G query heads of the group. Blocks whose keys are all outside
// [max(limit - window, 0), limit) write an empty partial and return at once,
// so only live tiles are read. Each live block writes its partial (max, sum,
// unnormalized output), and `attend_combine_kernel` (common.cuh), a second
// small launch, rescales and sums the partials. The split itself is
// `attend_split` (common.cuh), shared with the paged kernel.
#include "attn_tc.cuh"

using namespace gt;

namespace {

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kAttnThreads)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k, const TKV* __restrict__ v,
                    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                    const int* __restrict__ kv_limit, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_o, int Hkv, int G, int S,
                    int split, int n_splits, int window, float softcap) {
  extern __shared__ float smem[];
  const int sp = blockIdx.x;
  const int bh = blockIdx.y;  // b * Hkv + kv head
  const int b = bh / Hkv;

  const int limit = min(kv_limit[b], S);
  const int live_lo = window > 0 ? max(limit - window, 0) : 0;
  const int s0 = sp * split;
  const int kbeg = max(s0, live_lo);
  const int kend = min(s0 + split, limit);  // exclusive
  const size_t pidx = static_cast<size_t>(bh) * n_splits + sp;
  float* pm = part_m + pidx * G;
  float* pl = part_l + pidx * G;
  if (kbeg >= kend) {
    write_dead_split(pm, pl, G);
    return;
  }
  // q [B, Hq, D], Hq = Hkv * G; k/v [B, Hkv, S, D]; scales [B, Hkv, S]
  const size_t slab = static_cast<size_t>(bh) * S + s0;
  attend_split<TQ, TKV, D>(q + static_cast<size_t>(bh) * G * D, k + slab * D, v + slab * D,
                           k_scale == nullptr ? nullptr : k_scale + slab,
                           v_scale == nullptr ? nullptr : v_scale + slab, kbeg - s0, kend - s0,
                           split, G, softcap, pm, pl, part_o + pidx * G * D, smem);
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k, const void* v, const float* k_scale,
           const float* v_scale, const int* kv_limit, void* out, float* part_m, float* part_l,
           float* part_o, int B, int Hq, int Hkv, int S, int split, int window, float softcap,
           cudaStream_t s) {
  const int G = Hq / Hkv;
  const int n_splits = (S + split - 1) / split;
  const size_t smem = static_cast<size_t>(G) * (D + split) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_splits, B * Hkv);
  decode_split_kernel<TQ, TKV, D><<<grid, kAttnThreads, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), k_scale,
      v_scale, kv_limit, part_m, part_l, part_o, Hkv, G, S, split, n_splits, window, softcap);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attend_combine_kernel<TQ><<<B * Hkv, kAttnThreads, 0, s>>>(part_m, part_l, part_o,
                                                             static_cast<TQ*>(out), G, D, n_splits);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16 q)
// ---------------------------------------------------------------------------
constexpr int kDecWarps = 4;

template <int D, bool kInt8>
struct DecodeTc {
  static constexpr int kLd = D + 8;          // bf16 pitch of a staged K or V row (ldmatrix
                                             // phases on distinct banks)
  static constexpr int kTile = 16 * kLd * 2;  // bytes of a 16-key bf16 K or V tile
  static constexpr int kRawTile = 16 * D;     // bytes of a 16-key int8 K or V tile
  static constexpr int kPLd = 24;             // bf16 pitch of a warp's P [8 heads][16 keys]
  // a warp's share: `stages` ring stages of K and V (bf16, or int8 raw
  // bytes and then one bf16 pair they widen into), and P
  static constexpr int kStage = kInt8 ? 2 * kRawTile : 2 * kTile;
  __host__ __device__ static constexpr int warp_bytes(int stages) {
    return stages * kStage + (kInt8 ? 2 * kTile : 0) + 8 * kPLd * 2;
  }
  // the warps' shares, reused for the block's merge ([kDecWarps][8][D] f32)
  // and the last block's ([2][n_splits][G] f32)
  static size_t bytes(int stages, int n_splits, int G) {
    const size_t warps = static_cast<size_t>(kDecWarps) * warp_bytes(stages);
    const size_t merge = static_cast<size_t>(kDecWarps) * 8 * D * 4;
    const size_t last = static_cast<size_t>(2) * n_splits * G * 4;
    return warps > merge ? (warps > last ? warps : last) : (merge > last ? merge : last);
  }
};

// ring stages a warp: one where each warp has one 16-key tile a split
__host__ __device__ constexpr int decode_tc_stages(int split) { return split > 16 * kDecWarps ? 2 : 1; }

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

// work: part_m, part_l [B * Hkv][n_splits][G] then part_o [..][G][D], f32
template <int D, bool kInt8>
__global__ void __launch_bounds__(kDecWarps * 32)
decode_tc_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k,
                 const void* __restrict__ v, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale, const int* __restrict__ kv_limit,
                 float* __restrict__ work, int* __restrict__ tickets,
                 __nv_bfloat16* __restrict__ out, int Hkv, int G, int S, int split, int n_splits,
                 int window, float softcap) {
  using L = DecodeTc<D, kInt8>;
  using TKV = typename std::conditional<kInt8, int8_t, __nv_bfloat16>::type;
  constexpr int kLd = L::kLd, kThreads = kDecWarps * 32;
  extern __shared__ __align__(128) unsigned char dec_smem[];
  __shared__ float s_m[kDecWarps][8], s_l[kDecWarps][8];
  __shared__ int s_last;

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
    const size_t slab = static_cast<size_t>(bh) * S;  // first cache row of (b, kv head)
    // q as the B operand: lane (g, t) holds q[head g][16 kk + 2t (+8) + {0, 1}]; heads >= G: 0
    uint32_t qf[D / 16][2];
    const uint32_t* qh = reinterpret_cast<const uint32_t*>(q + (static_cast<size_t>(bh) * G + g) * D) + t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = g < G ? __ldg(qh + kk * 8) : 0u;
      qf[kk][1] = g < G ? __ldg(qh + kk * 8 + 4) : 0u;
    }
    const int kb0 = s0 + (kbeg - s0) / 16 * 16;
    const int ntile = (kend - kb0 + 15) / 16;  // the block's 16-key tiles; the warp's: warp, warp + W, ..
    const int mine = ntile > warp ? (ntile - warp + kDecWarps - 1) / kDecWarps : 0;
    const int stages = decode_tc_stages(split);
    unsigned char* wbase = dec_smem + warp * L::warp_bytes(stages);
    __nv_bfloat16* pt = reinterpret_cast<__nv_bfloat16*>(wbase + stages * L::kStage +
                                                         (kInt8 ? 2 * L::kTile : 0));

    // the warp's j-th tile (keys past kend: zeros, nothing read) into stage j % stages
    auto issue = [&](int j) {
      const int key0 = kb0 + 16 * (warp + j * kDecWarps);
      unsigned char* st = wbase + (j % stages) * L::kStage;
      constexpr int kChunks = D * static_cast<int>(sizeof(TKV)) / 16;  // 16-byte pieces a row
#pragma unroll
      for (int c = lane; c < 16 * kChunks; c += 32) {
        const int r = c / kChunks, d = (c % kChunks) * (16 / static_cast<int>(sizeof(TKV)));
        const bool ok = key0 + r < kend;
        const size_t off = (slab + key0 + r) * D + d;
        const int dst = kInt8 ? r * D + d : (r * kLd + d) * 2;
        cp_async16(smem_u32(st + dst), ok ? kp + off : kp, ok);
        cp_async16(smem_u32(st + L::kStage / 2 + dst), ok ? vp + off : vp, ok);
      }
    };

    float o[D / 16][4];
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // heads 2t, 2t + 1 (l: this lane's keys)

    if (mine > 0) issue(0);
    cp_async_commit();
    for (int j = 0; j < mine; ++j) {
      if (j + 1 < mine) issue(j + 1);  // into the stage tile j - 1 freed (stages == 2)
      cp_async_commit();
      cp_async_wait<1>();  // tile j landed: this lane's copies,
      __syncwarp();        // and the warp's
      const int key0 = kb0 + 16 * (warp + j * kDecWarps);
      const unsigned char* st = wbase + (j % stages) * L::kStage;
      const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(st);
      const __nv_bfloat16* vt = reinterpret_cast<const __nv_bfloat16*>(st + L::kTile);
      if constexpr (kInt8) {  // widen the tile's integers to bf16, exactly
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
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_u32(kt + (lane % 16) * kLd + kk * 16 + (lane / 16) * 8));
        mma_16816(kk % 2 ? sb : sa, a, qf[kk][0], qf[kk][1]);
      }
      // c0: key g, head 2t; c1: key g, head 2t + 1; c2, c3: key g + 8
      float sc[4], tmx[2] = {kMaskValue, kMaskValue};
      bool ok[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + g + 8 * (e / 2);
        ok[e] = key >= kbeg && key < kend && 2 * t + e % 2 < G;
        float x = sa[e] + sb[e];
        if constexpr (kInt8) x *= ok[e] ? k_scale[slab + key] : 0.f;
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
        if constexpr (kInt8) w *= ok[e] ? v_scale[slab + key0 + g + 8 * (e / 2)] : 0.f;
        pt[(2 * t + e % 2) * L::kPLd + g + 8 * (e / 2)] = __float2bfloat16_rn(w);
      }
      l[0] = l[0] * al[0] + (p[0] + p[2]);
      l[1] = l[1] * al[1] + (p[1] + p[3]);
      __syncwarp();
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
      __syncwarp();  // stage j % stages and P consumed
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
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(tickets + bh, 1) == n_splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const size_t base = static_cast<size_t>(bh) * n_splits * G;
  float* sw = reinterpret_cast<float*>(dec_smem);  // [n_splits][G]: m, then each split's weight
  float* sl = sw + n_splits * G;                   // [n_splits][G]: l
  __shared__ float s_inv[8];
  for (int i = threadIdx.x; i < n_splits * G; i += kThreads) {
    sw[i] = __ldcg(part_m + base + i);
    sl[i] = __ldcg(part_l + base + i);
  }
  __syncthreads();
  // a warp a head: the max over live splits, each split's weight, and the
  // sum of weight x l in a fixed order (lane-strided, then a shuffle tree)
  for (int h = warp; h < G; h += kDecWarps) {
    float mx = -INFINITY;
    for (int sp_ = lane; sp_ < n_splits; sp_ += 32)
      if (sl[sp_ * G + h] > 0.f) mx = fmaxf(mx, sw[sp_ * G + h]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int sp_ = lane; sp_ < n_splits; sp_ += 32) {
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
  constexpr int kE = 8 * D / kThreads;
  const int E = G * D / kThreads;
  float acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = 0.f;
  for (int s4 = 0; s4 < n_splits; s4 += 4) {
    float val[4][kE], wt[4][kE];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int i = threadIdx.x + e * kThreads;
        const bool in = e < E && s4 + u < n_splits;
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
    if (e < E) out[static_cast<size_t>(bh) * G * D + i] = __float2bfloat16_rn(acc[e] * s_inv[i / D]);
  }
  if (threadIdx.x == 0) tickets[bh] = 0;
}

template <int D, bool kInt8>
int launch_tc(const void* q, const void* k, const void* v, const float* k_scale,
              const float* v_scale, const int* kv_limit, void* out, float* work, int* tickets,
              int B, int Hq, int Hkv, int S, int split, int window, float softcap, cudaStream_t s) {
  using L = DecodeTc<D, kInt8>;
  const int G = Hq / Hkv;
  const int n_splits = (S + split - 1) / split;
  const size_t smem = L::bytes(decode_tc_stages(split), n_splits, G);
  if (G > 8 || split % 16 != 0 || smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(decode_tc_kernel<D, kInt8>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_splits, B * Hkv);
  decode_tc_kernel<D, kInt8><<<grid, kDecWarps * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, k_scale, v_scale, kv_limit, work, tickets,
      static_cast<__nv_bfloat16*>(out), Hkv, G, S, split, n_splits, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Hq, D] (f32 or bf16), k/v [B, Hkv, S, D] in q's dtype or int8
// (kv_dtype kI8, with f32 k_scale/v_scale [B, Hkv, S]; else the scales are
// null), all contiguous; kv_limit i32 [B]; out [B, Hq, D] in q's dtype.
// part_m/part_l f32 [B*Hkv, n_splits, G] and part_o f32 [B*Hkv, n_splits, G,
// D] are scratch, n_splits = ceil(S/split).
extern "C" int gt_decode_attention(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale, const void* kv_limit,
                                   void* out, void* part_m, void* part_l, void* part_o, int B,
                                   int Hq, int Hkv, int S, int D, int q_dtype, int kv_dtype,
                                   int split, int window, float softcap, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lim = static_cast<const int*>(kv_limit);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* po = static_cast<float*>(part_o);
#define GT_DECODE(TQ, TKV, DIM) \
  return launch<TQ, TKV, DIM>(q, k, v, ks, vs, lim, out, pm, pl, po, B, Hq, Hkv, S, split, window, softcap, s)
  if (q_dtype == kBF16 && kv_dtype == kBF16 && D == 256) GT_DECODE(__nv_bfloat16, __nv_bfloat16, 256);
  if (q_dtype == kBF16 && kv_dtype == kBF16 && D == 128) GT_DECODE(__nv_bfloat16, __nv_bfloat16, 128);
  if (q_dtype == kF32 && kv_dtype == kF32 && D == 256) GT_DECODE(float, float, 256);
  if (q_dtype == kF32 && kv_dtype == kF32 && D == 128) GT_DECODE(float, float, 128);
  if (q_dtype == kBF16 && kv_dtype == kI8 && D == 256) GT_DECODE(__nv_bfloat16, int8_t, 256);
  if (q_dtype == kBF16 && kv_dtype == kI8 && D == 128) GT_DECODE(__nv_bfloat16, int8_t, 128);
  if (q_dtype == kF32 && kv_dtype == kI8 && D == 256) GT_DECODE(float, int8_t, 256);
  if (q_dtype == kF32 && kv_dtype == kI8 && D == 128) GT_DECODE(float, int8_t, 128);
#undef GT_DECODE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core kernel: q [B, Hq, D] bf16 with G = Hq / Hkv <= 8, k/v
// [B, Hkv, S, D] bf16 or int8 (kv_dtype kI8, with f32 k_scale/v_scale [B,
// Hkv, S]; else null), all contiguous; kv_limit i32 [B]; out [B, Hq, D]
// bf16. work: B * Hkv * n_splits * G * (D + 2) f32, n_splits = ceil(S /
// split); tickets: B * Hkv ints, 0 on entry and on return; split: a
// multiple of 16.
extern "C" int gt_decode_attention_tc(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* kv_limit, void* out, void* work, void* tickets,
                                      int B, int Hq, int Hkv, int S, int D, int kv_dtype, int split,
                                      int window, float softcap, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lim = static_cast<const int*>(kv_limit);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* w = static_cast<float*>(work);
  int* tk = static_cast<int*>(tickets);
#define GT_DECODE_TC(DIM, I8)                                                                \
  return launch_tc<DIM, I8>(q, k, v, ks, vs, lim, out, w, tk, B, Hq, Hkv, S, split, window, \
                            softcap, s)
  if (kv_dtype == kBF16 && D == 256) GT_DECODE_TC(256, false);
  if (kv_dtype == kBF16 && D == 128) GT_DECODE_TC(128, false);
  if (kv_dtype == kI8 && D == 256) GT_DECODE_TC(256, true);
  if (kv_dtype == kI8 && D == 128) GT_DECODE_TC(128, true);
#undef GT_DECODE_TC
  return static_cast<int>(cudaErrorInvalidValue);
}
