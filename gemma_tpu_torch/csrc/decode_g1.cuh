// The decode (T = 1) attention core for one query head a KV head (G = Hq /
// Hkv = 1: Gemma-7B's multi-head attention), shared by the dense cache
// (decode_attention.cu) and the page pools (paged_attention.cu).
//
// `decode_g1_kernel<D, E, Rows>`. Replaces at G = 1 the Pallas kernels
// `_decode_kernel` (gemma_tpu/ops/attention.py) and `_paged_kernel`
// (gemma_tpu/ops/paged_attention.py), over the element policy E: bf16 q
// over bf16 K/V, bf16 q over int8 K/V with f32 scales a key (read in
// place), f32 q over f32 K/V, and f32 q over int8 K/V. Numerics, the
// reference's (decode_attention.cu): s = q . k in f32 (int8: s = (q . k8)
// * ks), softcap, the key mask, an online softmax in f32, the weight p
// rounded to the cache dtype (int8: bf16(p * vs), f32 q too; f32: p kept),
// out = weight . v / l, 0 where no key is valid, in q's dtype.
//
// What bounds it on the H100: at G = 1 each key is used by one query row,
// so the work is 4 flops a byte of bf16 K and V: bytes, and at today's
// lengths latency (Gemma-7B's 16 heads at limit 204 read 3.3 MB, 1.0 us
// of HBM). The split-S kernel it replaces took a key a warp, 64 bytes a
// warp a load, staged every score in shared memory for a separate softmax
// pass, walked every key serially for each output, and merged its splits
// in a second launch; and a tensor-core core would carry 7 zero columns.
// This core is built for one row:
// * Loads: a lane owns one 16-byte slice of a key row (bf16 at D = 256:
//   a row is one warp-wide load; int8 two rows a load, f32 half a row) and
//   the same slice of q and of the output, in registers. A warp keeps up
//   to 8 such loads of K and 8 of V in flight a step (`G1Layout::kKeys`
//   keys: 8 in bf16 and int8 at D = 256, 4 in f32), plain 16-byte vector
//   loads.
// * Scores: each lane's slice of q . k in f32 (fmaf in element order),
//   then a shuffle tree over the lanes of the row; int8 scales after the
//   dot; softcap; keys at or past the block's end masked (and not read).
// * Online softmax in registers, per warp: the step's max over its rows
//   (a shuffle tree over the rows of a load), the rescale, p = exp(s - m),
//   its weight rounded as above; each lane adds weight x its V slice. No
//   score touches shared memory.
// * One launch: the warps merge in shared memory (4 KB at D = 256), the
//   block writes its partial to the stream's persistent workspace
//   (kernels/build.py `workspace`), and the last block of each (b, kv head)
//   merges the splits in split order by a ticket (`merge_splits_last`,
//   decode_tc.cuh, the tensor-core core's merge): no second launch, no
//   per-call allocation, and the result does not depend on which block
//   finished last.
// * A block takes `split` keys (ops/attention.py `decode_tc_split`), fixed
//   by S and never by the live length, which stays on the device: the
//   launch can be captured in a graph once the workspace is sized. Its
//   warps take steps of kKeys keys in turn from the first live key. A
//   split with no live key (past the limit, or before the window) reads
//   nothing, writes no partial and takes no ticket: the live splits of a
//   row follow from its limit, so the last of them merges only those
//   (the whole row's out is 0 where it has no live key).
// * Rows: each key's row comes from the policy `Rows` (decode_tc.cuh):
//   `DenseRows`, or `PagedRows` through the page table, looked up for each
//   key, so every page size is taken. With the same S and split both run
//   the same steps in the same order with the same arithmetic: paged
//   equals dense decode on the gathered pages bit for bit.
// Expected (written before the first run on the card; the split-S kernel's
// Gemma-7B readings, NVIDIA H100 80GB HBM3, 700 W): batch 1 at S = 512,
// limit 204 0.004-0.006 ms (split-S 0.0136, bound 0.0010); 8 serving rows
// 0.008-0.011 (0.0190, bound 0.0069); f32 q at S = 512 ~0.005 (0.0131), at
// S = 4096 no worse than 0.0715 (bound 0.040); a Gemma-7B q8_0 decode step
// ~0.2-0.3 ms less busy of ~7.56 and 28 fewer launches. What the card
// measured: PERF.md section 6.
#pragma once

#include "decode_tc.cuh"  // DenseRows, PagedRows, merge_splits_last

namespace {

using namespace gt;

constexpr int kG1Warps = 4;

// the element policies: the query's and the cache's element types
template <typename TQ_, typename TKV_>
struct G1Elems {
  using TQ = TQ_;
  using TKV = TKV_;
  static constexpr bool kInt8 = std::is_same<TKV_, int8_t>::value;
};

// a lane's share of a key row: 16-byte chunks of kEpc elements, kLpr lanes
// a row (kRpw rows a warp-wide load), kCpl chunks a lane a row; kNu row
// loads a lane a step (at most 8 chunks of K and 8 of V, at most 64
// elements: int8 4 rows, its widening and FMAs being twice bf16's a chunk),
// kKeys keys a warp step
template <int D, typename TKV>
struct G1Layout {
  static constexpr int kEpc = 16 / static_cast<int>(sizeof(TKV));
  static constexpr int kChunks = D / kEpc;
  static constexpr int kLpr = kChunks < 32 ? kChunks : 32;
  static constexpr int kRpw = 32 / kLpr;
  static constexpr int kCpl = kChunks / kLpr;
  static constexpr int kNu = 8 / kCpl < 64 / (kCpl * kEpc) ? 8 / kCpl : 64 / (kCpl * kEpc);
  static constexpr int kKeys = kNu * kRpw;
};

// element e of a 16-byte chunk as f32 (exact)
template <typename T> __device__ __forceinline__ float chunk_elem(const uint4& c, int e);
template <> __device__ __forceinline__ float chunk_elem<__nv_bfloat16>(const uint4& c, int e) {
  const uint32_t w = (&c.x)[e / 2];
  return __uint_as_float(e % 2 ? w & 0xFFFF0000u : w << 16);
}
template <> __device__ __forceinline__ float chunk_elem<int8_t>(const uint4& c, int e) {
  return static_cast<float>(static_cast<int8_t>(((&c.x)[e / 4] >> (8 * (e % 4))) & 0xFF));
}
template <> __device__ __forceinline__ float chunk_elem<float>(const uint4& c, int e) {
  return __uint_as_float((&c.x)[e]);
}

// q [B * Hkv, D] (one head a KV head); S: the logical keys of a row (the
// dense cache's S, or maxp * ps); work: part_m, part_l [B * Hkv][n_splits]
// then part_o [..][D], f32
template <int D, class E, class Rows>
__global__ void __launch_bounds__(kG1Warps * 32)
decode_g1_kernel(const typename E::TQ* __restrict__ q, const typename E::TKV* __restrict__ k,
                 const typename E::TKV* __restrict__ v, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale, const int* __restrict__ kv_limit,
                 float* __restrict__ work, int* __restrict__ tickets, typename E::TQ* __restrict__ out,
                 const Rows rows, int Hkv, int S, int split, int n_splits, int window, float softcap) {
  using TKV = typename E::TKV;
  using L = G1Layout<D, TKV>;
  constexpr int kThreads = kG1Warps * 32;
  extern __shared__ __align__(16) float g1_smem[];
  __shared__ float s_m[kG1Warps], s_l[kG1Warps];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rr = lane / L::kLpr, cl = lane % L::kLpr;  // the lane's row of a load, its chunk
  const int sp = blockIdx.x, bh = blockIdx.y, b = bh / Hkv;
  // this lane's chunks of q (elements (cl + kLpr i) kEpc + e), loaded
  // beside the limit: the key loads wait on the limit, these need not
  float qf[L::kCpl][L::kEpc];
  const typename E::TQ* qb = q + static_cast<size_t>(bh) * D;
#pragma unroll
  for (int i = 0; i < L::kCpl; ++i) {
#pragma unroll
    for (int e = 0; e < L::kEpc; ++e) qf[i][e] = to_f32(qb[(cl + L::kLpr * i) * L::kEpc + e]);
  }
  const int limit = min(kv_limit[b], S);
  const int live_lo = window > 0 ? max(limit - window, 0) : 0;
  const int sp_lo = live_lo / split, sp_hi = (limit + split - 1) / split;  // the splits with a live key
  if (sp < sp_lo || sp >= sp_hi) {  // reads no key, writes no partial, takes no ticket
    if (sp == 0 && sp_hi <= sp_lo) {  // no live key in the row (limit 0): out = 0
      for (int d = threadIdx.x; d < D; d += kThreads)
        out[static_cast<size_t>(bh) * D + d] = from_f32<typename E::TQ>(0.f);
    }
    return;
  }
  const int s0 = sp * split;
  const int kbeg = max(s0, live_lo), kend = min(s0 + split, limit);  // live keys [kbeg, kend), not empty
  const size_t npart = static_cast<size_t>(gridDim.y) * n_splits;
  float* part_m = work;
  float* part_l = work + npart;
  float* part_o = work + 2 * npart;
  const size_t pidx = static_cast<size_t>(bh) * n_splits + sp;

  float o[L::kCpl][L::kEpc];
#pragma unroll
  for (int i = 0; i < L::kCpl; ++i) {
#pragma unroll
    for (int e = 0; e < L::kEpc; ++e) o[i][e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;  // the warp's running max; l: this lane's row group's keys

  // warp w takes the steps of keys kbeg + kKeys (w + kG1Warps j) ..; key
  // key0 + u kRpw + rr is this lane's u-th row
  for (int key0 = kbeg + warp * L::kKeys; key0 < kend; key0 += kG1Warps * L::kKeys) {
    uint4 kr[L::kNu][L::kCpl], vr[L::kNu][L::kCpl];
    float ks[L::kNu], vs[L::kNu];
    bool ok[L::kNu];
#pragma unroll
    for (int u = 0; u < L::kNu; ++u) {
      const int key = key0 + u * L::kRpw + rr;
      ok[u] = key < kend;
      ks[u] = vs[u] = 0.f;
#pragma unroll
      for (int i = 0; i < L::kCpl; ++i) kr[u][i] = vr[u][i] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u]) {
        const size_t row = rows(bh, key);
        const uint4* kp = reinterpret_cast<const uint4*>(k + row * D) + cl;
        const uint4* vp = reinterpret_cast<const uint4*>(v + row * D) + cl;
#pragma unroll
        for (int i = 0; i < L::kCpl; ++i) {
          kr[u][i] = __ldg(kp + L::kLpr * i);
          vr[u][i] = __ldg(vp + L::kLpr * i);
        }
        if constexpr (E::kInt8) {
          ks[u] = __ldg(k_scale + row);
          vs[u] = __ldg(v_scale + row);
        }
      }
    }
    // scores: the lane's slice, then the shuffle tree over the row's lanes
    float s[L::kNu];
    float mx = kMaskValue;
#pragma unroll
    for (int u = 0; u < L::kNu; ++u) {
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < L::kCpl; ++i) {
#pragma unroll
        for (int e = 0; e < L::kEpc; ++e) x = fmaf(qf[i][e], chunk_elem<TKV>(kr[u][i], e), x);
      }
#pragma unroll
      for (int off = L::kLpr / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if constexpr (E::kInt8) x *= ks[u];
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      s[u] = ok[u] ? x : kMaskValue;
      mx = fmaxf(mx, s[u]);
    }
#pragma unroll
    for (int off = L::kLpr; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float mn = fmaxf(m, mx);
    const float al = expf(m - mn);
    m = mn;
#pragma unroll
    for (int i = 0; i < L::kCpl; ++i) {
#pragma unroll
      for (int e = 0; e < L::kEpc; ++e) o[i][e] *= al;
    }
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < L::kNu; ++u) {
      const float p = ok[u] ? expf(s[u] - m) : 0.f;
      psum += p;
      float w;
      if constexpr (E::kInt8) {
        w = round_to<__nv_bfloat16>(p * vs[u]);
      } else {
        w = round_to<TKV>(p);
      }
#pragma unroll
      for (int i = 0; i < L::kCpl; ++i) {
#pragma unroll
        for (int e = 0; e < L::kEpc; ++e) o[i][e] = fmaf(w, chunk_elem<TKV>(vr[u][i], e), o[i][e]);
      }
    }
    l = l * al + psum;
  }

  // the warp's rows of a load summed (a shuffle tree), then the warps merged
#pragma unroll
  for (int off = L::kLpr; off < 32; off <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int i = 0; i < L::kCpl; ++i) {
#pragma unroll
      for (int e = 0; e < L::kEpc; ++e) o[i][e] += __shfl_xor_sync(0xffffffffu, o[i][e], off);
    }
  }
  float* red = g1_smem;  // [kG1Warps][D]
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  if (rr == 0) {
#pragma unroll
    for (int i = 0; i < L::kCpl; ++i) {
#pragma unroll
      for (int e = 0; e < L::kEpc; ++e) red[warp * D + (cl + L::kLpr * i) * L::kEpc + e] = o[i][e];
    }
  }
  __syncthreads();
  // each warp scaled to the block's max, summed in warp order (a warp
  // without keys: m = -inf, weight 0)
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kG1Warps; ++w) mx = fmaxf(mx, s_m[w]);
  float f[kG1Warps];
#pragma unroll
  for (int w = 0; w < kG1Warps; ++w) f[w] = expf(s_m[w] - mx);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kG1Warps; ++w) acc += red[w * D + d] * f[w];
    part_o[pidx * D + d] = acc;
  }
  if (threadIdx.x == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kG1Warps; ++w) sum += s_l[w] * f[w];
    part_m[pidx] = mx;
    part_l[pidx] = sum;
  }
  merge_splits_last<D, 1, kThreads>(part_m, part_l, part_o, out, tickets, bh, 1, n_splits, sp_lo, sp_hi,
                                    g1_smem);
}

// One launch of the core: q [B, Hq, D] (E::TQ) with Hq == Hkv; k/v and
// their scales where `rows` finds them, 16-byte aligned; S logical keys a
// row; work: B * Hkv * n_splits * (D + 2) f32, n_splits = ceil(S / split);
// tickets: B * Hkv ints, 0 on entry and on return.
template <int D, class E, class Rows>
int launch_decode_g1(const void* q, const void* k, const void* v, const float* k_scale,
                     const float* v_scale, const int* kv_limit, void* out, float* work, int* tickets,
                     const Rows& rows, int B, int Hkv, int S, int split, int window, float softcap,
                     cudaStream_t s) {
  using TQ = typename E::TQ;
  using TKV = typename E::TKV;
  static std::atomic<int> limits[kSmemDevices];
  const int n_splits = (S + split - 1) / split;
  const size_t red = static_cast<size_t>(kG1Warps) * D * sizeof(float);
  const size_t last = static_cast<size_t>(2) * n_splits * sizeof(float);
  const size_t smem = red > last ? red : last;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = raise_smem_limit(decode_g1_kernel<D, E, Rows>, limits, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_splits, B * Hkv);
  decode_g1_kernel<D, E, Rows><<<grid, kG1Warps * 32, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), k_scale,
      v_scale, kv_limit, work, tickets, static_cast<TQ*>(out), rows, Hkv, S, split, n_splits, window,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

// launch_decode_g1 at the q and kv dtype codes (q kBF16 or kF32; kv q's
// code or kI8) and head dim (128 or 256) of a call; refuses G != 1, a
// split below 1 and K/V not 16-byte aligned
template <class Rows>
int dispatch_decode_g1(int q_dtype, int kv_dtype, int D, const void* q, const void* k, const void* v,
                       const float* k_scale, const float* v_scale, const int* kv_limit, void* out,
                       float* work, int* tickets, const Rows& rows, int B, int Hq, int Hkv, int S,
                       int split, int window, float softcap, cudaStream_t s) {
  if (B <= 0 || Hkv <= 0 || Hq != Hkv || S <= 0 || split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
#define GT_DECODE_G1(TQ, TKV, DIM)                                                                 \
  return launch_decode_g1<DIM, G1Elems<TQ, TKV>, Rows>(q, k, v, k_scale, v_scale, kv_limit, out, work, \
                                                       tickets, rows, B, Hkv, S, split, window,      \
                                                       softcap, s)
  if (q_dtype == kBF16 && kv_dtype == kBF16 && D == 256) GT_DECODE_G1(__nv_bfloat16, __nv_bfloat16, 256);
  if (q_dtype == kBF16 && kv_dtype == kBF16 && D == 128) GT_DECODE_G1(__nv_bfloat16, __nv_bfloat16, 128);
  if (q_dtype == kBF16 && kv_dtype == kI8 && D == 256) GT_DECODE_G1(__nv_bfloat16, int8_t, 256);
  if (q_dtype == kBF16 && kv_dtype == kI8 && D == 128) GT_DECODE_G1(__nv_bfloat16, int8_t, 128);
  if (q_dtype == kF32 && kv_dtype == kF32 && D == 256) GT_DECODE_G1(float, float, 256);
  if (q_dtype == kF32 && kv_dtype == kF32 && D == 128) GT_DECODE_G1(float, float, 128);
  if (q_dtype == kF32 && kv_dtype == kI8 && D == 256) GT_DECODE_G1(float, int8_t, 256);
  if (q_dtype == kF32 && kv_dtype == kI8 && D == 128) GT_DECODE_G1(float, int8_t, 128);
#undef GT_DECODE_G1
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
