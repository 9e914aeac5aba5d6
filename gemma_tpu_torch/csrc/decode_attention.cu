// Decode (T = 1) attention over the dense per-layer KV cache.
//
// Replaces the bf16 arm of the Pallas kernel `_decode_kernel` of
// gemma_tpu/ops/attention.py (launched by `_decode_call` via
// `decode_attention`). Semantics, per batch row b with limit = kv_limit[b]
// (the query sits at position limit - 1):
//   s = q . k (f32), then softcap: s = cap * tanh(s / cap);
//   key col is valid iff col < limit and, with a window, col > limit-1-window;
//   online softmax in f32, p rounded to the cache dtype before p . v,
//   out = acc / l (0 where no key is valid), returned in q's dtype.
//
// What bounds it on the H100: the live prefix of K and V (bytes). The TPU
// kernel walks S in sequence per (batch) and skips dead tiles with
// `tile_map`; one block per (batch, kv head) here would use 1 of the 132
// SMs for Gemma-2B (Hkv = 1). So the work is split along S:
// `decode_split_kernel` gives each block `split` keys of one (b, kv head)
// for all G query heads of the group. Blocks whose keys are all outside
// [max(limit - window, 0), limit) return at once, so only live tiles are
// read. Each live block writes its partial (max, sum, unnormalized output),
// and `decode_combine_kernel`, a second small launch, rescales and sums the
// partials. Scores use one warp per key (lanes stride over D so both the
// global reads of K and the shared reads of q are conflict-free); p . v
// gives each thread (g, d) pairs and reads V rows coalesced.
#include "common.cuh"

using namespace gt;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ kv_limit, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_o, int Hkv, int G, int S,
                    int split, int n_splits, int window, float softcap) {
  extern __shared__ float smem[];
  float* qs = smem;           // [G][D]
  float* ps = smem + G * D;   // [G][split]
  const int sp = blockIdx.x;
  const int bh = blockIdx.y;  // b * Hkv + kv head
  const int b = bh / Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int limit = min(kv_limit[b], S);
  const int live_lo = window > 0 ? max(limit - window, 0) : 0;
  const int s0 = sp * split;
  const int kbeg = max(s0, live_lo);
  const int kend = min(s0 + split, limit);  // exclusive
  const size_t pidx = static_cast<size_t>(bh) * n_splits + sp;
  float* pm = part_m + pidx * G;
  float* pl = part_l + pidx * G;
  float* po = part_o + pidx * G * D;
  if (kbeg >= kend) {  // dead split: read nothing, contribute nothing
    for (int g = threadIdx.x; g < G; g += kThreads) {
      pm[g] = -INFINITY;
      pl[g] = 0.f;
    }
    return;
  }

  const T* qb = q + static_cast<size_t>(bh) * G * D;  // q [B, Hq, D], Hq = Hkv * G
  for (int i = threadIdx.x; i < G * D; i += kThreads) qs[i] = to_f32(qb[i]);
  __syncthreads();

  const T* kb = k + static_cast<size_t>(bh) * S * D;  // k/v [B, Hkv, S, D]
  const T* vb = v + static_cast<size_t>(bh) * S * D;
  constexpr int kPerLane = D / 32;
  for (int j = kbeg + warp; j < kend; j += kWarps) {
    float kf[kPerLane];
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) kf[e] = to_f32(kb[static_cast<size_t>(j) * D + lane + 32 * e]);
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) s = fmaf(qs[g * D + lane + 32 * e], kf[e], s);
      s = warp_sum(s);
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      if (lane == 0) ps[g * split + (j - s0)] = s;
    }
  }
  __syncthreads();

  // softmax statistics of this split, one warp per query head
  for (int g = warp; g < G; g += kWarps) {
    float* row = ps + g * split;
    float m = -INFINITY;
    for (int j = kbeg - s0 + lane; j < kend - s0; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = kbeg - s0 + lane; j < kend - s0; j += 32) {
      const float p = expf(row[j] - m);
      l += p;
      row[j] = round_to<T>(p);
    }
    l = warp_sum(l);
    if (lane == 0) {
      pm[g] = m;
      pl[g] = l;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    const float* row = ps + g * split;
    float acc = 0.f;
    for (int j = kbeg; j < kend; ++j)
      acc = fmaf(row[j - s0], to_f32(vb[static_cast<size_t>(j) * D + d]), acc);
    po[i] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                      const float* __restrict__ part_o, T* __restrict__ out, int G, int D,
                      int n_splits) {
  const int bh = blockIdx.x;
  const float* pm = part_m + static_cast<size_t>(bh) * n_splits * G;
  const float* pl = part_l + static_cast<size_t>(bh) * n_splits * G;
  const float* po = part_o + static_cast<size_t>(bh) * n_splits * G * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    float m = -INFINITY;
    for (int s = 0; s < n_splits; ++s)
      if (pl[s * G + g] > 0.f) m = fmaxf(m, pm[s * G + g]);
    float l = 0.f;
    float acc = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      if (!(pl[s * G + g] > 0.f)) continue;  // dead split: its partial output is unset
      const float w = expf(pm[s * G + g] - m);
      l = fmaf(w, pl[s * G + g], l);
      acc = fmaf(w, po[static_cast<size_t>(s) * G * D + i], acc);
    }
    const float l_inv = l == 0.f ? 1.f : 1.f / l;
    out[static_cast<size_t>(bh) * G * D + i] = from_f32<T>(acc * l_inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* kv_limit, void* out,
           float* part_m, float* part_l, float* part_o, int B, int Hq, int Hkv, int S, int split,
           int window, float softcap, cudaStream_t s) {
  const int G = Hq / Hkv;
  const int n_splits = (S + split - 1) / split;
  const size_t smem = static_cast<size_t>(G) * (D + split) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_splits, B * Hkv);
  decode_split_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_limit,
      part_m, part_l, part_o, Hkv, G, S, split, n_splits, window, softcap);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<B * Hkv, kThreads, 0, s>>>(part_m, part_l, part_o,
                                                        static_cast<T*>(out), G, D, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Hq, D], k/v [B, Hkv, S, D] (contiguous, dtype f32 or bf16), kv_limit
// i32 [B], out [B, Hq, D] in q's dtype. part_m/part_l f32 [B*Hkv, n_splits, G]
// and part_o f32 [B*Hkv, n_splits, G, D] are scratch, n_splits = ceil(S/split).
extern "C" int gt_decode_attention(const void* q, const void* k, const void* v,
                                   const void* kv_limit, void* out, void* part_m, void* part_l,
                                   void* part_o, int B, int Hq, int Hkv, int S, int D, int dtype,
                                   int split, int window, float softcap, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lim = static_cast<const int*>(kv_limit);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* po = static_cast<float*>(part_o);
#define GT_DECODE(T, DIM) \
  return launch<T, DIM>(q, k, v, lim, out, pm, pl, po, B, Hq, Hkv, S, split, window, softcap, s)
  if (dtype == kBF16 && D == 256) GT_DECODE(__nv_bfloat16, 256);
  if (dtype == kBF16 && D == 128) GT_DECODE(__nv_bfloat16, 128);
  if (dtype == kF32 && D == 256) GT_DECODE(float, 256);
  if (dtype == kF32 && D == 128) GT_DECODE(float, 128);
#undef GT_DECODE
  return static_cast<int>(cudaErrorInvalidValue);
}
