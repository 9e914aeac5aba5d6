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
// `decode_tc_kernel` (decode_tc.cuh, with `DenseRows`) at 2 <= G = Hq / Hkv
// <= 8 (Gemma-2B's G = 8; the main path): bf16 q over a bf16 or int8 cache
// (`DecBf16`, `DecInt8`), and f32 q over an f32 cache in 3xTF32
// (`DecTf32`: f32 serving and --verify's f32 cache): 16 keys on the m16
// side of `mma.sync` and the query group on n8, the splits merged in the
// same launch by the last block. The paged kernel (paged_attention.cu)
// runs the same core through its page table (bf16 q).
//
// `decode_split_kernel`: G = 1 and G > 8, and f32 q over an int8 cache,
// with FMA only. At G = 1 (Gemma-7B) the tensor-core kernel, whose n8 side
// then carries 7 zero columns, measured faster at batch 1 and slower over
// 8 serving rows, where its 1024 blocks of 69 KB run in three waves
// against the split-S kernel's one (PERF.md).
// `decode_split_kernel` gives each block `split` keys of one (b, kv head)
// for all G query heads of the group. Blocks whose keys are all outside
// [max(limit - window, 0), limit) write an empty partial and return at once,
// so only live tiles are read. Each live block writes its partial (max, sum,
// unnormalized output), and `attend_combine_kernel` (common.cuh), a second
// small launch, rescales and sums the partials. The split itself is
// `attend_split` (common.cuh), shared with the paged kernel.
#include "decode_tc.cuh"

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

// The tensor-core kernel: q [B, Hq, D] with G = Hq / Hkv <= 8, bf16 over
// k/v [B, Hkv, S, D] bf16 or int8 (kv_dtype kI8, with f32 k_scale/v_scale
// [B, Hkv, S]; else null), or f32 over f32 k/v (kv_dtype kF32, the TF32
// policy), all contiguous; kv_limit i32 [B]; out [B, Hq, D] in q's dtype.
// work: B * Hkv * n_splits * G * (D + 2) f32, n_splits = ceil(S / split);
// tickets: B * Hkv ints, 0 on entry and on return; split: a multiple of
// 16.
extern "C" int gt_decode_attention_tc(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* kv_limit, void* out, void* work, void* tickets,
                                      int B, int Hq, int Hkv, int S, int D, int kv_dtype, int split,
                                      int window, float softcap, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype == kF32) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* lim = static_cast<const int*>(kv_limit);
    float* wk = static_cast<float*>(work);
    int* tk = static_cast<int*>(tickets);
    if (D == 256)
      return launch_decode_tc<256, DecTf32>(q, k, v, nullptr, nullptr, lim, out, wk, tk, DenseRows{S}, B, Hq,
                                            Hkv, S, split, window, softcap, s);
    if (D == 128)
      return launch_decode_tc<128, DecTf32>(q, k, v, nullptr, nullptr, lim, out, wk, tk, DenseRows{S}, B, Hq,
                                            Hkv, S, split, window, softcap, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_decode_tc(kv_dtype, D, q, k, v, static_cast<const float*>(k_scale),
                            static_cast<const float*>(v_scale), static_cast<const int*>(kv_limit),
                            out, static_cast<float*>(work), static_cast<int*>(tickets),
                            DenseRows{S}, B, Hq, Hkv, S, split, window, softcap,
                            static_cast<cudaStream_t>(stream));
}
