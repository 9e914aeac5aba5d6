// Shared helpers of the gemma_tpu_torch kernels (plain C entry points,
// built by gemma_tpu_torch/kernels/build.py and bound with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace gt {

// dtype codes passed from Python (kernels/build.py DTYPE_CODES, INT8_CODE)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kI8 = 2;  // int8 K/V with f32 scales

// the reference's attention mask value (gemma_tpu/ops/attention.py MASK_VALUE)
constexpr float kMaskValue = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an f32 value to T's precision and widen it back: the reference's
// casts to the working dtype before a dot (`p.astype(v.dtype)`, `w.bf16`).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

constexpr int kSmemDevices = 16;  // devices whose shared memory limits are remembered

// Raise `kernel`'s dynamic shared memory limit on the current device to at
// least `smem`. `limits` (one array a kernel, 0 on start) remembers the
// bytes set a device, so a launch pays the runtime call only when it needs
// more than any before: a decode step's launches wait on the host
// (PERF.md).
template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, std::atomic<int> (&limits)[kSmemDevices], size_t smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::atomic<int>* limit = dev < kSmemDevices ? &limits[dev] : nullptr;
  if (limit != nullptr && static_cast<int>(smem) <= limit->load(std::memory_order_relaxed)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess && limit != nullptr) {
    int seen = limit->load(std::memory_order_relaxed);
    while (seen < static_cast<int>(smem) && !limit->compare_exchange_weak(seen, static_cast<int>(smem))) {
    }
  }
  return e;
}

}  // namespace gt

// ---------------------------------------------------------------------------
// Split-S decode attention, shared by decode_attention.cu (dense cache) and
// paged_attention.cu (page pools). The internal linkage keeps each
// translation unit's instantiations its own; nvcc's host stubs take kernels
// in an unnamed namespace only at file scope, not inside `gt`.
// ---------------------------------------------------------------------------
namespace {

using namespace gt;

constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;

// A split that holds no live key: it reads nothing and contributes nothing
// (the combine skips it on l == 0).
__device__ __forceinline__ void write_dead_split(float* pm, float* pl, int G) {
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    pm[g] = -INFINITY;
    pl[g] = 0.f;
  }
}

// One split of T = 1 attention for the G query heads of one (batch, kv head)
// over the live keys lo..hi-1 of a [split, D] K/V slab (indices relative to
// the slab). Writes the split's softmax max and sum per head (pm, pl [G])
// and its unnormalized output (po [G, D]). smem: G * (D + split) floats.
//
// Numerics, the reference kernel's: s = q . k in f32, with int8 K scaled
// after the dot (s = (q . k8) * ks); softcap; p = exp(s - max); l sums p;
// the weight is p rounded to the K/V dtype, or for int8 bf16(p * vs), for
// f32 queries too; out = weight . v (int8 V exact in f32).
//
// Scores use one warp per key (lanes stride over D, so the reads of K and
// of q in shared memory are conflict-free); weight . v gives each thread
// (g, d) pairs and reads V rows coalesced.
template <typename TQ, typename TKV, int D>
__device__ __forceinline__ void attend_split(
    const TQ* __restrict__ qb, const TKV* __restrict__ kb, const TKV* __restrict__ vb,
    const float* __restrict__ ksb, const float* __restrict__ vsb, int lo, int hi, int split,
    int G, float softcap, float* __restrict__ pm, float* __restrict__ pl,
    float* __restrict__ po, float* smem) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int kPerLane = D / 32;
  float* qs = smem;          // [G][D]
  float* ws = smem + G * D;  // [G][split]: scores, then weights
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < G * D; i += kAttnThreads) qs[i] = to_f32(qb[i]);
  __syncthreads();

  for (int j = lo + warp; j < hi; j += kAttnWarps) {
    float kf[kPerLane];
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) kf[e] = to_f32(kb[static_cast<size_t>(j) * D + lane + 32 * e]);
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) s = fmaf(qs[g * D + lane + 32 * e], kf[e], s);
      s = warp_sum(s);
      if constexpr (kQuant) s *= ksb[j];
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      if (lane == 0) ws[g * split + j] = s;
    }
  }
  __syncthreads();

  // softmax statistics of this split, one warp per query head
  for (int g = warp; g < G; g += kAttnWarps) {
    float* row = ws + g * split;
    float m = -INFINITY;
    for (int j = lo + lane; j < hi; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lo + lane; j < hi; j += 32) {
      const float p = expf(row[j] - m);
      l += p;
      if constexpr (kQuant) {
        row[j] = round_to<__nv_bfloat16>(p * vsb[j]);
      } else {
        row[j] = round_to<TKV>(p);
      }
    }
    l = warp_sum(l);
    if (lane == 0) {
      pm[g] = m;
      pl[g] = l;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * D; i += kAttnThreads) {
    const int g = i / D;
    const int d = i % D;
    const float* row = ws + g * split;
    float acc = 0.f;
    for (int j = lo; j < hi; ++j) acc = fmaf(row[j], to_f32(vb[static_cast<size_t>(j) * D + d]), acc);
    po[i] = acc;
  }
}

// Merge the n_splits partials of each (batch, kv head) -- grid B * Hkv --
// into out [B * Hkv, G, D] in TQ. Dead splits (l == 0) are skipped: their
// partial output is unset.
template <typename TQ>
__global__ void __launch_bounds__(kAttnThreads)
attend_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                      const float* __restrict__ part_o, TQ* __restrict__ out, int G, int D,
                      int n_splits) {
  const int bh = blockIdx.x;
  const float* pm = part_m + static_cast<size_t>(bh) * n_splits * G;
  const float* pl = part_l + static_cast<size_t>(bh) * n_splits * G;
  const float* po = part_o + static_cast<size_t>(bh) * n_splits * G * D;
  for (int i = threadIdx.x; i < G * D; i += kAttnThreads) {
    const int g = i / D;
    float m = -INFINITY;
    for (int s = 0; s < n_splits; ++s)
      if (pl[s * G + g] > 0.f) m = fmaxf(m, pm[s * G + g]);
    float l = 0.f;
    float acc = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      if (!(pl[s * G + g] > 0.f)) continue;
      const float w = expf(pm[s * G + g] - m);
      l = fmaf(w, pl[s * G + g], l);
      acc = fmaf(w, po[static_cast<size_t>(s) * G * D + i], acc);
    }
    const float l_inv = l == 0.f ? 1.f : 1.f / l;
    out[static_cast<size_t>(bh) * G * D + i] = from_f32<TQ>(acc * l_inv);
  }
}

}  // namespace
