// Shared helpers of the gemma_tpu_torch kernels (plain C entry points,
// built by gemma_tpu_torch/kernels/build.py and bound with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gt {

// dtype codes passed from Python (kernels/build.py DTYPE_CODES)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// the reference's attention mask value (gemma_tpu/ops/attention.py MASK_VALUE)
constexpr float kMaskValue = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

}  // namespace gt
