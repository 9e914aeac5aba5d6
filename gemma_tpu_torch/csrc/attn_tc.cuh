// Shared pieces of the tensor-core attention kernels (flash_attention.cu,
// decode_tc.cuh): the transposing ldmatrix, the 3xTF32 product of their
// f32 policies, and reductions over the lanes of a warp or of an mma
// fragment.
//
// Fragment layouts of `mma.sync.m16n8k16` (bf16 operands, f32
// accumulators), lane = 4 g + t: A[g (+8)][2t (+8) + {0, 1}],
// B[2t (+8) + {0, 1}][g], C[g (+8)][2t + {0, 1}]. A C fragment's row lives
// on the 4 lanes of a quad (same g); its column on the 8 lanes of the same
// t. gemma_tpu_torch/tools/tc_emulation.py emulates both kernels lane by
// lane through these layouts.
#pragma once

#include <limits.h>

#include "dq_tile_tf32.cuh"  // cp.async, ldmatrix_x4, mma_16816, pack_bf16, smem_u32, split_tf32, mma_1688_tf32

namespace {

using namespace gt;

// ldmatrix.x4.trans: lane l's address gives row l % 8 of matrix l / 8; lane
// (g, t) receives, of each 8 x 8 matrix M, (M[2t][g], M[2t + 1][g])
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a . b in 3xTF32 (m16n8k8), each operand split by `split_tf32` into
// hi and lo: the small parts' products first, then hi . hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_1688_tf32(c, al, bh0, bh1);
  mma_1688_tf32(c, ah, bl0, bl1);
  mma_1688_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ int warp_max_i(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ int warp_min_i(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// over the 4 lanes of a quad (a C fragment's row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// over the 8 lanes of the same t (a C fragment's column)
__device__ __forceinline__ float col_max(float x) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float col_sum(float x) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace
