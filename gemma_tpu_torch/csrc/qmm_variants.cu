// Decode-GEMV instruments: an int8 x int4 -> int32 dot and a per-row byte
// checksum (the `stream` modes). The q4_0 GEMV's modes are launched from
// the main path's kernel in q4_0_matmul.cu (`gt_qmm_variant`).
//
// Replaces the Pallas kernels of the reference's timing tools:
// * `kernel3` of tools/probe_int4.py (`gt_int4_dot`);
// * the `stream` mode of `_kernel` in tools/bench_qmm_variants.py and
//   tools/bench_q6k_variants.py (`gt_row_checksum`).
//
// The int4 dot: x int8 [M, K], w int4 [N, K/2] (element 2j in the low
// nibble of byte j, two's complement), y int32. Hopper's wgmma takes no
// int4 (only the older mma.sync has s4 shapes), and at M <= 8 a tensor-core
// tile would be mostly padding: one warp per output row, x staged per
// 1024-element K-chunk in shared memory as int8 words, the nibbles
// sign-extended to int8 in registers and fed to __dp4a, four products an
// instruction.
//
// The checksum reads every byte of up to four arrays of [N, row_bytes] and
// writes, per row, the wrapping uint32 sum of their elements at their
// width (1, 2 or 4 bytes): the least work that still needs every byte. One
// warp per row; each lane issues kLoads 16-byte loads before it sums them,
// so a 2048-row array keeps megabytes in flight, as HBM's latency needs.
//
// What bounds it on the H100: bytes, for both. The dot does 2 * M int8
// operations on each half-byte weight (32 a byte at M = 8), far below the
// int8 tensor core's ~590 per byte of HBM; the checksum does one add a byte.
//
// Every launch is checked: each entry point returns cudaGetLastError().
#include "common.cuh"

namespace {

using namespace gt;

constexpr int kWarps = 8;
constexpr int kMaxM = 8;
constexpr int kKChunk = 1024;  // K elements of x staged per pass
constexpr int kLoads = 4;      // 16-byte loads a checksum lane has in flight

__device__ __forceinline__ uint32_t sext4(uint32_t v) {  // nibble -> int8 bits
  return static_cast<uint32_t>((static_cast<int>(v ^ 8u) - 8)) & 0xffu;
}

constexpr int kXWordsPad = 9;  // int32 words per lane's 32 staged int8 values

__global__ void __launch_bounds__(kWarps * 32)
int4_dot_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
                int32_t* __restrict__ y, int M, int N, int K) {
  __shared__ int32_t xs[kMaxM][32][kXWordsPad];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * kWarps + warp;
  const uint8_t* wrow = w + static_cast<size_t>(n) * (K / 2);
  int acc[kMaxM];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) acc[m] = 0;

  for (int k0 = 0; k0 < K; k0 += kKChunk) {
    const int klen = min(kKChunk, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < M * (kKChunk / 4); i += blockDim.x) {
      const int m = i / (kKChunk / 4);
      const int e4 = i % (kKChunk / 4);
      xs[m][e4 / 8][e4 % 8] = 4 * e4 < klen
          ? *reinterpret_cast<const int32_t*>(x + static_cast<size_t>(m) * K + k0 + 4 * e4) : 0;
    }
    __syncthreads();
    if (n < N && lane < klen / 32) {
      const uint4 raw = *reinterpret_cast<const uint4*>(wrow + static_cast<size_t>(k0 / 2) + 16 * lane);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      int packed[8];  // elements 4t..4t+3: bytes 2t and 2t + 1, low nibble first
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const uint32_t b0 = (words[t / 2] >> (16 * (t % 2))) & 0xffu;
        const uint32_t b1 = (words[t / 2] >> (16 * (t % 2) + 8)) & 0xffu;
        packed[t] = static_cast<int>(sext4(b0 & 0xfu) | (sext4(b0 >> 4) << 8) |
                                     (sext4(b1 & 0xfu) << 16) | (sext4(b1 >> 4) << 24));
      }
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
#pragma unroll
          for (int t = 0; t < 8; ++t) acc[m] = __dp4a(packed[t], xs[m][lane][t], acc[m]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
  }
  if (lane == 0 && n < N) {
#pragma unroll
    for (int m = 0; m < kMaxM; ++m)
      if (m < M) y[static_cast<size_t>(m) * N + n] = acc[m];
  }
}

struct ChecksumArrays {
  const uint8_t* p[4];
  int row_bytes[4];
  int width[4];
};

__device__ __forceinline__ uint32_t word_sum(uint32_t v, int width) {
  if (width == 1) return __dp4a(v, 0x01010101u, 0u);
  if (width == 2) return (v & 0xffffu) + (v >> 16);
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
row_checksum_kernel(ChecksumArrays a, int32_t* __restrict__ out, int N) {
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * kWarps + threadIdx.x / 32;
  if (n >= N) return;
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int rb = a.row_bytes[j];
    if (rb == 0) continue;
    const uint8_t* row = a.p[j] + static_cast<size_t>(n) * rb;
    const int width = a.width[j];
    if (rb % 16 == 0) {
      const uint4* words = reinterpret_cast<const uint4*>(row);
      const int nwords = rb / 16;
      for (int i0 = lane; i0 < nwords; i0 += 32 * kLoads) {
        uint4 v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int i = i0 + 32 * u;
          v[u] = i < nwords ? words[i] : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          acc += word_sum(v[u].x, width) + word_sum(v[u].y, width) + word_sum(v[u].z, width) +
                 word_sum(v[u].w, width);
      }
    } else {
      for (int i = lane; i < rb / 4; i += 32) acc += word_sum(reinterpret_cast<const uint32_t*>(row)[i], width);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[n] = static_cast<int32_t>(acc);
}

}  // namespace

// x: [M, K] int8; w: int4 [N, K/2] (K-paired, two's complement); y: [M, N]
// int32, exact.
extern "C" int gt_int4_dot(const void* x, const void* w, void* y, int M, int N, int K,
                           void* stream) {
  if (M <= 0 || M > kMaxM || N <= 0 || K <= 0 || K % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kWarps - 1) / kWarps);
  int4_dot_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w), static_cast<int32_t*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// Up to four arrays a_j of [N, row_bytes_j] (row_bytes_j 0 for none, else
// a multiple of 4) with element widths 1, 2 or 4; out: [N] int32.
extern "C" int gt_row_checksum(const void* a0, int rb0, int w0, const void* a1, int rb1, int w1,
                               const void* a2, int rb2, int w2, const void* a3, int rb3, int w3,
                               void* out, int N, void* stream) {
  ChecksumArrays a{{static_cast<const uint8_t*>(a0), static_cast<const uint8_t*>(a1),
                    static_cast<const uint8_t*>(a2), static_cast<const uint8_t*>(a3)},
                   {rb0, rb1, rb2, rb3}, {w0, w1, w2, w3}};
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; j < 4; ++j) {
    const int w = a.width[j];
    if (a.row_bytes[j] < 0 || a.row_bytes[j] % 4 != 0 || (a.row_bytes[j] && w != 1 && w != 2 && w != 4))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  row_checksum_kernel<<<(N + kWarps - 1) / kWarps, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<int32_t*>(out), N);
  return static_cast<int>(cudaGetLastError());
}
