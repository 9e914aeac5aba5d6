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
// What bounds it on the H100: at prefill lengths of a few hundred tokens
// the work is small and the kernel is latency- and shared-memory-bound, not
// HBM-bound. The design is the simple one: a block owns 16 query rows of
// one head (grid: T/16 x Hq x B, so any T and S, ragged edges masked) and
// walks the keys in tiles of 32 from the first tile any of its rows can
// see (window) to min(kv_limit, max row position + 1), so whole dead tiles
// are never read. Q, K and V tiles are staged in shared memory in f32
// (rows padded by one float so the score loop is bank-conflict-free);
// scores and p . v are plain FMA with f32 accumulation. At D = 256 the
// tiles need ~84 KB of shared memory, so the launch opts in with
// cudaFuncSetAttribute(MaxDynamicSharedMemorySize). Tensor cores are later
// work.
#include "common.cuh"

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ positions, const int* __restrict__ kv_limit,
             T* __restrict__ out, int T_len, int Hq, int Hkv, int S, int window, float softcap) {
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
        t < T_len ? to_f32(q[((static_cast<size_t>(b) * T_len + t) * Hq + h) * D + d]) : 0.f;
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

  const T* kb = k + (static_cast<size_t>(b) * Hkv + hk) * S * D;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hk) * S * D;
  for (int s0 = s_beg; s0 < s_end; s0 += kBS) {
    __syncthreads();  // previous tile's Ks/Vs/Ps fully consumed
    for (int i = tid; i < kBS * D; i += kThreads) {
      const int j = i / D;
      const int d = i % D;
      const int s = s0 + j;
      const bool in = s < S;
      Ks[j * (D + 1) + d] = in ? to_f32(kb[static_cast<size_t>(s) * D + d]) : 0.f;
      Vs[j * D + d] = in ? to_f32(vb[static_cast<size_t>(s) * D + d]) : 0.f;
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
      Ps[r * (kBS + 1) + lane] = round_to<T>(p);
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
    out[((static_cast<size_t>(b) * T_len + t) * Hq + h) * D + d_own] = from_f32<T>(o[i] * l_inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* positions, const int* kv_limit,
           void* out, int B, int T_len, int Hq, int Hkv, int S, int window, float softcap,
           cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_len + kBQ - 1) / kBQ, Hq, B);
  flash_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), positions,
      kv_limit, static_cast<T*>(out), T_len, Hq, Hkv, S, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, T, Hq, D], k/v [B, Hkv, S, D], out [B, T, Hq, D] (contiguous, all f32
// or all bf16), positions i32 [B, T], kv_limit i32 [B]. Returns a cudaError_t.
extern "C" int gt_flash_attention(const void* q, const void* k, const void* v,
                                  const void* positions, const void* kv_limit, void* out, int B,
                                  int T_len, int Hq, int Hkv, int S, int D, int dtype, int window,
                                  float softcap, void* stream) {
  if (B <= 0 || T_len <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(positions);
  const int* lim = static_cast<const int*>(kv_limit);
#define GT_FLASH(T, DIM) \
  return launch<T, DIM>(q, k, v, pos, lim, out, B, T_len, Hq, Hkv, S, window, softcap, s)
  if (dtype == kBF16 && D == 256) GT_FLASH(__nv_bfloat16, 256);
  if (dtype == kBF16 && D == 128) GT_FLASH(__nv_bfloat16, 128);
  if (dtype == kF32 && D == 256) GT_FLASH(float, 256);
  if (dtype == kF32 && D == 128) GT_FLASH(float, 128);
#undef GT_FLASH
  return static_cast<int>(cudaErrorInvalidValue);
}
