// Paged decode (T = 1) attention: K/V pages read through a page table.
//
// Replaces the Pallas kernel `_paged_kernel` of
// gemma_tpu/ops/paged_attention.py (launched by `_paged_call` via
// `paged_decode_attention`), both its arms: pages in the query's dtype (bf16
// or f32), and int8 pages with f32 scales [P, Hkv, ps] read in place.
// Layouts: q [B, Hq, D]; k/v pages [P, Hkv, ps, D]; page_table i32 [B, maxp]
// (the physical page of each logical page of a sequence; 0 is the trash
// page); kv_limit i32 [B] (the query sits at position kv_limit - 1). The
// numerics are decode attention's (decode_attention.cu).
//
// What bounds it on the H100: launch and latency at serving shapes (8 slots
// x ~300 keys x 256 x 2 bytes x 2 for K and V is ~2.5 MB a layer in bf16,
// under 1 us of HBM time; half for int8), the live K/V bytes at long
// contexts. The TPU kernel walks the pages of a row in sequence with its
// running softmax in VMEM and fetches each page through scalar-prefetched
// table entries (`page_map`). Three kernels, routed in
// ops/paged_attention.py `paged_route`:
//
// `decode_tc_kernel` (decode_tc.cuh, with `PagedRows`): 2 <= G <= 8 and a
// page size that is a multiple of 16 (the main path: Gemma-2B's G = 8,
// 64-token pages), every element policy of the dense core: bf16 q over bf16
// or int8 pages, f32 q over f32 pages (`DecTf32`) or int8 pages
// (`DecTf32Int8`). The dense decode kernel's tensor-core core with the page
// table in place of the slab offset: all G query heads on the n8 side of
// `mma.sync`, 16-key tiles fetched by cp.async from their physical pages
// into the core's ring (two stages where a warp has more than one tile), a
// block a `decode_tc_split(maxp * ps)` keys (several pages, or part of one)
// and the splits merged in split order by the last block, in one launch.
// Its split, tile order and arithmetic are the dense kernel's at S = maxp *
// ps, so it equals decode attention on the gathered pages bit for bit.
// A tile reads its table entry only when it holds a live key.
//
// `decode_g1_kernel` (decode_g1.cuh, with `PagedRows`): G = 1 (Gemma-7B),
// all four (q, pages) arms, any page size: the dense G = 1 core with each
// key's row looked up in the page table (only for a live key), a block a
// `decode_tc_split(maxp * ps)` keys, the splits merged by the last block in
// one launch. Its steps and arithmetic are the dense core's at S = maxp *
// ps, so it equals decode attention on the gathered pages bit for bit.
//
// `paged_split_kernel`: G > 8, and at 2 <= G <= 8 page sizes off 16. Each
// block takes ONE page of one (batch row, kv head): grid (maxp, B * Hkv),
// the split equal to the page size. A block
// reads its own physical page id from page_table[b, i] only when the page
// holds a live key; pages at or past kv_limit[b], or wholly before the
// window, write an empty partial and read nothing (their table entries are
// the trash page). The combine launch of decode_attention.cu then merges
// the pages of each (row, head). Its G = 1 instances are built but no
// route reaches them.
#include "decode_g1.cuh"

using namespace gt;

namespace {

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kAttnThreads)
paged_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                   const TKV* __restrict__ v_pages, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, const int* __restrict__ page_table,
                   const int* __restrict__ kv_limit, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_o, int Hkv, int G, int ps,
                   int maxp, int window, float softcap) {
  extern __shared__ float smem[];
  const int i = blockIdx.x;   // logical page
  const int bh = blockIdx.y;  // b * Hkv + kv head
  const int b = bh / Hkv;
  const int h = bh % Hkv;

  const int limit = min(kv_limit[b], maxp * ps);
  const int live_lo = window > 0 ? max(limit - window, 0) : 0;
  const int s0 = i * ps;
  const int kbeg = max(s0, live_lo);
  const int kend = min(s0 + ps, limit);  // exclusive
  const size_t pidx = static_cast<size_t>(bh) * maxp + i;
  float* pm = part_m + pidx * G;
  float* pl = part_l + pidx * G;
  if (kbeg >= kend) {  // dead page: its table entry is never read
    write_dead_split(pm, pl, G);
    return;
  }
  const int page = page_table[static_cast<size_t>(b) * maxp + i];
  const size_t slab = (static_cast<size_t>(page) * Hkv + h) * ps;
  attend_split<TQ, TKV, D>(q + static_cast<size_t>(bh) * G * D, k_pages + slab * D,
                           v_pages + slab * D, k_scale == nullptr ? nullptr : k_scale + slab,
                           v_scale == nullptr ? nullptr : v_scale + slab, kbeg - s0, kend - s0,
                           ps, G, softcap, pm, pl, part_o + pidx * G * D, smem);
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k_pages, const void* v_pages, const float* k_scale,
           const float* v_scale, const int* page_table, const int* kv_limit, void* out,
           float* part_m, float* part_l, float* part_o, int B, int Hq, int Hkv, int ps, int maxp,
           int window, float softcap, cudaStream_t s) {
  const int G = Hq / Hkv;
  const size_t smem = static_cast<size_t>(G) * (D + ps) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(maxp, B * Hkv);
  paged_split_kernel<TQ, TKV, D><<<grid, kAttnThreads, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), k_scale, v_scale, page_table, kv_limit, part_m, part_l,
      part_o, Hkv, G, ps, maxp, window, softcap);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attend_combine_kernel<TQ><<<B * Hkv, kAttnThreads, 0, s>>>(part_m, part_l, part_o,
                                                             static_cast<TQ*>(out), G, D, maxp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Hq, D] (f32 or bf16); k/v pages [P, Hkv, ps, D] in q's dtype or int8
// (kv_dtype kI8, with f32 k_scale/v_scale [P, Hkv, ps]; else the scales are
// null), all contiguous; page_table i32 [B, maxp]; kv_limit i32 [B]; out
// [B, Hq, D] in q's dtype. part_m/part_l f32 [B*Hkv, maxp, G] and part_o f32
// [B*Hkv, maxp, G, D] are scratch.
extern "C" int gt_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                  const void* k_scale, const void* v_scale,
                                  const void* page_table, const void* kv_limit, void* out,
                                  void* part_m, void* part_l, void* part_o, int B, int Hq,
                                  int Hkv, int ps, int maxp, int D, int q_dtype, int kv_dtype,
                                  int window, float softcap, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || ps <= 0 || maxp <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* lim = static_cast<const int*>(kv_limit);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* po = static_cast<float*>(part_o);
#define GT_PAGED(TQ, TKV, DIM)                                                                  \
  return launch<TQ, TKV, DIM>(q, k_pages, v_pages, ks, vs, pt, lim, out, pm, pl, po, B, Hq, Hkv, \
                              ps, maxp, window, softcap, s)
  if (q_dtype == kBF16 && kv_dtype == kBF16 && D == 256) GT_PAGED(__nv_bfloat16, __nv_bfloat16, 256);
  if (q_dtype == kBF16 && kv_dtype == kBF16 && D == 128) GT_PAGED(__nv_bfloat16, __nv_bfloat16, 128);
  if (q_dtype == kF32 && kv_dtype == kF32 && D == 256) GT_PAGED(float, float, 256);
  if (q_dtype == kF32 && kv_dtype == kF32 && D == 128) GT_PAGED(float, float, 128);
  if (q_dtype == kBF16 && kv_dtype == kI8 && D == 256) GT_PAGED(__nv_bfloat16, int8_t, 256);
  if (q_dtype == kBF16 && kv_dtype == kI8 && D == 128) GT_PAGED(__nv_bfloat16, int8_t, 128);
  if (q_dtype == kF32 && kv_dtype == kI8 && D == 256) GT_PAGED(float, int8_t, 256);
  if (q_dtype == kF32 && kv_dtype == kI8 && D == 128) GT_PAGED(float, int8_t, 128);
#undef GT_PAGED
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core kernel: q [B, Hq, D] with G = Hq / Hkv <= 8, bf16 (q_dtype
// kBF16) over k/v pages [P, Hkv, ps, D] bf16 or int8, or f32 (kF32) over f32
// or int8 pages; int8 (kv_dtype kI8) with f32 k_scale/v_scale [P, Hkv, ps],
// else null; ps a multiple of 16, all contiguous; page_table i32 [B, maxp];
// kv_limit i32 [B]; out [B, Hq, D] in q's dtype. work: B * Hkv * n_splits *
// G * (D + 2) f32, n_splits = ceil(maxp * ps / split); tickets: B * Hkv
// ints, 0 on entry and on return; split: a multiple of 16.
extern "C" int gt_paged_attention_tc(const void* q, const void* k_pages, const void* v_pages,
                                     const void* k_scale, const void* v_scale,
                                     const void* page_table, const void* kv_limit, void* out,
                                     void* work, void* tickets, int B, int Hq, int Hkv, int ps,
                                     int maxp, int D, int q_dtype, int kv_dtype, int split, int window,
                                     float softcap, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || ps <= 0 || ps % 16 != 0 || maxp <= 0 || split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedRows rows{static_cast<const int*>(page_table), Hkv, ps, maxp};
  return dispatch_decode_tc(q_dtype, kv_dtype, D, q, k_pages, v_pages, static_cast<const float*>(k_scale),
                            static_cast<const float*>(v_scale), static_cast<const int*>(kv_limit),
                            out, static_cast<float*>(work), static_cast<int*>(tickets), rows, B,
                            Hq, Hkv, maxp * ps, split, window, softcap,
                            static_cast<cudaStream_t>(stream));
}

// The G = 1 core through the page table: q [B, Hq, D] bf16 or f32 with Hq ==
// Hkv; k/v pages [P, Hkv, ps, D] in q's dtype or int8 (kv_dtype kI8, with
// f32 k_scale/v_scale [P, Hkv, ps]; else null), any ps, all contiguous, K
// and V 16-byte aligned; page_table i32 [B, maxp]; kv_limit i32 [B]; out
// [B, Hq, D] in q's dtype. work: B * Hkv * n_splits * (D + 2) f32, n_splits
// = ceil(maxp * ps / split); tickets: B * Hkv ints, 0 on entry and on
// return.
extern "C" int gt_paged_attention_g1(const void* q, const void* k_pages, const void* v_pages,
                                     const void* k_scale, const void* v_scale,
                                     const void* page_table, const void* kv_limit, void* out,
                                     void* work, void* tickets, int B, int Hq, int Hkv, int ps,
                                     int maxp, int D, int q_dtype, int kv_dtype, int split,
                                     int window, float softcap, void* stream) {
  if (ps <= 0 || maxp <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const PagedRows rows{static_cast<const int*>(page_table), Hkv, ps, maxp};
  return dispatch_decode_g1(q_dtype, kv_dtype, D, q, k_pages, v_pages,
                            static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                            static_cast<const int*>(kv_limit), out, static_cast<float*>(work),
                            static_cast<int*>(tickets), rows, B, Hq, Hkv, maxp * ps, split, window,
                            softcap, static_cast<cudaStream_t>(stream));
}
