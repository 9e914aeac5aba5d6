"""Paged decode attention: T = 1 attention through a paged KV cache's table.

Counterpart of `gemma_tpu/ops/paged_attention.py`. `csrc/paged_attention.cu`
replaces `_paged_kernel` with three kernels, bf16/f32 pages or int8 pages
with their f32 scales read in place, routed by `paged_route`:
* G = 1 (Gemma-7B), every (q, pages) arm and page size, takes the dense
  decode's core built for one query row (`csrc/decode_g1.cuh`) with each
  key's row looked up in the table, one launch at the dense core's split
  for S = maxp * ps (`decode_tc_split`); it equals `decode_attention` on
  the gathered pages bit for bit;
* TC_MIN_G <= G <= TC_MAX_G with a page size that is a multiple of 16
  (the main path: Gemma-2B's G = 8, 64-token pages) takes the tensor-core
  decode kernel through the page table, one launch, in every arm of the
  dense core (bf16 queries over bf16 or int8 pages; f32 queries over f32
  pages in 3xTF32, or over int8 pages with q in two TF32 parts), its split
  the dense kernel's at S = maxp * ps (`decode_tc_split`), its scratch and
  tickets the persistent `build.workspace`; it equals `decode_attention`
  on the gathered pages bit for bit;
* G > 8, and at 2 <= G <= 8 page sizes off 16, take the split-S kernel:
  one block per live page of one (batch row, kv head), then the combine
  launch of the decode kernel, its shared memory G * (D + ps) * 4 bytes
  within 48 KB.
The reference's 8-row query-group padding and its `D % 128` gate are TPU
tiling and are not ported: the kernels take any Hq % Hkv == 0 and head_dim
128 or 256, and raise on anything else.

`paged_decode_attention_plain` follows the kernels' numerics: the pages of
each row gathered through the table into a dense view, then the decode
kernel's plain version (int8: s = (q . k8) * ks, weight bf16(p * vs)).
`set_force_plain(True)` routes `paged_decode_attention` to it on every
device: the reference's explicit switch, set only by `utils.verify`.
"""
from __future__ import annotations

import torch

from ..kernels import build
from .attention import (TC_MAX_G, TC_MIN_G, check_kv_args, decode_attention_plain, decode_tc_split,
                        kv_dtype_code)

_FORCE_PLAIN = False


def set_force_plain(flag: bool) -> None:
    """Route `paged_decode_attention` to its plain version on every device
    while set. Only `utils.verify` sets it, and clears it in a `finally`."""
    global _FORCE_PLAIN
    _FORCE_PLAIN = bool(flag)


def forcing_plain() -> bool:
    return _FORCE_PLAIN


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Pool [P, Hkv, ps, ...] through page_table [B, maxp] -> the dense
    per-row view [B, Hkv, maxp * ps, ...] (trash pages included: the
    sequence lengths mask them)."""
    g = pool[page_table.long()]  # [B, maxp, Hkv, ps, ...]
    B, maxp, H, ps = g.shape[:4]
    return g.transpose(1, 2).reshape(B, H, maxp * ps, *g.shape[4:])


def paged_decode_attention_plain(q, cache, layer: int, kv_limit, attn_softcap: float = 0.0,
                                 window: int = 0):
    """Plain version of the paged kernel: q [B, 1, Hq, D] -> [B, 1, Hq, D]."""
    k, v, ks, vs = cache.layer_pages(layer)
    pt = cache.page_table
    dense = [None if t is None else gather_pages(t, pt) for t in (k, v, ks, vs)]
    return decode_attention_plain(q, dense[0], dense[1], kv_limit, attn_softcap, window,
                                  dense[2], dense[3])


def paged_route(q_dtype: torch.dtype, G: int, ps: int, S: int) -> tuple[str, int]:
    """("g1", keys a block) for the G = 1 core through the page table (any
    query dtype and page size), ("tc" for bf16 queries, "tf32" for f32
    ones, keys a block) for the tensor-core kernel through it, or ("split",
    ps) for the split-S kernel (a block a page): TC_MIN_G <= G <= TC_MAX_G
    with a page size that is a multiple of 16 (a 16-key tile never
    straddles two pages) takes the tensor cores, over pages of the query's
    dtype or int8. Both one-launch cores run at the dense kernel's split
    for S = maxp * ps."""
    if G == 1:
        return "g1", decode_tc_split(S)
    if TC_MIN_G <= G <= TC_MAX_G and ps % 16 == 0:
        return ("tc" if q_dtype == torch.bfloat16 else "tf32"), decode_tc_split(S)
    return "split", ps


def paged_decode_attention(q, cache, layer: int, kv_limit, attn_softcap: float = 0.0,
                           window: int = 0):
    """T = 1 attention over layer `layer` of a `PagedKVCache`, q [B, 1, Hq, D]
    (query_scale applied, at position kv_limit - 1) -> [B, 1, Hq, D] in
    q.dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    of `paged_route` (the tensor-core kernel or the G = 1 core, one launch
    each; or the split-S kernel plus the combine) or raises. Pages in q's
    dtype count their calls in `launches`, int8 pages in `int8_launches`;
    those that went through the tensor-core kernel also in `tc_launches`
    (bf16 queries), `tf32_launches` (f32 queries over f32 pages) or
    `tf32_int8_launches` (f32 queries over int8 pages), through the G = 1
    core in `g1_launches`. While `set_force_plain` is on, the plain version
    on every device."""
    if q.device.type == "cpu" or _FORCE_PLAIN:
        return paged_decode_attention_plain(q, cache, layer, kv_limit, attn_softcap, window)
    B, T, Hq, D = q.shape
    if T != 1:
        raise ValueError(f"paged decode attention takes one query per sequence, got T={T}")
    kp, vp, ks, vs = cache.layer_pages(layer)
    check_kv_args("paged attention", q, kp, vp, ks, vs)
    pt = cache.page_table
    Hkv, ps = kp.shape[1], kp.shape[2]
    maxp = pt.shape[1]
    G = Hq // Hkv
    if pt.shape[0] != B or pt.dtype != torch.int32 or not pt.is_contiguous():
        raise ValueError(f"paged attention: page table {tuple(pt.shape)} {pt.dtype} for batch {B}")
    if pt.device != q.device or kv_limit.device != q.device:
        raise ValueError("paged attention: q, the pages, the table and kv_limit must be on one device")
    route, split = paged_route(q.dtype, G, ps, maxp * ps)
    if route == "split" and G * (D + ps) * 4 > 48 * 1024:
        raise ValueError(f"paged attention: G={G}, D={D}, page size {ps} exceed 48 KB of shared memory")
    qc = q.contiguous()
    lim = kv_limit.to(torch.int32).contiguous()
    out = torch.empty_like(qc)
    int8 = ks is not None
    scales = (ks.data_ptr(), vs.data_ptr()) if int8 else (None, None)
    lib = build.load()
    stream = build.stream_ptr(q.device)
    if route == "g1":
        n_splits = -(-maxp * ps // split)
        work, tickets = build.workspace(q.device, stream, B * Hkv * n_splits * (D + 2), B * Hkv)
        err = lib.gt_paged_attention_g1(
            qc.data_ptr(), kp.data_ptr(), vp.data_ptr(), *scales, pt.data_ptr(), lim.data_ptr(),
            out.data_ptr(), work.data_ptr(), tickets.data_ptr(), B, Hq, Hkv, ps, maxp, D,
            build.DTYPE_CODES[q.dtype], kv_dtype_code(kp, ks), split, int(window),
            float(attn_softcap), stream,
        )
    elif route != "split":
        n_splits = -(-maxp * ps // split)
        work, tickets = build.workspace(q.device, stream, B * Hkv * n_splits * G * (D + 2), B * Hkv)
        err = lib.gt_paged_attention_tc(
            qc.data_ptr(), kp.data_ptr(), vp.data_ptr(), *scales, pt.data_ptr(), lim.data_ptr(),
            out.data_ptr(), work.data_ptr(), tickets.data_ptr(), B, Hq, Hkv, ps, maxp, D,
            build.DTYPE_CODES[q.dtype], kv_dtype_code(kp, ks), split, int(window), float(attn_softcap),
            stream,
        )
    else:
        part_m = torch.empty(B * Hkv, maxp, G, dtype=torch.float32, device=q.device)
        part_l = torch.empty_like(part_m)
        part_o = torch.empty(B * Hkv, maxp, G, D, dtype=torch.float32, device=q.device)
        err = lib.gt_paged_attention(
            qc.data_ptr(), kp.data_ptr(), vp.data_ptr(), *scales, pt.data_ptr(), lim.data_ptr(),
            out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), part_o.data_ptr(),
            B, Hq, Hkv, ps, maxp, D, build.DTYPE_CODES[q.dtype], kv_dtype_code(kp, ks),
            int(window), float(attn_softcap), stream,
        )
    build.check(err, f"paged attention ({route}) B={B} Hq={Hq} Hkv={Hkv} ps={ps} maxp={maxp} D={D} "
                     f"int8={int8}")
    if int8:
        paged_decode_attention.int8_launches += 1
    else:
        paged_decode_attention.launches += 1
    paged_decode_attention.tc_launches += route == "tc"
    paged_decode_attention.tf32_launches += route == "tf32" and not int8
    paged_decode_attention.tf32_int8_launches += route == "tf32" and int8
    paged_decode_attention.g1_launches += route == "g1"
    return out


paged_decode_attention.launches = 0
paged_decode_attention.int8_launches = 0
paged_decode_attention.tc_launches = 0
paged_decode_attention.tf32_launches = 0
paged_decode_attention.tf32_int8_launches = 0
paged_decode_attention.g1_launches = 0
