"""Paged decode attention: T = 1 attention through a paged KV cache's table.

Counterpart of `gemma_tpu/ops/paged_attention.py`. The kernel,
`csrc/paged_attention.cu`, replaces `_paged_kernel`: one block per live
page of one (batch row, kv head), bf16/f32 pages or int8 pages with their
f32 scales read in place, then the combine launch of the decode kernel.
The reference's 8-row query-group padding and its `D % 128` gate are TPU
tiling and are not ported: the kernel takes any Hq % Hkv == 0, head_dim
128 or 256, and a page size whose shared memory G * (D + ps) * 4 bytes fits
in 48 KB, and raises on anything else.

`paged_decode_attention_plain` follows the kernel's numerics: the pages of
each row gathered through the table into a dense view, then the decode
kernel's plain version (int8: s = (q . k8) * ks, weight bf16(p * vs)).
"""
from __future__ import annotations

import torch

from ..kernels import build
from .attention import check_kv_args, decode_attention_plain, kv_dtype_code


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


def paged_decode_attention(q, cache, layer: int, kv_limit, attn_softcap: float = 0.0,
                           window: int = 0):
    """T = 1 attention over layer `layer` of a `PagedKVCache`, q [B, 1, Hq, D]
    (query_scale applied, at position kv_limit - 1) -> [B, 1, Hq, D] in
    q.dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the paged
    kernel (plus the combine) or raises. Pages in q's dtype count their
    launches in `launches`, int8 pages in `int8_launches`."""
    if q.device.type == "cpu":
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
    if G * (D + ps) * 4 > 48 * 1024:
        raise ValueError(f"paged attention: G={G}, D={D}, page size {ps} exceed 48 KB of shared memory")
    if pt.device != q.device or kv_limit.device != q.device:
        raise ValueError("paged attention: q, the pages, the table and kv_limit must be on one device")
    qc = q.contiguous()
    lim = kv_limit.to(torch.int32).contiguous()
    part_m = torch.empty(B * Hkv, maxp, G, dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_o = torch.empty(B * Hkv, maxp, G, D, dtype=torch.float32, device=q.device)
    out = torch.empty_like(qc)
    int8 = ks is not None
    lib = build.load()
    err = lib.gt_paged_attention(
        qc.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        ks.data_ptr() if int8 else None, vs.data_ptr() if int8 else None,
        pt.data_ptr(), lim.data_ptr(), out.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_o.data_ptr(),
        B, Hq, Hkv, ps, maxp, D, build.DTYPE_CODES[q.dtype], kv_dtype_code(kp, ks),
        int(window), float(attn_softcap), build.stream_ptr(q.device),
    )
    build.check(err, f"paged attention B={B} Hq={Hq} Hkv={Hkv} ps={ps} maxp={maxp} D={D} int8={int8}")
    if int8:
        paged_decode_attention.int8_launches += 1
    else:
        paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.int8_launches = 0
