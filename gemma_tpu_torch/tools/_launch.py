"""One launch of an attention kernel through its C entry point, at a launch
shape that the public wrappers (`ops/attention.py`,
`ops/paged_attention.py`) pick for themselves: the flash kernel's row
warps, the decode cores' keys a block, the split-S kernels. The tools that
sweep those shapes or time a route against another (`probe_variants attn`,
`bench_decode_attn`, `bench_flash`, chip_smoke.py phase 8) share these. On
the card only: each raises on a CUDA error."""
from __future__ import annotations

import torch

from ..kernels import build


def flash(lib, q, k, v, pos, lim, row_warps: int):
    """The tensor-core flash kernel on bf16 inputs at `row_warps` (1, 2 or
    4; 0: its own plan)."""
    B, T_, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), lim.data_ptr(), out.data_ptr(),
            B, T_, Hq, Hkv, S, D)
    err = lib.gt_flash_attention_tc(*args, row_warps, 0, 0.0, build.stream_ptr(q.device))
    build.check(err, f"flash at {row_warps} row warps")
    return out


def decode(lib, split: int, q, k, v, lim, k_scale=None, v_scale=None, kind: str = "tc",
           window: int = 0, softcap: float = 0.0, q_code: bool = True):
    """The decode kernel `kind` on bf16 or f32 q at `split` keys a block: "tc"
    the tensor-core core (its element policy from q's dtype and the
    cache's), "g1" the core for one query row (G = 1), "split" the split-S
    kernel and its combine. `q_code=False` calls a library whose
    `gt_decode_attention_tc` takes no q dtype (built before f32 queries
    over int8 caches reached the core; its argtypes set to match)."""
    from ..ops import attention as att

    B, _, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G, n = Hq // Hkv, -(-S // split)
    out = torch.empty_like(q)
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if k_scale is not None else (None, None)
    qd, kvd = build.DTYPE_CODES[q.dtype], att.kv_dtype_code(k, k_scale)
    tail = (split, int(window), float(softcap), build.stream_ptr(q.device))
    if kind != "split":
        work, tickets = build.workspace(q.device, tail[-1], B * Hkv * n * G * (D + 2), B * Hkv)
        common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *scales, lim.data_ptr(), out.data_ptr(),
                  work.data_ptr(), tickets.data_ptr(), B, Hq, Hkv, S, D)
        if kind == "g1":
            err = lib.gt_decode_attention_g1(*common, qd, kvd, *tail)
        else:
            err = lib.gt_decode_attention_tc(*common, *((qd,) if q_code else ()), kvd, *tail)
    else:
        parts = torch.empty(B * Hkv * n * G * (D + 2), dtype=torch.float32, device=q.device)
        pm, pl = parts.data_ptr(), parts[B * Hkv * n * G:].data_ptr()
        po = parts[2 * B * Hkv * n * G:].data_ptr()
        err = lib.gt_decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), *scales, lim.data_ptr(),
                                      out.data_ptr(), pm, pl, po, B, Hq, Hkv, S, D, qd, kvd, *tail)
    build.check(err, f"decode {kind} split={split}")
    return out


def paged_split(lib, q, cache, layer: int, lim, window: int = 0, softcap: float = 0.0):
    """The split-S paged kernel (a block a page) and its combine on layer
    `layer` of a `PagedKVCache`, whatever route the wrapper would take."""
    from ..ops import attention as att

    kp, vp, ks, vs = cache.layer_pages(layer)
    pt = cache.page_table
    B, _, Hq, D = q.shape
    Hkv, ps, maxp = kp.shape[1], kp.shape[2], pt.shape[1]
    G = Hq // Hkv
    out = torch.empty_like(q)
    parts = torch.empty(B * Hkv * maxp * G * (D + 2), dtype=torch.float32, device=q.device)
    n = B * Hkv * maxp * G
    scales = (ks.data_ptr(), vs.data_ptr()) if ks is not None else (None, None)
    err = lib.gt_paged_attention(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), *scales, pt.data_ptr(),
                                 lim.data_ptr(), out.data_ptr(), parts.data_ptr(), parts[n:].data_ptr(),
                                 parts[2 * n:].data_ptr(), B, Hq, Hkv, ps, maxp, D,
                                 build.DTYPE_CODES[q.dtype], att.kv_dtype_code(kp, ks), int(window),
                                 float(softcap), build.stream_ptr(q.device))
    build.check(err, f"paged split-S ps={ps}")
    return out
