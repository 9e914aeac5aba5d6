"""Attention ops: plain SDPA, and the decode and flash kernels.

Counterpart of `gemma_tpu/ops/attention.py`, with its public layouts:
    q:   [B, T, Hq, D]   (already scaled by query_scale, RoPE applied)
    k,v: [B, Hkv, S, D]  (the KV cache's own layout)
    positions: [B, T] i32 absolute query positions (arbitrary per row)
    kv_limit:  [B] i32    number of valid cache slots
Key slot s is valid for a query at position pos iff s <= pos and
s < kv_limit[b] and, with a sliding window, s > pos - window.

Kernels: `csrc/decode_attention.cu` with `csrc/decode_tc.cuh` (replaces
`_decode_kernel`, its bf16 and int8 arms) and `csrc/flash_attention.cu`
(replaces `_flash_kernel`).
The route is fixed by dtype (and for decode by G = Hq / Hkv): a bf16 query
takes the tensor-core kernels (`mma.sync` on bf16 operands; decode over a
bf16 or int8 cache at 2 <= G <= 8). An f32 query, whose f32 x f32
products bf16 tensor cores cannot form exactly, takes the TF32 tensor-core
kernels (3xTF32: each operand split into two TF32 parts, three `mma.sync`
products): flash, and decode over an f32 cache at 2 <= G <= 8 (the same
decode core with its TF32 element policy). Decode at G = 1 and G > 8, and
f32 queries over an int8 cache, take the split-S kernel with its combine
launch. Every route launches a hand-written kernel; none falls back.
Their plain PyTorch versions here follow the kernels' numerics: f32 scores,
softcap before the mask, p rounded to the cache dtype before p . v, and 0
for a row with no valid key (plain `sdpa` gives the mean of V there
instead).

Int8 K and V (the int8 KV cache) come with f32 scales [B, Hkv, S], one per
(batch, kv head, position), and are read in place at decode: the scales
commute through both dots, s = (q . k8) * ks and out = bf16(p * vs) . v8
(`attention.py:313-344` of the reference), so p * vs rounds to bf16 even
with f32 activations.

`attention` dispatches on T alone: T == 1 goes to decode, anything else to
flash (int8 K and V are dequantized once first, as the reference does).
There is no shape gate to a plain path on CUDA, so every prefill length
reaches the flash kernel. `set_force_plain(True)` routes `attention` to the
plain versions on every device: the reference's explicit switch
(`set_force_fallback`, `gemma_tpu/ops/attention.py:51`), set only by
`utils.verify`, off by default, never turned on by a failing kernel.
"""
from __future__ import annotations

import torch

from ..kernels import build

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
KERNEL_HEAD_DIMS = (128, 256)
DECODE_SPLIT = 64  # keys per block of the split-S decode kernel (G = 1, G > 8, f32 q over int8)
TC_MAX_G = 8  # query heads a KV head the decode tensor-core kernel takes (its n8 side)
# G = 1 (Gemma-7B) takes the split-S kernel: at 8 serving rows the
# tensor-core kernel measured slower there (PERF.md)
TC_MIN_G = 2
_FORCE_PLAIN = False


def set_force_plain(flag: bool) -> None:
    """Route `attention` to the plain versions on every device while set.
    Only `utils.verify` sets it, and clears it in a `finally`."""
    global _FORCE_PLAIN
    _FORCE_PLAIN = bool(flag)


def _valid_mask(positions, kv_limit, S, window):
    """[B, T, S] bool: the key-validity rule of the module docstring."""
    key = torch.arange(S, device=positions.device, dtype=torch.int32)
    pos = positions.to(torch.int32)[:, :, None]
    valid = (key <= pos) & (key < kv_limit.to(torch.int32)[:, None, None])
    if window > 0:
        valid &= key > pos - window
    return valid


def _scores(q, k, attn_softcap):
    """f32 scores [B, Hkv, G, T, S] (products of bf16 values are exact in f32)."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, T, Hkv, Hq // Hkv, D).to(torch.float32)
    s = torch.einsum("bthgd,bhsd->bhgts", qg, k.to(torch.float32))
    if attn_softcap:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    return s


def dequantize_kv(x8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 K or V [..., S, D] with f32 scales [..., S] -> bf16: the scale
    rounded to bf16 and the product taken in bf16 (the reference's
    `KVCache.gather_layer` and `attention` rounding point)."""
    return x8.to(torch.bfloat16) * scale[..., None].to(torch.bfloat16)


def _pv(p, v, q_shape):
    """p [B, Hkv, G, T, S] (already on v's grid) . v -> [B, T, Hq, D] f32."""
    out = torch.einsum("bhgts,bhsd->bthgd", p, v.to(torch.float32))
    return out.reshape(q_shape)


def sdpa(q, k, v, positions, kv_limit, attn_softcap: float = 0.0, window: int = 0):
    """Plain softmax attention: a port of the reference's `sdpa_xla`."""
    s = _scores(q, k, attn_softcap)
    valid = _valid_mask(positions, kv_limit, k.shape[2], window)[:, None, None]
    w = torch.softmax(torch.where(valid, s, -1e30), dim=-1)
    return _pv(w.to(v.dtype).to(torch.float32), v, q.shape).to(v.dtype)


def flash_attention_plain(q, k, v, positions, kv_limit, attn_softcap: float = 0.0, window: int = 0,
                          k_scale=None, v_scale=None):
    """Plain version of the flash kernel (and, with int8 k/v and their
    scales, of the int8 decode arm): masked softmax with the kernel's
    rounding points; rows with no valid key give 0. Returns q.dtype."""
    s = _scores(q, k, attn_softcap if k_scale is None else 0.0)
    if k_scale is not None:  # s = (q . k8) * ks, then softcap
        s = s * k_scale[:, :, None, None, :]
        if attn_softcap:
            s = attn_softcap * torch.tanh(s / attn_softcap)
    valid = _valid_mask(positions, kv_limit, k.shape[2], window)[:, None, None]
    s = torch.where(valid, s, MASK_VALUE)
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_inv = torch.where(l == 0.0, 1.0, 1.0 / l)
    if v_scale is None:
        p = p.to(v.dtype)
    else:  # bf16(p * vs) . bf16(v8), whatever q's dtype
        p, v = (p * v_scale[:, :, None, None, :]).to(torch.bfloat16), v.to(torch.bfloat16)
    out = _pv(p.to(torch.float32), v, q.shape)
    l_inv = l_inv[..., 0].permute(0, 3, 1, 2).reshape(*q.shape[:3], 1)  # [B, T, Hq, 1]
    return (out * l_inv).to(q.dtype)


def decode_attention_plain(q, k, v, kv_limit, attn_softcap: float = 0.0, window: int = 0,
                           k_scale=None, v_scale=None):
    """Plain version of the decode kernel: q [B, 1, Hq, D] at position
    kv_limit - 1; k/v int8 with f32 scales [B, Hkv, S] for the int8 arm."""
    positions = (kv_limit.to(torch.int32) - 1)[:, None]
    return flash_attention_plain(q, k, v, positions, kv_limit, attn_softcap, window, k_scale, v_scale)


def check_kv_args(name, q, k, v, k_scale, v_scale):
    """Raise on query and K/V dtypes the CUDA attention kernels do not take:
    q bf16 or f32; K and V of q's dtype, or int8 with f32 scales of K's
    shape less its last axis."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} kernel takes a bf16 or f32 query, got {q.dtype}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {q.shape[-1]}")
    if k.shape != v.shape or k.shape[-1] != q.shape[-1] or q.shape[2] % k.shape[1]:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    tensors = [k, v]
    if k_scale is None:
        if k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError(f"{name} kernel takes k and v in q's dtype {q.dtype} or int8 with "
                            f"scales, got {k.dtype}, {v.dtype}")
    else:
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise TypeError(f"{name} kernel takes int8 k and v with scales, got {k.dtype}, {v.dtype}")
        for sc in (k_scale, v_scale):
            if sc is None or sc.dtype != torch.float32 or sc.shape != k.shape[:-1]:
                raise ValueError(f"{name}: scales must be f32 of shape {tuple(k.shape[:-1])}")
        tensors += [k_scale, v_scale]
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: q, k, v and the scales must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel needs contiguous k, v and scales")


def kv_dtype_code(k, k_scale) -> int:
    """The kernels' code for the K/V dtype: int8 when scales come with it."""
    return build.DTYPE_CODES[k.dtype] if k_scale is None else build.INT8_CODE


def decode_tc_split(S: int) -> int:
    """Keys a block of the tensor-core decode kernel at cache length S (a
    multiple of 16: its 4 warps take the block's 16-key tiles in turn):
    64, doubled while S holds more than 16 splits, at most 256. Measured
    (PERF.md): at S = 512, 64 keys beat 32 and 256 in both arms (128
    is 7 % faster in bf16, 11 % slower in int8); at S = 4096, 256 beat 64
    and 128 (the last block merges fewer partials). Fixed by S, never by
    the live length, which stays on the device."""
    split = 64
    while split < 256 and S > 16 * split:
        split *= 2
    return split


def decode_route(q_dtype: torch.dtype, G: int, S: int, int8: bool = False) -> tuple[str, int]:
    """The decode kernel of a call and its keys a block: at TC_MIN_G <= G <=
    TC_MAX_G, ("tc", decode_tc_split(S)) for bf16 queries (over a bf16 or
    int8 cache) and ("tf32", decode_tc_split(S)) for f32 queries over an
    f32 cache, both the tensor-core core; else ("split", DECODE_SPLIT), the
    split-S kernel."""
    if TC_MIN_G <= G <= TC_MAX_G:
        if q_dtype == torch.bfloat16:
            return "tc", decode_tc_split(S)
        if q_dtype == torch.float32 and not int8:
            return "tf32", decode_tc_split(S)
    return "split", DECODE_SPLIT


def decode_attention(q, k, v, kv_limit, attn_softcap: float = 0.0, window: int = 0,
                     k_scale=None, v_scale=None):
    """T = 1 attention, q [B, 1, Hq, D] -> [B, 1, Hq, D] in q.dtype; k/v in
    q's dtype, or int8 with f32 scales [B, Hkv, S] (the int8 arm).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    of `decode_route` (the tensor-core kernel, one launch; or the split-S
    kernel plus its combine step) or raises. The bf16/f32 arm counts its
    calls in `launches`, the int8 arm in `int8_launches`; those that went
    through the tensor-core kernel also in `tc_launches` (bf16 queries) or
    `tf32_launches` (f32 queries)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_limit, attn_softcap, window, k_scale, v_scale)
    B, T, Hq, D = q.shape
    if T != 1:
        raise ValueError(f"decode attention takes one query per sequence, got T={T}")
    check_kv_args("decode attention", q, k, v, k_scale, v_scale)
    if k.shape[0] != B or kv_limit.device != q.device:
        raise ValueError(f"decode attention: q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    int8 = k_scale is not None
    route, split = decode_route(q.dtype, G, S, int8)
    n_splits = -(-S // split)
    qc = q.contiguous()
    lim = kv_limit.to(torch.int32).contiguous()
    out = torch.empty_like(qc)
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if int8 else (None, None)
    lib = build.load()
    stream = build.stream_ptr(q.device)
    if route != "split":
        work, tickets = build.workspace(q.device, stream, B * Hkv * n_splits * G * (D + 2), B * Hkv)
        err = lib.gt_decode_attention_tc(
            qc.data_ptr(), k.data_ptr(), v.data_ptr(), *scales, lim.data_ptr(), out.data_ptr(),
            work.data_ptr(), tickets.data_ptr(), B, Hq, Hkv, S, D, kv_dtype_code(k, k_scale),
            split, int(window), float(attn_softcap), stream,
        )
    else:
        part_m = torch.empty(B * Hkv, n_splits, G, dtype=torch.float32, device=q.device)
        part_l = torch.empty_like(part_m)
        part_o = torch.empty(B * Hkv, n_splits, G, D, dtype=torch.float32, device=q.device)
        err = lib.gt_decode_attention(
            qc.data_ptr(), k.data_ptr(), v.data_ptr(), *scales, lim.data_ptr(), out.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_o.data_ptr(), B, Hq, Hkv, S, D,
            build.DTYPE_CODES[q.dtype], kv_dtype_code(k, k_scale), split, int(window),
            float(attn_softcap), stream,
        )
    build.check(err, f"decode attention ({route}) B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} int8={int8}")
    if int8:
        decode_attention.int8_launches += 1
    else:
        decode_attention.launches += 1
    decode_attention.tc_launches += route == "tc"
    decode_attention.tf32_launches += route == "tf32"
    return out


decode_attention.launches = 0
decode_attention.int8_launches = 0
decode_attention.tc_launches = 0
decode_attention.tf32_launches = 0


def flash_attention(q, k, v, positions, kv_limit, attn_softcap: float = 0.0, window: int = 0):
    """Prefill attention, q [B, T, Hq, D] -> [B, T, Hq, D] in q.dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises: bf16 the tensor-core kernel (also counted in `tc_launches`),
    f32 the TF32 kernel (also counted in `tf32_launches`). Any T and S."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, positions, kv_limit, attn_softcap, window)
    check_kv_args("flash attention", q, k, v, None, None)
    B, T, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if k.shape[0] != B or kv_limit.device != q.device:
        raise ValueError(f"flash attention: q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    if tuple(positions.shape) != (B, T) or positions.device != q.device:
        raise ValueError(f"flash attention: positions {tuple(positions.shape)} != {(B, T)}")
    qc = q.contiguous()
    pos = positions.to(torch.int32).contiguous()
    lim = kv_limit.to(torch.int32).contiguous()
    out = torch.empty_like(qc)
    lib = build.load()
    tc = q.dtype == torch.bfloat16
    args = (qc.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), lim.data_ptr(),
            out.data_ptr(), B, T, Hq, Hkv, S, D)
    tail = (int(window), float(attn_softcap), build.stream_ptr(q.device))
    # row warps 0: the kernels' block plan (`flash_tc_shape`, csrc/flash_attention.cu)
    err = (lib.gt_flash_attention_tc(*args, 0, *tail) if tc
           else lib.gt_flash_attention_tf32(*args, *tail))
    build.check(err, f"flash attention B={B} T={T} Hq={Hq} Hkv={Hkv} S={S} D={D} tc={tc}")
    flash_attention.launches += 1
    flash_attention.tc_launches += tc
    flash_attention.tf32_launches += not tc
    return out


flash_attention.launches = 0
flash_attention.tc_launches = 0
flash_attention.tf32_launches = 0


def attention(q, k, v, positions, kv_limit, attn_softcap: float = 0.0, window: int = 0,
              k_scale=None, v_scale=None):
    """Dispatch: T == 1 -> decode (int8 k/v read in place with their
    scales); otherwise flash, after dequantizing int8 k/v once to bf16 and
    then to q's dtype (the flash kernel takes one dtype). While
    `set_force_plain` is on, the plain versions of both."""
    decode, flash = ((decode_attention_plain, flash_attention_plain) if _FORCE_PLAIN
                     else (decode_attention, flash_attention))
    if q.shape[1] == 1:
        return decode(q, k, v, kv_limit, attn_softcap, window, k_scale, v_scale)
    if k_scale is not None:
        k, v = dequantize_kv(k, k_scale).to(q.dtype), dequantize_kv(v, v_scale).to(q.dtype)
    return flash(q, k, v, positions, kv_limit, attn_softcap, window)
