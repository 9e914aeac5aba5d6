"""Reference (numpy, host-side) codecs for ggml block-quant formats.

The port's own copy of `gemma_tpu/quant/numpy_ref.py`;
tests/test_torch_gguf.py holds the two bit-equal. These are the ground truth
the port's dequantization and kernels are validated against, the role
ggml-quants.c's `dequantize_row_*` / `quantize_row_*` play for ggml.
Dequantization is bit-exact w.r.t. the ggml layouts; quantization uses
straightforward scale fitting (valid ggml payloads, not necessarily the same
scale *choices* ggml's least-squares search makes).

All functions operate on flat element counts that are block-size multiples;
row boundaries in ggml always coincide with block boundaries.
"""
from __future__ import annotations

import numpy as np

from ..gguf.constants import GGMLType, QK_K, block_size, type_size

F32 = np.float32


def _as_blocks(raw: np.ndarray, t: GGMLType) -> np.ndarray:
    ts = type_size(t)
    raw = np.frombuffer(raw, dtype=np.uint8) if not isinstance(raw, np.ndarray) else raw
    if raw.size % ts:
        raise ValueError(f"payload {raw.size}B not a multiple of {t.name} block {ts}B")
    return raw.reshape(-1, ts)


# ---------------------------------------------------------------------------
# 32-element block formats
# ---------------------------------------------------------------------------

def dequant_q4_0(raw) -> np.ndarray:
    b = _as_blocks(raw, GGMLType.Q4_0)
    d = b[:, :2].copy().view("<f2").astype(F32)          # (nb, 1)
    qs = b[:, 2:]
    q = np.concatenate([qs & 0x0F, qs >> 4], axis=1).astype(np.int8) - 8
    return (d * q).reshape(-1)


def dequant_q4_1(raw) -> np.ndarray:
    b = _as_blocks(raw, GGMLType.Q4_1)
    d = b[:, 0:2].copy().view("<f2").astype(F32)
    m = b[:, 2:4].copy().view("<f2").astype(F32)
    qs = b[:, 4:]
    q = np.concatenate([qs & 0x0F, qs >> 4], axis=1).astype(F32)
    return (d * q + m).reshape(-1)


def _q5_bits(b: np.ndarray, qh_off: int, qs_off: int) -> np.ndarray:
    qh = b[:, qh_off : qh_off + 4].copy().view("<u4").astype(np.uint32)  # (nb, 1)
    qs = b[:, qs_off : qs_off + 16]
    j = np.arange(16, dtype=np.uint32)
    lo_bit = ((qh >> j) & 1).astype(np.uint8)            # (nb, 16)
    hi_bit = ((qh >> (j + 16)) & 1).astype(np.uint8)
    lo = (qs & 0x0F) | (lo_bit << 4)
    hi = (qs >> 4) | (hi_bit << 4)
    return np.concatenate([lo, hi], axis=1)              # (nb, 32), 5-bit values


def dequant_q5_0(raw) -> np.ndarray:
    b = _as_blocks(raw, GGMLType.Q5_0)
    d = b[:, :2].copy().view("<f2").astype(F32)
    q = _q5_bits(b, 2, 6).astype(np.int16) - 16
    return (d * q).reshape(-1)


def dequant_q5_1(raw) -> np.ndarray:
    b = _as_blocks(raw, GGMLType.Q5_1)
    d = b[:, 0:2].copy().view("<f2").astype(F32)
    m = b[:, 2:4].copy().view("<f2").astype(F32)
    q = _q5_bits(b, 4, 8).astype(F32)
    return (d * q + m).reshape(-1)


def dequant_q8_0(raw) -> np.ndarray:
    b = _as_blocks(raw, GGMLType.Q8_0)
    d = b[:, :2].copy().view("<f2").astype(F32)
    q = b[:, 2:].view(np.int8).astype(F32)
    return (d * q).reshape(-1)


def quant_q8_0(x: np.ndarray) -> bytes:
    x = np.asarray(x, dtype=F32).reshape(-1, 32)
    amax = np.abs(x).max(axis=1, keepdims=True)
    d = amax / 127.0
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.round(x * inv).clip(-127, 127).astype(np.int8)
    out = np.empty((x.shape[0], 34), dtype=np.uint8)
    out[:, :2] = d.astype("<f2").view(np.uint8)
    out[:, 2:] = q.view(np.uint8)
    return out.tobytes()


def quant_q4_0(x: np.ndarray) -> bytes:
    x = np.asarray(x, dtype=F32).reshape(-1, 32)
    # ggml convention: scale by the signed max-magnitude element / -8 so the
    # extreme value maps exactly onto quant level 0 or 15.
    idx = np.abs(x).argmax(axis=1)
    mx = x[np.arange(x.shape[0]), idx]
    d = mx / -8.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)[:, None]
    q = (np.round(x * inv) + 8).clip(0, 15).astype(np.uint8)
    packed = (q[:, :16] | (q[:, 16:] << 4)).astype(np.uint8)
    out = np.empty((x.shape[0], 18), dtype=np.uint8)
    out[:, :2] = d.astype("<f2")[:, None].view(np.uint8)
    out[:, 2:] = packed
    return out.tobytes()


# ---------------------------------------------------------------------------
# K-quants (256-element super-blocks)
# ---------------------------------------------------------------------------

def _unpack_scale_min_k4(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Decode the 12-byte 6-bit packed (scale, min) table of Q4_K/Q5_K.

    Mirrors ggml's get_scale_min_k4. Returns (sc, mn) each (nb, 8) uint8.
    """
    s = scales.astype(np.uint8)
    sc = np.empty((s.shape[0], 8), dtype=np.uint8)
    mn = np.empty((s.shape[0], 8), dtype=np.uint8)
    for j in range(4):
        sc[:, j] = s[:, j] & 63
        mn[:, j] = s[:, j + 4] & 63
    for j in range(4, 8):
        sc[:, j] = (s[:, j + 4] & 0x0F) | ((s[:, j - 4] >> 6) << 4)
        mn[:, j] = (s[:, j + 4] >> 4) | ((s[:, j] >> 6) << 4)
    return sc, mn


def _pack_scale_min_k4(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Inverse of _unpack_scale_min_k4; sc/mn are (nb, 8) in [0, 63]."""
    sc = sc.astype(np.uint8)
    mn = mn.astype(np.uint8)
    out = np.zeros((sc.shape[0], 12), dtype=np.uint8)
    for j in range(4):
        out[:, j] = sc[:, j] & 63
        out[:, j + 4] = mn[:, j] & 63
    for j in range(4, 8):
        out[:, j - 4] |= (sc[:, j] >> 4) << 6
        out[:, j] |= (mn[:, j] >> 4) << 6
        out[:, j + 4] = (sc[:, j] & 0x0F) | ((mn[:, j] & 0x0F) << 4)
    return out


def dequant_q4_k(raw) -> np.ndarray:
    b = _as_blocks(raw, GGMLType.Q4_K)
    d = b[:, 0:2].copy().view("<f2").astype(F32)         # (nb, 1)
    dmin = b[:, 2:4].copy().view("<f2").astype(F32)
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    qs = b[:, 16:144].reshape(-1, 4, 32)                 # 4 chunks of 32 bytes
    lo = (qs & 0x0F).astype(F32)                         # sub-blocks 0,2,4,6
    hi = (qs >> 4).astype(F32)                           # sub-blocks 1,3,5,7
    q = np.stack([lo, hi], axis=2).reshape(-1, 8, 32)    # (nb, sub, 32)
    scale = (d * sc.astype(F32))[:, :, None]
    minv = (dmin * mn.astype(F32))[:, :, None]
    return (scale * q - minv).reshape(-1)


def quant_q4_k(x: np.ndarray) -> bytes:
    x = np.asarray(x, dtype=F32).reshape(-1, 8, 32)      # (nb, sub, 32)
    nb = x.shape[0]
    xmin = np.minimum(x.min(axis=2), 0.0)                # per-sub min (<= 0)
    xmax = np.maximum(x.max(axis=2), xmin + 1e-30)
    sub_scale = (xmax - xmin) / 15.0                     # (nb, 8)
    sub_min = -xmin
    d = sub_scale.max(axis=1, keepdims=True) / 63.0
    dmin = sub_min.max(axis=1, keepdims=True) / 63.0
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    inv_m = np.where(dmin > 0, 1.0 / np.where(dmin == 0, 1, dmin), 0.0)
    sc = np.round(sub_scale * inv_d).clip(0, 63).astype(np.uint8)
    mn = np.round(sub_min * inv_m).clip(0, 63).astype(np.uint8)
    d16 = d.astype("<f2")
    dmin16 = dmin.astype("<f2")
    eff_scale = d16.astype(F32) * sc
    eff_min = dmin16.astype(F32) * mn
    inv_s = np.where(eff_scale > 0, 1.0 / np.where(eff_scale == 0, 1, eff_scale), 0.0)
    q = np.round((x + eff_min[:, :, None]) * inv_s[:, :, None]).clip(0, 15).astype(np.uint8)
    q = q.reshape(nb, 4, 2, 32)
    packed = (q[:, :, 0] | (q[:, :, 1] << 4)).reshape(nb, 128)
    out = np.empty((nb, 144), dtype=np.uint8)
    out[:, 0:2] = d16.view(np.uint8)
    out[:, 2:4] = dmin16.view(np.uint8)
    out[:, 4:16] = _pack_scale_min_k4(sc, mn)
    out[:, 16:] = packed
    return out.tobytes()


def quant_q5_k(x: np.ndarray) -> bytes:
    # same super-block affine search as quant_q4_k, 5-bit values [0, 31]
    # (ggml quantize_row_q5_K simplified the same way: round-to-nearest
    # against the f16-rounded effective scales); bit layout mirrors
    # dequant_q5_k exactly — qs lo-nibbles per 32-chunk, qh bit-planes
    x = np.asarray(x, dtype=F32).reshape(-1, 8, 32)
    nb = x.shape[0]
    xmin = np.minimum(x.min(axis=2), 0.0)
    xmax = np.maximum(x.max(axis=2), xmin + 1e-30)
    sub_scale = (xmax - xmin) / 31.0
    sub_min = -xmin
    d = sub_scale.max(axis=1, keepdims=True) / 63.0
    dmin = sub_min.max(axis=1, keepdims=True) / 63.0
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    inv_m = np.where(dmin > 0, 1.0 / np.where(dmin == 0, 1, dmin), 0.0)
    sc = np.round(sub_scale * inv_d).clip(0, 63).astype(np.uint8)
    mn = np.round(sub_min * inv_m).clip(0, 63).astype(np.uint8)
    d16 = d.astype("<f2")
    dmin16 = dmin.astype("<f2")
    eff_scale = d16.astype(F32) * sc
    eff_min = dmin16.astype(F32) * mn
    inv_s = np.where(eff_scale > 0, 1.0 / np.where(eff_scale == 0, 1, eff_scale), 0.0)
    q = np.round((x + eff_min[:, :, None]) * inv_s[:, :, None]).clip(0, 31).astype(np.uint8)
    qs = np.empty((nb, 4, 32), dtype=np.uint8)
    qh = np.zeros((nb, 32), dtype=np.uint8)
    for c in range(4):
        lo5, hi5 = q[:, 2 * c], q[:, 2 * c + 1]
        qs[:, c] = (lo5 & 0x0F) | ((hi5 & 0x0F) << 4)
        qh |= ((lo5 >> 4) & 1) << (2 * c)
        qh |= ((hi5 >> 4) & 1) << (2 * c + 1)
    out = np.empty((nb, 176), dtype=np.uint8)
    out[:, 0:2] = d16.view(np.uint8)
    out[:, 2:4] = dmin16.view(np.uint8)
    out[:, 4:16] = _pack_scale_min_k4(sc, mn)
    out[:, 16:48] = qh
    out[:, 48:176] = qs.reshape(nb, 128)
    return out.tobytes()


def dequant_q5_k(raw) -> np.ndarray:
    b = _as_blocks(raw, GGMLType.Q5_K)
    d = b[:, 0:2].copy().view("<f2").astype(F32)
    dmin = b[:, 2:4].copy().view("<f2").astype(F32)
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    qh = b[:, 16:48]                                     # 32 bytes of high bits
    qs = b[:, 48:176].reshape(-1, 4, 32)
    out_q = np.empty((b.shape[0], 8, 32), dtype=F32)
    for c in range(4):
        lo_hbit = ((qh >> (2 * c)) & 1).astype(np.uint8)
        hi_hbit = ((qh >> (2 * c + 1)) & 1).astype(np.uint8)
        out_q[:, 2 * c] = ((qs[:, c] & 0x0F) | (lo_hbit << 4)).astype(F32)
        out_q[:, 2 * c + 1] = ((qs[:, c] >> 4) | (hi_hbit << 4)).astype(F32)
    scale = (d * sc.astype(F32))[:, :, None]
    minv = (dmin * mn.astype(F32))[:, :, None]
    return (scale * out_q - minv).reshape(-1)


def dequant_q6_k(raw) -> np.ndarray:
    b = _as_blocks(raw, GGMLType.Q6_K)
    ql = b[:, 0:128]
    qh = b[:, 128:192]
    scales = b[:, 192:208].view(np.int8).astype(F32)     # (nb, 16)
    d = b[:, 208:210].copy().view("<f2").astype(F32)     # (nb, 1)
    nb = b.shape[0]
    q = np.empty((nb, 256), dtype=np.int16)
    for n in range(2):                                    # two 128-element halves
        lq = ql[:, n * 64 : n * 64 + 64]
        hq = qh[:, n * 32 : n * 32 + 32]
        base = n * 128
        q[:, base + 0 : base + 32] = ((lq[:, :32] & 0x0F) | (((hq >> 0) & 3) << 4)).astype(np.int16) - 32
        q[:, base + 32 : base + 64] = ((lq[:, 32:] & 0x0F) | (((hq >> 2) & 3) << 4)).astype(np.int16) - 32
        q[:, base + 64 : base + 96] = ((lq[:, :32] >> 4) | (((hq >> 4) & 3) << 4)).astype(np.int16) - 32
        q[:, base + 96 : base + 128] = ((lq[:, 32:] >> 4) | (((hq >> 6) & 3) << 4)).astype(np.int16) - 32
    sc = np.repeat(scales, 16, axis=1)                   # per-16-element scale
    return (d * sc * q.astype(F32)).reshape(-1)


def quant_q6_k(x: np.ndarray) -> bytes:
    x = np.asarray(x, dtype=F32).reshape(-1, 16, 16)     # (nb, sub16, 16)
    nb = x.shape[0]
    amax = np.abs(x).max(axis=2)                         # (nb, 16)
    sub_scale = amax / 31.0
    d = sub_scale.max(axis=1, keepdims=True) / 127.0
    inv_d = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    sc = np.round(sub_scale * inv_d).clip(-127, 127).astype(np.int8)
    d16 = d.astype("<f2")
    eff = d16.astype(F32) * sc.astype(F32)               # (nb, 16)
    inv_s = np.where(eff != 0, 1.0 / np.where(eff == 0, 1, eff), 0.0)
    q = (np.round(x * inv_s[:, :, None]) + 32).clip(0, 63).astype(np.uint8)
    q = q.reshape(nb, 256)
    ql = np.empty((nb, 128), dtype=np.uint8)
    qh = np.empty((nb, 64), dtype=np.uint8)
    for n in range(2):
        base = n * 128
        q1 = q[:, base : base + 32]
        q2 = q[:, base + 32 : base + 64]
        q3 = q[:, base + 64 : base + 96]
        q4 = q[:, base + 96 : base + 128]
        ql[:, n * 64 : n * 64 + 32] = (q1 & 0x0F) | ((q3 & 0x0F) << 4)
        ql[:, n * 64 + 32 : n * 64 + 64] = (q2 & 0x0F) | ((q4 & 0x0F) << 4)
        qh[:, n * 32 : n * 32 + 32] = (q1 >> 4) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4) | ((q4 >> 4) << 6)
    out = np.empty((nb, 210), dtype=np.uint8)
    out[:, 0:128] = ql
    out[:, 128:192] = qh
    out[:, 192:208] = sc.view(np.uint8)
    out[:, 208:210] = d16.view(np.uint8)
    return out.tobytes()


def dequant_q8_k(raw) -> np.ndarray:
    b = _as_blocks(raw, GGMLType.Q8_K)
    d = b[:, 0:4].copy().view("<f4")
    q = b[:, 4:260].view(np.int8).astype(F32)
    return (d * q).reshape(-1)


def quant_q8_k(x: np.ndarray) -> bytes:
    x = np.asarray(x, dtype=F32).reshape(-1, 256)
    amax = np.abs(x).max(axis=1, keepdims=True)
    d = amax / 127.0
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.round(x * inv).clip(-127, 127).astype(np.int8)
    bsums = q.reshape(-1, 16, 16).sum(axis=2).astype("<i2")
    out = np.empty((x.shape[0], 292), dtype=np.uint8)
    out[:, 0:4] = d.astype("<f4").view(np.uint8)
    out[:, 4:260] = q.view(np.uint8)
    out[:, 260:292] = bsums.view(np.uint8).reshape(-1, 32)
    return out.tobytes()


# ---------------------------------------------------------------------------
# Plain float formats + dispatch
# ---------------------------------------------------------------------------

def _dequant_f16(raw) -> np.ndarray:
    return np.frombuffer(bytes(raw), dtype="<f2").astype(F32)


def _dequant_f32(raw) -> np.ndarray:
    return np.frombuffer(bytes(raw), dtype="<f4").copy()


def _dequant_bf16(raw) -> np.ndarray:
    u16 = np.frombuffer(bytes(raw), dtype="<u2").astype(np.uint32) << 16
    return u16.view(np.float32)


_DEQUANT = {
    GGMLType.F32: _dequant_f32,
    GGMLType.F16: _dequant_f16,
    GGMLType.BF16: _dequant_bf16,
    GGMLType.Q4_0: dequant_q4_0,
    GGMLType.Q4_1: dequant_q4_1,
    GGMLType.Q5_0: dequant_q5_0,
    GGMLType.Q5_1: dequant_q5_1,
    GGMLType.Q8_0: dequant_q8_0,
    GGMLType.Q4_K: dequant_q4_k,
    GGMLType.Q5_K: dequant_q5_k,
    GGMLType.Q6_K: dequant_q6_k,
    GGMLType.Q8_K: dequant_q8_k,
}

_QUANT = {
    GGMLType.Q4_0: quant_q4_0,
    GGMLType.Q8_0: quant_q8_0,
    GGMLType.Q4_K: quant_q4_k,
    GGMLType.Q5_K: quant_q5_k,
    GGMLType.Q6_K: quant_q6_k,
    GGMLType.Q8_K: quant_q8_k,
}


def dequantize(raw, t: GGMLType, shape: tuple[int, ...] | None = None) -> np.ndarray:
    """Decode a ggml payload to float32. `shape` reshapes the flat output."""
    fn = _DEQUANT.get(t)
    if fn is None:
        raise NotImplementedError(f"dequantize {t.name}")
    out = fn(raw)
    return out.reshape(shape) if shape is not None else out


def quantize(x: np.ndarray, t: GGMLType) -> bytes:
    """Encode float data into a ggml payload of type t."""
    if t == GGMLType.F32:
        return np.asarray(x, dtype="<f4").tobytes()
    if t == GGMLType.F16:
        return np.asarray(x, dtype="<f2").tobytes()
    if t == GGMLType.BF16:
        u32 = np.asarray(x, dtype=F32).view(np.uint32)
        # round-to-nearest-even bf16
        rounded = ((u32 + 0x7FFF + ((u32 >> 16) & 1)) >> 16).astype("<u2")
        return rounded.tobytes()
    fn = _QUANT.get(t)
    if fn is None:
        raise NotImplementedError(f"quantize {t.name}")
    return fn(np.asarray(x))


def supported_dequant_types() -> list[GGMLType]:
    return sorted(_DEQUANT, key=int)
