"""QTensor — block-quantized matrices in the port's Hopper layout.

Counterpart of `gemma_tpu/quant/qtensor.py`, with its own layout. The
reference's device layout is TPU-shaped: K-major arrays, K-paired signed
nibbles, bf16 q4_0 scales, split-plane q6_k and hi/lo bf16 superscales. The
port's layout is N-major structure-of-arrays, a format tag plus per-format
buffers, chosen for the kernels in `csrc/`:

====== =================================================== =======
fmt    buffers (logical matrix [N, K] = [out, in])          bpw
====== =================================================== =======
q4_0   qs u8 [N, K/2]: ggml's 16 payload bytes of each      4.5
       32-block, in ggml's in-block order (element j < 16
       is the low nibble of byte j, element j + 16 its
       high nibble), unsigned with the zero point 8;
       scales f16 [N, K/32]: ggml's exact f16 scales
q8_0   qs i8 [N, K]: ggml's 32 payload bytes of each        8.5
       32-block, in order; scales f16 [N, K/32]: ggml's
       exact f16 scales
q4_k   qs u8 [N, K/2]: ggml's 128 payload bytes of each     4.5
       256-superblock (32-byte chunk c holds sub-block 2c
       in its low nibbles and 2c + 1 in its high nibbles);
       scales u8 [N, K/256, 12]: ggml's packed 6-bit
       sc/mn table; dm f16 [N, K/256, 2]: ggml's d, dmin
q6_k   ql u8 [N, K/2], qh u8 [N, K/4], sc i8 [N, K/16],     6.5625
       d f16 [N, K/256]: the four fields of ggml's
       210-byte superblock, each in ggml's in-block byte
       order (split because 210 is not 16-byte aligned)
====== =================================================== =======

Each row's K is contiguous, so a warp walking one output row issues
16-byte coalesced loads. The density is ggml's wire density and every scale
stays exact: `dequant` is bit-identical to `numpy_ref` (the port's copy of
the reference's ggml codecs: the same f32 operations in the same order),
and packing is a slice of ggml's block bytes. The 12-byte q4_k table stays
packed (4.5 bpw rather than 4.625 unpacked): the kernels decode it in
registers.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..gguf.constants import GGMLType
from . import numpy_ref

QGROUP = 32  # ggml QK4_0: elements per q4_0 block (one f16 scale)
QK_K = 256  # ggml QK_K: elements per q4_k / q6_k superblock
Q4_0_BLOCK_BYTES = 18  # 2-byte f16 scale + 16 payload bytes
Q8_0_BLOCK_BYTES = 34  # 2-byte f16 scale + 32 int8 payload bytes
Q4_K_BLOCK_BYTES = 144  # d, dmin (f16), 12-byte sc/mn table, 128 payload bytes
Q6_K_BLOCK_BYTES = 210  # ql 128, qh 64, sc 16 (int8), d (f16)

# fmt -> (ggml block size, K per payload column,
#         ((buffer, dtype, trailing shape for a given K), ...));
# the first buffer is the payload that K is read from
FORMATS = {
    "q4_0": (QGROUP, 2, (("qs", torch.uint8, lambda k: (k // 2,)),
                         ("scales", torch.float16, lambda k: (k // QGROUP,)))),
    "q8_0": (QGROUP, 1, (("qs", torch.int8, lambda k: (k,)),
                         ("scales", torch.float16, lambda k: (k // QGROUP,)))),
    "q4_k": (QK_K, 2, (("qs", torch.uint8, lambda k: (k // 2,)),
                       ("scales", torch.uint8, lambda k: (k // QK_K, 12)),
                       ("dm", torch.float16, lambda k: (k // QK_K, 2)))),
    "q6_k": (QK_K, 2, (("ql", torch.uint8, lambda k: (k // 2,)),
                       ("qh", torch.uint8, lambda k: (k // 4,)),
                       ("sc", torch.int8, lambda k: (k // 16,)),
                       ("d", torch.float16, lambda k: (k // QK_K,)))),
}

_GGML_FMT = {GGMLType.Q4_0: "q4_0", GGMLType.Q8_0: "q8_0", GGMLType.Q4_K: "q4_k",
             GGMLType.Q6_K: "q6_k"}
QUANTIZED_TYPES = frozenset(_GGML_FMT)


class QTensor(nn.Module):
    """A logical [N, K] = [out, in] block-quantized matrix: a format tag and
    that format's buffers (`FORMATS`), registered as module buffers so
    `.to(device)` moves them. `ops.linear.linear` routes it by `fmt`."""

    def __init__(self, fmt: str, **buffers: torch.Tensor):
        super().__init__()
        if fmt not in FORMATS:
            raise ValueError(f"unknown QTensor format {fmt!r}")
        block, k_per_col, spec = FORMATS[fmt]
        if set(buffers) != {name for name, _, _ in spec}:
            raise ValueError(f"{fmt} wants buffers {[n for n, _, _ in spec]}, got {sorted(buffers)}")
        payload = buffers[spec[0][0]]
        if payload.dim() != 2:
            raise ValueError(f"{fmt} payload must be [N, K/{k_per_col}], got {tuple(payload.shape)}")
        n, k = int(payload.shape[0]), k_per_col * int(payload.shape[1])
        if k % block:
            raise ValueError(f"{fmt} needs in-features divisible by {block}, got {k}")
        for name, dtype, trailing in spec:
            t = buffers[name]
            if t.dtype != dtype:
                raise TypeError(f"{fmt} buffer {name} must be {dtype}, got {t.dtype}")
            if tuple(t.shape) != (n, *trailing(k)):
                raise ValueError(f"{fmt} buffer {name} has shape {tuple(t.shape)}, "
                                 f"wants {(n, *trailing(k))}")
            self.register_buffer(name, t)
        self.fmt = fmt
        self.shape = (n, k)  # logical (N, K)

    @property
    def arrays(self) -> dict[str, torch.Tensor]:
        """The format's buffers by name, in `FORMATS` order."""
        return dict(self._buffers)

    @property
    def device(self) -> torch.device:
        return next(iter(self._buffers.values())).device

    def extra_repr(self) -> str:
        return f"fmt={self.fmt}, shape={self.shape}"


def select_rows(qt: QTensor, rows) -> QTensor:
    """The QTensor of rows `rows` (an index tensor or a slice) of `qt`."""
    return QTensor(qt.fmt, **{k: v[rows].contiguous() for k, v in qt.arrays.items()})


def select_cols(qt: QTensor, lo: int, hi: int) -> QTensor:
    """The QTensor of in-features [lo, hi) of `qt`: each buffer sliced along
    K at whole blocks (32 for q4_0 and q8_0, 256 for q4_k and q6_k), copied
    into contiguous buffers the kernels take. Raises where lo or hi would
    cut a block."""
    block = FORMATS[qt.fmt][0]
    K = qt.shape[1]
    if not 0 <= lo < hi <= K or lo % block or hi % block:
        raise ValueError(f"{qt.fmt}: columns [{lo}, {hi}) of K = {K} do not hold whole "
                         f"{block}-element blocks")
    out = {}
    for name, _, trailing in FORMATS[qt.fmt][2]:
        per = K // trailing(K)[0]  # in-features a step of the buffer's axis 1
        out[name] = qt.arrays[name][:, lo // per : hi // per].contiguous()
    return QTensor(qt.fmt, **out)


def concat_rows(parts: list[QTensor]) -> QTensor:
    """Concatenate QTensors of one format and K along N (fused projections)."""
    fmt, k = parts[0].fmt, parts[0].shape[1]
    if any(p.fmt != fmt or p.shape[1] != k for p in parts):
        raise ValueError("concat_rows needs one format and one K")
    return QTensor(fmt, **{name: torch.cat([p.arrays[name] for p in parts])
                           for name in parts[0].arrays})


# ---------------------------------------------------------------------------
# ggml bytes -> port layout (numpy)
# ---------------------------------------------------------------------------

def _blocks(raw, shape: tuple[int, int], block: int, nbytes: int) -> np.ndarray:
    rows, cols = shape
    if cols % block:
        raise ValueError(f"in-features must be divisible by {block}, got {cols}")
    return np.frombuffer(bytes(raw), dtype=np.uint8).reshape(rows, cols // block, nbytes)


def _f16(b: np.ndarray) -> np.ndarray:
    """[..., 2k] little-endian bytes -> [..., k] f16."""
    return np.ascontiguousarray(b).view("<f2")


def pack_q4_0(raw, shape: tuple[int, int]) -> dict[str, np.ndarray]:
    """ggml q4_0 bytes of an [N, K] matrix -> qs u8 [N, K/2], scales f16
    [N, K/32]. The payload bytes keep ggml's in-block nibble order."""
    b = _blocks(raw, shape, QGROUP, Q4_0_BLOCK_BYTES)
    rows, cols = shape
    return {"qs": np.ascontiguousarray(b[:, :, 2:]).reshape(rows, cols // 2),
            "scales": _f16(b[:, :, :2]).reshape(rows, cols // QGROUP)}


def pack_q8_0(raw, shape: tuple[int, int]) -> dict[str, np.ndarray]:
    """ggml q8_0 bytes of an [N, K] matrix -> qs i8 [N, K] (the 32 payload
    bytes of each block, in order), scales f16 [N, K/32]."""
    b = _blocks(raw, shape, QGROUP, Q8_0_BLOCK_BYTES)
    rows, cols = shape
    return {"qs": np.ascontiguousarray(b[:, :, 2:]).view(np.int8).reshape(rows, cols),
            "scales": _f16(b[:, :, :2]).reshape(rows, cols // QGROUP)}


def pack_q4_k(raw, shape: tuple[int, int]) -> dict[str, np.ndarray]:
    """ggml q4_k bytes -> qs u8 [N, K/2], scales u8 [N, K/256, 12], dm f16
    [N, K/256, 2]: slices of the 144-byte superblocks."""
    b = _blocks(raw, shape, QK_K, Q4_K_BLOCK_BYTES)
    rows, cols = shape
    return {"qs": np.ascontiguousarray(b[:, :, 16:]).reshape(rows, cols // 2),
            "scales": np.ascontiguousarray(b[:, :, 4:16]),
            "dm": _f16(b[:, :, 0:4])}


def pack_q6_k(raw, shape: tuple[int, int]) -> dict[str, np.ndarray]:
    """ggml q6_k bytes -> ql u8 [N, K/2], qh u8 [N, K/4], sc i8 [N, K/16],
    d f16 [N, K/256]: slices of the 210-byte superblocks."""
    b = _blocks(raw, shape, QK_K, Q6_K_BLOCK_BYTES)
    rows, cols = shape
    return {"ql": np.ascontiguousarray(b[:, :, 0:128]).reshape(rows, cols // 2),
            "qh": np.ascontiguousarray(b[:, :, 128:192]).reshape(rows, cols // 4),
            "sc": np.ascontiguousarray(b[:, :, 192:208]).view(np.int8).reshape(rows, cols // 16),
            "d": _f16(b[:, :, 208:210]).reshape(rows, cols // QK_K)}


_PACKERS = {"q4_0": pack_q4_0, "q8_0": pack_q8_0, "q4_k": pack_q4_k, "q6_k": pack_q6_k}


def _to_qtensor(fmt: str, arrays: dict[str, np.ndarray], device) -> QTensor:
    return QTensor(fmt, **{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                           for k, v in arrays.items()})


def from_ggml(raw, ggml_type: GGMLType, shape: tuple[int, int], device) -> QTensor:
    """A ggml payload of the quantized path -> QTensor on `device`."""
    if ggml_type not in _GGML_FMT:
        raise ValueError(f"{ggml_type.name} is not a quantized-path format")
    fmt = _GGML_FMT[ggml_type]
    return _to_qtensor(fmt, _PACKERS[fmt](raw, shape), device)


# ---------------------------------------------------------------------------
# Plain dequantization (torch), bit-exact against numpy_ref
# ---------------------------------------------------------------------------

def _unpack_scale_min_k4(table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """ggml's packed 6-bit table u8 [..., 12] -> (sc, mn) u8 [..., 8] each
    (ggml get_scale_min_k4; `numpy_ref._unpack_scale_min_k4`)."""
    a, b, c = table[..., 0:4], table[..., 4:8], table[..., 8:12]
    sc = torch.cat([a & 63, (c & 15) | ((a >> 6) << 4)], dim=-1)
    mn = torch.cat([b & 63, (c >> 4) | ((b >> 6) << 4)], dim=-1)
    return sc, mn


def _dequant_q4_0(qs, scales):
    """f32 scale * (q - 8), [..., K]."""
    lead = qs.shape[:-1]
    blocks = qs.reshape(*lead, -1, 16)
    q = torch.cat([blocks & 0x0F, blocks >> 4], dim=-1).to(torch.float32) - 8.0
    return (q * scales.to(torch.float32)[..., None]).reshape(*lead, -1)


def _dequant_q8_0(qs, scales):
    """f32 scale * q, [..., K] (numpy_ref.dequant_q8_0)."""
    lead = qs.shape[:-1]
    q = qs.to(torch.float32).reshape(*lead, -1, QGROUP)
    return (q * scales.to(torch.float32)[..., None]).reshape(*lead, -1)


def q4_k_group_scales(scales: torch.Tensor, dm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(d * sc, dmin * mn) f32 [..., K/256, 8]: each 32-group's scale and min."""
    sc, mn = _unpack_scale_min_k4(scales)
    dmf = dm.to(torch.float32)
    return dmf[..., 0:1] * sc.to(torch.float32), dmf[..., 1:2] * mn.to(torch.float32)


def q4_k_nibbles(qs: torch.Tensor) -> torch.Tensor:
    """qs u8 [..., K/2] -> q u8 [..., K/256, 8, 32] in logical order."""
    chunks = qs.reshape(*qs.shape[:-1], -1, 4, 32)
    return torch.stack([chunks & 0x0F, chunks >> 4], dim=-2).flatten(-3, -2)


def _dequant_q4_k(qs, scales, dm):
    """(d * sc) * q - dmin * mn, [..., K] (numpy_ref.dequant_q4_k)."""
    scale, minv = q4_k_group_scales(scales, dm)
    q = q4_k_nibbles(qs).to(torch.float32)
    return (scale[..., None] * q - minv[..., None]).flatten(-3)


def q6_k_values(ql: torch.Tensor, qh: torch.Tensor) -> torch.Tensor:
    """ql u8 [..., K/2], qh u8 [..., K/4] -> q in [-32, 31] (int16)
    [..., K] in logical order. Within each 128-element half: ql[l] low
    nibbles -> elements l and 32 + l (l < 32, runs of ql[0:32], ql[32:64]),
    high nibbles -> 64 + l and 96 + l; qh[l] bits 0-1, 2-3, 4-5, 6-7 -> the
    same four elements' high bits."""
    lead = ql.shape[:-1]
    lq = ql.reshape(*lead, -1, 2, 32)  # [..., half, run of 32 bytes, 32]
    low4 = torch.cat([lq & 0x0F, lq >> 4], dim=-2)  # [..., half, 4, 32]
    hq = qh.reshape(*lead, -1, 1, 32)
    # the qh bit field of each of the four 32-runs of a half: 0, 2, 4, 6 (made
    # on the device: a copy from the host would wait for the stream)
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=ql.device)[:, None]
    hi2 = (hq >> shifts) & 3
    return ((low4 | (hi2 << 4)).to(torch.int16) - 32).reshape(*lead, -1)


def _dequant_q6_k(ql, qh, sc, d):
    """(d * sc) * q per 16, [..., K] (numpy_ref.dequant_q6_k)."""
    lead = ql.shape[:-1]
    scale = d.to(torch.float32)[..., None] * sc.to(torch.float32).unflatten(-1, (-1, 16))
    q = q6_k_values(ql, qh).to(torch.float32).reshape(*lead, -1, 16, 16)
    return (scale[..., None] * q).reshape(*lead, -1)


_DEQUANT = {"q4_0": _dequant_q4_0, "q8_0": _dequant_q8_0, "q4_k": _dequant_q4_k,
            "q6_k": _dequant_q6_k}


def dequant(qt: QTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The logical [N, K] matrix (the plain PyTorch dequant), computed in f32
    and then cast."""
    return _DEQUANT[qt.fmt](**qt.arrays).to(dtype)


def gather_dequant(qt: QTensor, indices: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Embedding lookup: dequantize only rows `indices` -> [..., K]."""
    rows = select_rows(qt, indices.reshape(-1).long())
    return dequant(rows, dtype).reshape(*indices.shape, qt.shape[1])


# ---------------------------------------------------------------------------
# The reference's layout -> ggml bytes -> port layout (numpy)
# ---------------------------------------------------------------------------

def _bf16_bits_to_f32(a: np.ndarray) -> np.ndarray:
    if a.dtype.itemsize != 2:
        raise TypeError(f"reference scales should be bf16, got {a.dtype}")
    return (np.asarray(a).view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def _exact_f16(x32: np.ndarray, what: str) -> np.ndarray:
    with np.errstate(over="ignore"):
        x16 = x32.astype(np.float16)
    if not np.array_equal(x16.astype(np.float32), x32):
        raise ValueError(f"reference {what} are not representable in f16 (overflow)")
    return x16


def _nibbles(qs_t: np.ndarray) -> np.ndarray:
    """The reference's K-paired signed nibbles u8 [K/2, N] (element 2k' in
    the low nibble, two's complement of u - 8) -> ggml's unsigned values u8
    [N, K]: the nibble of u - 8 is u ^ 8."""
    qs_t = np.asarray(qs_t, np.uint8)
    pairs = np.stack([qs_t & 0x0F, qs_t >> 4], axis=1).reshape(2 * qs_t.shape[0], qs_t.shape[1])
    return np.ascontiguousarray((pairs ^ 8).T)


def from_jax_q4_0(arrays: dict[str, np.ndarray], device="cpu") -> QTensor:
    """Convert a reference q4_0 QTensor's numpy arrays into the port layout.

    The reference keeps `qs` u8 [K/2, N] as K-paired signed nibbles (element
    2k' in the low nibble, two's complement of q - 8) and `scales` bf16
    [K/32, N]. The bf16 scales it rounded from ggml's f16 are exact in f16;
    a value that is not (an overflow) raises."""
    u = _nibbles(arrays["qs"])
    n, k = u.shape
    u = u.reshape(n, k // QGROUP, QGROUP)
    qs = (u[:, :, :16] | (u[:, :, 16:] << 4)).reshape(n, k // 2)
    sc16 = _exact_f16(_bf16_bits_to_f32(arrays["scales"]).T, "q4_0 scales")
    return _to_qtensor("q4_0", {"qs": qs, "scales": sc16}, device)


def from_jax_q8_0(arrays: dict[str, np.ndarray], device="cpu") -> QTensor:
    """Convert a reference q8_0 QTensor (`qs` i8 [K, N], `scales` bf16
    [K/32, N]) into the port layout: transposed, with the bf16 scales it
    rounded from ggml's f16 carried as f16 (exact; an overflow raises)."""
    qs = np.ascontiguousarray(np.asarray(arrays["qs"]).view(np.int8).T)
    sc16 = _exact_f16(np.ascontiguousarray(_bf16_bits_to_f32(arrays["scales"]).T), "q8_0 scales")
    return _to_qtensor("q8_0", {"qs": qs, "scales": sc16}, device)


def _superscale(rows_bf16: np.ndarray, hi: int, lo: int) -> np.ndarray:
    """An exact bf16 hi/lo pair (the reference's `_hi_lo`) -> the f16 value:
    rows `hi` and `lo` of [S, 4, N] -> [N, S] f16."""
    d32 = rows_bf16[:, hi] + rows_bf16[:, lo]
    return _exact_f16(np.ascontiguousarray(d32.T), "superblock scales")


def from_jax_q4_k(arrays: dict[str, np.ndarray], device="cpu") -> QTensor:
    """Convert a reference q4_k QTensor (`qs` K-paired signed q - 8 nibbles
    u8 [K/2, N]; `meta` i8 [3K/32, N], per superblock 8 sc6, 8 mn6 and the
    low then high bytes of the bf16 [d_hi, dmin_hi, d_lo, dmin_lo] quad)
    back into ggml's 144-byte blocks, then pack them."""
    q = _nibbles(arrays["qs"])  # [N, K]
    n, k = q.shape
    nsb = k // QK_K
    meta = np.asarray(arrays["meta"]).view(np.uint8).reshape(nsb, 24, n)
    sc6 = np.ascontiguousarray(meta[:, 0:8].transpose(2, 0, 1)).reshape(-1, 8)
    mn6 = np.ascontiguousarray(meta[:, 8:16].transpose(2, 0, 1)).reshape(-1, 8)
    bits = meta[:, 16:20].astype(np.uint16) | (meta[:, 20:24].astype(np.uint16) << 8)
    quad = _bf16_bits_to_f32(bits)  # [S, 4, N]
    blocks = np.empty((n, nsb, Q4_K_BLOCK_BYTES), np.uint8)
    blocks[:, :, 0:2] = _superscale(quad, 0, 2)[..., None].view(np.uint8)
    blocks[:, :, 2:4] = _superscale(quad, 1, 3)[..., None].view(np.uint8)
    blocks[:, :, 4:16] = numpy_ref._pack_scale_min_k4(sc6, mn6).reshape(n, nsb, 12)
    sub = q.reshape(n, nsb, 4, 2, 32)  # chunk c: sub-blocks 2c (low), 2c + 1 (high)
    blocks[:, :, 16:] = (sub[:, :, :, 0] | (sub[:, :, :, 1] << 4)).reshape(n, nsb, 128)
    return from_ggml(blocks.tobytes(), GGMLType.Q4_K, (n, k), device)


def _q6_k_blocks(u: np.ndarray, sc8_t: np.ndarray, d_t: np.ndarray) -> np.ndarray:
    """u [N, K] values q + 32 in 0..63, the reference's sc8 i8 [K/16, N] and
    d bf16 [K/64, N] rows [d_hi, d_lo, d_hi, d_lo] -> ggml q6_k blocks
    [N, K/256, 210] (numpy_ref.quant_q6_k's packing)."""
    n, k = u.shape
    nsb = k // QK_K
    v = u.reshape(n, nsb, 2, 4, 32)  # [..., half, run, l]
    blocks = np.empty((n, nsb, Q6_K_BLOCK_BYTES), np.uint8)
    ql = np.concatenate([(v[:, :, :, 0] & 15) | ((v[:, :, :, 2] & 15) << 4),
                         (v[:, :, :, 1] & 15) | ((v[:, :, :, 3] & 15) << 4)], axis=3)
    qh = ((v[:, :, :, 0] >> 4) | ((v[:, :, :, 1] >> 4) << 2)
          | ((v[:, :, :, 2] >> 4) << 4) | ((v[:, :, :, 3] >> 4) << 6))
    blocks[:, :, 0:128] = ql.reshape(n, nsb, 128)
    blocks[:, :, 128:192] = qh.reshape(n, nsb, 64)
    blocks[:, :, 192:208] = np.ascontiguousarray(
        np.asarray(sc8_t).view(np.int8).T).view(np.uint8).reshape(n, nsb, 16)
    d4 = _bf16_bits_to_f32(d_t).reshape(nsb, 4, n)
    blocks[:, :, 208:210] = _superscale(d4, 0, 1)[..., None].view(np.uint8)
    return blocks


def from_jax_q6_k(arrays: dict[str, np.ndarray], fmt: str = "q6_k", device="cpu") -> QTensor:
    """Convert a reference q6_k QTensor back into ggml's 210-byte blocks,
    then pack them. `fmt` is the reference's layout:
    * "q6_k" (split-plane): `ql` K-paired signed nibbles of (u & 15) - 8,
      `qh` plane-major 2-bit fields of u >> 4 (per 256-row granule, byte row
      j holds rows i*64 + j at bits 2i), `sc8`, hi/lo bf16 `d`;
    * "q6_k_v4" (deep-K int8): `qs` i8 [K, N] = q, `sc8`, `d`."""
    if fmt == "q6_k":
        low = _nibbles(arrays["ql"])  # [N, K], u & 15
        qh_t = np.asarray(arrays["qh"], np.uint8)
        g = qh_t.reshape(-1, 1, 64, qh_t.shape[1])
        planes = (g >> (2 * np.arange(4, dtype=np.uint8))[None, :, None, None]) & 3
        hi2 = planes.reshape(-1, qh_t.shape[1]).T
        u = low | (hi2 << 4)
    elif fmt == "q6_k_v4":
        u = (np.asarray(arrays["qs"]).view(np.int8).T.astype(np.int16) + 32).astype(np.uint8)
    else:
        raise ValueError(f"unknown reference q6_k layout {fmt!r}")
    blocks = _q6_k_blocks(np.ascontiguousarray(u), arrays["sc8"], arrays["d"])
    return from_ggml(blocks.tobytes(), GGMLType.Q6_K, u.shape, device)


def from_jax(fmt: str, arrays: dict[str, np.ndarray], device="cpu") -> QTensor:
    """A reference QTensor (`fmt`, numpy `arrays`) -> the port's QTensor."""
    if fmt == "q4_0":
        return from_jax_q4_0(arrays, device)
    if fmt == "q8_0":
        return from_jax_q8_0(arrays, device)
    if fmt == "q4_k":
        return from_jax_q4_k(arrays, device)
    if fmt in ("q6_k", "q6_k_v4"):
        return from_jax_q6_k(arrays, fmt, device)
    raise ValueError(f"unknown reference format {fmt!r}")
