"""QTensor — q4_0 matrices in the port's Hopper layout.

Counterpart of `gemma_tpu/quant/qtensor.py`, with its own layout. The
reference's device layout is TPU-shaped: K-major arrays, K-paired signed
nibbles and q4_0 scales rounded to bf16. The port's layout is N-major
structure-of-arrays, chosen for the q4_0 kernels in `csrc/q4_0_matmul.cu`:

====== =================================================== =====
fmt    arrays (logical matrix [N, K] = [out, in])           bpw
====== =================================================== =====
q4_0   qs u8 [N, K/2]: ggml's 16 payload bytes of each      4.5
       32-block, in ggml's in-block order (element j < 16
       is the low nibble of byte j, element j + 16 its
       high nibble), unsigned with the zero point 8;
       scales f16 [N, K/32]: ggml's exact f16 scales
====== =================================================== =====

Each row's K is contiguous, so a warp walking one output row issues
16-byte coalesced loads, and one 16-byte load is exactly one 32-block with
one scale. The density is ggml's wire density, and the scales stay exact:
dequant is bit-identical to `gemma_tpu.quant.numpy_ref`.

Other block formats (q8_0, q4_k, q6_k) have no port layout yet; they raise
`NotImplementedError` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gemma_tpu.gguf.constants import GGMLType

QGROUP = 32  # ggml QK4_0: elements per block (one f16 scale)
Q4_0_BLOCK_BYTES = 18  # 2-byte f16 scale + 16 payload bytes

# formats of the reference's quantized path that the port has not laid out
# yet, with the ROADMAP queue item that ports each
_NOT_PORTED = {
    GGMLType.Q8_0: "q8_0 (ROADMAP queue 1, item 2: q8_0)",
    GGMLType.Q4_K: "q4_k (ROADMAP queue 1, item 1: q4_k/q6_k for q4_k_m)",
    GGMLType.Q6_K: "q6_k (ROADMAP queue 1, item 1: q4_k/q6_k for q4_k_m)",
}
QUANTIZED_TYPES = frozenset(_NOT_PORTED) | {GGMLType.Q4_0}


class QTensor(nn.Module):
    """A logical [N, K] = [out, in] q4_0 matrix held as `qs` / `scales`
    buffers. `ops.linear.linear` routes it to the q4_0 matmul."""

    fmt = "q4_0"

    def __init__(self, qs: torch.Tensor, scales: torch.Tensor):
        super().__init__()
        if qs.dtype != torch.uint8 or scales.dtype != torch.float16:
            raise TypeError(f"q4_0 wants qs u8 and scales f16, got {qs.dtype}, {scales.dtype}")
        if qs.dim() != 2 or scales.shape != (qs.shape[0], qs.shape[1] // 16) or qs.shape[1] % 16:
            raise ValueError(f"q4_0 shapes qs {tuple(qs.shape)} / scales {tuple(scales.shape)}")
        self.register_buffer("qs", qs)
        self.register_buffer("scales", scales)

    @property
    def shape(self) -> tuple[int, int]:
        """Logical (N, K)."""
        return (int(self.qs.shape[0]), int(self.qs.shape[1]) * 2)

    @property
    def device(self) -> torch.device:
        return self.qs.device

    def extra_repr(self) -> str:
        return f"fmt={self.fmt}, shape={self.shape}"


def pack_q4_0(raw, shape: tuple[int, int]) -> tuple[np.ndarray, np.ndarray]:
    """ggml q4_0 bytes of an [N, K] matrix -> (qs u8 [N, K/2], scales f16
    [N, K/32]). The payload bytes keep ggml's in-block nibble order."""
    rows, cols = shape
    if cols % QGROUP:
        raise ValueError(f"q4_0 needs in-features divisible by {QGROUP}, got {cols}")
    b = np.frombuffer(bytes(raw), dtype=np.uint8).reshape(rows, cols // QGROUP, Q4_0_BLOCK_BYTES)
    scales = np.ascontiguousarray(b[:, :, :2]).view("<f2").reshape(rows, cols // QGROUP)
    qs = np.ascontiguousarray(b[:, :, 2:]).reshape(rows, cols // 2)
    return qs, scales


def from_ggml(raw, ggml_type: GGMLType, shape: tuple[int, int], device) -> QTensor:
    """A ggml payload of the quantized path -> QTensor on `device`."""
    if ggml_type in _NOT_PORTED:
        raise NotImplementedError(
            f"{_NOT_PORTED[ggml_type]} is not ported to gemma_tpu_torch yet"
        )
    if ggml_type != GGMLType.Q4_0:
        raise ValueError(f"{ggml_type.name} is not a quantized-path format")
    qs, scales = pack_q4_0(raw, shape)
    return QTensor(
        torch.from_numpy(qs).to(device), torch.from_numpy(scales.astype(np.float16)).to(device)
    )


def _dequant_rows(qs: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """qs u8 [..., K/2], scales f16 [..., K/32] -> [..., K] in `dtype`,
    computed as f32 scale * (q - 8) and then cast."""
    lead = qs.shape[:-1]
    blocks = qs.reshape(*lead, -1, 16)
    q = torch.cat([blocks & 0x0F, blocks >> 4], dim=-1).to(torch.float32) - 8.0
    w = q * scales.to(torch.float32)[..., None]
    return w.reshape(*lead, -1).to(dtype)


def dequant(qt: QTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The logical [N, K] matrix (the plain PyTorch dequant)."""
    return _dequant_rows(qt.qs, qt.scales, dtype)


def gather_dequant(qt: QTensor, indices: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Embedding lookup: dequantize only rows `indices` -> [..., K]."""
    flat = indices.reshape(-1).long()
    rows = _dequant_rows(qt.qs[flat], qt.scales[flat], dtype)
    return rows.reshape(*indices.shape, qt.shape[1])


def from_jax_q4_0(arrays: dict[str, np.ndarray], device="cpu") -> QTensor:
    """Convert a reference q4_0 QTensor's numpy arrays into the port layout.

    The reference keeps `qs` u8 [K/2, N] as K-paired signed nibbles (element
    2k' in the low nibble, two's complement of q - 8) and `scales` bf16
    [K/32, N]. The bf16 scales it rounded from ggml's f16 are exact in f16;
    a value that is not (an overflow) raises."""
    qs_j = np.asarray(arrays["qs"], np.uint8)
    half_k, n = qs_j.shape
    k = 2 * half_k
    # signed nibble v = q - 8 stored as v & 15, so the unsigned ggml q = nib ^ 8
    elems = np.stack([qs_j & 0x0F, qs_j >> 4], axis=1).reshape(k, n) ^ 8
    u = np.ascontiguousarray(elems.T).reshape(n, k // QGROUP, QGROUP)
    qs = (u[:, :, :16] | (u[:, :, 16:] << 4)).astype(np.uint8).reshape(n, k // 2)

    sc = np.asarray(arrays["scales"])
    if sc.dtype.itemsize != 2:
        raise TypeError(f"reference q4_0 scales should be bf16, got {sc.dtype}")
    sc32 = (sc.view(np.uint16).astype(np.uint32) << 16).view(np.float32).T
    with np.errstate(over="ignore"):
        sc16 = sc32.astype(np.float16)
    if not np.array_equal(sc16.astype(np.float32), sc32):
        raise ValueError("reference q4_0 scales are not representable in f16 (overflow)")
    return QTensor(
        torch.from_numpy(np.ascontiguousarray(qs)).to(device),
        torch.from_numpy(np.ascontiguousarray(sc16)).to(device),
    )
