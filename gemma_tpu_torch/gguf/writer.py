"""GGUF writer.

The port's own copy of `gemma_tpu/gguf/writer.py`; tests/test_torch_gguf.py
holds the two equal. Tests and `chip_smoke.py` fabricate small valid GGUF
models with it.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
    row_size,
)

_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_NP_TO_VT = {
    np.dtype("<u1"): GGUFValueType.UINT8,
    np.dtype("<i1"): GGUFValueType.INT8,
    np.dtype("<u2"): GGUFValueType.UINT16,
    np.dtype("<i2"): GGUFValueType.INT16,
    np.dtype("<u4"): GGUFValueType.UINT32,
    np.dtype("<i4"): GGUFValueType.INT32,
    np.dtype("<f4"): GGUFValueType.FLOAT32,
    np.dtype("<u8"): GGUFValueType.UINT64,
    np.dtype("<i8"): GGUFValueType.INT64,
    np.dtype("<f8"): GGUFValueType.FLOAT64,
    np.dtype("?"): GGUFValueType.BOOL,
}


def _infer_vt(v) -> GGUFValueType:
    if isinstance(v, bool) or isinstance(v, np.bool_):
        return GGUFValueType.BOOL
    if isinstance(v, (int, np.integer)):
        if v < 0:
            return GGUFValueType.INT32 if v >= -(2**31) else GGUFValueType.INT64
        return GGUFValueType.UINT32 if v < 2**32 else GGUFValueType.UINT64
    if isinstance(v, (float, np.floating)):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF value type for {type(v)}")


class GGUFWriter:
    def __init__(self, path: str | Path, *, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = Path(path)
        self.alignment = alignment
        self._kv: list[tuple[str, GGUFValueType, object]] = []
        # name -> (ne_disk_order, ggml_type, payload bytes, offset)
        self._tensors: list[tuple[str, list[int], GGMLType, bytes]] = []

    # -- metadata ----------------------------------------------------------
    def add_kv(self, key: str, value, vt: GGUFValueType | None = None) -> None:
        self._kv.append((key, vt or _infer_vt(value), value))

    # -- tensors -----------------------------------------------------------
    def add_tensor(
        self,
        name: str,
        data: bytes | np.ndarray,
        shape: tuple[int, ...],
        ggml_type: GGMLType,
    ) -> None:
        """Add a tensor. `shape` is logical numpy order; `data` is the packed
        payload (for quantized types) or a numpy array (for plain types)."""
        if isinstance(data, np.ndarray):
            payload = np.ascontiguousarray(data).tobytes()
        else:
            payload = bytes(data)
        ne = list(reversed(shape))  # GGUF stores fastest-varying dim first
        n_rows = int(np.prod(ne[1:])) if len(ne) > 1 else 1
        expect = n_rows * row_size(ggml_type, ne[0])
        if len(payload) != expect:
            raise ValueError(
                f"{name}: payload {len(payload)}B != expected {expect}B "
                f"for shape {shape} type {ggml_type.name}"
            )
        self._tensors.append((name, ne, ggml_type, payload))

    # -- serialization -----------------------------------------------------
    def _write_str(self, f, s: str) -> None:
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def _write_value(self, f, vt: GGUFValueType, v) -> None:
        if vt == GGUFValueType.STRING:
            self._write_str(f, v)
        elif vt == GGUFValueType.ARRAY:
            if isinstance(v, np.ndarray):
                elem_vt = _NP_TO_VT[v.dtype.newbyteorder("<")]
                f.write(struct.pack("<IQ", int(elem_vt), v.size))
                f.write(np.ascontiguousarray(v, dtype=v.dtype).tobytes())
            else:
                v = list(v)
                elem_vt = _infer_vt(v[0]) if v else GGUFValueType.INT32
                # normalize int arrays that mix signs
                if elem_vt in (GGUFValueType.UINT32, GGUFValueType.INT32) and any(
                    isinstance(x, (int, np.integer)) and x < 0 for x in v
                ):
                    elem_vt = GGUFValueType.INT32
                f.write(struct.pack("<IQ", int(elem_vt), len(v)))
                for x in v:
                    self._write_value(f, elem_vt, x)
        else:
            f.write(struct.pack(_SCALAR_FMT[vt], v))

    def write(self) -> None:
        with open(self.path, "wb") as f:
            f.write(struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION, len(self._tensors), len(self._kv)))
            for key, vt, v in self._kv:
                self._write_str(f, key)
                f.write(struct.pack("<I", int(vt)))
                self._write_value(f, vt, v)

            offset = 0
            offsets = []
            for name, ne, ggml_type, payload in self._tensors:
                self._write_str(f, name)
                f.write(struct.pack("<I", len(ne)))
                for d in ne:
                    f.write(struct.pack("<Q", d))
                f.write(struct.pack("<IQ", int(ggml_type), offset))
                offsets.append(offset)
                offset += len(payload)
                offset += -offset % self.alignment

            f.write(b"\x00" * (-f.tell() % self.alignment))
            for (name, ne, ggml_type, payload), off in zip(self._tensors, offsets):
                f.write(payload)
                f.write(b"\x00" * (-len(payload) % self.alignment))
