"""Dense KV cache: per-layer [B, Hkv, S, D] buffers, updated in place.

Counterpart of `gemma_tpu/runtime/kv_cache.py`. The layout is the
reference's: one buffer per layer for K and one for V, sequence second to
last, so the attention kernels read a [S, D] slab per (batch, kv head)
without a transpose. `length[b]` counts the valid slots of sequence b.

Int8 mode (`quantized=True`): K and V are int8 with one f32 scale per
(batch, kv head, position), `k_scale`/`v_scale` [B, Hkv, S], made by
`quantize_kv` (the reference's `_quantize`, bit for bit).

Unlike the reference, which donates its immutable buffers through jit, the
writes here update the buffers IN PLACE and return the same cache object.
The hand-off format between a prefill and a serving cache is the
reference's: stacked [L, Hkv, T, D] K and V, and [L, Hkv, T] scales.
"""
from __future__ import annotations

import torch

from ..models.config import GemmaConfig
from ..ops.attention import dequantize_kv


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on `device`; to a CUDA device through pinned memory and
    a copy that does not make the host wait for the queued kernels."""
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 over the last axis: x [..., D] ->
    (int8 [..., D], f32 scale [...]). Bit-exact with the reference's
    `KVCache._quantize`: the amax of the f32 values, scale = amax / 127,
    the inverse 0 where the scale is 0, and round half to even of x * inv
    (not x / scale, which rounds ties differently)."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1) / 127.0
    inv = torch.where(scale > 0, 1.0 / torch.where(scale == 0, 1.0, scale), 0.0)
    return torch.round(xf * inv[..., None]).to(torch.int8), scale


class KVCache:
    """k/v: lists of L tensors [B, Hkv, S, D] (int8 when quantized);
    k_scale/v_scale: lists of L f32 tensors [B, Hkv, S], or None;
    length: i32 [B]."""

    def __init__(self, k: list[torch.Tensor], v: list[torch.Tensor], length: torch.Tensor,
                 k_scale: list[torch.Tensor] | None = None, v_scale: list[torch.Tensor] | None = None):
        self.k = k
        self.v = v
        self.length = length
        self.k_scale = k_scale
        self.v_scale = v_scale

    @classmethod
    def create(
        cls,
        config: GemmaConfig,
        batch: int,
        max_len: int,
        dtype: torch.dtype = torch.bfloat16,
        device: torch.device | str = "cpu",
        quantized: bool = False,
    ) -> "KVCache":
        shape = (batch, config.n_kv_heads, max_len, config.head_dim)
        L = config.n_layers

        def bufs(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=device) for _ in range(L)]

        kv_dtype = torch.int8 if quantized else dtype
        return cls(
            k=bufs(shape, kv_dtype), v=bufs(shape, kv_dtype),
            length=torch.zeros(batch, dtype=torch.int32, device=device),
            k_scale=bufs(shape[:-1], torch.float32) if quantized else None,
            v_scale=bufs(shape[:-1], torch.float32) if quantized else None,
        )

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2]

    def layer_kv(self, layer: int):
        """(k, v, k_scale, v_scale) of layer `layer` as stored: [B, Hkv, S, D]
        buffers and, in int8 mode, their [B, Hkv, S] scales (else None)."""
        if self.quantized:
            return self.k[layer], self.v[layer], self.k_scale[layer], self.v_scale[layer]
        return self.k[layer], self.v[layer], None, None

    def gather_layer(self, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The [B, Hkv, S, D] K and V of layer `layer`, dequantized to bf16 in
        int8 mode (scale rounded to bf16, product in bf16, as the reference)."""
        k, v, ks, vs = self.layer_kv(layer)
        if ks is None:
            return k, v
        return dequantize_kv(k, ks), dequantize_kv(v, vs)

    def _write(self, layer: int, idx: tuple, k_new: torch.Tensor, v_new: torch.Tensor) -> None:
        """Store k_new/v_new at k[layer][idx] (idx indexes the first three
        axes, so it also addresses the scales), quantizing in int8 mode."""
        if self.quantized:
            (k_new, sk), (v_new, sv) = quantize_kv(k_new), quantize_kv(v_new)
            self.k_scale[layer][idx] = sk
            self.v_scale[layer][idx] = sv
        self.k[layer][idx] = k_new.to(self.k[layer].dtype)
        self.v[layer][idx] = v_new.to(self.v[layer].dtype)

    def write_chunk(self, layer: int, start: int, k_new: torch.Tensor, v_new: torch.Tensor) -> "KVCache":
        """Write a [B, T, H, D] chunk at slots [start, start + T) of every
        sequence (prefill), in place."""
        T = k_new.shape[1]
        if start < 0 or start + T > self.max_len:
            raise ValueError(f"chunk [{start}, {start + T}) exceeds cache capacity {self.max_len}")
        idx = (slice(None), slice(None), slice(start, start + T))
        self._write(layer, idx, k_new.transpose(1, 2), v_new.transpose(1, 2))
        return self

    def write_chunk_per_seq(self, layer: int, starts: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor) -> "KVCache":
        """Write a [B, T, H, D] chunk at slots [starts[b], starts[b] + T) of
        sequence b (the batched speculative verify), in place, as one
        indexed write and with no host sync. Starts are clamped on the
        device to [0, S - T], as the reference clips them: the chunk moves
        back whole. Active sequences never need the clamp; an idle serving
        slot may drift past capacity, and its rows are rewritten when the
        slot is admitted again."""
        B, T = k_new.shape[:2]
        dev = self.k[layer].device
        starts = starts.to(device=dev, dtype=torch.long).clamp(0, self.max_len - T)
        rows = starts[:, None] + torch.arange(T, device=dev)
        # (b, :, rows[b, t]) addresses [B, T, H, D], and [B, T, H] of the scales
        self._write(layer, (torch.arange(B, device=dev)[:, None], slice(None), rows), k_new, v_new)
        return self

    def write_token(self, layer: int, index: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor) -> "KVCache":
        """Write one token per sequence, k_new [B, 1, H, D] at slot index[b]
        (decode), in place. `index` stays on the device: no host sync. Every
        index must lie in [0, max_len): `Engine.decode_step` clamps it."""
        dev = self.k[layer].device
        rows = torch.arange(k_new.shape[0], device=dev)
        idx = (rows, slice(None), index.to(device=dev, dtype=torch.long))
        self._write(layer, idx, k_new[:, 0], v_new[:, 0])
        return self

    def advance(self, n: int | torch.Tensor) -> "KVCache":
        self.length = self.length + n
        return self

    # -- sequence hand-off (stacked [L, H, T, D] boundary format) ----------
    def extract_seq(self, b: int = 0):
        """Batch row `b` as the stacked insert parts: (k_seq [L, H, S, D],
        v_seq, (k_scale [L, H, S] | None, v_scale | None))."""
        k_seq = torch.stack([kl[b] for kl in self.k])
        v_seq = torch.stack([vl[b] for vl in self.v])
        if not self.quantized:
            return k_seq, v_seq, (None, None)
        return k_seq, v_seq, (torch.stack([s[b] for s in self.k_scale]),
                              torch.stack([s[b] for s in self.v_scale]))

    def insert_sequence(self, slot: int, k_seq: torch.Tensor, v_seq: torch.Tensor,
                        length: int, k_scale: torch.Tensor | None = None,
                        v_scale: torch.Tensor | None = None) -> "KVCache":
        """Copy a prefilled sequence (k_seq [L, H, T, D], already int8 with
        scales [L, H, T] when the cache is) into batch row `slot`, in place.
        Slots past T keep what they held: `length` masks them."""
        T = k_seq.shape[2]
        if T > self.max_len:
            raise ValueError(f"prefill of {T} slots exceeds cache capacity {self.max_len}")
        for l in range(len(self.k)):
            self.k[l][slot, :, :T] = k_seq[l]
            self.v[l][slot, :, :T] = v_seq[l]
            if self.quantized:
                self.k_scale[l][slot, :, :T] = k_scale[l]
                self.v_scale[l][slot, :, :T] = v_scale[l]
        self.length[slot] = length
        return self
