"""Dense KV cache: per-layer [B, Hkv, S, D] buffers, updated in place.

Counterpart of `gemma_tpu/runtime/kv_cache.py` (dense arm). The layout is
the reference's: one buffer per layer for K and one for V, sequence second
to last, so the attention kernels read a [S, D] slab per (batch, kv head)
without a transpose. `length[b]` counts the valid slots of sequence b.

Unlike the reference, which donates its immutable buffers through jit, the
writes here update the buffers IN PLACE and return the same cache object.
The int8 mode (`quantized=True`) is not ported yet and raises.
"""
from __future__ import annotations

import torch

from ..models.config import GemmaConfig


class KVCache:
    """k/v: lists of L tensors [B, Hkv, S, D]; length: i32 [B]."""

    def __init__(self, k: list[torch.Tensor], v: list[torch.Tensor], length: torch.Tensor):
        self.k = k
        self.v = v
        self.length = length

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
        if quantized:
            raise NotImplementedError(
                "the int8 KV cache is not ported yet (ROADMAP queue 1, item 3)"
            )
        shape = (batch, config.n_kv_heads, max_len, config.head_dim)
        L = config.n_layers
        return cls(
            k=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(L)],
            v=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(L)],
            length=torch.zeros(batch, dtype=torch.int32, device=device),
        )

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2]

    def gather_layer(self, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The [B, Hkv, S, D] buffers of layer `layer`."""
        return self.k[layer], self.v[layer]

    def write_chunk(self, layer: int, start: int, k_new: torch.Tensor, v_new: torch.Tensor) -> "KVCache":
        """Write a [B, T, H, D] chunk at slots [start, start + T) of every
        sequence (prefill), in place."""
        T = k_new.shape[1]
        if start < 0 or start + T > self.max_len:
            raise ValueError(f"chunk [{start}, {start + T}) exceeds cache capacity {self.max_len}")
        kb, vb = self.k[layer], self.v[layer]
        kb[:, :, start : start + T] = k_new.transpose(1, 2).to(kb.dtype)
        vb[:, :, start : start + T] = v_new.transpose(1, 2).to(vb.dtype)
        return self

    def write_token(self, layer: int, index: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor) -> "KVCache":
        """Write one token per sequence, k_new [B, 1, H, D] at slot index[b]
        (decode), in place. `index` stays on the device: no host sync."""
        kb, vb = self.k[layer], self.v[layer]
        rows = torch.arange(kb.shape[0], device=kb.device)
        idx = index.to(device=kb.device, dtype=torch.long)
        kb[rows, :, idx] = k_new[:, 0].to(kb.dtype)
        vb[rows, :, idx] = v_new[:, 0].to(vb.dtype)
        return self

    def advance(self, n: int | torch.Tensor) -> "KVCache":
        self.length = self.length + n
        return self
