"""Paged KV cache: a page table per sequence over shared per-layer pools.

Counterpart of `gemma_tpu/runtime/paged_kv.py`. KV memory is a pool of
fixed-size pages shared by all sequences; each sequence maps its logical
positions to physical pages through its row of the page table, so capacity
is pooled and admission costs the pages a request needs.

Device state, updated in place:
    k_pages, v_pages: lists of L per-layer pools [n_pages, Hkv, page_size, D]
                      (int8 in int8 mode, with f32 k_scale/v_scale pools
                      [n_pages, Hkv, page_size])
    page_table:       i32 [B, max_pages] physical page of each logical page
    length:           i32 [B]

The host-side `PageAllocator` owns the free list (the scheduler calls it at
admission and finish). Page 0 is the trash page: an idle slot's table row
is all 0, so its decode writes land there. `gather_pages` gives the dense
view that prefill (T > 1) attends over; decode reads the pages in place
through `ops.paged_attention`.
"""
from __future__ import annotations

import torch

from ..models.config import GemmaConfig
from ..ops.attention import dequantize_kv
from ..ops.paged_attention import gather_pages
from .kv_cache import quantize_kv, to_device


class PageAllocator:
    """Host-side free list over the physical page pool; page 0 is reserved
    as the trash page."""

    TRASH_PAGE = 0

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, 0, -1))  # page 0 reserved

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def release(self, pages: list[int]) -> None:
        self._free.extend(pages)


class PagedKVCache:
    def __init__(self, k_pages: list[torch.Tensor], v_pages: list[torch.Tensor],
                 page_table: torch.Tensor, length: torch.Tensor,
                 k_scale: list[torch.Tensor] | None = None, v_scale: list[torch.Tensor] | None = None):
        self.k_pages = k_pages
        self.v_pages = v_pages
        self.page_table = page_table
        self.length = length
        self.k_scale = k_scale
        self.v_scale = v_scale

    @classmethod
    def create(
        cls,
        config: GemmaConfig,
        batch: int,
        n_pages: int,
        page_size: int = 64,
        max_seq_len: int | None = None,
        dtype: torch.dtype = torch.bfloat16,
        device: torch.device | str = "cpu",
        quantized: bool = False,
        identity_layout: bool = False,
    ) -> "PagedKVCache":
        """`identity_layout=True` gives slot b the private pages 1 + b*maxp ..
        (b+1)*maxp, so `Engine.prefill`/`generate` work without an allocator.
        The default all-zeros table points every slot at the trash page:
        right only for scheduler-managed caches, where `insert_sequence`
        installs each admitted sequence's pages."""
        msl = max_seq_len or config.context_length
        if msl % page_size != 0:
            # a floored table would send writes past maxp*ps out of the table
            raise ValueError(f"max_seq_len ({msl}) must be a multiple of page_size ({page_size})")
        maxp = msl // page_size
        L = config.n_layers
        shape = (n_pages, config.n_kv_heads, page_size, config.head_dim)
        if identity_layout:
            if n_pages < batch * maxp + 1:
                raise ValueError(f"identity_layout needs n_pages >= batch*max_pages+1 = "
                                 f"{batch * maxp + 1}, got {n_pages}")
            page_table = 1 + torch.arange(batch * maxp, dtype=torch.int32, device=device).reshape(batch, maxp)
        else:
            page_table = torch.zeros(batch, maxp, dtype=torch.int32, device=device)

        def pools(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=device) for _ in range(L)]

        pdt = torch.int8 if quantized else dtype
        return cls(
            k_pages=pools(shape, pdt), v_pages=pools(shape, pdt),
            page_table=page_table,
            length=torch.zeros(batch, dtype=torch.int32, device=device),
            k_scale=pools(shape[:-1], torch.float32) if quantized else None,
            v_scale=pools(shape[:-1], torch.float32) if quantized else None,
        )

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def page_size(self) -> int:
        return self.k_pages[0].shape[2]

    @property
    def n_pages(self) -> int:
        return self.k_pages[0].shape[0]

    @property
    def max_len(self) -> int:
        return self.page_table.shape[1] * self.page_size

    def layer_pages(self, layer: int):
        """(k_pages, v_pages, k_scale, v_scale) pools of layer `layer`; the
        scales are None unless the cache is int8."""
        if self.quantized:
            return self.k_pages[layer], self.v_pages[layer], self.k_scale[layer], self.v_scale[layer]
        return self.k_pages[layer], self.v_pages[layer], None, None

    def layer_kv(self, layer: int):
        """(k, v, k_scale, v_scale) of layer `layer` as dense [B, Hkv, S, D]
        views through the page table, as stored (int8 with scales, or
        None)."""
        return tuple(None if t is None else gather_pages(t, self.page_table)
                     for t in self.layer_pages(layer))

    def gather_layer(self, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Dense [B, Hkv, S, D] K and V of layer `layer`, dequantized to bf16
        in int8 mode (the reference's rounding point)."""
        k, v, ks, vs = self.layer_kv(layer)
        if ks is None:
            return k, v
        return dequantize_kv(k, ks), dequantize_kv(v, vs)

    # -- writes ------------------------------------------------------------
    def _write(self, layer: int, pos: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor) -> None:
        """Store k_new/v_new [B, T, H, D] at logical positions pos [B, T]."""
        ps = self.page_size
        page = torch.gather(self.page_table, 1, torch.div(pos, ps, rounding_mode="floor")).long()
        idx = (page, slice(None), pos.long() % ps)
        if self.quantized:
            (k_new, sk), (v_new, sv) = quantize_kv(k_new), quantize_kv(v_new)
            self.k_scale[layer][idx] = sk
            self.v_scale[layer][idx] = sv
        self.k_pages[layer][idx] = k_new.to(self.k_pages[layer].dtype)
        self.v_pages[layer][idx] = v_new.to(self.v_pages[layer].dtype)

    def write_token(self, layer: int, index: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor) -> "PagedKVCache":
        """k_new [B, 1, H, D] at logical position index[b] of each sequence
        (decode), in place, with no host sync. Every index must lie in
        [0, max_len): `Engine.decode_step` clamps it."""
        pos = index.to(device=self.page_table.device, dtype=torch.int64)[:, None]
        self._write(layer, pos, k_new, v_new)
        return self

    def write_chunk(self, layer: int, start: int, k_new: torch.Tensor, v_new: torch.Tensor) -> "PagedKVCache":
        """A [B, T, H, D] chunk at logical positions [start, start + T) of
        every sequence (prefill), in place."""
        B, T = k_new.shape[:2]
        if start < 0 or start + T > self.max_len:
            raise ValueError(f"chunk [{start}, {start + T}) exceeds cache capacity {self.max_len}")
        pos = torch.arange(start, start + T, device=self.page_table.device).expand(B, T)
        self._write(layer, pos, k_new, v_new)
        return self

    def write_chunk_per_seq(self, layer: int, starts: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor) -> "PagedKVCache":
        """Neither package writes a chunk at per-sequence starts into pages:
        refuse it (`write_token` would keep row 0 only)."""
        raise ValueError("per-sequence chunk writes (speculative verify) need the dense KVCache, "
                         "not the paged cache")

    def advance(self, n: int | torch.Tensor) -> "PagedKVCache":
        self.length = self.length + n
        return self

    # -- sequence insertion (pages chosen by the allocator) ----------------
    def insert_sequence(self, slot: int, pages: list[int], k_seq: torch.Tensor, v_seq: torch.Tensor,
                        length: int, k_scale: torch.Tensor | None = None,
                        v_scale: torch.Tensor | None = None) -> "PagedKVCache":
        """Copy a prefilled sequence (k_seq [L, H, T, D], T a multiple of the
        page size, int8 with scales [L, H, T] when the cache is) into the
        first T / page_size of `pages`, and install `pages` as row `slot` of
        the page table (the rest of the row points at the trash page)."""
        L, H, T, D = k_seq.shape
        ps = self.page_size
        n = T // ps
        maxp = self.page_table.shape[1]
        if T % ps or n > len(pages) or len(pages) > maxp:
            raise ValueError(f"a prefill of {T} slots does not fit {len(pages)} pages of {ps} "
                             f"(table width {maxp})")
        row = torch.zeros(maxp, dtype=torch.int32)
        row[: len(pages)] = torch.tensor(pages, dtype=torch.int32)
        row = to_device(row, self.page_table.device)
        dest = row[:n].long()

        def pages_of(x):  # [L, H, T, ...] -> [L, n, H, ps, ...]
            return x.reshape(L, H, n, ps, *x.shape[3:]).transpose(1, 2)

        k_c, v_c = pages_of(k_seq), pages_of(v_seq)
        for l in range(L):
            self.k_pages[l][dest] = k_c[l].to(self.k_pages[l].dtype)
            self.v_pages[l][dest] = v_c[l].to(self.v_pages[l].dtype)
        if self.quantized:
            ks_c, vs_c = pages_of(k_scale), pages_of(v_scale)
            for l in range(L):
                self.k_scale[l][dest] = ks_c[l]
                self.v_scale[l][dest] = vs_c[l]
        self.page_table[slot] = row
        self.length[slot] = length
        return self

    def release_slot(self, slot: int) -> "PagedKVCache":
        """Point row `slot` at the trash page and zero its length, so the
        slot's decode writes stay off pages the allocator hands out again."""
        self.page_table[slot] = PageAllocator.TRASH_PAGE
        self.length[slot] = 0
        return self
