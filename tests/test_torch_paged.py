"""Paged and int8 KV caches, and paged decode attention, against the JAX
package.

One cache state feeds both packages: the reference's `KVCache` or
`PagedKVCache` is built (or written) in JAX and carried into the port by
`testing.from_jax_cache`. The reference's `_paged_call` runs its Pallas
kernel in interpret mode (GEMMA_TPU_INTERPRET_KERNELS=1, pinned per test).

Tolerances: cache contents (bf16 pages, int8 values, f32 scales, tables,
lengths) must be equal bit for bit. Paged attention: the kernel rounds p
(or p * vs for int8 pages) to bf16 against its page-walk's running max, the
port's plain version against the row max, and outputs are bf16: atol =
rtol = 1e-2, as for the dense decode kernel (tests/test_torch_attention.py).
The tensor-core kernel's lane emulation (`tools/tc_emulation.paged_decode`)
is held to the reference kernel row by row, within 2e-2 of each row's
scale (`tools/_timing.attn_err`), as the card holds the kernel.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gemma_tpu.models.config import GemmaConfig as JaxGemmaConfig
from gemma_tpu.ops.paged_attention import paged_decode_attention as jax_paged
from gemma_tpu.runtime.kv_cache import KVCache as JaxKVCache
from gemma_tpu.runtime.paged_kv import PageAllocator as JaxPageAllocator
from gemma_tpu.runtime.paged_kv import PagedKVCache as JaxPagedKVCache
from gemma_tpu_torch.models.config import GemmaConfig
from gemma_tpu_torch.models.params import tensor_from_numpy
from gemma_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                 paged_decode_attention_plain, paged_route)
from gemma_tpu_torch.runtime import KVCache, PageAllocator, PagedKVCache
from gemma_tpu_torch.testing import from_jax_cache
from gemma_tpu_torch.tools import tc_emulation as emu
from gemma_tpu_torch.tools._timing import attn_err

TOL = dict(atol=1e-2, rtol=1e-2)


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    monkeypatch.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)


def _jax_paged_cache(rng, B, Hkv, D, n_pages, ps, maxp, lengths, quantized, fill_free=False):
    """A reference paged cache of one layer holding random bf16 pages (or
    their int8 quantization), distinct shuffled pages per sequence, the
    rest of each table row on the trash page; with `fill_free`, the trash
    page and the free pages hold random values too."""
    perm = rng.permutation(n_pages - 1) + 1
    pt = np.zeros((B, maxp), np.int32)
    kp = np.zeros((n_pages, Hkv, ps, D), np.float32)
    vp = np.zeros_like(kp)
    nxt = 0
    for b in range(B):
        for i in range(-(-lengths[b] // ps)):
            pg = int(perm[nxt])
            nxt += 1
            pt[b, i] = pg
            kp[pg] = rng.normal(size=(Hkv, ps, D)) * 0.3
            vp[pg] = rng.normal(size=(Hkv, ps, D)) * 0.3
    if fill_free:
        free = np.setdiff1d(np.arange(n_pages), pt[pt > 0])
        kp[free] = rng.normal(size=(len(free), Hkv, ps, D)) * 0.3
        vp[free] = rng.normal(size=(len(free), Hkv, ps, D)) * 0.3
    kp, vp = jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)
    common = dict(page_table=jnp.asarray(pt), length=jnp.asarray(lengths, jnp.int32))
    if not quantized:
        return JaxPagedKVCache(k_pages=(kp,), v_pages=(vp,), **common)
    (k8, ks), (v8, vs) = JaxKVCache._quantize(kp), JaxKVCache._quantize(vp)
    return JaxPagedKVCache(k_pages=(k8,), v_pages=(v8,), k_scale=(ks,), v_scale=(vs,), **common)


# the shapes of tests/test_paged_attention.py
PAGED_CASES = [
    # B, Hq, Hkv, D, ps, maxp, n_pages, lengths, softcap, window
    (1, 4, 1, 128, 16, 4, 8, [40], 0.0, 0),
    (2, 8, 2, 128, 16, 8, 24, [17, 128], 0.0, 0),
    (1, 4, 4, 128, 16, 4, 8, [64], 30.0, 0),
    (2, 8, 8, 128, 16, 8, 24, [100, 33], 0.0, 32),
    (1, 2, 2, 256, 32, 4, 6, [96], 0.0, 0),
    (1, 8, 2, 128, 16, 8, 24, [100], 30.0, 32),
]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("B,Hq,Hkv,D,ps,maxp,n_pages,lengths,softcap,window", PAGED_CASES)
def test_paged_plain_matches_jax_kernel(B, Hq, Hkv, D, ps, maxp, n_pages, lengths, softcap, window,
                                        quantized, rng):
    jcache = _jax_paged_cache(rng, B, Hkv, D, n_pages, ps, maxp, lengths, quantized)
    qj = jnp.asarray(rng.normal(size=(B, 1, Hq, D)) * 0.3, jnp.bfloat16)
    lim = jnp.asarray(lengths, jnp.int32)
    ref = jax_paged(qj, jcache, 0, lim, softcap, window)
    cache = from_jax_cache(_numpy(jcache))
    assert cache.quantized == quantized and cache.page_size == ps
    q = _t(qj)
    lim_t = torch.tensor(lengths, dtype=torch.int32)
    got = paged_decode_attention_plain(q, cache, 0, lim_t, softcap, window)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 1, Hq, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **TOL)
    # on CPU tensors the wrapper is the plain version
    torch.testing.assert_close(paged_decode_attention(q, cache, 0, lim_t, softcap, window), got)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("B,Hq,Hkv,D,ps,maxp,n_pages,lengths,softcap,window", PAGED_CASES)
def test_paged_tc_emulation_matches_jax_kernel(B, Hq, Hkv, D, ps, maxp, n_pages, lengths, softcap,
                                               window, quantized, rng):
    """The tensor-core kernel through the page table (lane emulation) against
    `_paged_kernel` on shuffled pages, the trash page and the free pages
    holding random values: within 2e-2 of each row's scale, and no table
    entry read but those of pages that hold a live key. The kernel takes
    G <= 8, so the G = 1 cases count too (the route sends them to split-S)."""
    jcache = _jax_paged_cache(rng, B, Hkv, D, n_pages, ps, maxp, lengths, quantized, fill_free=True)
    qj = jnp.asarray(rng.normal(size=(B, 1, Hq, D)) * 0.3, jnp.bfloat16)
    ref = jax_paged(qj, jcache, 0, jnp.asarray(lengths, jnp.int32), softcap, window)
    cache = from_jax_cache(_numpy(jcache))
    k, v, ks, vs = cache.layer_pages(0)
    reads = set()
    got = emu.paged_decode(_t(qj), k, v, cache.page_table, torch.tensor(lengths, dtype=torch.int32),
                           softcap, window, ks, vs, reads=reads)
    assert got.shape == (B, 1, Hq, D)
    ratio = attn_err(torch.from_numpy(got), torch.from_numpy(np.asarray(ref, np.float32)), 2e-2)[1]
    assert ratio <= 1.0
    for b, i in reads:  # the page holds a key in [max(limit - window, 0), limit)
        lo = max(lengths[b] - window, 0) if window else 0
        assert i * ps < lengths[b] and (i + 1) * ps > lo
    assert {b for b, _ in reads} == set(range(B))


@pytest.mark.parametrize("dtype,G,ps,S,route", [
    (torch.bfloat16, 8, 64, 512, ("tc", 64)),     # Gemma-2B serving: 64-token pages
    (torch.bfloat16, 8, 64, 4096, ("tc", 256)),   # a long cache: four pages a block
    (torch.bfloat16, 4, 16, 512, ("tc", 64)),     # four pages a block
    (torch.float32, 8, 64, 512, ("split", 64)),   # f32 products are not exact on bf16 tensor cores
    (torch.bfloat16, 1, 64, 512, ("split", 64)),  # G = 1 (Gemma-7B) stays split-S, as dense decode
    (torch.bfloat16, 16, 64, 512, ("split", 64)),  # beyond the n8 side
    (torch.bfloat16, 8, 8, 512, ("split", 8)),    # a 16-key tile would straddle two pages
])
def test_paged_route(dtype, G, ps, S, route):
    """bf16 queries with 2 <= G <= 8 and pages of a multiple of 16 keys take
    the tensor-core kernel at the dense kernel's split for S = maxp * ps;
    the rest the split-S kernel, a block a page."""
    assert paged_route(dtype, G, ps, S) == route


def test_page_allocator_matches_reference():
    """Pages come out in the reference's order, never page 0 (the trash
    page); exhaustion returns None and released pages come back."""
    ours, ref = PageAllocator(9), JaxPageAllocator(9)
    assert ours.free_pages == ref.free_pages == 8
    held = []
    for n in (3, 2, 5, 3):  # 5 exceeds the 3 left
        got, want = ours.allocate(n), ref.allocate(n)
        assert got == want and ours.free_pages == ref.free_pages
        if got is not None:
            assert 0 not in got
            held.append(got)
    assert ours.free_pages == 0
    ours.release(held[0])
    ref.release(held[0])
    assert ours.allocate(3) == ref.allocate(3)


CFG = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
           d_ff=64, context_length=32)


def _same(ours: torch.Tensor, ref) -> None:
    """Equal dtype, shape and bits."""
    ref = tensor_from_numpy(np.asarray(ref))
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    assert torch.equal(ours.contiguous().view(torch.uint8), ref.view(torch.uint8))


def _assert_same_state(cache, jcache, paged: bool) -> None:
    j = _numpy(jcache)
    names = ("k_pages", "v_pages") if paged else ("k", "v")
    for name in names + ("k_scale", "v_scale"):
        ours, ref = getattr(cache, name), getattr(j, name)
        assert (ours is None) == (ref is None), name
        for o, r in zip(ours or [], ref or []):
            _same(o, r)
    _same(cache.length, j.length)
    if paged:
        _same(cache.page_table, j.page_table)


def _kv(rng, *shape):
    k = jnp.asarray(rng.normal(size=shape) * 0.5, jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=shape) * 0.5, jnp.bfloat16)
    return (k, v), (_t(k), _t(v))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_cache_writes_insert_gather_match_reference(paged, quantized, rng):
    """write_chunk, write_token, insert_sequence and gather_layer of the
    port's dense and paged caches, bf16 and int8, leave the reference's
    state bit for bit; the state is carried over by `from_jax_cache`."""
    jcfg, cfg = JaxGemmaConfig(**CFG), GemmaConfig(**CFG)
    B, H, D, ps = 2, cfg.n_kv_heads, cfg.head_dim, 8
    if paged:
        jc = JaxPagedKVCache.create(jcfg, B, 12, page_size=ps, max_seq_len=32, quantized=quantized,
                                    identity_layout=True)
    else:
        jc = JaxKVCache.create(jcfg, B, 32, quantized=quantized)
    cache = from_jax_cache(_numpy(jc))
    assert isinstance(cache, PagedKVCache if paged else KVCache)
    _assert_same_state(cache, jc, paged)

    for layer, start, T in ((0, 0, 11), (1, 0, 11), (0, 16, 8)):
        (kj, vj), (k, v) = _kv(rng, B, T, H, D)
        jc = jc.write_chunk(layer, start, kj, vj)
        cache.write_chunk(layer, start, k, v)
    (kj, vj), (k, v) = _kv(rng, B, 1, H, D)
    jc = jc.write_token(1, jnp.asarray([11, 30], jnp.int32), kj, vj)
    cache.write_token(1, torch.tensor([11, 30], dtype=torch.int32), k, v)
    _assert_same_state(cache, jc, paged)
    for layer in range(cfg.n_layers):
        for ours, ref in zip(cache.gather_layer(layer), jc.gather_layer(layer)):
            _same(ours, ref)

    # a prefilled sequence of 16 slots (2 pages) into slot 1
    tmp = JaxKVCache.create(jcfg, 1, 16, quantized=quantized)
    (kj, vj), _ = _kv(rng, 1, 13, H, D)
    for layer in range(cfg.n_layers):
        tmp = tmp.write_chunk(layer, 0, kj, vj)
    k_seq, v_seq, (ks, vs) = tmp.extract_seq(0)
    port_tmp = from_jax_cache(_numpy(tmp))
    seq = port_tmp.extract_seq(0)
    for ours, ref in zip((seq[0], seq[1], *seq[2]), (k_seq, v_seq, ks, vs)):
        if ref is None:
            assert ours is None
        else:
            _same(ours, ref)
    if paged:
        pages = [9, 2, 11]
        row = np.zeros(4, np.int32)
        row[:3] = pages
        jc = jc.insert_sequence(1, jnp.asarray(row), 3, k_seq, v_seq, 13, ks, vs)
        cache.insert_sequence(1, pages, *seq[:2], 13, *seq[2])
        _assert_same_state(cache, jc, paged)
        # a finished slot points at the trash page
        cache.release_slot(1)
        assert cache.page_table[1].eq(0).all() and int(cache.length[1]) == 0
    else:
        jc = jc.insert_sequence(1, k_seq, v_seq, 13, ks, vs)
        cache.insert_sequence(1, *seq[:2], 13, *seq[2])
        # the reference pads an insert with zeros to S; the port leaves the
        # slots past T as they were, which the length masks
        j = _numpy(jc)
        for name in ("k", "v", "k_scale", "v_scale"):
            for o, r in zip(getattr(cache, name) or [], getattr(j, name) or []):
                _same(o[:, :, :16], np.asarray(r)[:, :, :16])
        _same(cache.length, j.length)
