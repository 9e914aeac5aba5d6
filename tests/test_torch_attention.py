"""Attention: the port's plain decode/flash versions against the JAX kernels.

The JAX `decode_attention` and `flash_attention` run their Pallas kernels in
interpret mode on the CPU (called directly, so no dispatch gate applies);
the cases are those of tests/test_attention.py. Inputs are bf16 from numpy
with a seed and go to both packages.

Tolerance: both sides compute f32 scores and an f32 softmax, but the
kernels round the unnormalized p to bf16 against a per-tile running max
while the plain versions round against the row max, and outputs are bf16:
atol = rtol = 1e-2 (two bf16 ulps near 1; the reference's own kernel tests
allow 2e-2). In f32 the same comparison is held to 1e-5.

The int8 arm (int8 K/V with f32 scales, quantized by both packages'
`_quantize`, which must agree bit for bit) has the same rounding points on
both sides, bf16(p * vs) included, so it keeps atol = rtol = 1e-2 with bf16
and with f32 queries.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gemma_tpu.ops.attention import decode_attention as jax_decode
from gemma_tpu.ops.attention import flash_attention as jax_flash
from gemma_tpu.ops.attention import sdpa_xla
from gemma_tpu.runtime.kv_cache import KVCache as JaxKVCache
from gemma_tpu_torch.ops.attention import (
    attention,
    decode_attention,
    decode_attention_plain,
    dequantize_kv,
    flash_attention,
    flash_attention_plain,
    sdpa,
)
from gemma_tpu_torch.runtime.kv_cache import quantize_kv

TOL = dict(atol=1e-2, rtol=1e-2)


def make_qkv(rng, B, T, S, Hq, Hkv, D, dtype=jnp.bfloat16):
    """The same q [B,T,Hq,D] and k/v [B,Hkv,S,D] as jax arrays and torch tensors."""
    arrs = [rng.normal(size=s) * 0.3 for s in ((B, T, Hq, D), (B, Hkv, S, D), (B, Hkv, S, D))]
    j = [jnp.asarray(a, dtype) for a in arrs]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in j]
    return j, t


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)


FLASH_CASES = [
    # B, T, S, Hq, Hkv, D, kv_limits, pos0
    (1, 128, 128, 4, 4, 128, [128], 0),          # MHA full square
    (1, 128, 256, 8, 2, 128, [200], 0),          # GQA, partial cache
    (2, 128, 256, 4, 1, 128, [128, 77], 0),      # MQA, per-batch limits
    (1, 256, 256, 2, 2, 128, [256], 0),          # multi q-tile causal
    (1, 128, 384, 4, 4, 128, [384], 256),        # offset queries (chunked prefill)
    (1, 37, 96, 8, 1, 256, [37], 0),             # ragged T and S (Gemma-2B heads)
]


@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,limits,pos0", FLASH_CASES)
def test_flash_plain_matches_jax_kernel(B, T, S, Hq, Hkv, D, limits, pos0, rng):
    (qj, kj, vj), (q, k, v) = make_qkv(rng, B, T, S, Hq, Hkv, D)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32) + pos0, (B, T))
    lim = np.asarray(limits, np.int32)
    ref = jax_flash(qj, kj, vj, jnp.asarray(pos), jnp.asarray(lim))
    got = flash_attention_plain(q, k, v, torch.from_numpy(pos.copy()), torch.from_numpy(lim))
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, Hq, D)
    _close(got, ref, **TOL)


@pytest.mark.parametrize("cap,window,pos0", [(30.0, 0, 0), (0.0, 16, 128), (0.0, 100, 128),
                                             (0.0, 128, 128), (50.0, 64, 128)])
def test_flash_softcap_and_window(cap, window, pos0, rng):
    (qj, kj, vj), (q, k, v) = make_qkv(rng, 1, 128, 256, 4, 2, 128)
    pos = (np.arange(128, dtype=np.int32) + pos0)[None]
    lim = np.asarray([256], np.int32)
    ref = jax_flash(qj, kj, vj, jnp.asarray(pos), jnp.asarray(lim), attn_softcap=cap, window=window)
    got = flash_attention_plain(q, k, v, torch.from_numpy(pos), torch.from_numpy(lim), cap, window)
    _close(got, ref, **TOL)


def test_flash_non_consecutive_positions(rng):
    B, T, S, Hq, Hkv, D = 2, 128, 256, 4, 2, 128
    (qj, kj, vj), (q, k, v) = make_qkv(rng, B, T, S, Hq, Hkv, D)
    pos = np.stack([rng.permutation(np.arange(0, 2 * T, 2))[:T],
                    rng.integers(0, S, size=T)]).astype(np.int32)
    lim = np.asarray([S, 180], np.int32)
    ref = jax_flash(qj, kj, vj, jnp.asarray(pos), jnp.asarray(lim))
    got = flash_attention_plain(q, k, v, torch.from_numpy(pos), torch.from_numpy(lim))
    _close(got, ref, **TOL)


def test_flash_rows_without_keys_are_zero(rng):
    """Rows whose window lies past kv_limit see no key: the kernel writes 0
    (plain sdpa would give the mean of V there)."""
    (qj, kj, vj), (q, k, v) = make_qkv(rng, 1, 128, 256, 2, 2, 128)
    pos = (np.arange(128, dtype=np.int32) + 100)[None]
    lim = np.asarray([150], np.int32)
    ref = np.asarray(jax_flash(qj, kj, vj, jnp.asarray(pos), jnp.asarray(lim), window=32), np.float32)
    got = flash_attention_plain(q, k, v, torch.from_numpy(pos), torch.from_numpy(lim), 0.0, 32)
    empty = pos[0] >= 181
    assert empty.any() and (ref[0, empty] == 0).all()
    assert (got[0, torch.from_numpy(empty)] == 0).all()
    _close(got, ref, **TOL)


def test_flash_rows_before_any_key_finite(rng):
    (_, _, _), (q, k, v) = make_qkv(rng, 1, 128, 128, 2, 2, 128)
    pos = torch.arange(128, dtype=torch.int32)[None]
    out = flash_attention_plain(q, k, v, pos, torch.tensor([1], dtype=torch.int32))
    assert torch.isfinite(out.float()).all()


DECODE_CASES = [
    # B, S, Hq, Hkv, D, limits, softcap, window
    (1, 512, 8, 1, 256, [200], 0.0, 0),      # Gemma-2B MQA
    (2, 256, 16, 16, 256, [77, 130], 0.0, 0),  # Gemma-7B MHA
    (1, 256, 8, 2, 128, [256], 30.0, 0),     # GQA + softcap
    (1, 512, 8, 1, 256, [300], 0.0, 64),     # sliding window
    (1, 512, 8, 1, 256, [1], 0.0, 0),        # single valid key
    (1, 2048, 16, 16, 128, [300], 0.0, 0),   # MHA, 1 live tile of many
    (2, 2048, 8, 1, 256, [1100, 64], 0.0, 0),
    (1, 2048, 8, 1, 256, [1500], 0.0, 256),  # dead tiles both sides of window
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,limits,cap,win", DECODE_CASES)
def test_decode_plain_matches_jax_kernel(B, S, Hq, Hkv, D, limits, cap, win, rng):
    (qj, kj, vj), (q, k, v) = make_qkv(rng, B, 1, S, Hq, Hkv, D)
    lim = np.asarray(limits, np.int32)
    ref = jax_decode(qj, kj, vj, jnp.asarray(lim), attn_softcap=cap, window=win)
    got = decode_attention_plain(q, k, v, torch.from_numpy(lim), cap, win)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 1, Hq, D)
    _close(got, ref, **TOL)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 20.0)])
def test_f32_plain_matches_jax_kernels(window, cap, rng):
    """f32 q/k/v (the evaluation mode): nothing rounds, tight tolerance."""
    (qj, kj, vj), (q, k, v) = make_qkv(rng, 1, 40, 64, 4, 2, 128, dtype=jnp.float32)
    pos = np.arange(40, dtype=np.int32)[None] + 10
    lim = np.asarray([50], np.int32)
    ref = jax_flash(qj, kj, vj, jnp.asarray(pos), jnp.asarray(lim), attn_softcap=cap, window=window)
    got = flash_attention_plain(q, k, v, torch.from_numpy(pos), torch.from_numpy(lim), cap, window)
    _close(got, ref, atol=1e-5, rtol=1e-5)
    ref_d = jax_decode(qj[:, :1], kj, vj, jnp.asarray(lim), attn_softcap=cap, window=window)
    got_d = decode_attention_plain(q[:, :1], k, v, torch.from_numpy(lim), cap, window)
    _close(got_d, ref_d, atol=1e-5, rtol=1e-5)


def test_sdpa_matches_reference(rng):
    (qj, kj, vj), (q, k, v) = make_qkv(rng, 2, 16, 32, 4, 2, 16)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32) + 3, (2, 16)).copy()
    lim = np.asarray([19, 12], np.int32)
    ref = sdpa_xla(qj, kj, vj, jnp.asarray(pos), jnp.asarray(lim), 20.0, 8)
    got = sdpa(q, k, v, torch.from_numpy(pos), torch.from_numpy(lim), 20.0, 8)
    _close(got, ref, **TOL)


def test_dispatch_and_cpu_wrappers(rng):
    """attention(): T == 1 -> decode, else flash; on CPU tensors the kernel
    wrappers are their plain versions; int8 k/v go to the decode arm with
    their scales, and are dequantized once (bf16, then q's dtype) for T > 1."""
    (_, _, _), (q, k, v) = make_qkv(rng, 1, 5, 16, 4, 2, 16)
    lim = torch.tensor([5], dtype=torch.int32)
    pos = torch.arange(5, dtype=torch.int32)[None]
    torch.testing.assert_close(attention(q, k, v, pos, lim), flash_attention_plain(q, k, v, pos, lim))
    torch.testing.assert_close(flash_attention(q, k, v, pos, lim), flash_attention_plain(q, k, v, pos, lim))
    q1 = q[:, :1]
    torch.testing.assert_close(attention(q1, k, v, pos[:, -1:], lim), decode_attention_plain(q1, k, v, lim))
    torch.testing.assert_close(decode_attention(q1, k, v, lim), decode_attention_plain(q1, k, v, lim))
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    torch.testing.assert_close(attention(q1, k8, v8, pos[:, -1:], lim, k_scale=ks, v_scale=vs),
                               decode_attention_plain(q1, k8, v8, lim, k_scale=ks, v_scale=vs))
    q32 = q.float()
    kd, vd = dequantize_kv(k8, ks).float(), dequantize_kv(v8, vs).float()
    torch.testing.assert_close(attention(q32, k8, v8, pos, lim, k_scale=ks, v_scale=vs),
                               flash_attention_plain(q32, kd, vd, pos, lim))


def _jax_quantize(x):
    q, s = JaxKVCache._quantize(x)
    return np.asarray(q), np.asarray(s)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_quantize_kv_bit_exact(dtype, rng):
    """The port's int8 quantization equals the reference's `_quantize` bit
    for bit, on random rows and on rows built with exact .5 ties, zero rows
    and rows whose amax is one element."""
    x = rng.normal(size=(2, 7, 3, 128)) * 2.0
    x[0, 0] = 0.0  # scale 0 -> inverse 0
    x[0, 1, 0] = np.arange(128) - 63.5  # amax 64.5: half-integer multiples of the scale
    x[1, 2, 1, :5] = [1e-3, -4e-3, 0.0, 7.0, -7.0]
    xj = jnp.asarray(x, dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    rq, rs = _jax_quantize(xj)
    q, s = quantize_kv(xt)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), rq)
    np.testing.assert_array_equal(s.numpy().view(np.int32), rs.view(np.int32))


@pytest.mark.parametrize("B,S,Hq,Hkv,D,limits,cap,win", DECODE_CASES)
def test_decode_int8_plain_matches_jax_kernel(B, S, Hq, Hkv, D, limits, cap, win, rng):
    """The int8 arm: the reference's decode kernel (interpret mode) reads
    int8 K/V with their scales; so does the port's plain version."""
    (qj, kj, vj), (q, k, v) = make_qkv(rng, B, 1, S, Hq, Hkv, D)
    (k8, ks), (v8, vs) = _jax_quantize(kj), _jax_quantize(vj)
    lim = np.asarray(limits, np.int32)
    ref = jax_decode(qj, jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(lim), attn_softcap=cap,
                     window=win, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    t = [torch.from_numpy(np.array(a)) for a in (k8, v8, ks, vs)]
    got = decode_attention_plain(q, t[0], t[1], torch.from_numpy(lim), cap, win, t[2], t[3])
    assert got.dtype == torch.bfloat16 and got.shape == (B, 1, Hq, D)
    _close(got, ref, **TOL)
    # f32 queries: the weight still rounds to bf16(p * vs) on both sides
    ref32 = jax_decode(qj.astype(jnp.float32), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(lim),
                       attn_softcap=cap, window=win, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got32 = decode_attention_plain(q.float(), t[0], t[1], torch.from_numpy(lim), cap, win, t[2], t[3])
    assert got32.dtype == torch.float32
    _close(got32, ref32, **TOL)


def test_decode_route_is_fixed_by_dtype_and_group():
    """At 2 <= G <= 8 bf16 queries take the tensor-core kernel and f32
    queries its f32 policies (over an f32 or an int8 cache), both at the
    split of `decode_tc_split` (a multiple of 16, fixed by S); G = 1 the
    core built for one query row in every (q, cache) arm, at
    `decode_tc_split`; G > 8 the split-S kernel. No route depends on the
    live length or the cache's dtype."""
    from gemma_tpu_torch.ops import attention as att

    for S in (1, 512, 4096, 8192):
        route, split = att.decode_route(torch.bfloat16, 8, S)
        assert route == "tc" and split % 16 == 0 and split == att.decode_tc_split(S)
        assert att.decode_route(torch.bfloat16, 2, S)[0] == "tc"
        assert att.decode_route(torch.float32, 8, S) == ("tf32", att.decode_tc_split(S))
        assert att.decode_route(torch.float32, 2, S) == ("tf32", att.decode_tc_split(S))
        for q_dtype in (torch.float32, torch.bfloat16):
            assert att.decode_route(q_dtype, 1, S) == ("g1", att.decode_tc_split(S))
            assert att.decode_route(q_dtype, 16, S) == ("split", att.DECODE_SPLIT)
    assert [att.decode_tc_split(S) for S in (512, 1024, 2048, 4096, 8192)] == [64, 64, 128, 256, 256]
