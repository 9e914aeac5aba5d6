"""The tensor-core kernels' index math, emulated lane by lane in numpy
(`gemma_tpu_torch/tools/tc_emulation.py`), against the plain versions the
card holds the kernels to.

* The small-M GEMV (`csrc/dq_gemv.cuh`) of every format: its products are
  exact (integer weights and bf16 x), so it differs from the plain version
  (f32 weights and x, M <= 8) only in the order of f32 sums, and for q4_k
  in the f32 rounding of each dequantized weight against its (d*sc, affine)
  split: 1e-5 of the output's scale, also against every format's Pallas
  kernel in interpret mode at M = 1.
* The f32 route's TF32 tile of q4_k and q6_k (`csrc/dq_tile_tf32.cuh`):
  x split into two TF32 parts against the exact integer weights, each
  group scaled in f32, the K splits summed in order: within 1e-5 of the
  output's scale of the plain f32 version and of the JAX package's f32
  dispatch, and within 2e-2 of `_q4_k_kernel` / `_q6_k_kernel` in
  interpret mode, which round x and weights to bf16 at M > 8 (the
  tolerances of tests/test_torch_quant_matmul.py). One TF32 pass misses
  1e-5, so the second pass is guarded.
* The prefill tile's functors (`Q4_0Tile`, `Q8_0Tile`): the bf16 weights
  they store equal the plain bf16 dequant bit for bit, zeros past K (the
  half step where K % 64 == 32) and past N.
* Flash and decode attention (`csrc/flash_attention.cu` flash_tc_kernel,
  `csrc/decode_tc.cuh` decode_tc_kernel), bf16: products are exact,
  but p rounds to bf16 against a tile's (flash) or a warp's (decode)
  running max where the plain version rounds against the row max, and the
  output is bf16: 2e-2 of the output's scale, the card's tolerance
  (chip_smoke.py). Rows without a valid key are exactly 0. One case of
  each is also held to the JAX kernel in interpret mode.
* Decode through a page table (`decode_tc_kernel` with `PagedRows`): equal
  bit for bit to the dense emulation on the gathered pages at the same
  split, and within 2e-2 of each row's scale of the plain version
  (`tools/_timing.attn_err`); tests/test_torch_paged.py holds it to the
  JAX `_paged_kernel`.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gemma_tpu.ops.attention import decode_attention as jax_decode
from gemma_tpu.ops.attention import flash_attention as jax_flash
from gemma_tpu.ops.quant_matmul import quant_matmul as jax_quant_matmul
from gemma_tpu.quant.qtensor import dequant_t, quantize_array
from gemma_tpu_torch.ops.attention import decode_attention_plain, decode_tc_split, flash_attention_plain
from gemma_tpu_torch.ops.paged_attention import gather_pages
from gemma_tpu_torch.ops.quant_matmul import PLAIN
from gemma_tpu_torch.quant.qtensor import dequant, from_jax
from gemma_tpu_torch.tools import tc_emulation as emu
from gemma_tpu_torch.tools._timing import attn_err, random_qtensor


def _case(fmt, N, K, seed):
    gen = torch.Generator().manual_seed(seed)
    return gen, random_qtensor(fmt, N, K, gen, "cpu")


# q4_0, q8_0: K = 1056, an odd count of 32-blocks (scale words at odd
# parity, a slice ending mid-stage; with 19 rows the last scale ends the
# array mid-word), and at M = 1 K = 3072 (Gemma-7B's d_model). q4_k, q6_k:
# K in whole superblocks; 19 rows with K = 1280: q6_k's d values end the
# array mid-word. 4096 with 48 rows: K splits; 40, 20 and 19 rows: ragged
# against the 16-row tiles
@pytest.mark.parametrize("N,K,M,fmt", [
    *((N, K, M, fmt) for fmt in ("q4_0", "q8_0")
      for N, K, M in ((40, 1056, 5), (19, 1056, 3), (20, 1280, 8), (48, 4096, 2),
                      (40, 1056, 1), (19, 1056, 1), (48, 4096, 1), (32, 3072, 1))),
    *((N, K, M, fmt) for fmt in ("q4_k", "q6_k")
      for N, K, M in ((40, 1280, 1), (19, 1280, 5), (20, 2048, 8), (48, 4096, 2)))])
def test_gemv_emulation_matches_plain(fmt, N, K, M):
    gen, qt = _case(fmt, N, K, seed=N + M)
    x = torch.randn(M, K, generator=gen).to(torch.bfloat16)
    ref = PLAIN[fmt](x, qt).numpy()
    got = emu.gemv(x, qt)
    assert got.shape == (M, N)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("fmt", ["q4_0", "q8_0"])
@pytest.mark.parametrize("N,K", [(20, 1056), (19, 1056), (12, 1280)])
def test_tile_functor_weights_are_the_plain_bf16_dequant(fmt, N, K):
    _, qt = _case(fmt, N, K, seed=K)
    tile = emu.tile_weights(qt, N + 3)
    assert tile.shape == (N + 3, -(-K // 64) * 64)
    assert np.array_equal(tile[:N, :K], dequant(qt, torch.bfloat16).float().numpy())
    assert not tile[N:].any() and not tile[:, K:].any()


def test_fragment_conversions_are_exact():
    """Every nibble, every 6-bit value and every int8 byte, through the
    kernel's bit tricks."""
    u = np.arange(16, dtype=np.uint32)
    pair = emu.nibble_pair(u | (u[::-1] << 16))
    assert np.array_equal(emu._bf16_bits_to_f32(pair & 0xFFFF), u - 8.0)
    assert np.array_equal(emu._bf16_bits_to_f32(pair >> 16), u[::-1] - 8.0)
    u = np.arange(64, dtype=np.uint32)
    pair = emu.six_bit_pair(u | (u[::-1] << 16))
    assert np.array_equal(emu._bf16_bits_to_f32(pair & 0xFFFF), u - 32.0)
    assert np.array_equal(emu._bf16_bits_to_f32(pair >> 16), u[::-1] - 32.0)
    b = np.arange(256, dtype=np.uint32)
    w = b | (b[::-1] << 8) | (b << 16) | ((b ^ 0x55) << 24)
    q = lambda v: (v.astype(np.uint8).view(np.int8)).astype(np.float32)  # noqa: E731
    for i, j in ((0, 2), (1, 3)):
        pair = emu.int8_pair(w ^ 0x80808080, i, j)
        assert np.array_equal(emu._bf16_bits_to_f32(pair & 0xFFFF), q((w >> (8 * i)) & 0xFF))
        assert np.array_equal(emu._bf16_bits_to_f32(pair >> 16), q((w >> (8 * j)) & 0xFF))


@pytest.mark.parametrize("M", [1, 8])
@pytest.mark.parametrize("N,K", [(2560, 2048), (2048, 2048), (32768, 2048), (2048, 16384),
                                 (256000, 2048), (12288, 3072), (3072, 4096), (49152, 3072),
                                 (3072, 24576), (256000, 3072), (1000, 1056),
                                 # q4_k_m's attn_k and attn_v; the K-quants' edge cases
                                 (256, 2048), (1000, 1280), (999, 1280)])
def test_gemv_plan_covers_k_in_slices_that_fit(N, K, M):
    """The plan at the main path's shapes (Gemma-2B q4_0 and q4_k_m,
    Gemma-7B q8_0), at the decode step's M = 1 and the serving step's
    M = 8: whole 32-blocks a slice (q4_k and q6_k: whole superblocks), at
    most the slice the shared x buffer holds at M, every K value in one
    slice, and enough warps for the card where K allows; at M = 1 K split
    only to fill the card (q8_0's gate_up and head in one)."""
    for gran, target, slice_min in ((32, emu.GV_TARGET_WARPS, emu.GV_BLOCK_SLICE_MIN),
                                     (emu.GV_SUPER_K, emu.GV_SUPER_TARGET_WARPS, emu.GV_SLICE_MIN)):
        if K % gran:
            continue
        sl, splits = emu.gemv_plan(M, N, K, gran=gran, target=target, slice_min=slice_min)
        assert sl % gran == 0 and sl <= emu.gemv_slice_max(M)
        assert (splits - 1) * sl < K <= splits * sl
        warps = -(-N // 16) * splits
        assert warps >= target * emu.H100_SMS or sl < 2 * slice_min
        if M == 1 and splits > 1:
            assert -(-N // 16) * splits // 2 < target * emu.H100_SMS
    if M == 1 and N >= 49152 and K == 3072:
        assert emu.gemv_plan(M, N, K)[1] == 1


@pytest.mark.parametrize("fmt", ["q4_0", "q8_0", "q4_k", "q6_k"])
def test_kquant_gemv_emulation_matches_the_jax_kernel(fmt, monkeypatch):
    """Every format's GEMV at M = 1 against `_q4_0_kernel`, `_q8_0_kernel`,
    `_q4_k_kernel` and `_q6_k_kernel` (interpret mode) on the same weights
    (`from_jax` carries them exactly: q4_0's and q8_0's bf16 scales are
    exact in f16) and the same bf16 x; the reference takes f32 weights at
    M <= 8."""
    monkeypatch.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")
    rng = np.random.default_rng(7)
    jqt = quantize_array(rng.normal(size=(256, 1024)).astype(np.float32) * 0.05, fmt)
    qt = from_jax(jqt.fmt, {k: np.asarray(v) for k, v in jqt.arrays.items()})
    xj = jnp.asarray(rng.normal(size=(1, 1024)).astype(np.float32), jnp.bfloat16)
    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    ref = np.asarray(jax_quant_matmul(xj, jqt), np.float32)
    got = emu.gemv(x, qt)
    assert got.shape == ref.shape == (1, 256)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


# (fmt, M, N, K): JAX-quantized weights (its K-quant kernels take K % 1024 ==
# 0); M = 16 one m16 row of a 64-row tile, 17 ragged, 70 two row tiles
TF32_JAX_CASES = [(fmt, M, N, 1024) for fmt in ("q4_k", "q6_k")
                  for M, N in ((16, 256), (17, 512), (70, 256))]


@pytest.mark.parametrize("fmt,M,N,K", TF32_JAX_CASES)
def test_tf32_tile_emulation_matches_plain_and_jax(fmt, M, N, K, monkeypatch):
    """The TF32 tile (f32 x, M > 8) against the plain f32 version and the
    JAX package's f32 dispatch within 1e-5 of the output's scale, and
    against `_q4_k_kernel` / `_q6_k_kernel` in interpret mode (bf16 x and
    weights at M > 8) within 2e-2; K splits in play (the plan's splits
    at these shapes: 2 to 4)."""
    monkeypatch.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")
    rng = np.random.default_rng(M + N)
    jqt = quantize_array(rng.normal(size=(N, K)).astype(np.float32) * 0.05, fmt)
    qt = from_jax(jqt.fmt, {k: np.asarray(v) for k, v in jqt.arrays.items()})
    x = rng.normal(size=(M, K)).astype(np.float32)
    got = emu.tile_tf32(torch.from_numpy(x), qt)
    assert got.shape == (M, N) and emu.tf32_plan(fmt, M, N, K)[1] > 1
    plain = PLAIN[fmt](torch.from_numpy(x), qt).numpy()
    scale = np.abs(plain).max()
    assert np.abs(got - plain).max() <= 1e-5 * scale
    xj = jnp.asarray(x)
    f32_dispatch = np.asarray(jnp.dot(xj, dequant_t(jqt, jnp.float32)))
    assert np.abs(got - f32_dispatch).max() <= 1e-5 * scale
    assert np.abs(got - np.asarray(jax_quant_matmul(xj, jqt))).max() <= 2e-2 * scale


# ragged N (past a 64- or 128-wide tile), ragged M, K of an odd count of
# superblocks (q6_k's d words at both parities, the last one ending the
# array mid-word), one split and several
@pytest.mark.parametrize("fmt", ["q4_k", "q6_k"])
@pytest.mark.parametrize("M,N,K", [(17, 300, 1280), (70, 1000, 512), (203, 1100, 256)])
def test_tf32_tile_emulation_ragged(fmt, M, N, K):
    gen, qt = _case(fmt, N, K, seed=M + N)
    x = torch.randn(M, K, generator=gen)
    ref = PLAIN[fmt](x, qt).numpy()
    got = emu.tile_tf32(x, qt)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_tf32_single_pass_misses_1e5():
    """Without the lo pass (x rounded once to TF32) the tile misses 1e-5 of
    the output's scale: the second pass is what holds it."""
    gen, qt = _case("q4_k", 256, 1024, seed=3)
    x = torch.randn(70, 1024, generator=gen)
    ref = PLAIN["q4_k"](x, qt).numpy()
    scale = np.abs(ref).max()
    one = np.abs(emu.tile_tf32(x, qt, passes=1) - ref).max()
    two = np.abs(emu.tile_tf32(x, qt) - ref).max()
    assert one > 1e-5 * scale and two <= 1e-5 * scale


def test_tf32_rounding_and_split():
    """`tf32_rna` (`cvt.rna.tf32.f32` on finite values): nearest, ties away
    from zero, 10 mantissa bits; hi + lo (lo truncated) is x within 2^-21 of
    |x|, hi and lo exact in TF32; the bytes less the bias are exact
    integers."""
    one = np.float32(1)
    ulp = np.float32(2.0 ** -10)
    v = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + 3 * ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4],
                 np.float32)
    assert np.array_equal(emu.tf32_rna(v), np.array(
        [1 + ulp, -(1 + ulp), 1 + 2 * ulp, one, 1 + ulp], np.float32))
    x = np.random.default_rng(0).normal(size=4096).astype(np.float32) * 3
    hi, lo = emu.split_tf32(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    assert np.all(np.abs(x.astype(np.float64) - hi - lo) <= 2.0 ** -21 * np.abs(x))
    b = np.arange(256, dtype=np.uint32)
    vals = emu._bytes_minus(b | (b << 8) | (b << 16) | (b << 24), 32)
    assert np.array_equal(vals, np.repeat((b.astype(np.float32) - 32)[:, None], 4, 1))


@pytest.mark.parametrize("M", [17, 64, 203, 512])
@pytest.mark.parametrize("fmt,N,K", [("q4_k", 2048, 2048), ("q4_k", 256, 2048),
                                     ("q4_k", 32768, 2048), ("q4_k", 2048, 16384),
                                     ("q6_k", 256, 2048), ("q6_k", 256000, 2048)])
def test_tf32_plan_at_the_q4_k_m_shapes(fmt, M, N, K):
    """The plan at Gemma-2B q4_k_m's shapes: wide rows on 128-wide tiles
    (two blocks an SM), narrow ones on 64; K split in whole steps, at
    least 2 a split and at most 16 splits, only where the split grid stays
    within 16 warps an SM (attn_k and attn_v always, attn_q, attn_out and
    down at every M here, gate_up and head never)."""
    bn, splits = emu.tf32_plan(fmt, M, N, K)
    assert bn == (128 if N >= 1024 else 64)
    steps = K // emu.TF_BK
    assert steps % splits == 0 and steps // splits >= 2 and splits <= 16
    warps = -(-M // 64) * -(-N // bn) * emu.TF_WARPS
    assert splits == 1 or warps * splits <= 16 * emu.H100_SMS
    assert (splits > 1) == (N <= 2048)
    if splits < 16:  # a doubling would overfill the card
        assert warps * splits * 2 > 16 * emu.H100_SMS


ATT_TOL = 2e-2  # of max|ref|: p rounded against a local max, bf16 outputs


def _qkv(B, T, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.3).to(torch.bfloat16)
            for shape in ((B, T, Hq, D), (B, Hkv, S, D), (B, Hkv, S, D))]


def _held(got, ref):
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= ATT_TOL * np.abs(ref).max()


FLASH_EMU_CASES = [
    # B, T, S, Hq, Hkv, D, pos0, limits, softcap, window, row warps (0: the plan)
    (1, 37, 300, 8, 1, 128, 0, [37], 0.0, 0, 0),     # MQA, ragged T and S: 1 x 4 key groups
    (1, 37, 100, 8, 1, 128, 0, [37], 0.0, 0, 4),     # rows of 8 positions a block
    (2, 21, 90, 4, 4, 128, 40, [61, 50], 30.0, 0, 2),  # MHA, batch rows, softcap, offset
    (1, 30, 260, 4, 2, 128, 150, [180], 0.0, 24, 1),  # GQA, window: tiles skipped both sides
    (1, 9, 40, 8, 1, 256, 0, [9], 50.0, 0, 0),       # Gemma-2B heads, D = 256 (16-key tiles)
    (1, 5, 80, 8, 1, 256, 60, [65], 0.0, 0, 4),      # D = 256, 32-key tiles, one key group
]


@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,pos0,limits,cap,window,row_warps", FLASH_EMU_CASES)
def test_flash_emulation_matches_plain(B, T, S, Hq, Hkv, D, pos0, limits, cap, window, row_warps):
    q, k, v = _qkv(B, T, S, Hq, Hkv, D, seed=T + S)
    pos = (torch.arange(T, dtype=torch.int32) + pos0).expand(B, T).contiguous()
    lim = torch.tensor(limits, dtype=torch.int32)
    ref = flash_attention_plain(q, k, v, pos, lim, cap, window).float().numpy()
    _held(emu.flash(q, k, v, pos, lim, cap, window, row_warps), ref)


def test_flash_emulation_rows_without_keys_are_zero():
    """Rows at positions >= 81 see no key below kv_limit 50 in a 32-window."""
    q, k, v = _qkv(1, 40, 96, 4, 1, 128, seed=3)
    pos = (torch.arange(40, dtype=torch.int32) + 50)[None]
    lim = torch.tensor([50], dtype=torch.int32)
    got = emu.flash(q, k, v, pos, lim, 0.0, 32, row_warps=2)
    empty = pos[0].numpy() >= 81
    assert empty.any() and not got[0, empty].any()
    _held(got, flash_attention_plain(q, k, v, pos, lim, 0.0, 32).float().numpy())


def test_flash_block_plan():
    """Four row warps where the grid holds 99 blocks (long prompts); fewer
    row warps below, the block's other warps splitting the keys: a 512-row
    chunk and Gemma-7B's 203-token prompt take 2 x 2, Gemma-2B's 1 x 4."""
    assert emu.flash_shape(1, 1, 203, 8) == (1, 4) and emu.flash_shape(1, 16, 203, 1) == (2, 2)
    assert emu.flash_shape(1, 1, 2048, 8) == (4, 1) and emu.flash_shape(1, 16, 2048, 1) == (4, 1)
    assert emu.flash_shape(1, 1, 512, 8) == (2, 2)


DECODE_EMU_CASES = [
    # B, S, Hq, Hkv, D, limits, softcap, window, split
    (1, 300, 8, 1, 128, [204], 0.0, 0, 64),          # Gemma-2B's group, ragged last tile
    (2, 160, 4, 4, 128, [1, 160], 0.0, 0, 64),       # G = 1 (MHA): 7 zero columns; one key
    (1, 256, 8, 2, 128, [230], 30.0, 40, 32),        # GQA, softcap, window: dead splits
    (2, 200, 8, 1, 128, [130, 17], 0.0, 0, 128),     # a warp with two tiles; per-row limits
    (1, 64, 8, 1, 256, [50], 20.0, 0, 16),           # D = 256, one tile a split
]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,limits,cap,window,split", DECODE_EMU_CASES)
def test_decode_emulation_matches_plain(B, S, Hq, Hkv, D, limits, cap, window, split, int8):
    from gemma_tpu_torch.runtime.kv_cache import quantize_kv

    q, k, v = _qkv(B, 1, S, Hq, Hkv, D, seed=S + split)
    lim = torch.tensor(limits, dtype=torch.int32)
    scales = {}
    if int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        scales = dict(k_scale=ks, v_scale=vs)
    ref = decode_attention_plain(q, k, v, lim, cap, window, **scales).float().numpy()
    _held(emu.decode(q, k, v, lim, cap, window, split=split, **scales), ref)


PAGED_EMU_CASES = [
    # B, Hq, Hkv, D, ps, maxp, limits, softcap, window, split (None: the route's)
    (2, 8, 1, 128, 64, 4, [1, 200], 0.0, 0, None),       # serving's pages: a page a block
    (1, 4, 2, 128, 16, 16, [230], 30.0, 40, None),       # four pages a block; window: dead splits
    (1, 8, 1, 128, 256, 2, [300], 0.0, 0, None),         # a quarter of a page a block
    (2, 8, 1, 256, 32, 4, [50, 128], 20.0, 0, 128),      # D = 256, two tiles a warp, two stages
    (2, 4, 4, 128, 16, 5, [80, 33], 0.0, 24, 32),        # G = 1 (the kernel's), two pages a block
]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,Hq,Hkv,D,ps,maxp,limits,cap,window,split", PAGED_EMU_CASES)
def test_paged_decode_emulation_is_dense_decode_on_the_gathered_pages(B, Hq, Hkv, D, ps, maxp, limits,
                                                                      cap, window, split, int8):
    """Each row's pages shuffled over the pool, the trash page 0 and the free
    pages random: the paged kernel runs the dense kernel's tiles, in its
    order and arithmetic, so the two agree bit for bit."""
    from gemma_tpu_torch.runtime.kv_cache import quantize_kv

    rng = np.random.default_rng(B * ps + maxp)
    n_pages = B * maxp + 3
    q, kp, vp = [torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.3).to(torch.bfloat16)
                 for shape in ((B, 1, Hq, D), (n_pages, Hkv, ps, D), (n_pages, Hkv, ps, D))]
    perm = rng.permutation(n_pages - 1) + 1
    table = np.zeros((B, maxp), np.int32)
    live = [-(-n // ps) for n in limits]
    table[np.arange(maxp)[None, :] < np.asarray(live)[:, None]] = perm[: sum(live)]
    pt = torch.from_numpy(table)
    lim = torch.tensor(limits, dtype=torch.int32)
    ks = vs = None
    if int8:
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
    dense = [None if x is None else gather_pages(x, pt) for x in (kp, vp, ks, vs)]
    got = emu.paged_decode(q, kp, vp, pt, lim, cap, window, ks, vs, split)
    want = emu.decode(q, dense[0], dense[1], lim, cap, window, dense[2], dense[3],
                      split or decode_tc_split(maxp * ps))
    assert np.array_equal(got, want)
    ref = decode_attention_plain(q, *dense[:2], lim, cap, window, *dense[2:])
    assert attn_err(torch.from_numpy(got), ref, ATT_TOL)[1] <= 1.0


def test_emulations_match_the_jax_kernels():
    """The emulated kernels against the reference's Pallas kernels
    (interpret mode) on the same bf16 inputs: Gemma-2B's group (MQA) with
    softcap and window for flash, MHA over per-row limits for decode."""
    q, k, v = _qkv(1, 30, 96, 8, 1, 128, seed=11)
    qj, kj, vj = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v))
    pos = (np.arange(30, dtype=np.int32) + 40)[None]
    lim = np.asarray([70], np.int32)
    ref = jax_flash(qj, kj, vj, jnp.asarray(pos), jnp.asarray(lim), attn_softcap=30.0, window=48)
    _held(emu.flash(q, k, v, torch.from_numpy(pos), torch.from_numpy(lim), 30.0, 48), ref)
    q, k, v = _qkv(2, 1, 160, 4, 4, 128, seed=12)
    qj, kj, vj = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v))
    lim = np.asarray([77, 150], np.int32)
    ref = jax_decode(qj, kj, vj, jnp.asarray(lim))
    _held(emu.decode(q, k, v, torch.from_numpy(lim)), ref)


def test_transposing_ldmatrix():
    """ldmatrix.x4.trans gives lane (g, t) (M[2t][g], M[2t + 1][g])."""
    m = np.arange(4 * 64, dtype=np.uint16)  # four 8 x 8 matrices, rows of 8 values
    addr = 2 * 8 * np.arange(32)  # lane l: row l % 8 of matrix l // 8
    r = emu.ldmatrix_x4_trans(m.view(np.uint8), addr)
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    for i in range(4):
        assert np.array_equal(r[i] & 0xFFFF, 64 * i + 8 * (2 * t) + g)
        assert np.array_equal(r[i] >> 16, 64 * i + 8 * (2 * t + 1) + g)
