"""The tensor-core kernels' index math, emulated lane by lane in numpy
(`gemma_tpu_torch/tools/tc_emulation.py`), against the plain versions the
card holds the kernels to.

* The small-M GEMV (`csrc/dq_gemv.cuh`) of every format: its products are
  exact (integer weights and bf16 x), so it differs from the plain version
  (f32 weights and x, M <= 8) only in the order of f32 sums, and for q4_k
  in the f32 rounding of each dequantized weight against its (d*sc, affine)
  split: 1e-5 of the output's scale, also against every format's Pallas
  kernel in interpret mode at M = 1.
* The f32 GEMV of every format (`dq_gemv_kernel` with `XF32`): x split
  into three bf16 parts that sum to x exactly, three products a k16 step
  against the exact integer weights, q4_k's per-32 sums from the f32 x:
  within 1e-5 of the output's scale of the plain f32 version, of the JAX
  package's f32 dispatch and of `_q4_0_kernel` / `_q8_0_kernel` /
  `_q4_k_kernel` / `_q6_k_kernel` in interpret mode (f32 weights and x at
  M <= 8) on bf16-exact f32 x. Two parts still hold 1e-5 on random data;
  one misses it. Its plan keeps the blocks an SM that bf16 x reaches.
* The decode-GEMV instruments' instances of the same GEMV
  (`Q4KAblation` of csrc/q4_k_matmul.cu, `Q4_0Variant` of
  csrc/q4_0_matmul.cu): q4_k without its affine part (noaffine) or its
  6-bit sub-scales (nosub), and q4_0 on f32, bf16 or f16 scales in the
  group-scaled form or with the weight rounded to bf16 (or unscaled) in
  registers before one accumulator: within 1e-5 of the output's scale of
  their plain versions (`ops/qmm_variants.py`; the rounded forms round
  the same weights on both sides). The group form on f16 scales and
  q4_0ref are the main path's q4_0 instance, bit for bit.
* The f32 route's TF32 tile of every format (`csrc/dq_tile_tf32.cuh`): x
  split into two TF32 parts against the exact integer weights, each group
  scaled in f32, the K splits summed in order: within 1e-5 of the output's
  scale of the plain f32 version and of the JAX package's f32 dispatch,
  and within 2e-2 of `_q4_0_kernel`, `_q8_0_kernel`, `_q4_k_kernel` /
  `_q6_k_kernel` in interpret mode, which round x and weights to bf16 at
  M > 8 (the tolerances of tests/test_torch_quant_matmul.py); q4_0 and
  q8_0 also where K % 64 == 32 (the half step past K). One TF32 pass
  misses 1e-5, so the second pass is guarded.
* Flash attention's f32 route (`flash_mma_kernel` with `FlashTf32`):
  both products in 3xTF32, so it differs from the plain f32 version by
  ~2^-21 of each product and the order of f32 sums: within 1e-4 of each
  row's scale (`tools/_timing.attn_err`, the card's check in
  chip_smoke.py phase 8), of the plain version and of the JAX kernel in
  interpret mode (f32).
  Dropping any one of the four small-part products, or both small parts
  (1xTF32), misses that tolerance.
* Decode attention's f32 route (`decode_tc_kernel` with `DecTf32`): the
  same 3xTF32 products on the decode core's tiles, at 2 <= G <= 8, D = 128
  and 256, limits 0, 1, 17 and 204, softcap, window and dead splits:
  within 1e-4 of each row's scale of the plain version and of the JAX
  kernel in interpret mode (f32); rows without a key exactly 0; dropping
  any one small-part product misses it. Through a page table
  (`PagedRows`) it equals the dense emulation on the gathered pages bit
  for bit.
* f32 queries over an int8 cache (`decode_tc_kernel` with `DecTf32Int8`):
  the scores on `DecTf32`'s fragments with each int8 key exact in one
  TF32 part (K . lo(q), then K . hi(q)), scaled by ks after; P = bf16(p *
  vs) against the int8 arm's widened V: within 2e-2 of each row's scale
  of the plain version and of the JAX kernel in interpret mode (p * vs
  rounds to bf16, as in the int8 arm), dense and through pages (bit for
  bit the dense form). Dropping q's lo part moves the output far less
  than that rounding, so this tolerance cannot see it.
  `decode_route` and `paged_route` send f32 queries to the core's f32
  policies at G = 2-8 (pages of a multiple of 16 keys), G = 1 to the core
  for one query row (below), and G = 16 and 24-key pages to the split-S
  kernel; on the CPU both ops run their plain versions.
* The prefill tile's functors (`Q4_0Tile`, `Q8_0Tile`): the bf16 weights
  they store equal the plain bf16 dequant bit for bit, zeros past K (the
  half step where K % 64 == 32) and past N.
* Flash and decode attention (`csrc/flash_attention.cu` flash_mma_kernel
  with FlashBf16, `csrc/decode_tc.cuh` decode_tc_kernel), bf16: products
  are exact, but p rounds to bf16 against a tile's (flash) or a warp's
  (decode) running max where the plain version rounds against the row max, and the
  output is bf16: 2e-2 of the output's scale, the card's tolerance
  (chip_smoke.py). Rows without a valid key are exactly 0. One case of
  each is also held to the JAX kernel in interpret mode.
* Decode through a page table (`decode_tc_kernel` with `PagedRows`): equal
  bit for bit to the dense emulation on the gathered pages at the same
  split, and within 2e-2 of each row's scale of the plain version
  (`tools/_timing.attn_err`); tests/test_torch_paged.py holds it to the
  JAX `_paged_kernel`.
* Decode at G = 1 (`decode_g1_kernel` of `csrc/decode_g1.cuh`, Gemma-7B's
  heads): lane slices of each key row, the shuffle trees, the per-warp
  online softmax and rounding of p, the warp merge and the split merge in
  split order, in its four (q, cache) arms at D = 128 and 256 with
  softcap, window, limits 0 and 1 and ragged limits: bf16 and int8 arms
  within 2e-2 of each row's scale of the plain version (p, or p * vs,
  rounds to bf16 against a warp's running max), f32 over f32 within 1e-4
  (nothing rounds), and the same against the JAX `_decode_kernel` in
  interpret mode; rows without a key exactly 0; through a page table of
  any page size equal bit for bit to the dense emulation on the gathered
  pages (tests/test_torch_paged.py: against `_paged_kernel`).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gemma_tpu.ops.attention import decode_attention as jax_decode
from gemma_tpu.ops.attention import flash_attention as jax_flash
from gemma_tpu.ops.quant_matmul import quant_matmul as jax_quant_matmul
from gemma_tpu.quant.qtensor import dequant_t, quantize_array
from gemma_tpu_torch.ops import qmm_variants as qv
from gemma_tpu_torch.ops.attention import decode_attention_plain, decode_tc_split, flash_attention_plain
from gemma_tpu_torch.ops.paged_attention import gather_pages
from gemma_tpu_torch.ops.quant_matmul import PLAIN
from gemma_tpu_torch.quant.qtensor import dequant, from_jax
from gemma_tpu_torch.runtime.kv_cache import quantize_kv
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


def test_f32_split_is_exact():
    """`XF32::split`: x0 + x1 + x2 == x exactly, each part a bf16 value, over
    random normals, large and tiny magnitudes (2^-110 and up) and +-0;
    below 2^-110, where x2 would need bf16 subnormals' missing bits, within
    2^-134."""
    rng = np.random.default_rng(18)
    x = np.concatenate([rng.normal(size=4096), rng.normal(size=1024) * 1e30, rng.normal(size=1024) * 1e-25,
                        rng.normal(size=1024) * 2.0 ** -100, [0.0, -0.0]]).astype(np.float32)
    x = x[(np.abs(x) >= 2.0 ** -110) | (x == 0)]
    parts = emu.split_bf16x3(x)
    vals = [emu._bf16_bits_to_f32(p).astype(np.float64) for p in parts]
    assert np.array_equal(vals[0] + vals[1] + vals[2], x.astype(np.float64))
    sub = (rng.normal(size=1024) * 2.0 ** -115).astype(np.float32)
    back = sum(emu._bf16_bits_to_f32(p).astype(np.float64) for p in emu.split_bf16x3(sub))
    assert np.abs(back - sub).max() <= 2.0 ** -134
    assert np.array_equal(emu._bf16_bits_to_f32(parts[0]).view(np.uint32) >> 31, x.view(np.uint32) >> 31)
    # the parts shrink by at least 2^8 each
    big = np.abs(x) > 0
    assert np.all(np.abs(vals[1][big]) <= 2.0 ** -8 * np.abs(vals[0][big]))
    assert np.all(np.abs(vals[2][big]) <= 2.0 ** -8 * np.abs(vals[1][big]))


# (fmt, N, K, M): every M of the M = 1, 2, 7, 8 rows; ragged N (19, 40 and
# 1000 against the 16-row tiles); q4_0 and q8_0 at K % 64 == 32 (1056); q4_k
# at five superblocks; K splits (4096: several slices; q4_0 1056 at M = 7
# and 8: four slices of the policy's 512; q8_0 at M >= 2: slices of 288 and
# 384, its wider ring stage; Gemma-7B's K = 3072 at M = 1: eight to fill the
# card)
GEMV_F32_CASES = [*(("q4_0", N, K, M) for N, K, M in ((40, 1056, 1), (19, 1056, 2), (40, 1056, 7),
                                                      (1000, 1056, 8), (48, 4096, 2), (20, 4096, 8))),
                  *(("q4_k", N, K, M) for N, K, M in ((19, 1280, 1), (40, 1280, 2), (20, 2048, 7),
                                                      (19, 1280, 8), (48, 4096, 8))),
                  *(("q8_0", N, K, M) for N, K, M in ((40, 1056, 1), (19, 1056, 2), (40, 1056, 7),
                                                      (20, 3072, 8), (24, 3072, 1))),
                  # q6_k: a k16 step is one sub-block (its own scale group); K = 1280 at
                  # M = 3 and 8 splits into three slices, 2048 at M = 8 into four
                  *(("q6_k", N, K, M) for N, K, M in ((19, 1280, 1), (40, 2048, 2), (40, 1280, 3),
                                                      (19, 2048, 8), (40, 1280, 8)))]


@pytest.mark.parametrize("fmt,N,K,M", GEMV_F32_CASES)
def test_f32_gemv_emulation_matches_plain(fmt, N, K, M):
    """The f32 GEMV against the plain f32 version within 1e-5 of the
    output's scale."""
    gen, qt = _case(fmt, N, K, seed=N + M)
    x = torch.randn(M, K, generator=gen)
    ref = PLAIN[fmt](x, qt).numpy()
    got = emu.gemv(x, qt)
    assert got.shape == (M, N)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("fmt", ["q4_0", "q4_k", "q8_0", "q6_k"])
@pytest.mark.parametrize("M", [1, 8])
def test_f32_gemv_matches_the_jax_dispatch_and_kernels(fmt, M, monkeypatch):
    """On JAX-quantized weights (`from_jax` carries them exactly), the f32
    GEMV within 1e-5 of the output's scale of the JAX package's f32
    dispatch (`register_all`: f32 x against the f32 dequant), and on
    bf16-exact f32 x of `_q4_0_kernel` / `_q4_k_kernel` / `_q8_0_kernel` /
    `_q6_k_kernel` in interpret mode, which take f32 weights and x at
    M <= 8."""
    monkeypatch.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")
    rng = np.random.default_rng(18 + M)
    jqt = quantize_array(rng.normal(size=(256, 1024)).astype(np.float32) * 0.05, fmt)
    qt = from_jax(jqt.fmt, {k: np.asarray(v) for k, v in jqt.arrays.items()})
    x = rng.normal(size=(M, 1024)).astype(np.float32)
    got = emu.gemv(torch.from_numpy(x), qt)
    f32_dispatch = np.asarray(jnp.dot(jnp.asarray(x), dequant_t(jqt, jnp.float32)))
    assert got.shape == f32_dispatch.shape == (M, 256)
    assert np.abs(got - f32_dispatch).max() <= 1e-5 * np.abs(f32_dispatch).max()
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    ref = np.asarray(jax_quant_matmul(jnp.asarray(xb), jqt), np.float32)
    got = emu.gemv(torch.from_numpy(xb), qt)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_f32_gemv_passes():
    """Which of x's parts the products need: the three parts and the first
    two hold 1e-5 of the output's scale on random data (x rounded to 16
    bits), x0 alone (x rounded to bf16) misses it."""
    gen, qt = _case("q4_k", 48, 4096, seed=5)
    x = torch.randn(8, 4096, generator=gen)
    ref = PLAIN["q4_k"](x, qt).numpy()
    scale = np.abs(ref).max()
    err = {p: np.abs(emu.gemv(x, qt, passes=p) - ref).max() / scale for p in (1, 2, 3)}
    assert err[3] <= err[2] <= 1e-5 < err[1]


@pytest.mark.parametrize("M", list(range(1, 9)))
@pytest.mark.parametrize("fmt,N,K", [("q4_0", 2560, 2048), ("q4_0", 2048, 2048), ("q4_0", 32768, 2048),
                                     ("q4_0", 2048, 16384), ("q4_0", 256000, 2048), ("q4_k", 2048, 2048),
                                     ("q4_k", 256, 2048), ("q4_k", 32768, 2048), ("q4_k", 2048, 16384),
                                     ("q8_0", 12288, 3072), ("q8_0", 3072, 4096), ("q8_0", 49152, 3072),
                                     ("q8_0", 3072, 24576), ("q8_0", 256000, 3072), ("q6_k", 256, 2048),
                                     ("q6_k", 256000, 2048)])
def test_f32_gemv_plan_keeps_the_blocks_an_sm(fmt, N, K, M):
    """The f32 plan at the Gemma-2B q4_0 and q4_k_m shapes (q6_k: attn_v and
    the head) and the Gemma-7B q8_0 ones: whole 32-blocks (superblocks) a
    slice, at most the policy's slice, every K value in one slice, and a
    block's shared memory (three bf16 planes of x) within the card's and
    reaching the blocks an SM that bf16 x reaches."""
    F = emu.GEMV_FORMATS[fmt]
    sl_max = emu.gemv_slice_max(M, fmt, emu.GV_F32_PARTS)
    sl, splits = emu.gemv_plan(M, N, K, gran=F.gran, target=F.target, slice_min=F.slice_min,
                               slice_max=sl_max)
    assert sl % F.gran == 0 and sl <= sl_max and (splits - 1) * sl < K <= splits * sl
    smem = emu.gemv_smem_bytes(fmt, M, sl, emu.GV_F32_PARTS)
    assert smem <= 227 * 1024
    bf16 = emu.gemv_smem_bytes(fmt, M, emu.gemv_slice_max(M))
    assert emu.gemv_sm_blocks(smem) >= emu.gemv_sm_blocks(bf16) >= 2
    if sl_max < emu.gemv_slice_max(M):  # the next wider slice would lose a block an SM
        wider = emu.gemv_smem_bytes(fmt, M, 2 * sl_max, emu.GV_F32_PARTS)
        assert emu.gemv_sm_blocks(wider) < emu.gemv_sm_blocks(bf16)


# q4_k: 19 rows and K = 1280 (five superblocks, one slice), and 48 rows at
# K = 4096 (K splits summed in order)
@pytest.mark.parametrize("mode", ["noaffine", "nosub"])
@pytest.mark.parametrize("N,K,M", [(19, 1280, 5), (48, 4096, 8)])
def test_q4_k_ablation_emulation_matches_plain(mode, N, K, M):
    gen, qt = _case("q4_k", N, K, seed=N + M)
    x = torch.randn(M, K, generator=gen).to(torch.bfloat16)
    ref = qv.q4_k_variant_plain(mode, x, qt).numpy()
    got = emu.gemv(x, emu.Q4KAblation(qt, mode))
    assert got.shape == (M, N)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


# q4_0: K = 1056 (33 scale groups: words at odd parity, f32 scales past K
# zero-filled), 20 rows; the round form also at K = 4096 over K splits
@pytest.mark.parametrize("mode,sc_dtype,N,K,M", [
    ("f32dot", torch.bfloat16, 20, 1056, 3), ("f32dot", torch.float32, 20, 1056, 8),
    ("rsc", torch.bfloat16, 20, 1056, 8), ("f32sc", torch.float32, 20, 1056, 1),
    ("u16sc", torch.float16, 20, 1056, 8), ("f32sc", torch.float32, 48, 4096, 8),
    ("bf16sc", torch.bfloat16, 20, 1056, 8), ("bf16sc", torch.float32, 19, 1056, 8),
    ("noscale", torch.float32, 20, 1056, 8)])
def test_q4_0_variant_emulation_matches_plain(mode, sc_dtype, N, K, M):
    gen, qt = _case("q4_0", N, K, seed=N + M)
    x = torch.randn(M, K, generator=gen).to(torch.bfloat16)
    sc = qt.scales.to(sc_dtype)
    ref = qv.qmm_variant_plain(mode, x, qt.qs, sc).numpy()
    got = emu.gemv(x, emu.Q4_0Variant(qt.qs, sc, qv.TC_FORMS[mode]))
    assert got.shape == (M, N)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_q4_0_production_lines_are_the_main_path_gemv():
    """gdot on f16 scales, and q4_0ref (q4_k's payload, its 6-bit
    sub-scales as f16 scales), run the main path's q4_0 instance: the group
    form on f16 scales is `BlockGemv<16>` bit for bit, and q4_0ref within
    1e-5 of the output's scale of its plain version."""
    gen, q4k = _case("q4_k", 40, 1280, seed=3)
    x = torch.randn(8, 1280, generator=gen).to(torch.bfloat16)
    w = qv.q4_0ref_weight(q4k)
    prod = emu.gemv(x, w)
    assert np.array_equal(emu.gemv(x, emu.Q4_0Variant(w.qs, w.scales, qv.TC_FORMS["gdot"])), prod)
    ref = qv.q4_k_variant_plain("q4_0ref", x, w).numpy()
    assert np.abs(prod - ref).max() <= 1e-5 * np.abs(ref).max()


# (fmt, M, N, K): JAX-quantized weights (its K-quant kernels take K % 1024 ==
# 0); M = 16 one m16 row of a 64-row tile, 17 ragged, 70 two row tiles
TF32_JAX_CASES = [(fmt, M, N, 1024) for fmt in ("q4_k", "q6_k", "q4_0")
                  for M, N in ((16, 256), (17, 512), (70, 256))]


@pytest.mark.parametrize("fmt,M,N,K", TF32_JAX_CASES)
def test_tf32_tile_emulation_matches_plain_and_jax(fmt, M, N, K, monkeypatch):
    """The TF32 tile (f32 x, M > 8) against the plain f32 version and the
    JAX package's f32 dispatch within 1e-5 of the output's scale, and
    against `_q4_k_kernel` / `_q6_k_kernel` / `_q4_0_kernel` in interpret
    mode (bf16 x and weights at M > 8) within 2e-2; K splits in play (the
    plan's splits at these shapes: 2 to 4)."""
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
# array mid-word), one split and several; q4_0 at K % 64 == 32 (the half
# step past K; its odd rows' scales at odd halves of their words), that
# step in the last of two splits (K = 2144), and past a 128-wide tile
TF32_RAGGED = [*(pytest.param(fmt, M, N, K, id=f"{M}-{N}-{K}-{fmt}")
                 for M, N, K in ((17, 300, 1280), (70, 1000, 512), (203, 1100, 256))
                 for fmt in ("q4_k", "q6_k")),
               *(pytest.param("q4_0", M, N, K, id=f"{M}-{N}-{K}-q4_0")
                 for M, N, K in ((17, 129, 2144), (70, 1000, 1056), (203, 1100, 288)))]


@pytest.mark.parametrize("fmt,M,N,K", TF32_RAGGED)
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


# q8_0 (Gemma-7B's format): K % 64 == 32 (1056: 33 blocks, the last step a
# half step; odd rows' scales at odd halves of their words), ragged M and N
# past a tile, one split and several
@pytest.mark.parametrize("M,N,K", [(17, 130, 1056), (70, 200, 1056), (33, 129, 2080)])
def test_tf32_tile_emulation_q8_0(M, N, K):
    gen, qt = _case("q8_0", N, K, seed=M + N)
    x = torch.randn(M, K, generator=gen)
    ref = PLAIN["q8_0"](x, qt).numpy()
    got = emu.tile_tf32(x, qt)
    assert got.shape == (M, N)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_tf32_q8_0_matches_the_jax_dispatch(monkeypatch):
    """q8_0's TF32 tile on JAX-quantized weights: within 1e-5 of the
    output's scale of the JAX package's f32 dispatch (f32 x against the f32
    dequant) at K % 64 == 32, where one TF32 pass misses 1e-5; and at K =
    1024, which `_q8_0_kernel` takes, within 2e-2 of it in interpret mode
    (bf16 x and weights at M > 8)."""
    monkeypatch.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")
    rng = np.random.default_rng(17)
    for M, N, K in ((17, 192, 1056), (20, 128, 1024)):
        jqt = quantize_array(rng.normal(size=(N, K)).astype(np.float32) * 0.05, "q8_0")
        qt = from_jax(jqt.fmt, {k: np.asarray(v) for k, v in jqt.arrays.items()})
        x = rng.normal(size=(M, K)).astype(np.float32)
        got = emu.tile_tf32(torch.from_numpy(x), qt)
        xj = jnp.asarray(x)
        f32_dispatch = np.asarray(jnp.dot(xj, dequant_t(jqt, jnp.float32)))
        scale = np.abs(f32_dispatch).max()
        assert np.abs(got - f32_dispatch).max() <= 1e-5 * scale
        if K % 64:
            one = emu.tile_tf32(torch.from_numpy(x), qt, passes=1)
            assert np.abs(one - f32_dispatch).max() > 1e-5 * scale
        else:
            assert np.abs(got - np.asarray(jax_quant_matmul(xj, jqt))).max() <= 2e-2 * scale


# Gemma-7B q8_0's rows: (N, K) -> K splits at M = 17, 64, 203 and 512
Q8_0_TF32_SPLITS = {(12288, 3072): (8, 8, 1, 1), (3072, 4096): (8, 8, 8, 4),
                    (49152, 3072): (1, 1, 1, 1), (3072, 24576): (8, 8, 8, 4),
                    (256000, 3072): (1, 1, 1, 1)}


@pytest.mark.parametrize("M", [17, 64, 203, 512])
@pytest.mark.parametrize("N,K", list(Q8_0_TF32_SPLITS))
def test_tf32_plan_at_the_gemma_7b_q8_0_shapes(M, N, K):
    """q8_0's 80-byte raw step keeps 128-wide tiles at two blocks an SM
    (96256 bytes of shared memory). K splits in whole steps, at least 2 a
    split, only where the grid holds fewer than two blocks an SM, the count
    with the fewest rounds x (steps a split + 2): never gate_up and the
    head, attn_out and down 8 or 4 ways."""
    smem = emu.TF_STAGES * emu.TF_BM * emu.TF_LD * 4 + emu.TF_STAGES * 128 * 80 + 2 * 4 * 128 * 4
    assert smem == 96256 and smem <= emu.TF_TWO_BLOCK_SMEM
    bn, splits = emu.tf32_plan("q8_0", M, N, K)
    assert bn == 128 and splits == Q8_0_TF32_SPLITS[N, K][[17, 64, 203, 512].index(M)]
    steps = K // emu.TF_BK
    assert steps % splits == 0 and steps // splits >= 2 and splits <= 16
    tiles, slots = -(-M // 64) * -(-N // bn), 2 * emu.H100_SMS
    assert splits == 1 or tiles < slots
    if tiles < slots:
        cost = {z: -(-tiles * z // slots) * (steps // z + 2) for z in (1, 2, 4, 8, 16)}
        assert cost[splits] == min(cost.values())


# Gemma-2B q4_0's rows: (N, K) -> K splits at M = 17, 64, 203 and 512
Q4_0_TF32_SPLITS = {(2560, 2048): (8, 8, 2, 4), (2048, 2048): (16, 16, 4, 2),
                    (32768, 2048): (1, 1, 1, 1), (2048, 16384): (16, 16, 4, 2),
                    (256000, 2048): (1, 1, 1, 1)}


@pytest.mark.parametrize("M", [17, 64, 203, 512])
@pytest.mark.parametrize("N,K", list(Q4_0_TF32_SPLITS))
def test_tf32_plan_at_the_gemma_2b_q4_0_shapes(M, N, K):
    """q4_0's 48-byte raw step (q4_k's pitch) keeps 128-wide tiles at two
    blocks an SM (83968 bytes of shared memory). K splits in whole steps,
    at least 2 a split, only where the grid holds fewer than two blocks an
    SM, the count with the fewest rounds x (steps a split + 2): never
    gate_up and the head; and the plan q4_k takes at the same shape."""
    smem = emu.TF_STAGES * emu.TF_BM * emu.TF_LD * 4 + emu.TF_STAGES * 128 * 48 + 2 * 4 * 128 * 4
    assert smem == 83968 and smem <= emu.TF_TWO_BLOCK_SMEM
    bn, splits = emu.tf32_plan("q4_0", M, N, K)
    assert bn == 128 and splits == Q4_0_TF32_SPLITS[N, K][[17, 64, 203, 512].index(M)]
    assert (bn, splits) == emu.tf32_plan("q4_k", M, N, K)
    steps = K // emu.TF_BK
    assert steps % splits == 0 and steps // splits >= 2 and splits <= 16
    tiles, slots = -(-M // 64) * -(-N // bn), 2 * emu.H100_SMS
    assert splits == 1 or tiles < slots
    if tiles < slots:
        cost = {z: -(-tiles * z // slots) * (steps // z + 2) for z in (1, 2, 4, 8, 16)}
        assert cost[splits] == min(cost.values())


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


ATT_TF32_TOL = 1e-4  # of each row's scale: the card's f32 check (chip_smoke.py phase 8)


def _qkv32(B, T, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.3)
            for shape in ((B, T, Hq, D), (B, Hkv, S, D), (B, Hkv, S, D))]


FLASH_TF32_CASES = [
    # B, T, S, Hq, Hkv, D, pos0, limits, softcap, window, row warps (0: the plan)
    (1, 37, 300, 8, 1, 128, 0, [37], 0.0, 0, 0),      # G = 8, ragged T and S: 1 x 4 key groups
    (2, 21, 90, 4, 4, 128, 40, [61, 50], 30.0, 0, 2),  # G = 1, batch rows, softcap, limit < position
    (1, 30, 260, 4, 2, 128, 150, [180], 0.0, 24, 1),  # GQA, window: tiles skipped both sides
    (1, 9, 40, 8, 1, 256, 0, [9], 50.0, 0, 0),        # Gemma-2B heads, D = 256 (8-key tiles)
    (1, 6, 80, 16, 16, 256, 60, [64], 0.0, 0, 4),     # Gemma-7B heads, 32-key tiles, kv_limit < T + pos0
    (1, 40, 96, 4, 1, 128, 50, [50], 0.0, 32, 2),     # rows past 81 see no key: exactly 0
]


@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,pos0,limits,cap,window,row_warps", FLASH_TF32_CASES)
def test_flash_tf32_emulation_matches_plain(B, T, S, Hq, Hkv, D, pos0, limits, cap, window, row_warps):
    q, k, v = _qkv32(B, T, S, Hq, Hkv, D, seed=T + S)
    pos = (torch.arange(T, dtype=torch.int32) + pos0).expand(B, T).contiguous()
    lim = torch.tensor(limits, dtype=torch.int32)
    ref = flash_attention_plain(q, k, v, pos, lim, cap, window)
    got = emu.flash_tf32(q, k, v, pos, lim, cap, window, row_warps)
    assert got.shape == tuple(ref.shape) and np.isfinite(got).all()
    assert attn_err(torch.from_numpy(got), ref, ATT_TF32_TOL)[1] <= 1.0
    key = np.arange(S)
    p_ = pos.numpy()[:, :, None]
    seen = (key <= p_) & (key < np.asarray(limits)[:, None, None]) & ((key > p_ - window) | (window <= 0))
    empty = ~seen.any(-1)  # [B, T]: rows without a valid key are exactly 0
    assert not got[empty].any()


def test_flash_tf32_emulation_matches_the_jax_kernel(monkeypatch):
    """f32 inputs through the JAX `flash_attention` (`_flash_kernel` in
    interpret mode): G = 8 with softcap and window, rows above kv_limit."""
    monkeypatch.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")
    q, k, v = _qkv32(1, 30, 96, 8, 1, 128, seed=21)
    pos = (np.arange(30, dtype=np.int32) + 40)[None]
    lim = np.asarray([60], np.int32)
    ref = jax_flash(*(jnp.asarray(x.numpy()) for x in (q, k, v)), jnp.asarray(pos), jnp.asarray(lim),
                    attn_softcap=30.0, window=48)
    got = emu.flash_tf32(q, k, v, torch.from_numpy(pos), torch.from_numpy(lim), 30.0, 48)
    assert attn_err(torch.from_numpy(got), torch.from_numpy(np.array(ref)), ATT_TF32_TOL)[1] <= 1.0


# (S passes, P . V passes): the kernel's, each with one small-part product
# dropped, and 1xTF32 (hi.hi only in both)
_HI = ("hi.hi",)
FLASH_TF32_ABLATIONS = [
    ("3xTF32", (emu.TF32_3X, emu.TF32_3X), True),
    *((f"S without {d}", (tuple(x for x in emu.TF32_3X if x != d), emu.TF32_3X), False)
      for d in ("lo.hi", "hi.lo")),
    *((f"P.V without {d}", (emu.TF32_3X, tuple(x for x in emu.TF32_3X if x != d)), False)
      for d in ("lo.hi", "hi.lo")),
    ("1xTF32", (_HI, _HI), False),
]


@pytest.mark.parametrize("name,passes,holds", FLASH_TF32_ABLATIONS, ids=[a[0] for a in FLASH_TF32_ABLATIONS])
def test_flash_tf32_needs_every_pass(name, passes, holds):
    """At Gemma-2B's group (G = 8, D = 256), 64 positions from 0: the
    kernel's three products a k8 step hold 1e-4 of each row's scale, and
    leaving out any small-part product of either S or P . V misses it."""
    q, k, v = _qkv32(1, 64, 64, 8, 1, 256, seed=1)
    pos = torch.arange(64, dtype=torch.int32)[None]
    lim = torch.tensor([64], dtype=torch.int32)
    ref = flash_attention_plain(q, k, v, pos, lim)
    got = emu.flash_tf32(q, k, v, pos, lim, passes=passes)
    assert (attn_err(torch.from_numpy(got), ref, ATT_TF32_TOL)[1] <= 1.0) == holds


DECODE_TF32_CASES = [
    # B, S, Hq, Hkv, D, limits, softcap, window, split (None: the route's)
    (1, 300, 8, 1, 128, [204], 0.0, 0, None),         # G = 8 (Gemma-2B's group), limit 204
    (2, 256, 8, 2, 128, [1, 230], 30.0, 40, 32),      # G = 4, limit 1, softcap, window: dead splits
    (1, 96, 8, 1, 256, [17], 50.0, 0, 16),            # Gemma-2B heads at D = 256, limit 17
    (2, 200, 4, 2, 256, [204, 130], 0.0, 0, 128),     # G = 2, D = 256: two tiles a warp, one stage
    (2, 160, 4, 2, 128, [0, 150], 0.0, 24, 64),       # a row without keys: exactly 0
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,limits,cap,window,split", DECODE_TF32_CASES)
def test_decode_tf32_emulation_matches_plain(B, S, Hq, Hkv, D, limits, cap, window, split):
    """The TF32 decode core within 1e-4 of each row's scale of the plain
    f32 version; rows without a valid key exactly 0."""
    q, k, v = _qkv32(B, 1, S, Hq, Hkv, D, seed=S + D)
    lim = torch.tensor(limits, dtype=torch.int32)
    ref = decode_attention_plain(q, k, v, lim, cap, window)
    got = emu.decode_tf32(q, k, v, lim, cap, window, split)
    assert got.shape == tuple(ref.shape) and np.isfinite(got).all()
    assert attn_err(torch.from_numpy(got), ref, ATT_TF32_TOL)[1] <= 1.0
    assert not got[np.asarray(limits) == 0].any()


def test_decode_tf32_emulation_matches_the_jax_kernel(monkeypatch):
    """f32 inputs through the JAX `decode_attention` (`_decode_kernel` in
    interpret mode): G = 4 over per-row limits, softcap and window."""
    monkeypatch.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")
    q, k, v = _qkv32(2, 1, 160, 8, 2, 128, seed=20)
    lim = np.asarray([77, 150], np.int32)
    ref = jax_decode(*(jnp.asarray(x.numpy()) for x in (q, k, v)), jnp.asarray(lim), attn_softcap=30.0,
                     window=48)
    got = emu.decode_tf32(q, k, v, torch.from_numpy(lim), 30.0, 48)
    assert attn_err(torch.from_numpy(got), torch.from_numpy(np.array(ref)), ATT_TF32_TOL)[1] <= 1.0


@pytest.mark.parametrize("name,passes,holds", FLASH_TF32_ABLATIONS, ids=[a[0] for a in FLASH_TF32_ABLATIONS])
def test_decode_tf32_needs_every_pass(name, passes, holds):
    """At Gemma-2B's group (G = 8, D = 256) over 128 keys: the core's three
    products a k8 step hold 1e-4 of each row's scale, and leaving out any
    small-part product of either S or P . V misses it."""
    q, k, v = _qkv32(1, 1, 128, 8, 1, 256, seed=2)
    lim = torch.tensor([128], dtype=torch.int32)
    ref = decode_attention_plain(q, k, v, lim)
    got = emu.decode_tf32(q, k, v, lim, passes=passes)
    assert (attn_err(torch.from_numpy(got), ref, ATT_TF32_TOL)[1] <= 1.0) == holds


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("S", [512, 4096])
def test_decode_route_takes_tf32_at_the_kernels_groups(G, S):
    """f32 queries take the decode core's f32 policies at 2 <= G <= 8 (over
    an f32 or an int8 cache, dense or through pages of a multiple of 16
    keys), at the bf16 core's split; G = 1 takes the core for one query row;
    G = 16, and pages of 24 keys, the split-S kernel."""
    from gemma_tpu_torch.ops import attention as att
    from gemma_tpu_torch.ops import paged_attention as pat

    g1 = ("g1", att.decode_tc_split(S))
    want = g1 if G == 1 else ("tf32", decode_tc_split(S)) if 2 <= G <= 8 else ("split", att.DECODE_SPLIT)
    assert att.decode_route(torch.float32, G, S) == want
    assert pat.paged_route(torch.float32, G, 64, S) == (want if G <= 8 else ("split", 64))
    assert pat.paged_route(torch.float32, G, 24, S) == (g1 if G == 1 else ("split", 24))


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU, f32 decode attention at G = 8 and q6_k's f32 matmul at
    M <= 8 return their plain versions and count no launch."""
    from gemma_tpu_torch.ops import attention as att
    from gemma_tpu_torch.ops import quant_matmul as qmm

    q, k, v = _qkv32(1, 1, 64, 8, 1, 128, seed=3)
    lim = torch.tensor([40], dtype=torch.int32)
    before = (att.decode_attention.launches, att.decode_attention.tf32_launches, qmm.q6_k_matmul.launches,
              qmm.q6_k_matmul.gemv_f32_launches)
    assert torch.equal(att.decode_attention(q, k, v, lim), decode_attention_plain(q, k, v, lim))
    gen, qt = _case("q6_k", 20, 512, seed=4)
    x = torch.randn(8, 512, generator=gen)
    assert torch.equal(qmm.q6_k_matmul(x, qt), PLAIN["q6_k"](x, qt))
    assert before == (att.decode_attention.launches, att.decode_attention.tf32_launches,
                      qmm.q6_k_matmul.launches, qmm.q6_k_matmul.gemv_f32_launches)


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


# The G = 1 core's four (q, cache) arms: (q dtype, int8 cache, tolerance of
# each row's scale). bf16 q over bf16 and int8 round p (int8: p * vs) to
# bf16 against a warp's running max where the plain version takes the row
# max; f32 q over f32 rounds nothing (1e-4, the card's f32 check); f32 q
# over int8 keeps bf16(p * vs) (2e-2, as chip_smoke.py holds it).
G1_ARMS = {"bf16": (torch.bfloat16, False, ATT_TOL), "int8": (torch.bfloat16, True, ATT_TOL),
           "f32": (torch.float32, False, ATT_TF32_TOL), "f32 int8": (torch.float32, True, ATT_TOL)}


def _g1_inputs(arm, q, k, v):
    """q, k, v (f32) in `arm`'s dtypes: (q, k, v, k_scale, v_scale, tolerance)."""
    dtype, int8, tol = G1_ARMS[arm]
    if int8:
        (k, ks), (v, vs) = quantize_kv(k.to(torch.bfloat16)), quantize_kv(v.to(torch.bfloat16))
        return q.to(dtype), k, v, ks, vs, tol
    return q.to(dtype), k.to(dtype), v.to(dtype), None, None, tol


def test_g1_layout():
    """A lane owns 16 bytes of a key row; a warp keeps up to 8 such loads of
    K (and of V), 64 elements, in flight a step: bf16 at D = 256 one row a
    load and 8 keys a step, int8 two rows a load and 8 keys, f32 half a
    row and 4 keys."""
    assert emu.g1_layout(256, 2) == (8, 32, 1, 1, 8, 8)
    assert emu.g1_layout(128, 2) == (8, 16, 2, 1, 8, 16)
    assert emu.g1_layout(256, 1) == (16, 16, 2, 1, 4, 8)
    assert emu.g1_layout(128, 1) == (16, 8, 4, 1, 4, 16)
    assert emu.g1_layout(256, 4) == (4, 32, 1, 2, 4, 4)
    assert emu.g1_layout(128, 4) == (4, 32, 1, 1, 8, 8)
    for D in (128, 256):
        for nbytes in (1, 2, 4):
            epc, lpr, rpw, cpl, nu, keys = emu.g1_layout(D, nbytes)
            assert lpr * rpw == 32 and lpr * cpl * epc == D and nu * cpl <= 8 and nu * cpl * epc <= 64


DECODE_G1_CASES = [
    # B, S, H, D, limits, softcap, window, split (None: the route's)
    (1, 512, 4, 256, [204], 0.0, 0, None),        # Gemma-7B's head_dim at the first step's limit
    (3, 160, 2, 128, [0, 1, 160], 0.0, 0, None),  # limit 0 (exactly 0), limit 1, a full cache
    (2, 300, 2, 128, [257, 90], 30.0, 40, 64),    # softcap, window: dead splits, steps from the first live key
    (2, 200, 2, 256, [130, 17], 50.0, 0, 128),    # ragged limits, several steps a warp
]


@pytest.mark.parametrize("arm", list(G1_ARMS))
@pytest.mark.parametrize("B,S,H,D,limits,cap,window,split", DECODE_G1_CASES)
def test_decode_g1_emulation_matches_plain(B, S, H, D, limits, cap, window, split, arm):
    q, k, v, ks, vs, tol = _g1_inputs(arm, *_qkv32(B, 1, S, H, H, D, seed=S + D))
    lim = torch.tensor(limits, dtype=torch.int32)
    ref = decode_attention_plain(q, k, v, lim, cap, window, ks, vs)
    got = emu.decode_g1(q, k, v, lim, cap, window, ks, vs, split)
    assert got.shape == tuple(ref.shape) and np.isfinite(got).all()
    assert attn_err(torch.from_numpy(got), ref.float(), tol)[1] <= 1.0
    assert not got[np.asarray(limits) == 0].any()


PAGED_G1_CASES = [
    # B, H, D, ps, maxp, limits, softcap, window, split (None: the route's)
    (2, 4, 256, 64, 8, [1, 300], 0.0, 0, None),      # serving's 64-key pages: two blocks a page
    (2, 2, 128, 16, 12, [100, 192], 30.0, 40, None),  # 16-key pages: two pages a block; window
    (2, 2, 128, 24, 6, [0, 131], 0.0, 0, 64),         # a page size off 16: pages straddle blocks
]


@pytest.mark.parametrize("arm", list(G1_ARMS))
@pytest.mark.parametrize("B,H,D,ps,maxp,limits,cap,window,split", PAGED_G1_CASES)
def test_paged_decode_g1_emulation_is_dense_decode_on_the_gathered_pages(B, H, D, ps, maxp, limits, cap,
                                                                         window, split, arm):
    """Each row's pages shuffled over the pool, the trash page 0 and the free
    pages random: the G = 1 core through the page table runs the dense
    core's steps in its order and arithmetic (equal bit for bit), within
    its arm's tolerance of the plain version, and reads the table entries
    of pages that hold a live key only."""
    rng = np.random.default_rng(B * ps + maxp)
    n_pages = B * maxp + 3
    q, kp, vp = (torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.3)
                 for shape in ((B, 1, H, D), (n_pages, H, ps, D), (n_pages, H, ps, D)))
    q, kp, vp, ks, vs, tol = _g1_inputs(arm, q, kp, vp)
    perm = rng.permutation(n_pages - 1) + 1
    table = np.zeros((B, maxp), np.int32)
    live = [-(-n // ps) for n in limits]
    table[np.arange(maxp)[None, :] < np.asarray(live)[:, None]] = perm[: sum(live)]
    pt = torch.from_numpy(table)
    lim = torch.tensor(limits, dtype=torch.int32)
    dense = [None if x is None else gather_pages(x, pt) for x in (kp, vp, ks, vs)]
    reads = set()
    got = emu.paged_decode_g1(q, kp, vp, pt, lim, cap, window, ks, vs, split, reads=reads)
    assert np.array_equal(got, emu.decode_g1(q, *dense[:2], lim, cap, window, *dense[2:], split))
    ref = decode_attention_plain(q, *dense[:2], lim, cap, window, *dense[2:])
    assert attn_err(torch.from_numpy(got), ref.float(), tol)[1] <= 1.0
    for b, i in reads:  # the page holds a key in [max(limit - window, 0), limit)
        lo = max(limits[b] - window, 0) if window else 0
        assert i * ps < limits[b] and (i + 1) * ps > lo


@pytest.mark.parametrize("arm", list(G1_ARMS))
def test_decode_g1_emulation_matches_the_jax_kernel(arm, monkeypatch):
    """The G = 1 core against the JAX `decode_attention` (`_decode_kernel` in
    interpret mode) on the same inputs: 4 heads over 4 KV heads, per-row
    limits (one of 0), softcap and window, at the arm's tolerance."""
    monkeypatch.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")
    q, k, v, ks, vs, tol = _g1_inputs(arm, *_qkv32(3, 1, 160, 4, 4, 128, seed=22))
    lim = np.asarray([77, 0, 150], np.int32)

    def j(x):
        return jnp.asarray(x.float().numpy(), jnp.bfloat16 if x.dtype == torch.bfloat16 else None)

    scales = {} if ks is None else dict(k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()))
    kj, vj = (jnp.asarray(x.numpy()) if x.dtype == torch.int8 else j(x) for x in (k, v))
    ref = jax_decode(j(q), kj, vj, jnp.asarray(lim), attn_softcap=30.0, window=48, **scales)
    got = emu.decode_g1(q, k, v, torch.from_numpy(lim), 30.0, 48, ks, vs)
    assert attn_err(torch.from_numpy(got), torch.from_numpy(np.array(ref, np.float32)), tol)[1] <= 1.0
    assert not got[1].any()


def test_cpu_tensors_take_the_plain_versions_at_g1():
    """On the CPU, decode and paged decode attention at G = 1 return their
    plain versions and count no launch of the G = 1 core."""
    from gemma_tpu_torch.ops import attention as att
    from gemma_tpu_torch.ops import paged_attention as pat
    from gemma_tpu_torch.tools.parent_turn import paged_inputs

    q, k, v = _qkv(1, 1, 64, 4, 4, 128, seed=5)
    lim = torch.tensor([40], dtype=torch.int32)
    before = (att.decode_attention.g1_launches, pat.paged_decode_attention.g1_launches)
    assert torch.equal(att.decode_attention(q, k, v, lim), decode_attention_plain(q, k, v, lim))
    qp, cache, plim = paged_inputs(torch.Generator().manual_seed(0), torch.device("cpu"), 2, 4, 4, 128, 16,
                                   [20, 64], 9, 64, False)
    assert torch.equal(pat.paged_decode_attention(qp, cache, 0, plim),
                       pat.paged_decode_attention_plain(qp, cache, 0, plim))
    assert before == (att.decode_attention.g1_launches, pat.paged_decode_attention.g1_launches)


DECODE_TF32_INT8_CASES = [
    # B, S, Hq, Hkv, D, limits, softcap, window, split (None: the route's)
    (1, 300, 8, 1, 128, [204], 0.0, 0, None),         # G = 8 (Gemma-2B's group), ragged limit
    (2, 256, 8, 2, 128, [1, 230], 30.0, 40, 32),      # G = 4, limit 1, softcap, window: dead splits
    (1, 96, 8, 1, 256, [17], 50.0, 0, 16),            # Gemma-2B heads at D = 256
    (2, 200, 4, 2, 256, [204, 130], 0.0, 0, 128),     # G = 2, two tiles a warp, two stages
    (2, 160, 4, 2, 128, [0, 150], 0.0, 24, 64),       # a row without keys: exactly 0
]


def _int8_cache(B, S, Hq, Hkv, D, seed):
    """f32 q [B, 1, Hq, D] (not bf16 values) and an int8 cache with its
    scales, from f32 K and V."""
    q, k, v = _qkv32(B, 1, S, Hq, Hkv, D, seed)
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    return q, k8, v8, ks, vs


@pytest.mark.parametrize("B,S,Hq,Hkv,D,limits,cap,window,split", DECODE_TF32_INT8_CASES)
def test_decode_tf32_int8_emulation_matches_plain(B, S, Hq, Hkv, D, limits, cap, window, split):
    """f32 q over an int8 cache on the decode core within 2e-2 of each row's
    scale of the plain version (s = (q . k8) * ks, out = bf16(p * vs) .
    v8); rows without a valid key exactly 0."""
    q, k8, v8, ks, vs = _int8_cache(B, S, Hq, Hkv, D, seed=S + D)
    lim = torch.tensor(limits, dtype=torch.int32)
    ref = decode_attention_plain(q, k8, v8, lim, cap, window, ks, vs)
    got = emu.decode_tf32_int8(q, k8, v8, ks, vs, lim, cap, window, split)
    assert got.shape == tuple(ref.shape) and np.isfinite(got).all()
    assert attn_err(torch.from_numpy(got), ref, ATT_TOL)[1] <= 1.0
    assert not got[np.asarray(limits) == 0].any()


def test_decode_tf32_int8_emulation_matches_the_jax_kernel(monkeypatch):
    """f32 q over int8 K/V through the JAX `decode_attention`
    (`_decode_kernel` in interpret mode, its int8 arm): G = 4 over per-row
    limits, softcap and window."""
    monkeypatch.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")
    q, k8, v8, ks, vs = _int8_cache(2, 160, 8, 2, 128, seed=21)
    lim = np.asarray([77, 150], np.int32)
    ref = jax_decode(jnp.asarray(q.numpy()), jnp.asarray(k8.numpy()), jnp.asarray(v8.numpy()), jnp.asarray(lim),
                     attn_softcap=30.0, window=48, k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()))
    got = emu.decode_tf32_int8(q, k8, v8, ks, vs, torch.from_numpy(lim), 30.0, 48)
    assert attn_err(torch.from_numpy(got), torch.from_numpy(np.array(ref)), ATT_TOL)[1] <= 1.0


def test_decode_tf32_int8_takes_q_in_two_parts():
    """The scores' two products against the one-part q (`passes`
    ("hi.hi",)): q's lo part moves the output, though less than the bf16
    rounding of p * vs that the int8 arm's tolerance allows."""
    q, k8, v8, ks, vs = _int8_cache(1, 128, 8, 1, 256, seed=3)
    lim = torch.tensor([128], dtype=torch.int32)
    two = emu.decode_tf32_int8(q, k8, v8, ks, vs, lim)
    one = emu.decode_tf32_int8(q, k8, v8, ks, vs, lim, passes=("hi.hi",))
    assert not np.array_equal(two, one)
    ref = decode_attention_plain(q, k8, v8, lim, k_scale=ks, v_scale=vs)
    assert attn_err(torch.from_numpy(two), ref, ATT_TOL)[1] <= attn_err(torch.from_numpy(one), ref, ATT_TOL)[1]


PAGED_F32_CASES = [
    # B, Hq, Hkv, D, ps, maxp, limits, softcap, window, split (None: the route's)
    (2, 8, 1, 128, 64, 4, [1, 200], 0.0, 0, None),       # serving's pages: a page a block
    (1, 4, 2, 128, 16, 16, [230], 30.0, 40, None),       # four pages a block; window: dead splits
    (2, 8, 1, 256, 32, 4, [50, 128], 20.0, 0, 128),      # D = 256, two tiles a warp
    (2, 8, 2, 128, 16, 5, [0, 33], 0.0, 24, 32),         # a row without keys, two pages a block
]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,Hq,Hkv,D,ps,maxp,limits,cap,window,split", PAGED_F32_CASES)
def test_paged_f32_emulation_is_dense_decode_on_the_gathered_pages(B, Hq, Hkv, D, ps, maxp, limits, cap,
                                                                   window, split, int8):
    """f32 queries through a page table, over f32 pages (`DecTf32`) and int8
    pages (`DecTf32Int8`), each row's pages shuffled over the pool: bit for
    bit the dense emulation of the same policy on the gathered pages at the
    same split, and within the plain version's tolerance (f32 pages 1e-4,
    int8 2e-2 of each row's scale)."""
    rng = np.random.default_rng(B * ps + maxp + 1)
    n_pages = B * maxp + 3
    q, kp, vp = [torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.3)
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
    S_split = split or decode_tc_split(maxp * ps)
    want = (emu.decode_tf32_int8(q, *dense[:2], *dense[2:], lim, cap, window, S_split) if int8
            else emu.decode_tf32(q, *dense[:2], lim, cap, window, S_split))
    assert np.array_equal(got, want)
    ref = decode_attention_plain(q, *dense[:2], lim, cap, window, *dense[2:])
    assert attn_err(torch.from_numpy(got), ref, ATT_TOL if int8 else ATT_TF32_TOL)[1] <= 1.0
    assert not got[np.asarray(limits) == 0].any()
