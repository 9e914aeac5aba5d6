"""The q4_0 and q8_0 tensor-core kernels' index math, emulated lane by lane
in numpy (`gemma_tpu_torch/tools/tc_emulation.py`), against the plain
versions the card holds the kernels to.

* The small-M GEMV (`csrc/dq_gemv.cuh`): its products are exact (integer
  weights and bf16 x), so it differs from the plain version (f32 weights
  and x, M <= 8) only in the order of f32 sums: 1e-5 of the output's scale.
* The prefill tile's functors (`Q4_0Tile`, `Q8_0Tile`): the bf16 weights
  they store equal the plain bf16 dequant bit for bit, zeros past K (the
  half step where K % 64 == 32) and past N.
"""
import numpy as np
import pytest
import torch

from gemma_tpu_torch.ops.quant_matmul import PLAIN
from gemma_tpu_torch.quant.qtensor import dequant
from gemma_tpu_torch.tools import tc_emulation as emu
from gemma_tpu_torch.tools._timing import random_qtensor


def _case(fmt, N, K, seed):
    gen = torch.Generator().manual_seed(seed)
    return gen, random_qtensor(fmt, N, K, gen, "cpu")


@pytest.mark.parametrize("fmt", ["q4_0", "q8_0"])
# K = 1056: an odd count of 32-blocks (scale words at odd parity, a slice
# ending mid-stage; with 19 rows the last scale ends the array mid-word);
# 4096 with 48 rows: eight K splits; 40, 20 and 19 rows: ragged against the
# 16-row tiles
@pytest.mark.parametrize("N,K,M", [(40, 1056, 5), (19, 1056, 3), (20, 1280, 8), (48, 4096, 2)])
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
    """Every nibble and every int8 byte, through the kernel's bit tricks."""
    u = np.arange(16, dtype=np.uint32)
    pair = emu.nibble_pair(u | (u[::-1] << 16))
    assert np.array_equal(emu._bf16_bits_to_f32(pair & 0xFFFF), u - 8.0)
    assert np.array_equal(emu._bf16_bits_to_f32(pair >> 16), u[::-1] - 8.0)
    b = np.arange(256, dtype=np.uint32)
    w = b | (b[::-1] << 8) | (b << 16) | ((b ^ 0x55) << 24)
    q = lambda v: (v.astype(np.uint8).view(np.int8)).astype(np.float32)  # noqa: E731
    for i, j in ((0, 2), (1, 3)):
        pair = emu.int8_pair(w ^ 0x80808080, i, j)
        assert np.array_equal(emu._bf16_bits_to_f32(pair & 0xFFFF), q((w >> (8 * i)) & 0xFF))
        assert np.array_equal(emu._bf16_bits_to_f32(pair >> 16), q((w >> (8 * j)) & 0xFF))


@pytest.mark.parametrize("N,K", [(2560, 2048), (2048, 2048), (32768, 2048), (2048, 16384),
                                 (256000, 2048), (12288, 3072), (3072, 4096), (49152, 3072),
                                 (3072, 24576), (256000, 3072), (1000, 1056)])
def test_gemv_plan_covers_k_in_slices_that_fit(N, K):
    """The plan at the main path's shapes: whole 32-blocks a slice, at most
    the slice the shared x buffer holds, every K value in one slice."""
    sl, splits = emu.gemv_plan(N, K)
    assert sl % 32 == 0 and sl <= emu.GV_SLICE_MAX
    assert (splits - 1) * sl < K <= splits * sl
