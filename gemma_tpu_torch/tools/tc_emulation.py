"""Lane-by-lane numpy emulation of the q4_0 and q8_0 tensor-core kernels.

The CUDA sources build only on the card, so their index math is held here,
on the CPU, against the plain versions (tests/test_torch_tc_emulation.py):

* `gemv` emulates `dq_gemv_kernel` of `csrc/dq_gemv.cuh` (2 <= M <= 8, bf16
  x): the block's x slice and each warp's ring stage in shared memory as
  bytes, ldmatrix.x4 on the raw payload, the A fragments built from the
  words by the kernel's bit operations (nibble pairs, int8 pairs), the B
  fragments of x by byte perms, `mma.sync` m16n8k16 through the PTX
  fragment layouts, the per-block scale into f32 accumulators, the K
  splits and their sum in order.
* `tile_weights` emulates the `Q4_0Tile` and `Q8_0Tile` functors of
  `csrc/q4_0_matmul.cu` and `csrc/q8_0_matmul.cu` (`copy` with cp.async's
  zero fill, then `store`) for every K-step of `dq_tile.cuh`, the half step
  past K included: the bf16 weight tile they write, as f32.

Run as a module, it checks both formats at a few ragged shapes:

    python -m gemma_tpu_torch.tools.tc_emulation
"""
from __future__ import annotations

import numpy as np
import torch

from ..quant.qtensor import QTensor

# constants of csrc/dq_gemv.cuh
GV_WARPS, GV_STAGE_K, GV_STAGES, GV_SCALE_WORDS = 4, 128, 4, 3
GV_SLICE_MAX, GV_SLICE_MIN, GV_TARGET_WARPS = 2048, 512, 8
H100_SMS = 132
BLOCK_BYTES = {"q4_0": 16, "q8_0": 32}
DQ_BK = 64  # csrc/dq_tile.cuh kDqBK


def _u32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.uint64).astype(np.uint32)


def byte_perm(x, y, s) -> np.ndarray:
    """CUDA `__byte_perm(x, y, s)` on uint32 arrays."""
    x, y = _u32(x), _u32(y)
    src = (y.astype(np.uint64) << 32) | x.astype(np.uint64)
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for j in range(4):
        sel = (int(s) >> (4 * j)) & 7
        out |= ((src >> (8 * sel)) & 0xFF) << (8 * j)
    return out.astype(np.uint32)


def _bf16_bits_to_f32(b) -> np.ndarray:
    return (_u32(b) << 16).view(np.float32)


def _f32_to_bf16_bits_exact(v) -> np.ndarray:
    bits = np.asarray(v, np.float32).view(np.uint32)
    assert not np.any(bits & 0xFFFF), "value not exact in bf16"
    return bits >> 16


def nibble_pair(v) -> np.ndarray:
    """`nibble_pair`: bf16x2 (u0 - 8, u1 - 8) of bits 0-3 and 16-19 of v."""
    b = (_u32(v) & 0x000F000F) | 0x43004300
    lo = _bf16_bits_to_f32(b & 0xFFFF) - np.float32(136)
    hi = _bf16_bits_to_f32(b >> 16) - np.float32(136)
    return _f32_to_bf16_bits_exact(lo) | (_f32_to_bf16_bits_exact(hi) << 16)


def int8_pair(u, i: int, j: int) -> np.ndarray:
    """`int8_pair`: bf16x2 (q_i, q_j) of w's int8 bytes, u = w ^ 0x80808080."""
    a = byte_perm(u, 0x4B000000, 0x7540 + i).view(np.float32) - np.float32(8388736)
    b = byte_perm(u, 0x4B000000, 0x7540 + j).view(np.float32) - np.float32(8388736)
    return byte_perm(a.view(np.uint32), b.view(np.uint32), 0x7632)


def gemv_plan(N: int, K: int, sms: int = H100_SMS) -> tuple[int, int]:
    """`dq_gemv_plan`: (slice, splits) at (N, K)."""
    tiles = (N + 15) // 16

    def slice_of(splits):
        return -(-(K // 32) // splits) * 32

    splits = 1
    while slice_of(splits) > GV_SLICE_MAX:
        splits *= 2
    while tiles * splits < GV_TARGET_WARPS * sms and slice_of(2 * splits) >= GV_SLICE_MIN:
        splits *= 2
    sl = slice_of(splits)
    return sl, -(-K // sl)


def ldmatrix_x4(smem: np.ndarray, addr: np.ndarray) -> list[np.ndarray]:
    """ldmatrix.x4.b16: lane l's address addr[l] gives row l % 8 of matrix
    l // 8; lane (g, t) receives word t of row g of each matrix."""
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    out = []
    for i in range(4):
        a = addr[8 * i + g] + 4 * t
        out.append(smem[a[:, None] + np.arange(4)].copy().view(np.uint32)[:, 0])
    return out


def mma_16816(c: list, a: list, b0: np.ndarray, b1: np.ndarray) -> list:
    """mma.sync m16n8k16 row.col f32.bf16.bf16.f32 over 32 lanes' fragments
    (uint32 bf16x2 registers, f32 accumulators), through the PTX layouts:
    lane (g, t) holds A[g (+8)][2t (+8) + {0, 1}], B[2t (+8) + {0, 1}][g],
    C[g (+8)][2t + {0, 1}]."""
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    A = np.zeros((16, 16), np.float64)
    B = np.zeros((16, 8), np.float64)
    for reg, (dr, dk) in zip(a, ((0, 0), (8, 0), (0, 8), (8, 8))):
        A[g + dr, 2 * t + dk] = _bf16_bits_to_f32(reg & 0xFFFF)
        A[g + dr, 2 * t + dk + 1] = _bf16_bits_to_f32(reg >> 16)
    for reg, dk in ((b0, 0), (b1, 8)):
        B[2 * t + dk, g] = _bf16_bits_to_f32(reg & 0xFFFF)
        B[2 * t + dk + 1, g] = _bf16_bits_to_f32(reg >> 16)
    C = (A @ B).astype(np.float32)  # the products are exact; f32 sums
    return [c[0] + C[g, 2 * t], c[1] + C[g, 2 * t + 1], c[2] + C[g + 8, 2 * t],
            c[3] + C[g + 8, 2 * t + 1]]


def _cp_half2(scales: np.ndarray, h: int, total: int) -> bytes:
    """`cp_async_half2`: the f16 word at element h (4, 2 or 0 bytes read)."""
    n = (4 if h + 1 < total else 2) if h < total else 0
    raw = scales.view(np.uint8)[2 * h: 2 * h + n].tobytes() if n else b""
    return raw + b"\0" * (4 - n)


def gemv(x: torch.Tensor, qt: QTensor, sms: int = H100_SMS) -> np.ndarray:
    """`launch_dq_gemv` on x bf16 [M, K] (2 <= M <= 8), qt q4_0 or q8_0:
    y f32 [M, N]."""
    bb = BLOCK_BYTES[qt.fmt]
    M, K = x.shape
    N = qt.shape[0]
    assert 2 <= M <= 8 and x.dtype == torch.bfloat16 and K % 32 == 0
    xb = x.contiguous().view(torch.int16).numpy().view(np.uint16)
    qs = qt.qs.contiguous().numpy().view(np.uint8).reshape(-1)
    scales = qt.scales.contiguous().numpy().reshape(-1)
    nscales = N * (K // 32)
    row_bytes = K // 32 * bb
    sl, splits = gemv_plan(N, K, sms)
    row_stage = GV_STAGE_K // 32 * bb
    pitch = row_stage + 16
    scales_off = 16 * pitch
    stage_bytes = scales_off + 16 * GV_SCALE_WORDS * 4
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    work = np.zeros((splits, M, N), np.float32)
    for z in range(splits):
        klo, khi = z * sl, min(K, (z + 1) * sl)
        xs = np.zeros((8, sl + 16), np.uint16)  # the block's x slice
        for r in range(M):
            for c in range(sl // 8):
                if klo + 8 * c < khi:
                    xs[r, 8 * c: 8 * c + 8] = xb[r, klo + 8 * c: klo + 8 * c + 8]
        xflat = xs.reshape(-1)
        for n0 in range(0, N, 16):
            acc = [np.zeros(32, np.float32) for _ in range(4)]
            for st in range(-(-(khi - klo) // GV_STAGE_K)):
                kb = klo + st * GV_STAGE_K
                stage = np.zeros(stage_bytes, np.uint8)  # issue(st)
                for i in range(row_stage):  # 16 rows x row_stage / 16 chunks
                    r, c = divmod(i, row_stage // 16)
                    if n0 + r < N and kb + c * 16 // bb * 32 < khi:
                        src = (n0 + r) * row_bytes + kb // 32 * bb + 16 * c
                        stage[r * pitch + 16 * c: r * pitch + 16 * c + 16] = qs[src: src + 16]
                for i in range(16 * GV_SCALE_WORDS):
                    r, j = divmod(i, GV_SCALE_WORDS)
                    h = (((n0 + r) * (K // 32) + kb // 32) & ~1) + 2 * j
                    stage[scales_off + 4 * i: scales_off + 4 * i + 4] = np.frombuffer(
                        _cp_half2(scales, h, nscales), np.uint8)
                sc = stage[scales_off:].view(np.float16)
                odd0 = ((n0 + g) * (K // 32) + kb // 32) & 1
                odd1 = ((n0 + g + 8) * (K // 32) + kb // 32) & 1
                for p in range(row_stage // 32):  # compute(st)
                    addr = ((lanes & 7) + ((lanes >> 3) & 1) * 8) * pitch + 32 * p + (lanes >> 4) * 16
                    r4 = ldmatrix_x4(stage, addr)
                    for b in range(32 // bb):
                        blk = p * (32 // bb) + b
                        if kb + 32 * blk >= khi:
                            break
                        f = [np.zeros(32, np.float32) for _ in range(4)]
                        for s in range(2):
                            if bb == 16:
                                w0, w1 = r4[2 * b], r4[2 * b + 1]
                                a = [nibble_pair(w0 >> (4 * s)), nibble_pair(w1 >> (4 * s)),
                                     nibble_pair(w0 >> (4 * s + 8)), nibble_pair(w1 >> (4 * s + 8))]
                            else:
                                u0, u1 = r4[2 * s] ^ 0x80808080, r4[2 * s + 1] ^ 0x80808080
                                a = [int8_pair(u0, 0, 2), int8_pair(u1, 0, 2), int8_pair(u0, 1, 3),
                                     int8_pair(u1, 1, 3)]
                            xo = g * (sl + 16) + (kb - klo) + 4 * t + 32 * blk + 16 * s
                            xw = xflat[xo[:, None] + np.arange(4)].astype(np.uint32)
                            lo, hi = xw[:, 0] | (xw[:, 1] << 16), xw[:, 2] | (xw[:, 3] << 16)
                            f = mma_16816(f, a, byte_perm(lo, hi, 0x5410), byte_perm(lo, hi, 0x7632))
                        d0 = sc[g * 2 * GV_SCALE_WORDS + odd0 + blk].astype(np.float32)
                        d1 = sc[(g + 8) * 2 * GV_SCALE_WORDS + odd1 + blk].astype(np.float32)
                        acc = [acc[0] + d0 * f[0], acc[1] + d0 * f[1], acc[2] + d1 * f[2],
                               acc[3] + d1 * f[3]]
            m = 2 * t
            for h in range(2):
                n = n0 + g + 8 * h
                for mm, v in ((m, acc[2 * h]), (m + 1, acc[2 * h + 1])):
                    ok = (n < N) & (mm < M)
                    work[z, mm[ok], n[ok]] = v[ok]
    y = work[0].copy()
    for z in range(1, splits):
        y += work[z]
    return y


def tile_weights(qt: QTensor, rows: int | None = None) -> np.ndarray:
    """The bf16 weight tile rows the tile's functor writes for every K-step
    (`copy`, then `store` of parts 0-3), as f32 [rows, steps * 64]; rows past
    N come from zero-filled copies and must be 0."""
    bb = BLOCK_BYTES[qt.fmt]
    N, K = qt.shape
    rows = N if rows is None else rows
    qs = qt.qs.contiguous().numpy().view(np.uint8).reshape(-1)
    scales = qt.scales.contiguous().numpy().reshape(-1)
    nscales = N * (K // 32)
    steps = -(-K // DQ_BK)
    out = np.zeros((rows, steps * DQ_BK), np.float32)
    for n in range(rows):
        ok = n < N
        row = n if ok else 0
        for st in range(steps):
            k0 = st * DQ_BK
            raw = np.zeros(2 * bb + 16, np.uint8)
            for part in range(4):  # copy
                if bb == 16 and part < 2 or bb == 32:
                    blk = part if bb == 16 else part // 2
                    if ok and k0 + 32 * blk < K:
                        src = row * (K // 32 * bb) + k0 // 32 * bb + 16 * part
                        raw[16 * part: 16 * part + 16] = qs[src: src + 16]
                j = part - 2 if bb == 16 else part
                if bb == 16 and part >= 2 or bb == 32 and part < 2:
                    h = ((row * (K // 32) + k0 // 32) & ~1) + 2 * j
                    raw[2 * bb + 4 * j: 2 * bb + 4 * j + 4] = np.frombuffer(
                        _cp_half2(scales, h, nscales if ok else 0), np.uint8)
            odd = (n * (K // 32) + k0 // 32) & 1
            ds = raw[2 * bb: 2 * bb + 8].view(np.float16).astype(np.float32)
            for part in range(4):  # store
                b = part // 2
                dst = out[n, k0 + 16 * part: k0 + 16 * part + 16]
                if k0 + 32 * b >= K:
                    dst[:] = 0
                    continue
                d = ds[odd + b]
                if bb == 16:
                    byt = raw[16 * b: 16 * b + 16]
                    q = ((byt >> (4 * (part % 2))) & 15).astype(np.float32) - np.float32(8)
                else:
                    q = raw[16 * part: 16 * part + 16].view(np.int8).astype(np.float32)
                dst[:] = torch.from_numpy(d * q).to(torch.bfloat16).float().numpy()
    return out


def main() -> None:
    from ..ops.quant_matmul import PLAIN
    from ..quant.qtensor import dequant
    from ._timing import random_qtensor

    gen = torch.Generator().manual_seed(0)
    for fmt in BLOCK_BYTES:
        for N, K, M in ((40, 1056, 5), (20, 1280, 8), (48, 4096, 2)):
            qt = random_qtensor(fmt, N, K, gen, "cpu")
            x = torch.randn(M, K, generator=gen).to(torch.bfloat16)
            ref = PLAIN[fmt](x, qt).numpy()
            err = np.abs(gemv(x, qt) - ref).max() / np.abs(ref).max()
            tile = tile_weights(qt, N + 3)
            exact = (np.array_equal(tile[:N, :K], dequant(qt, torch.bfloat16).float().numpy())
                     and not tile[N:].any() and not tile[:, K:].any())
            print(f"{fmt} N={N} K={K} M={M}: gemv max|diff| / max|ref| {err:.2e}; "
                  f"tile weights bit-exact: {exact}")


if __name__ == "__main__":
    main()
