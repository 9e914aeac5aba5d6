"""Lane-by-lane numpy emulation of the tensor-core kernels: the GEMV of
every format, q4_0's and q8_0's tile functors, flash and decode attention.

The CUDA sources build only on the card, so their index math is held here,
on the CPU, against the plain versions (tests/test_torch_tc_emulation.py):

* `gemv` emulates `dq_gemv_kernel` of `csrc/dq_gemv.cuh` (M <= 8) through
  each format's functor (`BlockGemv` for q4_0 and q8_0, `Q4KGemv`,
  `Q6KGemv`) and the element policy of x: bf16 x (`XBf16`), or f32 x
  (`XF32`, q4_0, q8_0 and q4_k on the main path) split into three bf16 parts
  (`split_bf16x3`), three products a k16 step, smallest part first, the
  per-32 sums from the f32 x, and the policy's slice (`gemv_slice_max`):
  the block's x slice (and q4_k's per-32 sums of x) and each
  warp's ring stage in shared memory as bytes, the functor's decoded scale
  table, ldmatrix.x4 on the raw payload, the A fragments built from the
  words by the kernel's bit operations (nibble pairs, 6-bit pairs, int8
  pairs), the B fragments of x by byte perms, `mma.sync` m16n8k16 through
  the PTX fragment layouts, the per-group scale (and q4_k's affine part)
  into f32 accumulators, the K splits and their sum in split order (by the
  row tile's last block, or a second launch: the same sums). The
  instruments' instances take a functor in place of the weight:
  `Q4KAblation` (q4_k without its affine part or its 6-bit sub-scales) and
  `Q4_0Variant` (q4_0 on f32, bf16 or f16 scales, its A fragments weighed
  into one accumulator in the rounded-weight and unscaled forms).
* `tile_weights` emulates the `Q4_0Tile` and `Q8_0Tile` functors of
  `csrc/q4_0_matmul.cu` and `csrc/q8_0_matmul.cu` (`copy` with cp.async's
  zero fill, then `store`) for every K-step of `dq_tile.cuh`, the half step
  past K included: the bf16 weight tile they write, as f32.
* `tile_tf32` emulates the f32 route's TF32 tile of `csrc/dq_tile_tf32.cuh`
  through the `Q4_0Tf32`, `Q8_0Tf32`, `Q4KTf32` and `Q6KTf32` functors: the x stage at
  its padded offsets (zero-filled past K: q4_0's and q8_0's half step), the raw
  bytes, the group scales, x split into two TF32 parts against the exact
  integer weights, each group's fragment scaled into f32 accumulators, the
  K splits summed in order.
* `flash` emulates `flash_mma_kernel` of `csrc/flash_attention.cu` with
  the bf16 policy `FlashBf16`: the (position, head) row packing of a
  block's row warps, Q, K and V in
  shared memory at the kernel's pitch and ring stage, the key groups'
  tiles of a stage, ldmatrix of Q and K, ldmatrix.trans of V, S's C
  fragments reused as P's A fragments, the masks and the online softmax
  over key tiles, the live-range and per-warp tile skips, and the merge of
  the key groups. `flash_tf32` emulates the same kernel with the f32
  policy `FlashTf32`: Q, K and V in f32 at its pitches (D + 16, D + 4),
  m16n8k8 TF32 fragments with D permuted within each 16-wide unit (one
  16-byte load a row for two k8 steps) and keys permuted within each 8
  (P's A fragment is S's C fragment; V's B values rows 2t, 2t + 1 at
  column g), every operand split into two TF32 parts and three products
  (lo.hi, hi.lo, hi.hi), p kept in f32.
* `decode` emulates `decode_tc_kernel` of `csrc/decode_tc.cuh` over the
  dense cache (`DenseRows`): K (or V^T by ldmatrix.trans) as the A
  operand, q (or P through its shared tile) as the n8 B operand, int8
  tiles widened to bf16 and their scales, each warp's running softmax, the
  block's merge and the last block's merge of the splits in order;
  `decode_tf32` its f32 policy `DecTf32` (3xTF32 on m16n8k8) and
  `decode_tf32_int8` its `DecTf32Int8` (f32 q in two TF32 parts against
  the exact int8 keys, p . v as the int8 arm's); `paged_decode` the same
  kernel through a page table (`PagedRows`), the policy from the dtypes,
  each tile's rows and scales taken from its physical page.

Run as a module, it checks each at a few ragged shapes:

    python -m gemma_tpu_torch.tools.tc_emulation
"""
from __future__ import annotations

import numpy as np
import torch

from ..quant.qtensor import QTensor

# constants of csrc/dq_gemv.cuh
GV_WARPS, GV_STAGE_K, GV_SUPER_K, GV_STAGES, GV_SCALE_WORDS = 4, 128, 256, 4, 3
GV_SLICE_MAX, GV_SLICE_MIN, GV_TARGET_WARPS, GV_SUPER_TARGET_WARPS = 2048, 512, 8, 4
GV_BLOCK_SLICE_MIN = 256  # q4_0's and q8_0's slice floor (BlockPlan)
GV_MIN_BLOCKS, GV_SMEM_SM, GV_SMEM_BLOCK = 4, 233472, 1024  # blocks an SM and shared bytes
GV_F32_PARTS = 3  # XF32's bf16 parts of x
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


def gemv_x_rows(M: int) -> int:
    """`gemv_x_rows`: rows of the x slice, with 2 <= M < 8's zero row."""
    return 1 if M == 1 else min(M + 1, 8)


def gemv_smem_bytes(fmt: str, M: int, sl: int, parts: int = 1) -> int:
    """`gemv_smem_bytes<F, X>`: a block's shared bytes at M rows of x in
    `parts` bf16 planes (1: bf16 x, 3: f32 x) and a K-slice `sl`."""
    F = GEMV_FORMATS[fmt]
    return (2 * parts * gemv_x_rows(M) * (sl + 16) + (32 * (sl // 32) if F.affine else 0)
            + GV_WARPS * (4 * F.table + GV_STAGES * F.stage_size(fmt)))


def gemv_sm_blocks(smem: int) -> int:
    """`gemv_sm_blocks`: blocks an SM by shared memory, at most the launch
    bound's 4."""
    return min(GV_SMEM_SM // (smem + GV_SMEM_BLOCK), GV_MIN_BLOCKS)


def gemv_slice_max(M: int, fmt: str | None = None, parts: int = 1) -> int:
    """`gemv_slice_max<F, X>`: K values of x a row a block holds; with more
    than one part (f32 x) bf16's, halved while a block of `fmt` would reach
    fewer blocks an SM than with bf16 x."""
    bf16 = 8 * GV_SLICE_MAX if M == 1 else GV_SLICE_MAX
    if parts == 1:
        return bf16
    blocks = gemv_sm_blocks(gemv_smem_bytes(fmt, M, bf16))
    sl = bf16
    while sl > GEMV_FORMATS[fmt].gran and gemv_sm_blocks(gemv_smem_bytes(fmt, M, sl, parts)) < blocks:
        sl //= 2
    return sl


def gemv_plan(M: int, N: int, K: int, sms: int = H100_SMS, gran: int = 32,
              target: int = GV_TARGET_WARPS, slice_min: int = GV_BLOCK_SLICE_MIN,
              slice_max: int | None = None) -> tuple[int, int]:
    """`dq_gemv_plan`: (slice, splits) at (M, N, K), slices in multiples of
    `gran` (q4_0, q8_0: 32; q4_k, q6_k: their 256-superblock) no wider than
    `slice_max` (default bf16's `gemv_slice_max(M)`), splits doubled towards
    `target` warps an SM while a slice keeps `slice_min` (`BlockPlan`,
    `SuperPlan`)."""
    tiles = (N + 15) // 16
    slice_max = slice_max or gemv_slice_max(M)

    def slice_of(splits):
        return -(-(K // gran) // splits) * gran

    splits = 1
    while slice_of(splits) > slice_max:
        splits *= 2
    while tiles * splits < target * sms and slice_of(2 * splits) >= slice_min:
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


def ldmatrix_x4_trans(smem: np.ndarray, addr: np.ndarray) -> list[np.ndarray]:
    """ldmatrix.x4.trans.b16: lane l's address gives row l % 8 of matrix
    l // 8; lane (g, t) receives (M[2t][g], M[2t + 1][g]) of each matrix M."""
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    h = smem.view(np.uint16)
    out = []
    for i in range(4):
        lo = h[(addr[8 * i + 2 * t] + 2 * g) // 2].astype(np.uint32)
        hi = h[(addr[8 * i + 2 * t + 1] + 2 * g) // 2].astype(np.uint32)
        out.append(lo | (hi << 16))
    return out


def _cp_half2(scales: np.ndarray, h: int, total: int) -> bytes:
    """`cp_async_half2`: the f16 word at element h (4, 2 or 0 bytes read)."""
    n = (4 if h + 1 < total else 2) if h < total else 0
    raw = scales.view(np.uint8)[2 * h: 2 * h + n].tobytes() if n else b""
    return raw + b"\0" * (4 - n)


LANES = np.arange(32)
LANE_G, LANE_T = LANES // 4, LANES % 4


def _rows16_addr(pitch: int, col: int) -> np.ndarray:
    """`ldmatrix_rows16`: lane l's address in a [16][pitch] tile, 32 bytes
    at column `col`."""
    return ((LANES & 7) + ((LANES >> 3) & 1) * 8) * pitch + col + (LANES >> 4) * 16


def _np(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().reshape(-1)


def six_bit_pair(v) -> np.ndarray:
    """`six_bit_pair`: bf16x2 (u0 - 32, u1 - 32) of bits 0-5 and 16-21 of v."""
    b = (_u32(v) & 0x003F003F) | 0x43004300
    lo = _bf16_bits_to_f32(b & 0xFFFF) - np.float32(160)
    hi = _bf16_bits_to_f32(b >> 16) - np.float32(160)
    return _f32_to_bf16_bits_exact(lo) | (_f32_to_bf16_bits_exact(hi) << 16)


def scale_min_k4(tb: np.ndarray, j: int) -> tuple[np.ndarray, np.ndarray]:
    """ggml get_scale_min_k4 on 12-byte tables tb [..., 12]: (sc, mn) of
    sub-block j as f32."""
    tb = tb.astype(np.uint32)
    if j < 4:
        sc, mn = tb[..., j] & 63, tb[..., j + 4] & 63
    else:
        sc = (tb[..., j + 4] & 15) | ((tb[..., j - 4] >> 6) << 4)
        mn = (tb[..., j + 4] >> 4) | ((tb[..., j] >> 6) << 4)
    return sc.astype(np.float32), mn.astype(np.float32)


class BlockGemv:
    """`BlockGemv<kBlockBytes>` (q4_0: 16, q8_0: 32) of csrc/dq_gemv.cuh."""
    stage_k, gran, target, slice_min = GV_STAGE_K, 32, GV_TARGET_WARPS, GV_BLOCK_SLICE_MIN
    group_k, steps, affine, table, one_acc = 32, 2, False, 0, False

    @staticmethod
    def stage_size(fmt: str) -> int:
        """`kStage`: the payload rows at their pitch, then the scale words."""
        return 16 * (GV_STAGE_K // 32 * BLOCK_BYTES[fmt] + 16) + 16 * GV_SCALE_WORDS * 4

    def __init__(self, qt: QTensor):
        self.N, self.K = qt.shape
        self.bb = BLOCK_BYTES[qt.fmt]
        self.qs = _np(qt.qs).view(np.uint8)
        self.sc = _np(qt.scales)
        self.row_stage = self.stage_k // 32 * self.bb
        self.pitch = self.row_stage + 16
        self.scales_off = 16 * self.pitch
        self.stage_bytes = self.scales_off + 16 * GV_SCALE_WORDS * 4
        self.pieces, self.groups = self.row_stage // 32, 32 // self.bb

    def copy(self, n0: int, kb: int, khi: int) -> np.ndarray:
        stage = np.zeros(self.stage_bytes, np.uint8)
        self.copy_payload(stage, n0, kb, khi)
        self.copy_scale_words(stage, n0, kb)
        return stage

    def copy_payload(self, stage: np.ndarray, n0: int, kb: int, khi: int) -> None:
        N, K, bb = self.N, self.K, self.bb
        for i in range(self.row_stage):  # 16 rows x row_stage / 16 chunks
            r, c = divmod(i, self.row_stage // 16)
            if n0 + r < N and kb + c * 16 // bb * 32 < khi:
                src = (n0 + r) * (K // 32 * bb) + kb // 32 * bb + 16 * c
                stage[r * self.pitch + 16 * c: r * self.pitch + 16 * c + 16] = self.qs[src: src + 16]

    def copy_scale_words(self, stage: np.ndarray, n0: int, kb: int) -> None:
        """The aligned 2-byte words that hold each row's four scales."""
        N, K = self.N, self.K
        for i in range(16 * GV_SCALE_WORDS):
            r, j = divmod(i, GV_SCALE_WORDS)
            h = (((n0 + r) * (K // 32) + kb // 32) & ~1) + 2 * j
            o = self.scales_off + 4 * i
            stage[o: o + 4] = np.frombuffer(_cp_half2(self.sc, h, N * (K // 32)), np.uint8)

    def prepare(self, stage, n0, kb):
        return None

    def load(self, stage, p):
        return ldmatrix_x4(stage, _rows16_addr(self.pitch, 32 * p))

    def a_frag(self, r, gi, s):
        if self.bb == 16:
            w0, w1 = r[2 * gi], r[2 * gi + 1]
            return [nibble_pair(w0 >> (4 * s)), nibble_pair(w1 >> (4 * s)),
                    nibble_pair(w0 >> (4 * s + 8)), nibble_pair(w1 >> (4 * s + 8))]
        u0, u1 = r[2 * s] ^ 0x80808080, r[2 * s + 1] ^ 0x80808080
        return [int8_pair(u0, 0, 2), int8_pair(u1, 0, 2), int8_pair(u0, 1, 3), int8_pair(u1, 1, 3)]

    def x_off(self, p, gi, s):
        return 32 * (p * self.groups + gi) + 16 * s

    def scales(self, stage, table, n0, kb, grp):
        sc = stage[self.scales_off:].view(np.float16)
        d = []
        for h in range(2):
            odd = ((n0 + LANE_G + 8 * h) * (self.K // 32) + kb // 32) & 1
            d.append(sc[(LANE_G + 8 * h) * 2 * GV_SCALE_WORDS + odd + grp].astype(np.float32))
        return d, None


class Q4KGemv:
    """`Q4KGemv` of csrc/q4_k_matmul.cu: a stage is one superblock, payload
    [16][144], then each row's 12-byte table and d, dmin [16][16]; the
    warp's table holds d*sc [8][16] and the offsets [8][16]."""
    stage_k = gran = GV_SUPER_K
    target, slice_min = GV_SUPER_TARGET_WARPS, GV_SLICE_MIN
    group_k, steps, affine, pieces, groups, table, one_acc = 32, 2, True, 4, 2, 256, False
    pitch = 144
    meta = 16 * pitch
    stage_bytes = meta + 16 * 16

    @classmethod
    def stage_size(cls, fmt: str) -> int:
        return cls.stage_bytes

    def __init__(self, qt: QTensor):
        self.N, self.K = qt.shape
        self.qs = _np(qt.qs).view(np.uint8)
        self.tab = _np(qt.scales).view(np.uint8)
        self.dm = _np(qt.dm).view(np.uint8)

    def copy(self, n0, kb, khi):
        N, K = self.N, self.K
        nsb, sb = K // 256, kb // 256
        stage = np.zeros(self.stage_bytes, np.uint8)
        for r in range(16):
            if n0 + r >= N:
                continue  # zero-filled
            src = (n0 + r) * (K // 2) + sb * 128
            stage[r * self.pitch: r * self.pitch + 128] = self.qs[src: src + 128]
            sbi = (n0 + r) * nsb + sb
            o = self.meta + 16 * r
            stage[o: o + 12] = self.tab[12 * sbi: 12 * sbi + 12]
            stage[o + 12: o + 16] = self.dm[4 * sbi: 4 * sbi + 4]
        return stage

    def prepare(self, stage, n0, kb):
        table = np.zeros(256, np.float32)
        r = LANES % 16
        meta = stage[self.meta:].reshape(16, 16)[r]  # each lane's row
        dm = meta[:, 12:16].copy().view(np.float16).astype(np.float32)
        for i in range(4):
            j = LANES // 16 + 2 * i
            for jj in (2 * i, 2 * i + 1):
                sel = j == jj
                sc, mn = scale_min_k4(meta[sel, :12], jj)
                dsc = dm[sel, 0] * sc
                table[16 * jj + r[sel]] = dsc
                table[128 + 16 * jj + r[sel]] = np.float32(8) * dsc - dm[sel, 1] * mn
        return table

    def load(self, stage, p):
        return ldmatrix_x4(stage, _rows16_addr(self.pitch, 32 * p))

    def a_frag(self, r, gi, s):
        w0, w1 = r[2 * s], r[2 * s + 1]
        return [nibble_pair(w0 >> (4 * gi)), nibble_pair(w1 >> (4 * gi)),
                nibble_pair(w0 >> (4 * gi + 8)), nibble_pair(w1 >> (4 * gi + 8))]

    def x_off(self, p, gi, s):
        return 64 * p + 32 * gi + 16 * s

    def scales(self, stage, table, n0, kb, grp):
        return ([table[16 * grp + LANE_G], table[16 * grp + LANE_G + 8]],
                [table[128 + 16 * grp + LANE_G], table[128 + 16 * grp + LANE_G + 8]])


class Q4KAblation(Q4KGemv):
    """`Q4KAblation<Mode>` of csrc/q4_k_matmul.cu, the q4_k instrument's
    ablations (no affine part, so no per-32 sums of x): `noaffine` decodes
    the 6-bit scales alone into a table of d*sc [8][16]; `nosub` copies the
    payload and each row's d, dmin word alone and scales every group by d."""
    affine = False

    def __init__(self, qt: QTensor, mode: str):
        assert mode in ("noaffine", "nosub")
        super().__init__(qt)
        self.mode = mode
        self.table = 128 if mode == "noaffine" else 0

    def copy(self, n0, kb, khi):
        stage = super().copy(n0, kb, khi)
        if self.mode == "nosub":  # no table bytes copied
            stage[self.meta:].reshape(16, 16)[:, :12] = 0
        return stage

    def _d(self, stage) -> np.ndarray:
        """Each stage row's d as f32 [16]."""
        return stage[self.meta:].reshape(16, 16)[:, 12:14].copy().view(np.float16)[:, 0].astype(np.float32)

    def prepare(self, stage, n0, kb):
        if self.mode == "nosub":
            return None
        table = np.zeros(128, np.float32)
        r = LANES % 16
        meta = stage[self.meta:].reshape(16, 16)[r]
        d = self._d(stage)[r]
        for i in range(4):
            j = LANES // 16 + 2 * i
            for jj in (2 * i, 2 * i + 1):
                sel = j == jj
                sc, _ = scale_min_k4(meta[sel, :12], jj)
                table[16 * jj + r[sel]] = d[sel] * sc
        return table

    def scales(self, stage, table, n0, kb, grp):
        if self.mode == "noaffine":
            return [table[16 * grp + LANE_G], table[16 * grp + LANE_G + 8]], None
        d = self._d(stage)
        return [d[LANE_G], d[LANE_G + 8]], None


class Q4_0Variant(BlockGemv):
    """`Q4_0Variant<Form, SC>` of csrc/q4_0_matmul.cu, the q4_0 instrument's
    variants of `BlockGemv<16>`: q4_0 payload `qs` with `scales` [N, K/32] of
    any dtype in the stage (2-byte: BlockGemv's words; f32: each row's four
    scales; form 3: none), in the dot form `form` of
    ops/qmm_variants.TC_FORMS. Forms 1-3 weigh each A fragment by its rows'
    scales (bf16(q * d), bf16(bf16 q * bf16 d), q) and sum into one
    accumulator across groups."""

    def __init__(self, qs: torch.Tensor, scales: torch.Tensor, form: int):
        self.N, self.K = qs.shape[0], 2 * qs.shape[1]
        self.bb, self.form = 16, form
        self.one_acc = form != 0
        self.qs = _np(qs).view(np.uint8)
        self.sc_dtype = scales.dtype
        raw = scales.view(torch.int16) if scales.dtype == torch.bfloat16 else scales
        self.sc = _np(raw)
        self.words = 0 if form == 3 else 4 if scales.element_size() == 4 else GV_SCALE_WORDS
        self.row_stage = self.stage_k // 32 * self.bb
        self.pitch = self.row_stage + 16
        self.scales_off = 16 * self.pitch
        self.stage_bytes = self.scales_off + 16 * self.words * 4
        self.pieces, self.groups = self.row_stage // 32, 32 // self.bb

    def copy(self, n0, kb, khi):
        stage = np.zeros(self.stage_bytes, np.uint8)
        self.copy_payload(stage, n0, kb, khi)
        if self.words == GV_SCALE_WORDS:
            self.copy_scale_words(stage, n0, kb)
        elif self.words == 4:  # f32: the row's four scales, zeros past K
            groups = self.K // 32
            raw = self.sc.view(np.uint8)
            for i in range(64):
                r, j = divmod(i, 4)
                if n0 + r < self.N and kb // 32 + j < groups:
                    src = 4 * ((n0 + r) * groups + kb // 32 + j)
                    stage[self.scales_off + 4 * i: self.scales_off + 4 * i + 4] = raw[src: src + 4]
        return stage

    def _f32(self, v: np.ndarray) -> np.ndarray:
        if self.sc_dtype == torch.bfloat16:
            return _bf16_bits_to_f32(v.view(np.uint16))
        return v.astype(np.float32)

    def scales(self, stage, table, n0, kb, grp):
        if self.words == 0:
            return [np.ones(32, np.float32)] * 2, None
        if self.words == 4:
            sc = stage[self.scales_off:].view(np.float32)
            return [sc[(LANE_G + 8 * h) * 4 + grp] for h in range(2)], None
        sc = stage[self.scales_off:].view(np.uint16)
        d = []
        for h in range(2):
            odd = ((n0 + LANE_G + 8 * h) * (self.K // 32) + kb // 32) & 1
            bits = sc[(LANE_G + 8 * h) * 2 * GV_SCALE_WORDS + odd + grp]
            d.append(self._f32(bits.view(np.float16) if self.sc_dtype == torch.float16 else bits))
        return d, None

    def weigh(self, d, a):
        """`weigh`: a[0], a[2] (row g) and a[1], a[3] (row g + 8) scaled by
        their d and rounded to bf16 (form 1: the f32 product; form 2: of
        bf16 d, exact in f32); form 3 leaves them."""
        if self.form == 3:
            return a
        out = []
        for i, reg in enumerate(a):
            dd = np.asarray(d[i & 1], np.float32)
            if self.form == 2:
                dd = _bf16_bits_to_f32(bf16_rn(dd))
            lo = (_bf16_bits_to_f32(reg & 0xFFFF) * dd).astype(np.float32)
            hi = (_bf16_bits_to_f32(reg >> 16) * dd).astype(np.float32)
            out.append(bf16_rn(lo).astype(np.uint32) | (bf16_rn(hi).astype(np.uint32) << 16))
        return out


class Q6KGemv:
    """`Q6KGemv` of csrc/q6_k_matmul.cu: a stage is one superblock, ql
    [16][144], qh [16][80], sc [16][16], the d words [16][4]; a piece is a
    half (12 ldmatrix words), a group one 16-element sub-block."""
    stage_k = gran = GV_SUPER_K
    target, slice_min = GV_SUPER_TARGET_WARPS, GV_SLICE_MIN
    group_k, steps, affine, pieces, groups, table, one_acc = 16, 1, False, 2, 8, 256, False
    ql_pitch, qh_pitch = 144, 80
    qh_off = 16 * ql_pitch
    sc_off = qh_off + 16 * qh_pitch
    d_off = sc_off + 16 * 16
    stage_bytes = d_off + 16 * 4

    @classmethod
    def stage_size(cls, fmt: str) -> int:
        return cls.stage_bytes

    def __init__(self, qt: QTensor):
        self.N, self.K = qt.shape
        self.ql = _np(qt.ql).view(np.uint8)
        self.qh = _np(qt.qh).view(np.uint8)
        self.sc = _np(qt.sc).view(np.uint8)
        self.d = _np(qt.d)

    def copy(self, n0, kb, khi):
        N, K = self.N, self.K
        nsb, sb = K // 256, kb // 256
        stage = np.zeros(self.stage_bytes, np.uint8)
        for r in range(16):
            ok = n0 + r < N
            row = n0 + r if ok else 0
            if ok:
                o, q = r * self.ql_pitch, row * (K // 2) + sb * 128
                stage[o: o + 128] = self.ql[q: q + 128]
                o, q = self.qh_off + r * self.qh_pitch, row * (K // 4) + sb * 64
                stage[o: o + 64] = self.qh[q: q + 64]
                o, q = self.sc_off + 16 * r, row * (K // 16) + sb * 16
                stage[o: o + 16] = self.sc[q: q + 16]
            o = self.d_off + 4 * r
            stage[o: o + 4] = np.frombuffer(
                _cp_half2(self.d, (row * nsb + sb) & ~1, N * nsb if ok else 0), np.uint8)
        return stage

    def prepare(self, stage, n0, kb):
        table = np.zeros(256, np.float32)
        r = LANES % 16
        dw = stage[self.d_off:].reshape(16, 4)[r].copy().view(np.float16).astype(np.float32)
        odd = ((n0 + r) * (self.K // 256) + kb // 256) & 1
        d = np.where(odd == 1, dw[:, 1], dw[:, 0])
        sc = stage[self.sc_off: self.sc_off + 256].reshape(16, 16)[r].view(np.int8)
        for i in range(8):
            j = 2 * i + LANES // 16
            table[16 * j + r] = d * sc[LANES, j].astype(np.float32)
        return table

    def load(self, stage, p):
        return (ldmatrix_x4(stage, _rows16_addr(self.ql_pitch, 64 * p))
                + ldmatrix_x4(stage, _rows16_addr(self.ql_pitch, 64 * p + 32))
                + ldmatrix_x4(stage, self.qh_off + _rows16_addr(self.qh_pitch, 32 * p)))

    @staticmethod
    def six_bits(lw, hw, t, f):
        return ((lw >> (4 * t)) & 0x0F0F0F0F) | (((hw >> (2 * f)) & 0x03030303) << 4)

    def a_frag(self, r, gi, s):
        t, p = divmod(gi, 4)
        lw, hw, f = 4 * (p // 2) + 2 * (p % 2), 8 + 2 * (p % 2), 2 * t + p // 2
        u0 = self.six_bits(r[lw], r[hw], t, f)
        u1 = self.six_bits(r[lw + 1], r[hw + 1], t, f)
        return [six_bit_pair(u0), six_bit_pair(u1), six_bit_pair(u0 >> 8), six_bit_pair(u1 >> 8)]

    def x_off(self, p, gi, s):
        return 128 * p + 16 * gi

    def scales(self, stage, table, n0, kb, grp):
        return [table[16 * grp + LANE_G], table[16 * grp + LANE_G + 8]], None


GEMV_FORMATS = {"q4_0": BlockGemv, "q8_0": BlockGemv, "q4_k": Q4KGemv, "q6_k": Q6KGemv}


def _fma(a, b, c) -> np.ndarray:
    """fmaf in f32 (the product is exact in f64)."""
    return (np.float64(1) * a * b + c).astype(np.float32)


def _sum8(v: np.ndarray) -> np.float32:
    """`sum8_bf16` of 8 f32 values (bf16 in shared memory), in its order."""
    s = [np.float32(v[2 * i] + v[2 * i + 1]) for i in range(4)]
    return np.float32(np.float32(s[0] + s[1]) + np.float32(s[2] + s[3]))


def _sum32(v: np.ndarray) -> np.float32:
    """A per-32 sum of x of either policy (bf16 x's in the kernel, `XF32::sum32`):
    four `_sum8`, pairwise."""
    return np.float32(np.float32(_sum8(v[:8]) + _sum8(v[8:16])) + np.float32(_sum8(v[16:24]) + _sum8(v[24:])))


def _quad_sum(v: np.ndarray, n: int) -> np.ndarray:
    """`XF32Packed::finish` on a lane array: lane l + v[l + 1] + ... + v[l +
    n - 1] (`__shfl_down_sync`, a lane past 31 reading its own), in f32."""
    s = v.copy()
    for q in range(1, n):
        s = (s + np.concatenate([v[q:], v[32 - q:]])).astype(np.float32)
    return s


def bf16_rn(v) -> np.ndarray:
    """f32 -> bf16 bits, round to nearest even (`__floats2bfloat162_rn` on
    finite values)."""
    b = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)


def split_bf16x3(v) -> list[np.ndarray]:
    """`XF32::split`: x as bf16 bits x0 = bf16(x), x1 = bf16(x - x0), x2 =
    bf16(x - x0 - x1), each residual exact in f32."""
    r = np.asarray(v, np.float32)
    parts = []
    for _ in range(GV_F32_PARTS):
        p = bf16_rn(r)
        parts.append(p)
        r = (r - _bf16_bits_to_f32(p)).astype(np.float32)
    return parts


def gemv(x: torch.Tensor, qt, sms: int = H100_SMS, passes: int = GV_F32_PARTS) -> np.ndarray:
    """`launch_dq_gemv` on x [M, K] (1 <= M <= 8) and qt of any format,
    through its functor (`GEMV_FORMATS`), or through a functor given in its
    place (the instruments' `Q4KAblation`, `Q4_0Variant`; bf16 x): y f32
    [M, N]. bf16 x takes the `XBf16` policy; f32 x `XF32` (the three-part
    split, its slice, the per-32 sums of the f32 x; at M <= 2 `XF32Packed`,
    the parts as columns of one product summed into quad lane 0 at the end),
    the products of its first `passes` parts only (fewer than 3 drops the
    smallest)."""
    F = GEMV_FORMATS[qt.fmt](qt) if isinstance(qt, QTensor) else qt
    M, K = x.shape
    N = F.N
    assert 1 <= M <= 8 and x.dtype in (torch.bfloat16, torch.float32) and K % F.gran == 0
    assert isinstance(qt, QTensor) or x.dtype == torch.bfloat16
    if x.dtype == torch.bfloat16:
        parts, used = 1, 1
        planes = [x.contiguous().view(torch.int16).numpy().view(np.uint16)]
    else:
        parts, used = GV_F32_PARTS, passes
        planes = split_bf16x3(x.contiguous().numpy())
    packed = parts > 1 and M <= 2
    xrows = gemv_x_rows(M)
    # column g's row: part g // 2 of x row g % 2 (packed), else x row g (the
    # zero row past M; at M = 1 x itself)
    if packed:
        col_plane, col_row = np.minimum(LANE_G // 2, parts - 1), np.minimum(LANE_G % 2, xrows - 1)
    else:
        col_plane, col_row = np.zeros_like(LANE_G), np.minimum(LANE_G, xrows - 1)
    steps_parts = [0] if packed else list(reversed(range(used)))  # the mma of a k16 step
    sl, splits = gemv_plan(M, N, K, sms, F.gran, F.target, F.slice_min,
                           gemv_slice_max(M, getattr(qt, "fmt", None), parts))
    g, t = LANE_G, LANE_T
    work = np.zeros((splits, M, N), np.float32)
    for z in range(splits):
        klo, khi = z * sl, min(K, (z + 1) * sl)
        # the x slice, a plane a part; row M (2 <= M < 8): zeros
        xs = np.zeros((parts, gemv_x_rows(M), sl + 16), np.uint16)
        for q in range(parts):
            for r in range(M):
                for c in range(sl // 8):
                    if klo + 8 * c < khi:
                        xs[q, r, 8 * c: 8 * c + 8] = planes[q][r, klo + 8 * c: klo + 8 * c + 8]
        xflat = xs.reshape(parts, -1)
        xsum = np.zeros((sl // 32, 8), np.float32)
        if F.affine:
            xf = _bf16_bits_to_f32(xs[0])
            for q in range(1, parts):  # the f32 x: (x0 + x1) + x2, exact
                xf = (xf + _bf16_bits_to_f32(xs[q])).astype(np.float32)
            for grp in range(sl // 32):
                for m in range(M):
                    xsum[grp, m] = _sum32(xf[m, 32 * grp: 32 * grp + 32])
        for n0 in range(0, N, 16):
            acc = [np.zeros(32, np.float32) for _ in range(4)]
            for st in range(-(-(khi - klo) // F.stage_k)):
                kb = klo + st * F.stage_k
                stage = F.copy(n0, kb, khi)
                table = F.prepare(stage, n0, kb)
                for p in range(F.pieces):  # compute(st)
                    r4 = F.load(stage, p)
                    for gi in range(F.groups):
                        grp = p * F.groups + gi
                        if F.gran < F.stage_k and kb + F.group_k * grp >= khi:
                            break
                        if F.one_acc:  # the weighed fragments straight into acc
                            d, _ = F.scales(stage, table, n0, kb, grp)
                            for s in range(F.steps):
                                a = F.weigh(d, F.a_frag(r4, gi, s))
                                xo = col_row * (sl + 16) + (kb - klo) + 4 * t + F.x_off(p, gi, s)
                                xw = xflat[col_plane[:, None], xo[:, None] + np.arange(4)].astype(np.uint32)
                                lo, hi = xw[:, 0] | (xw[:, 1] << 16), xw[:, 2] | (xw[:, 3] << 16)
                                acc = mma_16816(acc, a, byte_perm(lo, hi, 0x5410), byte_perm(lo, hi, 0x7632))
                            continue
                        f = [np.zeros(32, np.float32) for _ in range(4)]
                        for s in range(F.steps):
                            a = F.a_frag(r4, gi, s)
                            xo = col_row * (sl + 16) + (kb - klo) + 4 * t + F.x_off(p, gi, s)
                            for q in steps_parts:  # smallest part first
                                xw = xflat[(col_plane + q)[:, None], xo[:, None] + np.arange(4)].astype(np.uint32)
                                lo, hi = xw[:, 0] | (xw[:, 1] << 16), xw[:, 2] | (xw[:, 3] << 16)
                                f = mma_16816(f, a, byte_perm(lo, hi, 0x5410), byte_perm(lo, hi, 0x7632))
                        d, off = F.scales(stage, table, n0, kb, grp)
                        acc = [_fma(d[0], f[0], acc[0]), _fma(d[0], f[1], acc[1]),
                               _fma(d[1], f[2], acc[2]), _fma(d[1], f[3], acc[3])]
                        if F.affine:
                            xg = xsum[(kb - klo) // 32 + grp]
                            x0, x1 = xg[2 * t], xg[2 * t + 1]
                            acc = [_fma(off[0], x0, acc[0]), _fma(off[0], x1, acc[1]),
                                   _fma(off[1], x0, acc[2]), _fma(off[1], x1, acc[3])]
            if packed:  # `finish`: quad lane 0 sums the parts, (x0 + x1) + x2
                acc = [_quad_sum(v, used) for v in acc]
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


# ---------------------------------------------------------------------------
# The f32 route's TF32 tile (csrc/dq_tile_tf32.cuh) of every format
# ---------------------------------------------------------------------------
TF_BM, TF_BK, TF_LD, TF_STAGES, TF_WARPS = 64, 64, 80, 3, 8  # kTfBM, kTfBK, kTfLd, kTfStages, kTfThreads / 32
TF_TWO_BLOCK_SMEM = 113 * 1024  # kTfTwoBlockSmem
TF_MAX_SPLITS, TF_MIN_SPLIT_STEPS = 16, 2  # kTfMaxSplits, kTfMinSplitSteps


def tf32_rna(v) -> np.ndarray:
    """`tf32_rna` (`cvt.rna.tf32.f32` on finite values): f32 rounded to 10
    mantissa bits, nearest with ties away from zero (the low 13 bits
    cleared), as f32."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(v) -> tuple[np.ndarray, np.ndarray]:
    """`split_tf32`: (hi, lo) = (tf32(v) rounded, v - hi truncated to TF32);
    v - hi is exact in f32."""
    hi = tf32_rna(v)
    lo = (np.asarray(v, np.float32) - hi).view(np.uint32) & np.uint32(0xFFFFE000)
    return hi, lo.view(np.float32)


def mma_1688_tf32(c: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """mma.sync m16n8k8 row.col f32.tf32.tf32.f32 over lanes, every (m16
    tile, n8 tile) pair at once: a [R, 32, 4], b [J, 32, 2] f32 registers
    (exact TF32 values), c [R, J, 32, 4] f32, through the PTX layouts: lane
    (g, t) holds A[g (+8)][t (+4)] (a0 = (g, t), a1 = (g + 8, t), a2 = (g, t
    + 4), a3 = (g + 8, t + 4)), B[t (+4)][g], C[g (+8)][2t + {0, 1}]. The
    products are exact; each mma adds its sum of eight to c in one f32
    rounding."""
    R, J = a.shape[0], b.shape[0]
    A = np.zeros((R, 16, 8), np.float64)
    B = np.zeros((J, 8, 8), np.float64)
    for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
        A[:, LANE_G + dr, LANE_T + dk] = a[:, :, reg]
    for reg, dk in enumerate((0, 4)):
        B[:, LANE_T + dk, LANE_G] = b[:, :, reg]
    C = np.einsum("rmk,jkn->rjmn", A, B)
    out = np.empty_like(c)
    for reg, (dr, dn) in enumerate(((0, 0), (0, 1), (8, 0), (8, 1))):
        out[..., reg] = (c[..., reg] + C[:, :, LANE_G + dr, 2 * LANE_T + dn]).astype(np.float32)
    return out


def tf_x_off(r, c):
    """Float offset of 16-byte chunk c of row r in an x stage (kTfLd a row)."""
    return r * TF_LD + 4 * c


def _bytes_minus(w: np.ndarray, bias: float) -> np.ndarray:
    """`bytes_minus`: the four bytes of each word less `bias`, [..., 4] f32."""
    return np.stack([byte_perm(w, 0x4B000000, 0x7650 + i).view(np.float32)
                     - np.float32(8388608 + bias) for i in range(4)], axis=-1)


class Q4KTf32:
    """`Q4KTf32` of csrc/q4_k_matmul.cu on `Q4KTile`'s raw step: qs [0, 32),
    the 12-byte table [32, 44), d, dmin [44, 48)."""
    raw, group_units, affine = 48, 2, True

    def __init__(self, qt: QTensor):
        self.N, self.K = qt.shape
        self.qs = _np(qt.qs).view(np.uint8).reshape(self.N, self.K // 2)
        self.tab = _np(qt.scales).view(np.uint8).reshape(self.N, -1, 12)
        self.dm = _np(qt.dm).view(np.uint8).reshape(self.N, -1, 4)

    def copy(self, rows: int, k0: int) -> np.ndarray:
        """`Q4KTile::copy` of every row of the step at k0 ([rows, 48]; rows
        past N zero-filled)."""
        out = np.zeros((rows, self.raw), np.uint8)
        n, sb = min(rows, self.N), k0 // 256
        out[:n, :32] = self.qs[:n, sb * 128 + (k0 % 256) // 2: sb * 128 + (k0 % 256) // 2 + 32]
        out[:n, 32:44] = self.tab[:n, sb]
        out[:n, 44:48] = self.dm[:n, sb]
        return out

    def prepare(self, raw: np.ndarray, n0: int, k0: int) -> tuple[np.ndarray, np.ndarray]:
        """(d*sc [2, rows], offsets 8 d*sc - dmin*mn [2, rows]) of the step's
        two 32-groups."""
        dm = raw[:, 44:48].copy().view(np.float16).astype(np.float32)
        sc, off = [], []
        for grp in range(2):
            s, mn = scale_min_k4(raw[:, 32:44], 2 * ((k0 % 256) // 64) + grp)
            dsc = (dm[:, 0] * s).astype(np.float32)
            sc.append(dsc)
            off.append(_fma(-dm[:, 1], mn, np.float32(8) * dsc))
        return np.stack(sc), np.stack(off)

    def weights(self, raw: np.ndarray, k0: int, u: int) -> np.ndarray:
        """Lane t's four weights 16u + 4t .. + 3 of each row: [rows, 4 (t), 4]."""
        w = raw[:, 16 * (u % 2): 16 * (u % 2) + 16].copy().view(np.uint32)  # [rows, 4]
        return _bytes_minus((w >> (4 * (u // 2))) & 0x0F0F0F0F, 8)


class Q6KTf32:
    """`Q6KTf32` of csrc/q6_k_matmul.cu on `Q6KTile`'s raw step: ql [0, 64),
    qh [64, 96), the sc word [96, 100), the d word [100, 104)."""
    raw, group_units, affine = 112, 1, False

    def __init__(self, qt: QTensor):
        self.N, self.K = qt.shape
        self.ql = _np(qt.ql).view(np.uint8).reshape(self.N, self.K // 2)
        self.qh = _np(qt.qh).view(np.uint8).reshape(self.N, self.K // 4)
        self.sc = _np(qt.sc).view(np.uint8).reshape(self.N, self.K // 16)
        self.d = np.concatenate([_np(qt.d), np.zeros(1, np.float16)])  # a word may end past it

    def copy(self, rows: int, k0: int) -> np.ndarray:
        out = np.zeros((rows, self.raw), np.uint8)
        n, sb = min(rows, self.N), k0 // 256
        h, t = (k0 % 256) // 128, (k0 % 128) // 64
        out[:n, :64] = self.ql[:n, sb * 128 + 64 * h: sb * 128 + 64 * h + 64]
        out[:n, 64:96] = self.qh[:n, sb * 64 + 32 * h: sb * 64 + 32 * h + 32]
        out[:n, 96:100] = self.sc[:n, sb * 16 + 8 * h + 4 * t: sb * 16 + 8 * h + 4 * t + 4]
        idx = (np.arange(n) * (self.K // 256) + sb) & ~1
        out[:n, 100:104] = np.stack([self.d[idx], self.d[idx + 1]], 1).view(np.uint8)
        return out

    def prepare(self, raw: np.ndarray, n0: int, k0: int) -> tuple[np.ndarray, None]:
        dw = raw[:, 100:104].copy().view(np.float16).astype(np.float32)
        odd = ((n0 + np.arange(len(raw))) * (self.K // 256) + k0 // 256) & 1
        d = np.where(odd == 1, dw[:, 1], dw[:, 0])
        sc = raw[:, 96:100].view(np.int8).astype(np.float32)
        return (d[None] * sc.T).astype(np.float32), None

    def weights(self, raw: np.ndarray, k0: int, u: int) -> np.ndarray:
        t64 = (k0 % 128) // 64
        lw = raw[:, 16 * u: 16 * u + 16].copy().view(np.uint32)
        hw = raw[:, 64 + 16 * (u % 2): 64 + 16 * (u % 2) + 16].copy().view(np.uint32)
        q = ((lw >> (4 * t64)) & 0x0F0F0F0F) | (((hw >> (4 * t64 + 2 * (u // 2))) & 0x03030303) << 4)
        return _bytes_minus(q, 32)


class BlockTf32:
    """The f32 tile's functors of q4_0 and q8_0 (`Q4_0Tf32`, `Q8_0Tf32`) on
    their bf16 tiles' raw step (`Q4_0Tile`, `Q8_0Tile`): the two blocks'
    payload [0, 2 bb) (zeros past K: the half step), the two aligned f16
    words that hold their scales [2 bb, 2 bb + 8)."""
    bb = 0  # payload bytes of a 32-block
    group_units, affine = 2, False

    def __init__(self, qt: QTensor):
        self.N, self.K = qt.shape
        self.qs = _np(qt.qs).view(np.uint8).reshape(self.N, self.K // 32 * self.bb)
        self.scales = np.concatenate([_np(qt.scales).reshape(-1), np.zeros(4, np.float16)])

    def copy(self, rows: int, k0: int) -> np.ndarray:
        """The tile's `copy` of every row of the step at k0 ([rows, raw];
        rows past N, and the block past K, zero-filled; a scale word past
        the end of the array reads zeros, one that ends it only its low
        half)."""
        bb = self.bb
        out = np.zeros((rows, self.raw), np.uint8)
        n, total = min(rows, self.N), self.N * (self.K // 32)
        for blk in range(2):
            if k0 + 32 * blk < self.K:
                src = (k0 // 32 + blk) * bb
                out[:n, bb * blk: bb * blk + bb] = self.qs[:n, src: src + bb]
        h0 = (np.arange(n) * (self.K // 32) + k0 // 32) & ~1
        for j in range(2):
            h = h0 + 2 * j
            word = np.stack([np.where(h < total, self.scales[h], 0),
                             np.where(h + 1 < total, self.scales[h + 1], 0)], 1).astype(np.float16)
            out[:n, 2 * bb + 4 * j: 2 * bb + 4 * j + 4] = word.view(np.uint8)
        return out

    def prepare(self, raw: np.ndarray, n0: int, k0: int) -> tuple[np.ndarray, None]:
        """(d [2, rows] of the step's two blocks, 0 past K; no offsets)."""
        d = raw[:, 2 * self.bb: 2 * self.bb + 8].copy().view(np.float16).astype(np.float32)  # [rows, 4]
        r = np.arange(len(raw))
        odd = ((n0 + r) * (self.K // 32) + k0 // 32) & 1
        return np.stack([d[r, odd + grp] if k0 + 32 * grp < self.K else np.zeros(len(raw), np.float32)
                         for grp in range(2)]).astype(np.float32), None


class Q4_0Tf32(BlockTf32):
    """`Q4_0Tf32` of csrc/q4_0_matmul.cu: raw 48 bytes a row (payload [0, 32),
    scale words [32, 40)); unit u is nibble u % 2 of block u // 2."""
    bb, raw = 16, 48

    def weights(self, raw: np.ndarray, k0: int, u: int) -> np.ndarray:
        """The nibbles of the payload word at 16 (u // 2) + 4t, less 8."""
        w = raw[:, 16 * (u // 2): 16 * (u // 2) + 16].copy().view(np.uint32)  # [rows, 4]
        return _bytes_minus((w >> (4 * (u % 2))) & 0x0F0F0F0F, 8)


class Q8_0Tf32(BlockTf32):
    """`Q8_0Tf32` of csrc/q8_0_matmul.cu: raw 80 bytes a row (payload [0, 64),
    scale words [64, 72)); unit u is payload bytes 16u .. 16u + 15."""
    bb, raw = 32, 80

    def weights(self, raw: np.ndarray, k0: int, u: int) -> np.ndarray:
        """The payload word at 16u + 4t, sign bits flipped, less 128."""
        w = raw[:, 16 * u: 16 * u + 16].copy().view(np.uint32) ^ np.uint32(0x80808080)
        return _bytes_minus(w, 128)


TF32_FORMATS = {"q4_0": Q4_0Tf32, "q8_0": Q8_0Tf32, "q4_k": Q4KTf32, "q6_k": Q6KTf32}


def tf32_plan(fmt: str, M: int, N: int, K: int, sms: int = H100_SMS) -> tuple[int, int]:
    """`dq_tile_tf32_plan`: (BN, K splits) at (M, N, K): 128-wide tiles at
    N >= 1024 where two blocks fit an SM; K split only where the grid holds
    fewer than two blocks an SM, by the fewest rounds x (steps a split + 2)."""
    F = TF32_FORMATS[fmt]
    smem = (TF_STAGES * TF_BM * TF_LD * 4 + TF_STAGES * 128 * F.raw + 2 * 4 * 128 * 4
            + (2 * 2 * 128 * 4 + 2 * TF_BM * 2 * 4 if F.affine else 0))
    bn = 128 if N >= 1024 and smem <= TF_TWO_BLOCK_SMEM else 64
    steps = -(-K // TF_BK)
    tiles, slots = -(-M // TF_BM) * -(-N // bn), 2 * sms
    splits = 1
    if tiles >= slots:  # two blocks an SM or more: unsplit
        return bn, splits
    best, z = steps + 2, 2  # the fewest rounds x (steps a split + 2)
    while z <= TF_MAX_SPLITS and steps % z == 0 and steps // z >= TF_MIN_SPLIT_STEPS:
        cost = -(-tiles * z // slots) * (steps // z + 2)
        if cost < best:
            best, splits = cost, z
        z *= 2
    return bn, splits


def tile_tf32(x: torch.Tensor, qt: QTensor, sms: int = H100_SMS, passes: int = 2) -> np.ndarray:
    """`launch_dq_tile_tf32` on f32 x [M, K] (M > 8) and a weight of any
    format: y f32 [M, N]. Every block of the grid at once, a K-step at
    a time: the x stage at its padded offsets (zeros past K: a K of an odd
    count of 32-blocks ends on a half step), the functor's raw bytes,
    its scale table (and q4_k's offsets and per-32 sums of x), each 16-wide
    unit's A fragments (16-byte loads of rows g and g + 8, split into hi and
    lo) and B fragments (the functor's words), the two k8 steps' mma in
    fragment order (lo, then hi; `passes=1` leaves out lo), each group's
    fragment scaled into the accumulators, the affine part, then the K
    splits summed in order."""
    F = TF32_FORMATS[qt.fmt](qt)
    M, K = x.shape
    N = qt.shape[0]
    assert M > 8 and x.dtype == torch.float32 and K % 32 == 0
    bn, splits = tf32_plan(qt.fmt, M, N, K, sms)
    Mp, Np = -(-M // TF_BM) * TF_BM, -(-N // bn) * bn
    R, J = Mp // 16, Np // 8
    steps = -(-K // TF_BK) // splits
    xp = np.zeros((Mp, steps * splits * TF_BK), np.float32)  # cp.async's zero fill past M and K
    xp[:M, :K] = x.numpy()
    r_idx = np.arange(Mp)
    work = np.zeros((splits, M, N), np.float32)
    for z in range(splits):
        acc = np.zeros((R, J, 32, 4), np.float32)
        for st in range(steps):
            k0 = (z * steps + st) * TF_BK
            # the x stage of every row block: [Mp, 64] at tf_x_off
            xs = np.zeros((Mp // TF_BM, TF_BM * TF_LD), np.float32)
            rr = r_idx % TF_BM
            for c in range(TF_BK // 4):
                off = tf_x_off(rr, c)[:, None] + np.arange(4)
                xs[(r_idx // TF_BM)[:, None], off] = xp[:, k0 + 4 * c: k0 + 4 * c + 4]
            raw = F.copy(Np, k0)
            scale, offs = F.prepare(raw, 0, k0)
            if F.affine:  # each row's sums over the two 32-groups, the kernel's order
                xsum = np.zeros((Mp, 2), np.float32)
                for gq in range(2):
                    s = []
                    for q in range(4):
                        a, b = (xs[(r_idx // TF_BM)[:, None], tf_x_off(rr, 8 * gq + 2 * q + h)[:, None]
                                   + np.arange(4)] for h in range(2))
                        s.append(((a[:, 0] + a[:, 1]) + (a[:, 2] + a[:, 3]))
                                 + ((b[:, 0] + b[:, 1]) + (b[:, 2] + b[:, 3])))
                    xsum[:, gq] = (s[0] + s[1]) + (s[2] + s[3])
            part = None
            for u in range(4):
                if u % F.group_units == 0:
                    part = np.zeros_like(acc)
                # B: lane (g, t) of n8 tile j reads row 8j + g's four weights
                wv = F.weights(raw, k0, u)  # [Np, 4 (t), 4]
                bw = wv[(8 * np.arange(J))[:, None] + LANE_G[None], LANE_T[None]]  # [J, 32, 4]
                # A: lane (g, t) of m16 tile i reads rows 16i + g and + 8 at chunk 4u + t
                rows = (16 * np.arange(R))[:, None] + LANE_G[None]  # [R, 32]
                v0, v1 = (xs[(rw // TF_BM)[..., None], tf_x_off(rw % TF_BM, 4 * u + LANE_T)[..., None]
                             + np.arange(4)] for rw in (rows, rows + 8))  # [R, 32, 4]
                for s in range(2):
                    a = np.stack([v0[..., 2 * s], v1[..., 2 * s], v0[..., 2 * s + 1],
                                  v1[..., 2 * s + 1]], -1)
                    hi, lo = split_tf32(a)
                    b = bw[..., 2 * s: 2 * s + 2]
                    if passes == 2:
                        part = mma_1688_tf32(part, lo, b)
                    part = mma_1688_tf32(part, hi, b)
                if u % F.group_units == F.group_units - 1:
                    grp = u // F.group_units
                    col = (8 * np.arange(J))[:, None] + 2 * LANE_T[None]  # [J, 32]
                    for reg in range(4):
                        d = scale[grp][col + reg % 2][None]
                        acc[..., reg] = _fma(d, part[..., reg], acc[..., reg])
            if F.affine:
                col = (8 * np.arange(J))[:, None] + 2 * LANE_T[None]
                for reg in range(4):
                    row = (16 * np.arange(R))[:, None] + LANE_G[None] + 8 * (reg // 2)  # [R, 32]
                    o0, o1 = offs[0][col + reg % 2][None], offs[1][col + reg % 2][None]
                    s0, s1 = xsum[row, 0][:, None], xsum[row, 1][:, None]
                    acc[..., reg] = _fma(s1, o1, _fma(s0, o0, acc[..., reg]))
        for reg in range(4):
            m = (16 * np.arange(R))[:, None] + LANE_G[None] + 8 * (reg // 2)  # [R, 32]
            n = (8 * np.arange(J))[:, None] + 2 * LANE_T[None] + reg % 2  # [J, 32]
            mm = np.broadcast_to(m[:, None], acc.shape[:3])
            nn = np.broadcast_to(n[None], acc.shape[:3])
            ok = (mm < M) & (nn < N)
            work[z, mm[ok], nn[ok]] = acc[..., reg][ok]
    y = work[0].copy()
    for z in range(1, splits):
        y += work[z]
    return y


# constants of csrc/flash_attention.cu (kFlashTargetBlocks, FlashBf16) and
# csrc/decode_tc.cuh (kDecWarps, DecodeTc::kPLd)
FLASH_TARGET_BLOCKS = 99
DEC_WARPS, P_LD = 4, 24
MASK_VALUE = np.float32(-0.7 * np.finfo(np.float32).max)  # gt::kMaskValue
INT_MAX = 2**31 - 1
_F32 = np.float32


def _bits(x: torch.Tensor) -> np.ndarray:
    """The uint16 bits of a bf16 tensor."""
    return x.contiguous().view(torch.int16).numpy().view(np.uint16)


def _to_bf16_bits(v) -> np.ndarray:
    """f32 values rounded to bf16 (nearest even), as uint16 bits."""
    t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def _bf16_round(v) -> np.ndarray:
    return _bf16_bits_to_f32(_to_bf16_bits(v))


def _pack(lo, hi) -> np.ndarray:
    """`pack_bf16`: two f32 arrays rounded to a bf16x2 word each."""
    return _to_bf16_bits(lo).astype(np.uint32) | (_to_bf16_bits(hi).astype(np.uint32) << 16)


def _word(h: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """The bf16x2 word of elements idx, idx + 1 of uint16 bits h."""
    return h[idx].astype(np.uint32) | (h[idx + 1].astype(np.uint32) << 16)


def _quad(x: np.ndarray, op) -> np.ndarray:
    """op over the 4 lanes of each quad (a C fragment's row), per lane."""
    return np.repeat(op(x.reshape(8, 4), axis=1), 4)


def _col(x: np.ndarray, op) -> np.ndarray:
    """op over the 8 lanes of each t (a C fragment's column), per lane."""
    return np.tile(op(x.reshape(8, 4), axis=0), 8)


def _key_valid(s, pos, limit: int, window: int) -> np.ndarray:
    ok = (pos >= 0) & (s <= pos) & (s < limit)
    return ok & (s > pos - window) if window > 0 else ok


def flash_shape(B: int, Hkv: int, T: int, G: int) -> tuple[int, int]:
    """`flash_tc_shape`: (row warps, key groups) of a 4-warp block: the most
    row warps whose grid holds FLASH_TARGET_BLOCKS blocks."""
    for r in (4, 2):
        if B * Hkv * -(-(T * G) // (16 * r)) >= FLASH_TARGET_BLOCKS:
            return r, 4 // r
    return 1, 4


def flash_tile_keys(D: int, H: int) -> int:
    """`FlashBf16::kBK`: keys a warp's tile."""
    return (64 if D == 256 else 128) // (2 if H == 1 else H)


def _flash_ranges(pos_b, r0: int, R: int, rows: int, G: int, limit: int, window: int, SK: int):
    """A flash block's rows and live keys, as the kernel's skeleton forms them:
    each row warp's lanes' packed rows (g, g + 8) and their positions (-1
    past the rows), its live key range [lo, hi], the block's last live key,
    and the ring's first key and step count over stages of SK keys."""
    wpos, wlo, whi = [], [], []  # of each row warp
    for rw in range(R):
        prs = (r0 + rw * 16 + LANE_G, r0 + rw * 16 + LANE_G + 8)
        ps = [np.where(pr < rows, pos_b[np.minimum(pr, rows - 1) // G], -1) for pr in prs]
        hi_ = int(max(ps[0].max(), ps[1].max()))
        lo_ = INT_MAX if hi_ < 0 else (
            max(0, int(np.concatenate([p_[p_ >= 0] for p_ in ps]).min()) - window + 1)
            if window > 0 else 0)
        wpos.append((prs, ps))
        wlo.append(lo_)
        whi.append(min(hi_, limit - 1))
    lo, hi = min(wlo), max(whi)
    s_beg = lo // SK * SK if hi >= lo else 0
    nst = -(-(hi + 1 - s_beg) // SK) if hi >= lo else 0
    return wpos, wlo, whi, hi, s_beg, nst


def flash(q, k, v, positions, kv_limit, softcap: float = 0.0, window: int = 0,
          row_warps: int = 0) -> np.ndarray:
    """`flash_mma_kernel` with `FlashBf16` on bf16 q [B, T, Hq, D] and k/v
    [B, Hkv, S, D] (positions [B, T], kv_limit [B]): out [B, T, Hq, D] as
    f32 (bf16 values). row_warps: 0 for the plan, or 1, 2, 4."""
    B, T, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    R, H = flash_shape(B, Hkv, T, G) if not row_warps else (row_warps, 4 // row_warps)
    BK = flash_tile_keys(D, H)
    SK, ld, nrows, rows = BK * H, D + 8, 16 * R, T * G
    qb, kb, vb = _bits(q), _bits(k), _bits(v)
    pos_all, lims = positions.to(torch.int32).numpy(), kv_limit.to(torch.int32).numpy()
    lanes, t = np.arange(32), LANE_T
    k_off = nrows * ld  # uint16 offsets: Q [nrows][ld], K [2][SK][ld], V [2][SK][ld]
    v_off = k_off + 2 * SK * ld
    nblk = -(-rows // nrows)
    out = np.zeros((B, T, Hq, D), np.float32)
    for b, hk, bx in np.ndindex(B, Hkv, nblk):
        limit = min(int(lims[b]), S)
        r0 = (nblk - 1 - bx) * nrows  # latest rows first
        smem = np.zeros(2 * (v_off + 2 * SK * ld), np.uint8)
        h = smem.view(np.uint16)
        for r in range(min(nrows, rows - r0)):
            h[r * ld: r * ld + D] = qb[b, (r0 + r) // G, hk * G + (r0 + r) % G]
        wpos, wlo, whi, hi, s_beg, nst = _flash_ranges(pos_all[b], r0, R, rows, G, limit, window, SK)
        acc = [dict(o=[[np.zeros(32, _F32) for _ in range(4)] for _ in range(D // 8)],
                    m=[np.full(32, -np.inf, _F32) for _ in range(2)],
                    l=[np.zeros(32, _F32) for _ in range(2)]) for _ in range(R * H)]
        for i in range(nst):
            st = i % 2
            for j in range(SK):  # issue(i): keys past hi zero-filled
                key = s_beg + i * SK + j
                ko, vo = k_off + (st * SK + j) * ld, v_off + (st * SK + j) * ld
                h[ko: ko + D] = kb[b, hk, key] if key <= hi else 0
                h[vo: vo + D] = vb[b, hk, key] if key <= hi else 0
            for w in range(R * H):
                rw, kg = w % R, w // R
                s0 = s_beg + i * SK + kg * BK
                if s0 > whi[rw] or s0 + BK - 1 < wlo[rw]:
                    continue
                a_ = acc[w]
                kt, vt = k_off + (st * SK + kg * BK) * ld, v_off + (st * SK + kg * BK) * ld
                sc = [[np.zeros(32, _F32) for _ in range(4)] for _ in range(BK // 8)]
                for kk in range(D // 16):
                    a = ldmatrix_x4(smem, 2 * ((rw * 16 + lanes % 16) * ld + kk * 16 + (lanes // 16) * 8))
                    for n2 in range(BK // 16):
                        bk = ldmatrix_x4(smem, 2 * (kt + (n2 * 16 + (lanes // 16) * 8 + lanes % 8) * ld
                                                    + kk * 16 + ((lanes // 8) % 2) * 8))
                        sc[2 * n2] = mma_16816(sc[2 * n2], a, bk[0], bk[1])
                        sc[2 * n2 + 1] = mma_16816(sc[2 * n2 + 1], a, bk[2], bk[3])
                pos = wpos[rw][1]
                valid = {}
                mx = [np.full(32, MASK_VALUE, _F32) for _ in range(2)]
                for n in range(BK // 8):
                    for e in range(4):
                        key = s0 + n * 8 + 2 * t + (e & 1)
                        x = sc[n][e]
                        if softcap > 0:
                            x = (_F32(softcap) * np.tanh(x / _F32(softcap))).astype(_F32)
                        ok = _key_valid(key, pos[e // 2], limit, window)
                        valid[n, e] = ok
                        sc[n][e] = np.where(ok, x, MASK_VALUE).astype(_F32)
                        mx[e // 2] = np.maximum(mx[e // 2], sc[n][e])
                mn = [np.maximum(a_["m"][r], _quad(mx[r], np.max)) for r in range(2)]
                al = [np.exp(a_["m"][r] - mn[r]).astype(_F32) for r in range(2)]
                a_["m"] = mn
                psum = [np.zeros(32, _F32) for _ in range(2)]
                pa = []
                for n in range(BK // 8):
                    pn = [np.where(valid[n, e], np.exp(sc[n][e] - mn[e // 2]), 0).astype(_F32)
                          for e in range(4)]
                    psum[0] += pn[0] + pn[1]
                    psum[1] += pn[2] + pn[3]
                    pa.append((_pack(pn[0], pn[1]), _pack(pn[2], pn[3])))
                a_["l"] = [a_["l"][r] * al[r] + psum[r] for r in range(2)]
                o = a_["o"]
                for n in range(D // 8):
                    o[n] = [o[n][0] * al[0], o[n][1] * al[0], o[n][2] * al[1], o[n][3] * al[1]]
                for kk in range(BK // 16):
                    a = [pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0], pa[2 * kk + 1][1]]
                    for dp in range(D // 16):
                        bv = ldmatrix_x4_trans(smem, 2 * (vt + (kk * 16 + ((lanes // 8) % 2) * 8 + lanes % 8) * ld
                                                          + dp * 16 + (lanes // 16) * 8))
                        o[2 * dp] = mma_16816(o[2 * dp], a, bv[0], bv[1])
                        o[2 * dp + 1] = mma_16816(o[2 * dp + 1], a, bv[2], bv[3])
        for rw in range(R):
            a_ = acc[rw]  # key group 0 merges groups 1.. in order
            for kg in range(1, H):
                o_ = acc[kg * R + rw]
                for r in range(2):
                    m, hm = a_["m"][r], o_["m"][r]
                    mn = np.maximum(m, hm)
                    wa = np.where(m == -np.inf, 0, np.exp(m - np.where(mn == -np.inf, 0, mn))).astype(_F32)
                    wb = np.where(hm == -np.inf, 0, np.exp(hm - np.where(mn == -np.inf, 0, mn))).astype(_F32)
                    a_["l"][r] = a_["l"][r] * wa + o_["l"][r] * wb
                    for n in range(D // 8):
                        for e in (2 * r, 2 * r + 1):
                            a_["o"][n][e] = a_["o"][n][e] * wa + o_["o"][n][e] * wb
                    a_["m"][r] = mn
            for r in range(2):
                lsum = _quad(a_["l"][r], np.sum)
                inv = np.where(lsum == 0, _F32(1), _F32(1) / np.where(lsum == 0, 1, lsum)).astype(_F32)
                pr = wpos[rw][0][r]
                m = pr < rows
                tt, hh = pr[m] // G, hk * G + pr[m] % G
                for n in range(D // 8):
                    for e in range(2):
                        out[b, tt, hh, n * 8 + 2 * t[m] + e] = _bf16_round(a_["o"][n][2 * r + e][m] * inv[m])
    return out



def flash_tf32_tile_keys(D: int, H: int) -> int:
    """`FlashTf32::kBK`: keys a warp's tile (a ring stage: 32 keys at
    D = 256, 64 at D = 128)."""
    return (32 if D == 256 else 64) // H


TF32_3X = ("lo.hi", "hi.lo", "hi.hi")  # `mma_3xtf32`'s products, in its order


def mma_3xtf32(c: np.ndarray, a: np.ndarray, b: np.ndarray, passes=TF32_3X) -> np.ndarray:
    """`mma_3xtf32`: c += a . b with both operands split by `split_tf32`
    into (hi, lo), as the products `passes` names, in order
    (`mma_1688_tf32`'s layouts): the kernel's lo.hi, hi.lo, then hi.hi;
    ("hi.hi",) rounds each operand once to TF32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    parts = {"lo.hi": (al, bh), "hi.lo": (ah, bl), "hi.hi": (ah, bh)}
    for name in passes:
        c = mma_1688_tf32(c, *parts[name])
    return c


def flash_tf32(q, k, v, positions, kv_limit, softcap: float = 0.0, window: int = 0,
               row_warps: int = 0, passes=(TF32_3X, TF32_3X)) -> np.ndarray:
    """`flash_mma_kernel` with `FlashTf32` on f32 q [B, T, Hq, D] and k/v
    [B, Hkv, S, D] (positions [B, T], kv_limit [B]): out [B, T, Hq, D] f32. The blocks,
    rows, ring stages, tile skips, softmax and merge of `flash`; Q and K in
    shared memory at pitch D + 16, V at D + 4; S = Q K^T as m16n8k8 TF32
    fragments, a lane's A values (rows g, g + 8) and B values (key row g of
    each n8 tile) one 16-byte load each at chunk t of every 16-wide unit u
    of D, k8 step s taking its elements 2s and 2s + 1; P's A fragment the
    C fragment (c0, c2, c1, c3: slots t and t + 4 are keys 2t and 2t + 1),
    V's B values rows 2t and 2t + 1 at column g of every n8 tile of D;
    every product in 3xTF32 (`mma_3xtf32`; `passes`: the products of S and
    of P . V, to drop one for an ablation)."""
    B, T, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    R, H = flash_shape(B, Hkv, T, G) if not row_warps else (row_warps, 4 // row_warps)
    BK = flash_tf32_tile_keys(D, H)
    SK, ld, ldv, nrows, rows = BK * H, D + 16, D + 4, 16 * R, T * G
    NT, DT = BK // 8, D // 8
    qf, kf, vf = (x.to(torch.float32).numpy() for x in (q, k, v))
    pos_all, lims = positions.to(torch.int32).numpy(), kv_limit.to(torch.int32).numpy()
    g, t = LANE_G, LANE_T
    k_off = nrows * ld  # float offsets: Q [nrows][ld], K [2][SK][ld], V [2][SK][ldv]
    v_off = k_off + 2 * SK * ld
    nblk = -(-rows // nrows)
    out = np.zeros((B, T, Hq, D), np.float32)
    chunk = np.arange(4)
    for b, hk, bx in np.ndindex(B, Hkv, nblk):
        limit = min(int(lims[b]), S)
        r0 = (nblk - 1 - bx) * nrows  # latest rows first
        sm = np.zeros(v_off + 2 * SK * ldv, np.float32)
        for r in range(min(nrows, rows - r0)):
            sm[r * ld: r * ld + D] = qf[b, (r0 + r) // G, hk * G + (r0 + r) % G]
        wpos, wlo, whi, hi, s_beg, nst = _flash_ranges(pos_all[b], r0, R, rows, G, limit, window, SK)
        acc = [dict(o=np.zeros((1, DT, 32, 4), _F32), m=[np.full(32, -np.inf, _F32) for _ in range(2)],
                    l=[np.zeros(32, _F32) for _ in range(2)]) for _ in range(R * H)]
        for i in range(nst):
            st = i % 2
            for j in range(SK):  # issue(i): keys past hi zero-filled
                key = s_beg + i * SK + j
                ko, vo = k_off + (st * SK + j) * ld, v_off + (st * SK + j) * ldv
                sm[ko: ko + D] = kf[b, hk, key] if key <= hi else 0
                sm[vo: vo + D] = vf[b, hk, key] if key <= hi else 0
            for w in range(R * H):
                rw, kg = w % R, w // R
                s0 = s_beg + i * SK + kg * BK
                if s0 > whi[rw] or s0 + BK - 1 < wlo[rw]:
                    continue
                a_ = acc[w]
                qa = (rw * 16 + g) * ld + 4 * t  # [32]
                kt = k_off + (st * SK + kg * BK) * ld + g * ld + 4 * t
                vt = v_off + (st * SK + kg * BK) * ldv + 2 * t * ldv + g
                sc = np.zeros((1, NT, 32, 4), _F32)
                for u in range(D // 16):
                    x0 = sm[(qa + 16 * u)[:, None] + chunk]  # [32, 4]
                    x1 = sm[(qa + 8 * ld + 16 * u)[:, None] + chunk]
                    y = sm[(kt[None] + (8 * ld * np.arange(NT))[:, None] + 16 * u)[..., None] + chunk]
                    for s_ in range(2):
                        a = np.stack([x0[:, 2 * s_], x1[:, 2 * s_], x0[:, 2 * s_ + 1], x1[:, 2 * s_ + 1]],
                                     -1)[None]
                        sc = mma_3xtf32(sc, a, y[..., 2 * s_: 2 * s_ + 2], passes[0])
                pos = wpos[rw][1]
                valid = np.zeros((NT, 32, 4), bool)
                mx = [np.full(32, MASK_VALUE, _F32) for _ in range(2)]
                for n in range(NT):
                    for e in range(4):
                        key = s0 + n * 8 + 2 * t + (e & 1)
                        x = sc[0, n, :, e]
                        if softcap > 0:
                            x = (_F32(softcap) * np.tanh(x / _F32(softcap))).astype(_F32)
                        ok = _key_valid(key, pos[e // 2], limit, window)
                        valid[n, :, e] = ok
                        sc[0, n, :, e] = np.where(ok, x, MASK_VALUE)
                        mx[e // 2] = np.maximum(mx[e // 2], sc[0, n, :, e])
                mn = [np.maximum(a_["m"][r], _quad(mx[r], np.max)) for r in range(2)]
                al = [np.exp(a_["m"][r] - mn[r]).astype(_F32) for r in range(2)]
                a_["m"] = mn
                psum = [np.zeros(32, _F32) for _ in range(2)]
                p = np.zeros((NT, 32, 4), _F32)
                for n in range(NT):
                    for e in range(4):
                        p[n, :, e] = np.where(valid[n, :, e], np.exp(sc[0, n, :, e] - mn[e // 2]), 0)
                    psum[0] += p[n, :, 0] + p[n, :, 1]
                    psum[1] += p[n, :, 2] + p[n, :, 3]
                a_["l"] = [a_["l"][r] * al[r] + psum[r] for r in range(2)]
                o = a_["o"]
                for e in range(4):
                    o[..., e] *= al[e // 2]
                cols = vt[None] + 8 * np.arange(DT)[:, None]  # [DT, 32]: row 2t, column 8j + g
                for n in range(NT):
                    a = p[n][:, [0, 2, 1, 3]][None]  # slot t = key 2t, slot t + 4 = key 2t + 1
                    bv = np.stack([sm[cols + 8 * n * ldv], sm[cols + (8 * n + 1) * ldv]], -1)
                    o = mma_3xtf32(o, a, bv, passes[1])
                a_["o"] = o
        for rw in range(R):
            a_ = acc[rw]  # key group 0 merges groups 1.. in order
            for kg in range(1, H):
                o_ = acc[kg * R + rw]
                for r in range(2):
                    m, hm = a_["m"][r], o_["m"][r]
                    mn = np.maximum(m, hm)
                    wa = np.where(m == -np.inf, 0, np.exp(m - np.where(mn == -np.inf, 0, mn))).astype(_F32)
                    wb = np.where(hm == -np.inf, 0, np.exp(hm - np.where(mn == -np.inf, 0, mn))).astype(_F32)
                    a_["l"][r] = a_["l"][r] * wa + o_["l"][r] * wb
                    for e in (2 * r, 2 * r + 1):
                        a_["o"][0, :, :, e] = a_["o"][0, :, :, e] * wa + o_["o"][0, :, :, e] * wb
                    a_["m"][r] = mn
            for r in range(2):
                lsum = _quad(a_["l"][r], np.sum)
                inv = np.where(lsum == 0, _F32(1), _F32(1) / np.where(lsum == 0, 1, lsum)).astype(_F32)
                pr = wpos[rw][0][r]
                m = pr < rows
                tt, hh = pr[m] // G, hk * G + pr[m] % G
                for n in range(DT):
                    for e in range(2):
                        out[b, tt, hh, n * 8 + 2 * t[m] + e] = a_["o"][0, n, m, 2 * r + e] * inv[m]
    return out

def decode(q, k, v, kv_limit, softcap: float = 0.0, window: int = 0, k_scale=None, v_scale=None,
           split: int = 64) -> np.ndarray:
    """`decode_tc_kernel` with `DenseRows` on bf16 q [B, 1, Hq, D] (Hq / Hkv
    <= 8) and k/v [B, Hkv, S, D] bf16, or int8 with f32 scales [B, Hkv, S]:
    out [B, 1, Hq, D] as f32 (bf16 values)."""
    B, Hkv, S, D = k.shape
    return _decode_tc(q, k.reshape(-1, D), v.reshape(-1, D),
                      None if k_scale is None else k_scale.reshape(-1),
                      None if v_scale is None else v_scale.reshape(-1),
                      kv_limit, Hkv, S, lambda b, hk, key0: (b * Hkv + hk) * S + key0,
                      softcap, window, split)


def decode_tf32(q, k, v, kv_limit, softcap: float = 0.0, window: int = 0, split: int | None = None,
                passes=(TF32_3X, TF32_3X)) -> np.ndarray:
    """`decode_tc_kernel` with `DecTf32` and `DenseRows` on f32 q [B, 1, Hq,
    D] (2 <= Hq / Hkv <= 8) and k/v [B, Hkv, S, D] f32, split by default the
    route's (`decode_tc_split(S)`): out [B, 1, Hq, D] f32. The tiles, ring,
    masks, softmax and merges of `decode`; q split once into its hi and lo
    planes [8][D + 16] (heads >= G: 0), K at pitch D + 16 and V at D + 8;
    S = K q as m16n8k8 TF32 fragments, a lane's A values (key rows g, g + 8)
    and B values (head g) one 16-byte load each at chunk t of every 16-wide
    unit u of D, k8 step s taking its elements 2s and 2s + 1, the units in
    two accumulator chains; P through an f32 tile [8][20], V^T's A values
    (d rows g, g + 8 of each m16 tile; key slots t, t + 4) and P's B values
    (head g) of each k8 step of the 16 keys; every product in 3xTF32
    (`mma_3xtf32`; `passes`: the products of S and of P . V, to drop one
    for an ablation); p kept in f32."""
    from ..ops.attention import decode_tc_split

    B, Hkv, S, D = k.shape
    return _decode_tc(q, k.reshape(-1, D), v.reshape(-1, D), None, None, kv_limit, Hkv, S,
                      lambda b, hk, key0: (b * Hkv + hk) * S + key0, softcap, window,
                      decode_tc_split(S) if split is None else split, tf32=passes)


TF32_INT8_QK = ("hi.lo", "hi.hi")  # `DecTf32Int8`'s score products: K exact, q's lo then hi


def decode_tf32_int8(q, k, v, k_scale, v_scale, kv_limit, softcap: float = 0.0, window: int = 0,
                     split: int | None = None, passes=TF32_INT8_QK) -> np.ndarray:
    """`decode_tc_kernel` with `DecTf32Int8` and `DenseRows` on f32 q [B, 1,
    Hq, D] (2 <= Hq / Hkv <= 8) and int8 k/v [B, Hkv, S] with f32 scales [B,
    Hkv, S], split by default the route's: out [B, 1, Hq, D] f32. The scores
    are `decode_tf32`'s fragments (q's planes, the D permutation of each
    16-wide unit) with each int8 key its exact f32 value, so a k8 step's
    products are K . lo(q) then K . hi(q) (`passes`, of `mma_3xtf32`'s
    names: ("hi.hi",) drops q's lo part), scaled by ks after; P = bf16(p *
    vs) and V widened to bf16 as in `decode`'s int8 arm."""
    from ..ops.attention import decode_tc_split

    B, Hkv, S, D = k.shape
    return _decode_tc(q, k.reshape(-1, D), v.reshape(-1, D), k_scale.reshape(-1), v_scale.reshape(-1),
                      kv_limit, Hkv, S, lambda b, hk, key0: (b * Hkv + hk) * S + key0, softcap, window,
                      decode_tc_split(S) if split is None else split, q32=passes)


def paged_decode(q, k_pages, v_pages, page_table, kv_limit, softcap: float = 0.0, window: int = 0,
                 k_scale=None, v_scale=None, split: int | None = None,
                 reads: set | None = None) -> np.ndarray:
    """`decode_tc_kernel` with `PagedRows` on q [B, 1, Hq, D] and pools [P,
    Hkv, ps, D] (ps a multiple of 16) through page_table [B, maxp], the
    policy from the dtypes as the kernel's dispatch picks it: bf16 q over
    bf16 pools, or int8 with f32 scales [P, Hkv, ps] (`decode`'s); f32 q over
    f32 pools (`decode_tf32`'s) or int8 ones (`decode_tf32_int8`'s); split
    by default the route's, `decode_tc_split(maxp * ps)`. Each (row, logical
    page) whose table entry a tile reads goes into `reads`: out [B, 1, Hq,
    D] as f32 (bf16 values for bf16 q)."""
    from ..ops.attention import decode_tc_split

    _, Hkv, ps, D = k_pages.shape
    assert ps % 16 == 0
    table = page_table.to(torch.int32).numpy()
    S = table.shape[1] * ps

    def row(b, hk, key0):  # the tile at key0 lies in one page
        if reads is not None:
            reads.add((b, key0 // ps))
        return (int(table[b, key0 // ps]) * Hkv + hk) * ps + key0 % ps

    f32 = q.dtype == torch.float32
    return _decode_tc(q, k_pages.reshape(-1, D), v_pages.reshape(-1, D),
                      None if k_scale is None else k_scale.reshape(-1),
                      None if v_scale is None else v_scale.reshape(-1),
                      kv_limit, Hkv, S, row, softcap, window,
                      decode_tc_split(S) if split is None else split,
                      tf32=(TF32_3X, TF32_3X) if f32 and k_scale is None else None,
                      q32=TF32_INT8_QK if f32 and k_scale is not None else None)


def _decode_tc(q, k, v, k_scale, v_scale, kv_limit, Hkv: int, S: int, row, softcap: float,
               window: int, split: int, tf32=None, q32=None) -> np.ndarray:
    """`decode_tc_kernel` on K/V rows k, v [N, D] (scales [N]), S logical
    keys a (batch row, kv head), `row(b, hk, key0)` the row of the first
    key of a 16-key tile (its others follow it), called only for a tile
    that holds a live key; `tf32`: the `DecTf32` policy's products of S and
    of P . V (f32 q, k and v); `q32`: the `DecTf32Int8` policy's products of
    S (f32 q over int8 K/V, whose P . V is the int8 arm's); else bf16 or
    int8 K/V."""
    B, _, Hq, D = q.shape
    G = Hq // Hkv
    assert G <= 8 and split % 16 == 0
    int8 = k_scale is not None
    qk32 = tf32[0] if tf32 is not None else q32  # the TF32 scores' products (f32 q)
    if qk32 is not None:
        qb = q.to(torch.float32).numpy().reshape(B, Hq, D)
        ldk, ldv, pld = D + 16, D + 8, 20  # DecodeTc's kLdK (and kLdK8), kLdV, kPLd32
        chunk = np.arange(4)
    if tf32 is not None:
        kh, vh = (x.to(torch.float32).numpy() for x in (k, v))
    elif q32 is not None:  # int8 keys read raw as their f32 values; V widened to bf16
        kh, vh = k.numpy().astype(np.float32), _to_bf16_bits(v.numpy().astype(np.float32))
    else:
        qb = _bits(q).reshape(B, Hq, D)
        # the staged tiles: bf16 as they are, int8 widened exactly (`widen_int8x16`)
        kh, vh = ((_to_bf16_bits(x.numpy().astype(np.float32)) for x in (k, v)) if int8
                  else (_bits(k), _bits(v)))
    ks, vs = (k_scale.numpy(), v_scale.numpy()) if int8 else (None, None)
    lims = kv_limit.to(torch.int32).numpy()
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    ld, n_splits = D + 8, -(-S // split)
    out = np.zeros((B, 1, Hq, D), np.float32)
    for b, hk in np.ndindex(B, Hkv):
        limit = min(int(lims[b]), S)
        live_lo = max(limit - window, 0) if window > 0 else 0
        qrow = qb[b, hk * G:(hk + 1) * G]
        if qk32 is not None:  # q's planes [8][ldk] (kept as f32: mma_3xtf32 splits them alike)
            qs = np.zeros((8, ldk), _F32)
            qs[:G, :D] = qrow
            qs = qs.reshape(-1)
        else:
            # q as the B operand: lane (g, t) holds q[head g][16 kk + 2t (+8) + {0, 1}]
            gq = np.minimum(g, G - 1)
            qf = [[np.where(g < G, qrow[gq, kk * 16 + 2 * t + 8 * c].astype(np.uint32)
                            | (qrow[gq, kk * 16 + 2 * t + 8 * c + 1].astype(np.uint32) << 16), 0)
                   .astype(np.uint32) for c in range(2)] for kk in range(D // 16)]
        parts = []
        for sp in range(n_splits):
            s0 = sp * split
            kbeg, kend = max(s0, live_lo), min(s0 + split, limit)
            if kbeg >= kend:
                parts.append((np.full(G, -np.inf, _F32), np.zeros(G, _F32), None))
                continue
            kb0 = s0 + (kbeg - s0) // 16 * 16
            ntile = -(-(kend - kb0) // 16)
            s_m = np.full((DEC_WARPS, 8), -np.inf, _F32)
            s_l = np.zeros((DEC_WARPS, 8), _F32)
            red = np.zeros((DEC_WARPS, 8, D), _F32)
            states = []
            for w in range(DEC_WARPS):
                mine = -(-(ntile - w) // DEC_WARPS) if ntile > w else 0
                o = [[np.zeros(32, _F32) for _ in range(4)] for _ in range(D // 16)]
                m = [np.full(32, -np.inf, _F32) for _ in range(2)]
                l = [np.zeros(32, _F32) for _ in range(2)]
                for j in range(mine):
                    key0 = kb0 + 16 * (w + j * DEC_WARPS)
                    row0 = row(b, hk, key0)
                    if tf32 is not None:
                        tk, tv = np.zeros(16 * ldk, _F32), np.zeros(16 * ldv, _F32)
                        for r in range(16):
                            if key0 + r < kend:
                                tk[r * ldk: r * ldk + D] = kh[row0 + r]
                                tv[r * ldv: r * ldv + D] = vh[row0 + r]
                    elif q32 is not None:  # raw K at the pitch D + 16, V's bf16 tile at D + 8
                        tk, tv = np.zeros(16 * ldk, _F32), np.zeros(16 * ld, np.uint16)
                        for r in range(16):
                            if key0 + r < kend:
                                tk[r * ldk: r * ldk + D] = kh[row0 + r]
                                tv[r * ld: r * ld + D] = vh[row0 + r]
                    else:
                        tk, tv = np.zeros(16 * ld, np.uint16), np.zeros(16 * ld, np.uint16)
                        for r in range(16):
                            if key0 + r < kend:
                                tk[r * ld: r * ld + D] = kh[row0 + r]
                                tv[r * ld: r * ld + D] = vh[row0 + r]
                    # the tile's scale rows (int8): lane (g, t)'s keys g and g + 8
                    srows = [np.minimum(row0 + g + 8 * h, len(kh) - 1) for h in range(2)]
                    sab = [[np.zeros(32, _F32) for _ in range(4)] for _ in range(2)]  # two chains
                    if qk32 is not None:
                        kl, ql = g * ldk + 4 * t, g * ldk + 4 * t
                        for u in range(D // 16):
                            x0 = tk[(kl + 16 * u)[:, None] + chunk]  # [32, 4]: key g
                            x1 = tk[(kl + 8 * ldk + 16 * u)[:, None] + chunk]  # key g + 8
                            y = qs[(ql + 16 * u)[:, None] + chunk]  # head g
                            c = np.stack(sab[u % 2], -1)[None, None]
                            for s_ in range(2):
                                a = np.stack([x0[:, 2 * s_], x1[:, 2 * s_], x0[:, 2 * s_ + 1],
                                              x1[:, 2 * s_ + 1]], -1)[None]
                                c = mma_3xtf32(c, a, y[None, :, 2 * s_: 2 * s_ + 2], qk32)
                            sab[u % 2] = [c[0, 0, :, e] for e in range(4)]
                    else:
                        for kk in range(D // 16):
                            a = ldmatrix_x4(tk.view(np.uint8),
                                            2 * ((lanes % 16) * ld + kk * 16 + (lanes // 16) * 8))
                            sab[kk % 2] = mma_16816(sab[kk % 2], a, qf[kk][0], qf[kk][1])
                    sc, ok, tmx = [], [], [np.full(32, MASK_VALUE, _F32) for _ in range(2)]
                    for e in range(4):
                        key = key0 + g + 8 * (e // 2)
                        ok.append((key >= kbeg) & (key < kend) & (2 * t + e % 2 < G))
                        x = (sab[0][e] + sab[1][e]).astype(_F32)
                        if int8:
                            x = x * np.where(ok[e], ks[srows[e // 2]], 0).astype(_F32)
                        if softcap > 0:
                            x = (_F32(softcap) * np.tanh(x / _F32(softcap))).astype(_F32)
                        sc.append(np.where(ok[e], x, MASK_VALUE).astype(_F32))
                        tmx[e % 2] = np.maximum(tmx[e % 2], sc[e])
                    al = []
                    for hh in range(2):
                        mn = np.maximum(m[hh], _col(tmx[hh], np.max))
                        al.append(np.exp(m[hh] - mn).astype(_F32))
                        m[hh] = mn
                    pt = np.zeros((8, pld), _F32) if tf32 is not None else np.zeros((8, P_LD), np.uint16)
                    pv = []
                    for e in range(4):
                        pe = np.where(ok[e], np.exp(sc[e] - m[e % 2]), 0).astype(_F32)
                        pv.append(pe)
                        wgt = pe * np.where(ok[e], vs[srows[e // 2]], 0).astype(_F32) if int8 else pe
                        pt[2 * t + e % 2, g + 8 * (e // 2)] = wgt if tf32 is not None else _to_bf16_bits(wgt)
                    l = [l[0] * al[0] + (pv[0] + pv[2]), l[1] * al[1] + (pv[1] + pv[3])]
                    if tf32 is not None:
                        DT = D // 16
                        oc = np.stack([np.stack(o[mt], -1) for mt in range(DT)])[:, None]  # [DT, 1, 32, 4]
                        for e in range(4):
                            oc[..., e] *= al[e % 2]
                        vl = t * ldv + g
                        for kk in range(2):
                            bp = np.stack([pt[g, 8 * kk + t], pt[g, 8 * kk + t + 4]], -1)[None]  # [1, 32, 2]
                            vk = vl[None] + 8 * kk * ldv + 16 * np.arange(DT)[:, None]  # [DT, 32]
                            a = np.stack([tv[vk], tv[vk + 8], tv[vk + 4 * ldv], tv[vk + 4 * ldv + 8]], -1)
                            oc = mma_3xtf32(oc, a, bp, tf32[1])
                        o = [[oc[mt, 0, :, e] for e in range(4)] for mt in range(DT)]
                        continue
                    pflat = pt.reshape(-1)
                    b0, b1 = _word(pflat, g * P_LD + 2 * t), _word(pflat, g * P_LD + 8 + 2 * t)
                    for mt in range(D // 16):
                        o[mt] = [o[mt][0] * al[0], o[mt][1] * al[1], o[mt][2] * al[0], o[mt][3] * al[1]]
                        a = ldmatrix_x4_trans(tv.view(np.uint8), 2 * (((lanes // 16) * 8 + lanes % 8) * ld
                                                                       + mt * 16 + ((lanes // 8) % 2) * 8))
                        o[mt] = mma_16816(o[mt], a, b0, b1)
                l = [_col(x, np.sum) for x in l]
                for hh in range(2):
                    s_m[w, 2 * t[:4] + hh] = m[hh][:4]
                    s_l[w, 2 * t[:4] + hh] = l[hh][:4]
                states.append((m, o))
            M = s_m.max(axis=0)
            for w, (m, o) in enumerate(states):
                f = [np.exp(m[hh] - M[2 * t + hh]).astype(_F32) for hh in range(2)]
                for mt in range(D // 16):
                    for e in range(4):
                        red[w, 2 * t + e % 2, mt * 16 + g + 8 * (e // 2)] = o[mt][e] * f[e % 2]
            po = np.zeros((G, D), _F32)
            for w in range(DEC_WARPS):
                po += red[w, :G]
            pl = np.zeros(G, _F32)
            for w in range(DEC_WARPS):
                pl += s_l[w, :G] * np.exp(s_m[w, :G] - M[:G]).astype(_F32)
            parts.append((M[:G].copy(), pl, po))
        res = _merge_splits(parts, G, D)
        out[b, 0, hk * G:(hk + 1) * G] = res if qk32 is not None else _bf16_round(res)
    return out


def _merge_splits(parts, G: int, D: int) -> np.ndarray:
    """`merge_splits_last` (csrc/decode_tc.cuh): the last block's merge of
    the splits' partials (m [G], l [G], unnormalized o [G, D] or None for a
    split without a live key), in split order: [G, D] f32, 0 for a head
    without a live key."""
    res = np.zeros((G, D), _F32)
    for hh in range(G):
        mx = max((pm[hh] for pm, pl, _ in parts if pl[hh] > 0), default=-np.inf)
        total, acc = _F32(0), np.zeros(D, _F32)
        for pm, pl, po in parts:
            w = _F32(np.exp(pm[hh] - mx)) if pl[hh] > 0 else _F32(0)
            total = _F32(w * pl[hh] + total)
            if w > 0:
                acc = (w * po[hh] + acc).astype(_F32)
        res[hh] = acc * (_F32(1) if total == 0 else _F32(1) / total)
    return res


# constants of csrc/decode_g1.cuh (kG1Warps)
G1_WARPS = 4


def g1_layout(D: int, kv_bytes: int) -> tuple[int, int, int, int, int, int]:
    """`G1Layout<D, TKV>` of the G = 1 core at a cache element of `kv_bytes`
    bytes: (elements a 16-byte chunk, lanes a key row, rows a warp-wide
    load, chunks a lane a row, row loads a lane a step: at most 8 chunks
    and 64 elements, keys a warp step)."""
    epc = 16 // kv_bytes
    chunks = D // epc
    lpr = min(chunks, 32)
    rpw, cpl = 32 // lpr, chunks // lpr
    nu = min(8 // cpl, 64 // (cpl * epc))
    return epc, lpr, rpw, cpl, nu, nu * rpw


def decode_g1(q, k, v, kv_limit, softcap: float = 0.0, window: int = 0, k_scale=None, v_scale=None,
              split: int | None = None) -> np.ndarray:
    """`decode_g1_kernel` with `DenseRows` on q [B, 1, H, D] (bf16 or f32)
    and k/v [B, H, S, D] in q's dtype, or int8 with f32 scales [B, H, S]
    (one query head a KV head); split by default the route's
    (`decode_tc_split(S)`): out [B, 1, H, D] f32 (bf16 values for bf16 q)."""
    from ..ops.attention import decode_tc_split

    B, Hkv, S, D = k.shape
    return _decode_g1(q, k.reshape(-1, D), v.reshape(-1, D),
                      None if k_scale is None else k_scale.reshape(-1),
                      None if v_scale is None else v_scale.reshape(-1),
                      kv_limit, Hkv, S, lambda b, hk, key: (b * Hkv + hk) * S + key, softcap, window,
                      decode_tc_split(S) if split is None else split)


def paged_decode_g1(q, k_pages, v_pages, page_table, kv_limit, softcap: float = 0.0, window: int = 0,
                    k_scale=None, v_scale=None, split: int | None = None,
                    reads: set | None = None) -> np.ndarray:
    """`decode_g1_kernel` with `PagedRows` on q [B, 1, H, D] and pools [P,
    H, ps, D] (any ps) in q's dtype, or int8 with f32 scales [P, H, ps],
    through page_table [B, maxp]; split by default the route's,
    `decode_tc_split(maxp * ps)`. Each (row, logical page) whose table entry
    a live key reads goes into `reads`: out [B, 1, H, D] f32."""
    from ..ops.attention import decode_tc_split

    _, Hkv, ps, D = k_pages.shape
    table = page_table.to(torch.int32).numpy()
    S = table.shape[1] * ps

    def row(b, hk, key):  # each key's row through its page
        if reads is not None:
            reads.update((b, int(i)) for i in np.unique(key // ps))
        return (table[b, key // ps].astype(np.int64) * Hkv + hk) * ps + key % ps

    return _decode_g1(q, k_pages.reshape(-1, D), v_pages.reshape(-1, D),
                      None if k_scale is None else k_scale.reshape(-1),
                      None if v_scale is None else v_scale.reshape(-1),
                      kv_limit, Hkv, S, row, softcap, window,
                      decode_tc_split(S) if split is None else split)


def _decode_g1(q, k, v, k_scale, v_scale, kv_limit, Hkv: int, S: int, row, softcap: float,
               window: int, split: int) -> np.ndarray:
    """`decode_g1_kernel` on K/V rows k, v [N, D] (scales [N]), S logical keys
    a (batch row, kv head), `row(b, hk, keys)` the rows of an array of live
    keys. Only the splits that hold a live key run (the row's out is 0
    without one). Lane l owns chunks (l % kLpr + kLpr i) of kEpc elements
    of its row l // kLpr of a load: its q and output slices in registers,
    its K and V chunks of kNu rows a step; the dot in element order (fmaf),
    a shuffle tree over the row's lanes, the step's max over the rows of a
    load, the online softmax per warp, the warp's rows of a load summed by
    a shuffle tree, the warps merged in warp order, the live splits by
    `_merge_splits`."""
    B, _, Hq, D = q.shape
    assert Hq == Hkv
    int8 = k_scale is not None
    epc, lpr, rpw, cpl, nu, keys = g1_layout(D, k.element_size())
    kf, vf = (x.to(torch.float32).numpy() for x in (k, v))  # bf16 and int8 exact in f32
    ks, vs = (k_scale.numpy(), v_scale.numpy()) if int8 else (None, None)
    qf = q.to(torch.float32).numpy().reshape(B, Hq, D)
    lims = kv_limit.to(torch.int32).numpy()
    lanes = np.arange(32)
    rr, cl = lanes // lpr, lanes % lpr
    idx = ((cl[:, None] + lpr * np.arange(cpl)) * epc)[:, :, None] + np.arange(epc)  # [32, cpl, epc]
    lane_of = np.broadcast_to(lanes, (nu, 32))
    out = np.zeros((B, 1, Hq, D), np.float32)
    for b, hk in np.ndindex(B, Hkv):
        limit = min(int(lims[b]), S)
        live_lo = max(limit - window, 0) if window > 0 else 0
        qv = qf[b, hk][idx]  # [32, cpl, epc]
        parts = []
        for sp in range(live_lo // split, -(-limit // split)):  # the splits with a live key
            s0 = sp * split
            kbeg, kend = max(s0, live_lo), min(s0 + split, limit)
            s_m = np.full(G1_WARPS, -np.inf, _F32)
            s_l = np.zeros(G1_WARPS, _F32)
            red = np.zeros((G1_WARPS, D), _F32)
            for w in range(G1_WARPS):
                o = np.zeros((32, cpl, epc), _F32)
                m, l = _F32(-np.inf), np.zeros(32, _F32)
                for key0 in range(kbeg + w * keys, kend, G1_WARPS * keys):
                    key = key0 + rpw * np.arange(nu)[:, None] + rr  # [nu, 32]: lane l's u-th row
                    ok = key < kend
                    kr = np.zeros((nu, 32, cpl, epc), _F32)
                    vr = np.zeros_like(kr)
                    rows = row(b, hk, key[ok])
                    kr[ok] = kf[rows[:, None, None], idx[lane_of[ok]]]
                    vr[ok] = vf[rows[:, None, None], idx[lane_of[ok]]]
                    x = np.zeros((nu, 32), _F32)
                    for i in range(cpl):
                        for e in range(epc):
                            x = _fma(qv[:, i, e], kr[:, :, i, e], x)
                    off = lpr // 2
                    while off:
                        x = (x + x[:, lanes ^ off]).astype(_F32)
                        off //= 2
                    if int8:
                        ksu, vsu = np.zeros((nu, 32), _F32), np.zeros((nu, 32), _F32)
                        ksu[ok], vsu[ok] = ks[rows], vs[rows]
                        x = (x * ksu).astype(_F32)
                    if softcap > 0:
                        x = (_F32(softcap) * np.tanh(x / _F32(softcap))).astype(_F32)
                    sc = np.where(ok, x, MASK_VALUE).astype(_F32)
                    mx = sc.max(axis=0)  # [32]: the lane's rows, then over the rows of a load
                    off = lpr
                    while off < 32:
                        mx = np.maximum(mx, mx[lanes ^ off])
                        off *= 2
                    mn = max(m, mx[0])
                    al = _F32(np.exp(_F32(m - mn)))
                    m = mn
                    o = (o * al).astype(_F32)
                    psum = np.zeros(32, _F32)
                    for u in range(nu):
                        p = np.where(ok[u], np.exp(sc[u] - m), 0).astype(_F32)
                        psum = (psum + p).astype(_F32)
                        wgt = _bf16_round(p * vsu[u]) if int8 else p if k.dtype == torch.float32 else _bf16_round(p)
                        o = _fma(wgt[:, None, None], vr[u], o)
                    l = _fma(l, al, psum)
                off = lpr
                while off < 32:
                    l = (l + l[lanes ^ off]).astype(_F32)
                    o = (o + o[lanes ^ off]).astype(_F32)
                    off *= 2
                s_m[w], s_l[w] = m, l[0]
                red[w, idx[rr == 0].reshape(-1)] = o[rr == 0].reshape(-1)
            M = s_m.max()
            f = np.exp(s_m - M).astype(_F32)
            po, pl = np.zeros(D, _F32), _F32(0)
            for w in range(G1_WARPS):
                po = _fma(red[w], f[w], po)
                pl = _fma(s_l[w], f[w], pl)
            parts.append((np.full(1, M, _F32), np.full(1, pl, _F32), po[None]))
        res = _merge_splits(parts, 1, D)[0]  # 0 without a live split
        out[b, 0, hk] = res if q.dtype == torch.float32 else _bf16_round(res)
    return out


def main() -> None:
    from ..ops.quant_matmul import PLAIN
    from ..quant.qtensor import dequant
    from ._timing import random_qtensor

    gen = torch.Generator().manual_seed(0)
    for fmt in GEMV_FORMATS:
        block = fmt in BLOCK_BYTES
        for N, K, M in (((40, 1056, 5), (19, 1056, 1), (20, 1280, 8), (48, 4096, 2)) if block else
                        ((40, 1280, 1), (20, 2048, 8), (48, 4096, 2))):
            qt = random_qtensor(fmt, N, K, gen, "cpu")
            x = torch.randn(M, K, generator=gen).to(torch.bfloat16)
            ref = PLAIN[fmt](x, qt).numpy()
            err = np.abs(gemv(x, qt) - ref).max() / np.abs(ref).max()
            line = f"{fmt} N={N} K={K} M={M}: gemv max|diff| / max|ref| {err:.2e}"
            if block:
                tile = tile_weights(qt, N + 3)
                exact = (np.array_equal(tile[:N, :K], dequant(qt, torch.bfloat16).float().numpy())
                         and not tile[N:].any() and not tile[:, K:].any())
                line += f"; tile weights bit-exact: {exact}"
            print(line)
    for fmt, N, K, M in (("q4_0", 40, 1056, 7), ("q8_0", 40, 1056, 2), ("q4_k", 19, 1280, 8)):
        qt = random_qtensor(fmt, N, K, gen, "cpu")
        x = torch.randn(M, K, generator=gen)
        ref = PLAIN[fmt](x, qt).numpy()
        err = np.abs(gemv(x, qt) - ref).max() / np.abs(ref).max()
        print(f"{fmt} f32 N={N} K={K} M={M}: GEMV (three bf16 parts) max|diff| / max|ref| {err:.2e}")
    for fmt, M, N, K in (("q4_0", 17, 300, 1056), ("q8_0", 70, 300, 1056), ("q4_k", 17, 300, 1280),
                         ("q6_k", 17, 300, 1280)):
        qt = random_qtensor(fmt, N, K, gen, "cpu")
        x = torch.randn(M, K, generator=gen)
        ref = PLAIN[fmt](x, qt).numpy()
        err = np.abs(tile_tf32(x, qt) - ref).max() / np.abs(ref).max()
        print(f"{fmt} f32 N={N} K={K} M={M}: TF32 tile max|diff| / max|ref| {err:.2e}")
    from ..ops.attention import decode_attention_plain, flash_attention_plain
    from ..runtime.kv_cache import quantize_kv

    for B, T, S, Hq, Hkv, D, pos0, lim, cap, window in ((1, 37, 100, 8, 1, 128, 0, [37], 0.0, 0),
                                                        (2, 20, 70, 4, 4, 128, 30, [50, 45], 30.0, 16)):
        q, k, v = (torch.randn(*shape, generator=gen).mul(0.3).to(torch.bfloat16)
                   for shape in ((B, T, Hq, D), (B, Hkv, S, D), (B, Hkv, S, D)))
        pos = (torch.arange(T, dtype=torch.int32) + pos0).expand(B, T).contiguous()
        lim_t = torch.tensor(lim, dtype=torch.int32)
        ref = flash_attention_plain(q, k, v, pos, lim_t, cap, window).float().numpy()
        err = np.abs(flash(q, k, v, pos, lim_t, cap, window) - ref).max() / np.abs(ref).max()
        qd = q[:, :1].contiguous()
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        refd = decode_attention_plain(qd, k, v, lim_t, cap, window).float().numpy()
        errd = np.abs(decode(qd, k, v, lim_t, cap, window) - refd).max() / np.abs(refd).max()
        ref8 = decode_attention_plain(qd, k8, v8, lim_t, cap, window, ks, vs).float().numpy()
        err8 = np.abs(decode(qd, k8, v8, lim_t, cap, window, ks, vs) - ref8).max() / np.abs(ref8).max()
        q32, k32, v32 = q.float(), k.float(), v.float()
        ref32 = flash_attention_plain(q32, k32, v32, pos, lim_t, cap, window).numpy()
        err32 = np.abs(flash_tf32(q32, k32, v32, pos, lim_t, cap, window) - ref32).max() / np.abs(ref32).max()
        print(f"attention B={B} T={T} S={S} Hq={Hq} Hkv={Hkv} D={D}: max|diff| / max|ref|: flash "
              f"{err:.2e}, decode {errd:.2e}, decode int8 {err8:.2e}, f32 flash (TF32) {err32:.2e}")
    # paged decode: 16-key pages shuffled over a pool, against the dense
    # emulation on the gathered pages
    from ..ops.paged_attention import gather_pages

    B, Hq, Hkv, D, ps, maxp = 2, 8, 2, 128, 16, 8
    q = torch.randn(B, 1, Hq, D, generator=gen).mul(0.3).to(torch.bfloat16)
    kp, vp = (torch.randn(B * maxp + 1, Hkv, ps, D, generator=gen).mul(0.3).to(torch.bfloat16)
              for _ in range(2))
    pt = (torch.randperm(B * maxp, generator=gen) + 1).to(torch.int32).reshape(B, maxp)
    lim_t = torch.tensor([70, 128], dtype=torch.int32)
    same = np.array_equal(paged_decode(q, kp, vp, pt, lim_t, 30.0, 48),
                          decode(q, gather_pages(kp, pt), gather_pages(vp, pt), lim_t, 30.0, 48))
    print(f"paged decode B={B} Hq={Hq} Hkv={Hkv} D={D} ps={ps}: bit for bit the dense emulation on "
          f"the gathered pages: {same}")
    # f32 queries over f32 and int8 pages (`DecTf32`, `DecTf32Int8`)
    q32 = torch.randn(B, 1, Hq, D, generator=gen).mul(0.3)
    kp32, vp32 = (torch.randn(B * maxp + 1, Hkv, ps, D, generator=gen).mul(0.3) for _ in range(2))
    (kp8, ks8), (vp8, vs8) = quantize_kv(kp32), quantize_kv(vp32)
    dense = [gather_pages(x, pt) for x in (kp32, vp32, kp8, vp8, ks8, vs8)]
    got32 = paged_decode(q32, kp32, vp32, pt, lim_t, 30.0, 48)
    got8 = paged_decode(q32, kp8, vp8, pt, lim_t, 30.0, 48, ks8, vs8)
    ref8 = decode_attention_plain(q32, *dense[2:4], lim_t, 30.0, 48, *dense[4:]).numpy()
    print(f"f32 q through pages: f32 pages bit for bit the dense TF32 emulation: "
          f"{np.array_equal(got32, decode_tf32(q32, *dense[:2], lim_t, 30.0, 48))}; int8 pages "
          f"{np.array_equal(got8, decode_tf32_int8(q32, *dense[2:4], *dense[4:], lim_t, 30.0, 48))}, "
          f"max|diff| / max|ref| {np.abs(got8 - ref8).max() / np.abs(ref8).max():.2e}")


if __name__ == "__main__":
    main()
