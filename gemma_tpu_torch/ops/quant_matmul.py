"""Quantized dequant-matmul: y = x @ dequant(W).T, returned in f32.

Counterpart of `gemma_tpu/ops/quant_matmul.py` `quant_matmul`. One kernel
per format, each under `csrc/` with a header that says which Pallas kernel
it replaces, what bounds it on the H100 and how the design answers that:
* q4_0: `csrc/q4_0_matmul.cu` (replaces `_q4_0_kernel`);
* q8_0: `csrc/q8_0_matmul.cu` (replaces `_q8_0_kernel`);
* q4_k: `csrc/q4_k_matmul.cu` (replaces `_q4_k_kernel`);
* q6_k: `csrc/q6_k_matmul.cu` (replaces `_q6_k_kernel` and, on the
  reference's deep-K int8 layout, `_q6_k_v4_kernel`).
With bf16 x, every format runs on the tensor cores above M = 8, through the
shared tile of `csrc/dq_tile.cuh` (bf16 `mma.sync`, f32 accumulators, x
copied by `cp.async`, the weight dequantized to bf16 in shared memory), and
at 1 <= M <= 8 through the GEMV of `csrc/dq_gemv.cuh` (the weight's
integers against x in bf16 `mma.sync`, scaled per group in f32), the
batch-1 decode step included. With f32 x (evaluation mode) q4_k and q6_k
run above M = 8 on the tensor cores too, through the TF32 tile of
`csrc/dq_tile_tf32.cuh` (the weight's integers against x split into two
TF32 parts, scaled per group in f32: 1e-5 of the output's scale), counted
also in their wrappers' `tf32_launches` as the library reports its launches;
the rest of f32 x runs SIMT: every format's GEMV at M <= 8 and q4_0's and
q8_0's plain-FMA tiles above.

Numerics follow the reference kernels, which switch their dot dtype at
M = 8 (`quant_matmul.py:315`):
* M <= 8 (decode), or f32 activations (evaluation mode): weights and x in
  f32, f32 accumulation;
* M > 8 with bf16 activations (prefill): bf16 x against bf16-rounded
  weights, f32 accumulation. q4_0 rounds w = d * (q - 8), q8_0 w = d * q
  (the reference's scales are ggml's f16 rounded to bf16, the port's the
  exact f16: ROADMAP section 3, expected differences). q4_k rounds
  only its scale part, bf16(d*sc * (q - 8)), and adds the per-32 affine
  part sum(x) * (8 d*sc - dmin*mn) in f32, the reference's rounding point
  (`quant_matmul.py:131-143`; a bf16-rounded offset is a perplexity bias).
  q6_k rounds the true weight bf16((d*sc) * q); the reference rounds
  (d*sc) * (q + 24) and adds a -24 fold, which exists only for its int4
  bitcast (ROADMAP section 3, expected differences).

Each wrapper takes the plain version for CPU tensors and, for CUDA tensors,
launches its kernel or raises; `launches` counts its kernel launches.
`set_force_plain(True)` routes `quant_matmul` to the plain versions on
every device: the reference's explicit switch (`set_force_fallback`,
`gemma_tpu/ops/linear.py:27`), which `utils.verify` sets to run the plain
side of its check on the card. It is off by default and nothing turns it
on when a kernel fails.
"""
from __future__ import annotations

import torch

from ..kernels import build
from ..quant.qtensor import QTensor, dequant, q4_k_group_scales, q4_k_nibbles

DECODE_MAX_M = 8  # largest M served by the GEMV launch shape (f32 weights)
TF32_FORMATS = ("q4_k", "q6_k")  # f32 x above DECODE_MAX_M: csrc/dq_tile_tf32.cuh
_FORCE_PLAIN = False


def set_force_plain(flag: bool) -> None:
    """Route `quant_matmul` to the plain versions (`PLAIN`) on every
    device while set. Only `utils.verify` sets it, and clears it in a
    `finally`."""
    global _FORCE_PLAIN
    _FORCE_PLAIN = bool(flag)


def forcing_plain() -> bool:
    return _FORCE_PLAIN


def _f32_regime(x2: torch.Tensor) -> bool:
    return x2.dtype == torch.float32 or x2.shape[0] <= DECODE_MAX_M


def _dense_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x @ dequant(qt).T with f32 weights, or bf16-rounded weights and bf16
    x at M > 8 (q4_0, q8_0, q6_k)."""
    N, K = qt.shape
    x2 = x.reshape(-1, K)
    if _f32_regime(x2):
        y = x2.to(torch.float32) @ dequant(qt, torch.float32).T
    else:
        w = dequant(qt, torch.bfloat16).to(torch.float32)
        y = x2.to(torch.bfloat16).to(torch.float32) @ w.T
    return y.reshape(*x.shape[:-1], N)


def q4_0_matmul_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """The plain PyTorch version: x [..., K] -> [..., N] f32."""
    return _dense_plain(x, qt)


def q8_0_matmul_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """The plain PyTorch version: x [..., K] -> [..., N] f32."""
    return _dense_plain(x, qt)


def q6_k_matmul_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """The plain PyTorch version: x [..., K] -> [..., N] f32."""
    return _dense_plain(x, qt)


def q4_k_matmul_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """The plain PyTorch version: x [..., K] -> [..., N] f32. At M > 8 with
    bf16 x: x @ bf16(d*sc * (q - 8)).T + xsum32 @ (8 d*sc - dmin*mn).T."""
    N, K = qt.shape
    x2 = x.reshape(-1, K)
    if _f32_regime(x2):
        return _dense_plain(x, qt)
    scale, minv = q4_k_group_scales(qt.scales, qt.dm)  # [N, K/256, 8]
    q = q4_k_nibbles(qt.qs).to(torch.float32) - 8.0
    w = (scale[..., None] * q).to(torch.bfloat16).to(torch.float32).reshape(N, K)
    offs = (8.0 * scale - minv).reshape(N, K // 32)
    xb = x2.to(torch.bfloat16).to(torch.float32)
    xsum = xb.reshape(-1, K // 32, 32).sum(-1)
    y = xb @ w.T + xsum @ offs.T
    return y.reshape(*x.shape[:-1], N)


def _launch(op, entry: str, x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Check x and qt for the kernel `entry` and launch it:
    entry(x, x_dtype, *qt buffers, y, work, tickets, M, N, K, stream), where
    work is the f32 scratch of the tensor-core kernels' K splits, the
    tiles' and the GEMVs', and tickets the GEMV's split sums, both from the
    stream's persistent `build.workspace` (sizes: `build.matmul_scratch`,
    often none). Those kernels copy x in 16-byte pieces."""
    N, K = qt.shape
    name = f"{qt.fmt} matmul"
    if x.device.type != "cuda" or qt.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, weight on {qt.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} kernel takes bf16 or f32 activations, got {x.dtype}")
    bufs = list(qt.arrays.values())
    if not all(b.is_contiguous() and b.data_ptr() % 16 == 0 for b in bufs):
        raise ValueError(f"{name} kernel needs contiguous, 16-byte aligned buffers")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs x 16-byte aligned")
    M = x2.shape[0]
    y = torch.empty(M, N, dtype=torch.float32, device=x.device)
    if M == 0:
        return y.reshape(*lead, N)
    lib = build.load()
    code, fmt = build.DTYPE_CODES[x2.dtype], build.FORMAT_CODES[qt.fmt]
    stream = build.stream_ptr(x.device)
    nbytes, nt = build.matmul_scratch(lib, fmt, code, M, N, K)
    work = tickets = None
    if nbytes or nt:
        work, tickets = (t.data_ptr() for t in build.workspace(x.device, stream, nbytes // 4, nt))
    f32 = x2.dtype == torch.float32  # only f32 x can reach the TF32 tile
    tf32 = lib.gt_dq_tile_tf32_launches() if f32 else 0
    err = getattr(lib, entry)(x2.data_ptr(), code, *(b.data_ptr() for b in bufs), y.data_ptr(), work,
                              tickets, M, N, K, stream)
    build.check(err, f"{name} M={M} N={N} K={K}")
    op.launches += 1
    if f32:  # the tile's launches as the library counted them
        op.tf32_launches += lib.gt_dq_tile_tf32_launches() - tf32
    return y.reshape(*lead, N)


def _checked(fmt: str, x: torch.Tensor, qt: QTensor) -> bool:
    """Shared argument checks (a QTensor's K is a multiple of its block by
    construction); True when both lie on the CPU (the plain path)."""
    if qt.fmt != fmt:
        raise ValueError(f"{fmt} matmul got a {qt.fmt} weight")
    K = qt.shape[1]
    if x.shape[-1] != K:
        raise ValueError(f"{fmt} matmul: x has {x.shape[-1]} features, weight has {K}")
    return x.device.type == "cpu" and qt.device.type == "cpu"


def q4_0_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """y = x @ dequant(qt).T in f32 for a q4_0 weight; x [..., K] bf16 or f32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if _checked("q4_0", x, qt):
        return q4_0_matmul_plain(x, qt)
    return _launch(q4_0_matmul, "gt_q4_0_matmul", x, qt)


def q8_0_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """y = x @ dequant(qt).T in f32 for a q8_0 weight; x [..., K] bf16 or f32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if _checked("q8_0", x, qt):
        return q8_0_matmul_plain(x, qt)
    return _launch(q8_0_matmul, "gt_q8_0_matmul", x, qt)


def q4_k_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """y = x @ dequant(qt).T in f32 for a q4_k weight; x [..., K] bf16 or f32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if _checked("q4_k", x, qt):
        return q4_k_matmul_plain(x, qt)
    return _launch(q4_k_matmul, "gt_q4_k_matmul", x, qt)


def q6_k_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """y = x @ dequant(qt).T in f32 for a q6_k weight; x [..., K] bf16 or f32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if _checked("q6_k", x, qt):
        return q6_k_matmul_plain(x, qt)
    return _launch(q6_k_matmul, "gt_q6_k_matmul", x, qt)


q4_0_matmul.launches = 0
q8_0_matmul.launches = 0
q4_k_matmul.launches = 0
q6_k_matmul.launches = 0
# of those, the launches that went through the TF32 tile (csrc/dq_tile_tf32.cuh)
q4_0_matmul.tf32_launches = 0
q8_0_matmul.tf32_launches = 0
q4_k_matmul.tf32_launches = 0
q6_k_matmul.tf32_launches = 0

MATMULS = {"q4_0": q4_0_matmul, "q8_0": q8_0_matmul, "q4_k": q4_k_matmul, "q6_k": q6_k_matmul}
PLAIN = {"q4_0": q4_0_matmul_plain, "q8_0": q8_0_matmul_plain, "q4_k": q4_k_matmul_plain,
         "q6_k": q6_k_matmul_plain}


def quant_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """y = x @ dequant(qt).T in f32, by the weight's format (its plain
    version while `set_force_plain` is on)."""
    return (PLAIN if _FORCE_PLAIN else MATMULS)[qt.fmt](x, qt)
