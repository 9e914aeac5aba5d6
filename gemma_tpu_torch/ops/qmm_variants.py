"""The decode-GEMV instruments: kernels that take the place of the Pallas
kernels in the reference's timing tools, each with its plain version.

* `qmm_tc_variant` (`csrc/q4_0_matmul.cu` `Q4_0Variant`, replaces `_kernel`
  of tools/bench_qmm_variants.py): the main path's tensor-core q4_0 GEMV
  (`dq_gemv_kernel` of `csrc/dq_gemv.cuh`) over the port's q4_0 payload
  with f32, bf16 or f16-bit scales, in the dot forms of `TC_FORMS`, at M <=
  8; gdot and f32dot on f16 scales launch the main path's instance itself;
* `qmm_variant` (`csrc/q4_0_matmul.cu`, replaces `kernel`/`kernel2` of
  tools/probe_int4.py): q4_0's SIMT GEMV at M = 8 on f32 scales in the
  modes of `SIMT_MODES` (no path launches it: bf16 and f32 x at M <= 8 take
  the tensor-core GEMV);
* `int4_dot` (`csrc/qmm_variants.cu`, replaces `kernel3` of
  tools/probe_int4.py): int8 x [M, K] against int4 w [N, K/2] -> int32;
* `row_checksum` (`csrc/qmm_variants.cu`, the `stream` modes of
  tools/bench_qmm_variants.py and tools/bench_q6k_variants.py): per row, the
  wrapping uint32 sum of every element of up to four arrays;
* `q4_0_gemv_warps` (`csrc/q4_0_matmul.cu`, replaces `call` of
  tools/bench_bn_sweep.py): q4_0's SIMT GEMV at M = 8 with 4, 8, 16 or 32
  rows per block;
* `q4_k_variant` (`csrc/q4_k_matmul.cu` `Q4KAblation`, replaces `_kernel`
  of tools/bench_q4k_variants.py): the q4_k ablations of `Q4_K_MODES` on
  the main path's tensor-core q4_k GEMV (prod: its instance itself), and
  q4_0ref on q4_0's;
* `q6_k_variant` (`csrc/q6_k_matmul.cu`, replaces `_kernel` of
  tools/bench_q6k_variants.py): the q6_k GEMV over an int8 payload or the
  port's planes combined in f32 or int32.

They lie on no serving path: the benches under `gemma_tpu_torch/tools/`
and `chip_smoke.py` run them. As everywhere in the port, a CPU tensor takes
the plain version and a CUDA tensor launches the kernel or raises; each
wrapper's `launches` counts its kernel launches. The tensor-core ones take
the main path's K-split scratch (`build.workspace`) and plan.
"""
from __future__ import annotations

import torch

from ..kernels import build
from ..quant.qtensor import QTensor, q4_k_group_scales, q4_k_nibbles, q6_k_values
from .quant_matmul import q4_0_matmul_plain, q4_k_matmul_plain, q6_k_matmul_plain

GEMV_M = 8  # the rows of x every bench runs (the reference's decode bucket)

# mode name -> the plain version's dot form (`qmm_variant_plain`): 0 f32
# weights q * d, 1 bf16(q * d), 2 bf16(bf16 q * bf16 d), 3 q unscaled, 4
# per-32 sums scaled by d. The tool's f32sc and rsc, and its bf16sc and
# rscb, differed only in where the TPU kept the scale's broadcast: one form
# each here. u16sc is rsc on f16-bit scales.
VARIANT_MODES = {"f32dot": 0, "f32sc": 1, "rsc": 1, "u16sc": 1, "bf16sc": 2, "rscb": 2,
                 "noscale": 3, "gdot": 4}
# probe_int4's modes on the SIMT GEMV (f32 scales), by their forms above,
# which are the kernel's mode codes
SIMT_MODES = ("bf16sc", "noscale")
# scale dtype -> kernel code; float16 stands for the tool's u16 (f16 bits)
SCALE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# mode name -> the tensor-core GEMV's dot form (`Q4_0Variant`): 0 each
# 32-group's fragment scaled by d (gdot; f32dot is the same function up to
# the order of f32 sums), 1 the weight bf16(q * d), 2 bf16(bf16 q * bf16 d),
# 3 q unscaled; forms 1-3 sum into one accumulator across groups
TC_FORMS = {"gdot": 0, "f32dot": 0, "f32sc": 1, "rsc": 1, "u16sc": 1, "bf16sc": 2, "rscb": 2,
            "noscale": 3}
# mode name -> gt_q4_k_ablation's mode (0: the main path's q4_k instance);
# q4_0ref runs q4_0's main-path instance
Q4_K_MODES = {"prod": 0, "nohilo": 0, "noaffine": 1, "nosub": 2, "q4_0ref": None}
Q6_K_MODES = {"prod": 0, "split_f32": 1, "split_int": 2}
WARPS = (4, 8, 16, 32)


def _on_cpu(what: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain path); False when
    all lie on one CUDA device; else ValueError."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{what}: tensors on {sorted(map(str, devices))}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError(f"{what} kernel needs contiguous, 16-byte aligned buffers")
    return False


def _launch(op, entry: str, what: str, *args) -> None:
    build.check(getattr(build.load(), entry)(*args), what)
    op.launches += 1


def _gemv_scratch(fmt: str, x: torch.Tensor, N: int, K: int) -> tuple[int | None, int | None]:
    """The main path's bf16 GEMV scratch of format `fmt` at x's M: pointers
    to the stream's K-split partial sums and tickets (`build.workspace`),
    None where the plan makes no split."""
    nbytes, nt = build.matmul_scratch(build.load(), build.FORMAT_CODES[fmt],
                                      build.DTYPE_CODES[torch.bfloat16], x.shape[0], N, K)
    if not (nbytes or nt):
        return None, None
    work, tickets = build.workspace(x.device, build.stream_ptr(x.device), nbytes // 4, nt)
    return work.data_ptr(), tickets.data_ptr()


def _gemv_x(what: str, x: torch.Tensor, K: int, exact_m: bool = True) -> None:
    """x must be bf16 [8, K] (exact_m) or [M <= 8, K]."""
    M = x.shape[0] if x.dim() == 2 else -1
    if x.dim() != 2 or x.shape[1] != K or not (M == GEMV_M if exact_m else 0 < M <= GEMV_M):
        want = f"[{GEMV_M}, {K}]" if exact_m else f"[M <= {GEMV_M}, {K}]"
        raise ValueError(f"{what}: x must be {want}, got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} takes bf16 x, got {x.dtype}")


# ---------------------------------------------------------------------------
# q4_0-payload variants (bench_qmm_variants, probe_int4 kernel and kernel2)
# ---------------------------------------------------------------------------

def q4_0_values(qs: torch.Tensor) -> torch.Tensor:
    """The port's q4_0 payload u8 [N, K/2] -> the signed values u - 8, f32
    [N, K] in logical order."""
    blocks = qs.reshape(qs.shape[0], -1, 16)
    return (torch.cat([blocks & 0x0F, blocks >> 4], dim=-1).to(torch.float32) - 8.0).reshape(
        qs.shape[0], -1)


def pack_q4_0_values(v: torch.Tensor) -> torch.Tensor:
    """Signed values in [-8, 7], [N, K] -> the port's q4_0 payload u8
    [N, K/2] (`q4_0_values`'s inverse)."""
    u = (v.to(torch.int16) + 8).to(torch.uint8).reshape(v.shape[0], -1, 32)
    return (u[..., :16] | (u[..., 16:] << 4)).reshape(v.shape[0], -1)


def qmm_variant_plain(mode: str, x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """y [M, N] f32 of `mode` (see csrc/q4_0_matmul.cu) in plain PyTorch."""
    code = VARIANT_MODES[mode]
    q = q4_0_values(qs)
    N, K = q.shape
    xf = x.to(torch.float32)
    if code == 4:  # gdot: per-32 sums, scaled
        s = torch.einsum("mgk,ngk->mng", xf.reshape(-1, K // 32, 32), q.reshape(N, K // 32, 32))
        return (s * scales.to(torch.float32)[None]).sum(-1)
    if code == 3:
        return xf @ q.T
    sc = scales.to(torch.bfloat16 if code == 2 else torch.float32).to(torch.float32)
    w = q * sc.repeat_interleave(32, dim=-1)
    if code in (1, 2):
        w = w.to(torch.bfloat16).to(torch.float32)
    return xf @ w.T


def _variant_args(what: str, mode: str, x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor,
                  exact_m: bool, modes=VARIANT_MODES) -> tuple[int, int]:
    """Check a q4_0 variant's arguments; its (N, K)."""
    if mode not in modes:
        raise ValueError(f"unknown {what} mode {mode!r}; modes {sorted(modes)}")
    N, K = qs.shape[0], 2 * qs.shape[1]
    if scales.dtype not in SCALE_CODES or tuple(scales.shape) != (N, K // 32):
        raise ValueError(f"q4_0 variant scales must be f32/bf16/f16 [{N}, {K // 32}], "
                         f"got {scales.dtype} {tuple(scales.shape)}")
    if mode == "u16sc" and scales.dtype != torch.float16:
        raise TypeError("u16sc decodes f16 bits: pass float16 scales")
    _gemv_x(what, x, K, exact_m)
    return N, K


def qmm_tc_variant(mode: str, x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The q4_0 GEMV variant `mode` on the tensor cores (`TC_FORMS`): x bf16
    [M <= 8, K], qs u8 [N, K/2] (the port's q4_0 payload), scales [N, K/32]
    f32, bf16 or f16 (u16sc needs f16) -> y [M, N] f32. Its plain version
    is `qmm_variant_plain`."""
    N, K = _variant_args("q4_0 tensor-core variant", mode, x, qs, scales, exact_m=False)
    if _on_cpu("q4_0 tensor-core variant", x, qs, scales):
        return qmm_variant_plain(mode, x, qs, scales)
    M = x.shape[0]
    y = torch.empty(M, N, dtype=torch.float32, device=x.device)
    work, tickets = _gemv_scratch("q4_0", x, N, K)
    _launch(qmm_tc_variant, "gt_qmm_tc_variant", f"q4_0 tensor-core variant {mode} M={M} N={N} K={K}",
            x.data_ptr(), TC_FORMS[mode], qs.data_ptr(), scales.data_ptr(), SCALE_CODES[scales.dtype],
            y.data_ptr(), work, tickets, M, N, K, build.stream_ptr(x.device))
    return y


def qmm_variant(mode: str, x: torch.Tensor, qs: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The q4_0 SIMT GEMV variant `mode` of `SIMT_MODES`: x bf16 [8, K], qs
    u8 [N, K/2] (the port's q4_0 payload), scales f32 [N, K/32] -> y [8, N]
    f32. Its plain version is `qmm_variant_plain`."""
    N, K = _variant_args("q4_0 SIMT variant", mode, x, qs, scales, exact_m=True, modes=SIMT_MODES)
    if scales.dtype != torch.float32:
        raise TypeError(f"the q4_0 SIMT variant takes f32 scales, got {scales.dtype}")
    if _on_cpu("q4_0 SIMT variant", x, qs, scales):
        return qmm_variant_plain(mode, x, qs, scales)
    y = torch.empty(GEMV_M, N, dtype=torch.float32, device=x.device)
    _launch(qmm_variant, "gt_qmm_variant", f"q4_0 SIMT variant {mode} N={N} K={K}",
            x.data_ptr(), VARIANT_MODES[mode], qs.data_ptr(), scales.data_ptr(), y.data_ptr(), N, K,
            build.stream_ptr(x.device))
    return y


def int4_values(w: torch.Tensor) -> torch.Tensor:
    """int4 w [N, K/2] (element 2j in the low nibble of byte j, two's
    complement) -> int8 [N, K]."""
    v = torch.stack([w & 0x0F, w >> 4], dim=-1).reshape(w.shape[0], -1).to(torch.int16)
    return ((v ^ 8) - 8).to(torch.int8)


def pack_int4(v: torch.Tensor) -> torch.Tensor:
    """int values in [-8, 7], [N, K] -> int4 w u8 [N, K/2] (`int4_values`'s
    inverse)."""
    u = (v.to(torch.int16) & 0x0F).to(torch.uint8).reshape(v.shape[0], -1, 2)
    return u[..., 0] | (u[..., 1] << 4)


def int4_dot_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x int8 [M, K] . int4_values(w).T -> int32 [M, N], exact (f64 sums of
    integers far below 2^53)."""
    return (x.to(torch.float64) @ int4_values(w).to(torch.float64).T).round().to(torch.int32)


def int4_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y int32 [M, N] = x int8 [M <= 8, K] . int4 w [N, K/2], exact."""
    N, K = w.shape[0], 2 * w.shape[1]
    if x.dtype != torch.int8 or w.dtype != torch.uint8:
        raise TypeError(f"int4 dot takes int8 x and u8 nibbles, got {x.dtype}, {w.dtype}")
    if x.dim() != 2 or x.shape[1] != K or not 0 < x.shape[0] <= GEMV_M or K % 32:
        raise ValueError(f"int4 dot: x {tuple(x.shape)} against w {tuple(w.shape)}")
    if _on_cpu("int4 dot", x, w):
        return int4_dot_plain(x, w)
    M = x.shape[0]
    y = torch.empty(M, N, dtype=torch.int32, device=x.device)
    _launch(int4_dot, "gt_int4_dot", f"int4 dot M={M} N={N} K={K}",
            x.data_ptr(), w.data_ptr(), y.data_ptr(), M, N, K, build.stream_ptr(x.device))
    return y


# ---------------------------------------------------------------------------
# stream: every byte read once
# ---------------------------------------------------------------------------

_WORD_VIEWS = {1: (torch.uint8, 0xFF), 2: (torch.int16, 0xFFFF), 4: (torch.int32, 0xFFFFFFFF)}


def row_checksum_plain(*arrays: torch.Tensor) -> torch.Tensor:
    """Per row of the [N, ...] arrays, the sum of every element's raw bits
    as an unsigned integer of its width, modulo 2^32, as int32 [N]."""
    total = 0
    for a in arrays:
        view, mask = _WORD_VIEWS[a.element_size()]
        total = total + (a.reshape(a.shape[0], -1).view(view).to(torch.int64) & mask).sum(-1)
    return ((total + 2**31) % 2**32 - 2**31).to(torch.int32)


def row_checksum(*arrays: torch.Tensor) -> torch.Tensor:
    """`row_checksum_plain` of one to four arrays [N, ...] whose rows hold a
    multiple of 4 bytes."""
    if not 1 <= len(arrays) <= 4 or len({a.shape[0] for a in arrays}) != 1:
        raise ValueError("row checksum takes one to four arrays of one row count")
    N = arrays[0].shape[0]
    row_bytes = [a[0].numel() * a.element_size() if N else 0 for a in arrays]
    if any(rb % 4 for rb in row_bytes) or any(a.element_size() not in _WORD_VIEWS for a in arrays):
        raise ValueError(f"row checksum: rows of {row_bytes} bytes")
    if _on_cpu("row checksum", *arrays):
        return row_checksum_plain(*arrays)
    out = torch.empty(N, dtype=torch.int32, device=arrays[0].device)
    args = []
    for j in range(4):
        a = arrays[j] if j < len(arrays) else None
        args += [a.data_ptr(), row_bytes[j], a.element_size()] if a is not None else [None, 0, 1]
    _launch(row_checksum, "gt_row_checksum", f"row checksum N={N} rows of {row_bytes} bytes",
            *args, out.data_ptr(), N, build.stream_ptr(arrays[0].device))
    return out


# ---------------------------------------------------------------------------
# rows per block of q4_0's SIMT GEMV (bench_bn_sweep)
# ---------------------------------------------------------------------------

def q4_0_gemv_warps(x: torch.Tensor, qt: QTensor, warps: int) -> torch.Tensor:
    """q4_0's SIMT GEMV at M = 8 with `warps` rows per block:
    x bf16 [8, K] -> y [8, N] f32 (the plain version is q4_0's)."""
    if qt.fmt != "q4_0" or warps not in WARPS:
        raise ValueError(f"q4_0 GEMV sweep takes a q4_0 weight and warps in {WARPS}, "
                         f"got {qt.fmt}, {warps}")
    N, K = qt.shape
    _gemv_x("q4_0 GEMV sweep", x, K)
    if _on_cpu("q4_0 GEMV sweep", x, qt.qs, qt.scales):
        return q4_0_matmul_plain(x, qt)
    y = torch.empty(GEMV_M, N, dtype=torch.float32, device=x.device)
    _launch(q4_0_gemv_warps, "gt_q4_0_gemv_warps", f"q4_0 GEMV {warps} warps N={N} K={K}",
            x.data_ptr(), qt.qs.data_ptr(), qt.scales.data_ptr(), y.data_ptr(), N, K, warps,
            build.stream_ptr(x.device))
    return y


# ---------------------------------------------------------------------------
# q4_k metadata ablations (bench_q4k_variants)
# ---------------------------------------------------------------------------

def q4_k_hi_parts(qt: QTensor) -> QTensor:
    """`qt` with d and dmin rounded to bf16: the inputs of `nohilo`, which
    the reference stores as the hi half of an exact bf16 hi/lo pair (the
    port keeps exact f16 and pays no such cost)."""
    return QTensor("q4_k", qs=qt.qs, scales=qt.scales,
                   dm=qt.dm.to(torch.bfloat16).to(torch.float16))


def q4_0ref_weight(qt: QTensor) -> QTensor:
    """A q4_0 weight on q4_k `qt`'s payload bytes with its 6-bit sub-scales
    as the scales: the reference tool's `q4_0ref` floor."""
    sc, _ = q4_k_group_scales(qt.scales, torch.ones_like(qt.dm))
    return QTensor("q4_0", qs=qt.qs, scales=sc.reshape(qt.shape[0], -1).to(torch.float16))


def q4_k_variant_plain(mode: str, x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    if mode in ("prod", "nohilo"):
        return q4_k_matmul_plain(x, qt)
    if mode == "q4_0ref":
        return q4_0_matmul_plain(x, qt)
    N, K = qt.shape
    q = q4_k_nibbles(qt.qs).to(torch.float32) - 8.0  # [N, K/256, 8, 32]
    if mode == "noaffine":
        scale, _ = q4_k_group_scales(qt.scales, qt.dm)
        w = scale[..., None] * q
    else:  # nosub
        w = qt.dm[..., 0].to(torch.float32)[..., None, None] * q
    return x.to(torch.float32) @ w.reshape(N, K).T


def q4_k_variant(mode: str, x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """The q4_k GEMV ablation `mode` at M = 8 on the tensor cores, x bf16
    [8, K] -> [8, N] f32: prod (the main path's q4_k GEMV), nohilo (prod;
    pass `q4_k_hi_parts(qt)`), noaffine (d*sc * (q - 8)), nosub (d * (q -
    8)), q4_0ref (the main path's q4_0 GEMV; pass `q4_0ref_weight(qt)`)."""
    if mode not in Q4_K_MODES:
        raise ValueError(f"unknown q4_k variant {mode!r}; modes {list(Q4_K_MODES)}")
    want = "q4_0" if mode == "q4_0ref" else "q4_k"
    if qt.fmt != want:
        raise ValueError(f"q4_k variant {mode} takes a {want} weight, got {qt.fmt}")
    N, K = qt.shape
    _gemv_x(f"q4_k variant {mode}", x, K)
    if _on_cpu("q4_k variant", x, *qt.arrays.values()):
        return q4_k_variant_plain(mode, x, qt)
    y = torch.empty(GEMV_M, N, dtype=torch.float32, device=x.device)
    work, tickets = _gemv_scratch(qt.fmt, x, N, K)
    if mode == "q4_0ref":
        _launch(q4_k_variant, "gt_qmm_tc_variant", f"q4_k variant q4_0ref N={N} K={K}",
                x.data_ptr(), TC_FORMS["gdot"], qt.qs.data_ptr(), qt.scales.data_ptr(),
                SCALE_CODES[torch.float16], y.data_ptr(), work, tickets, GEMV_M, N, K,
                build.stream_ptr(x.device))
    else:
        _launch(q4_k_variant, "gt_q4_k_ablation", f"q4_k variant {mode} N={N} K={K}",
                x.data_ptr(), Q4_K_MODES[mode], qt.qs.data_ptr(), qt.scales.data_ptr(),
                qt.dm.data_ptr(), y.data_ptr(), work, tickets, GEMV_M, N, K,
                build.stream_ptr(x.device))
    return y


# ---------------------------------------------------------------------------
# q6_k layout ablations (bench_q6k_variants)
# ---------------------------------------------------------------------------

def q6_k_int8_payload(qt: QTensor) -> dict[str, torch.Tensor]:
    """The `prod` layout of q6_k `qt`: qs i8 [N, K] = q in [-32, 31], with
    qt's sc i8 [N, K/16] and d f16 [N, K/256] (8.5625 bits a weight)."""
    return {"qs": q6_k_values(qt.ql, qt.qh).to(torch.int8), "sc": qt.sc, "d": qt.d}


def q6_k_variant_plain(mode: str, x: torch.Tensor, arrays: dict[str, torch.Tensor]) -> torch.Tensor:
    if mode != "prod":
        return q6_k_matmul_plain(x, QTensor("q6_k", **arrays))
    q, sc, d = arrays["qs"], arrays["sc"], arrays["d"]
    N, K = q.shape
    scale = d.to(torch.float32)[..., None] * sc.to(torch.float32).reshape(N, K // 256, 16)
    w = (q.to(torch.float32).reshape(N, K // 256, 16, 16) * scale[..., None]).reshape(N, K)
    return x.to(torch.float32) @ w.T


def q6_k_variant(mode: str, x: torch.Tensor, arrays: dict[str, torch.Tensor]) -> torch.Tensor:
    """The q6_k GEMV ablation `mode` at M = 8, x bf16 [8, K] -> [8, N] f32:
    prod over `q6_k_int8_payload(qt)`, split_f32 or split_int (the main
    path's GEMV) over `qt.arrays` (ql, qh, sc, d)."""
    if mode not in Q6_K_MODES:
        raise ValueError(f"unknown q6_k variant {mode!r}; modes {list(Q6_K_MODES)}")
    keys = ("qs", "sc", "d") if mode == "prod" else ("ql", "qh", "sc", "d")
    if tuple(arrays) != keys:
        raise ValueError(f"q6_k variant {mode} takes arrays {keys}, got {tuple(arrays)}")
    N = arrays["sc"].shape[0]
    K = 16 * arrays["sc"].shape[1]
    _gemv_x(f"q6_k variant {mode}", x, K)
    bufs = list(arrays.values())
    if _on_cpu("q6_k variant", x, *bufs):
        return q6_k_variant_plain(mode, x, arrays)
    ptrs = [b.data_ptr() for b in bufs] + [None] * (4 - len(bufs))
    y = torch.empty(GEMV_M, N, dtype=torch.float32, device=x.device)
    _launch(q6_k_variant, "gt_q6_k_variant", f"q6_k variant {mode} N={N} K={K}",
            x.data_ptr(), Q6_K_MODES[mode], *ptrs, y.data_ptr(), N, K, build.stream_ptr(x.device))
    return y


qmm_tc_variant.launches = 0
qmm_variant.launches = 0
int4_dot.launches = 0
row_checksum.launches = 0
q4_0_gemv_warps.launches = 0
q4_k_variant.launches = 0
q6_k_variant.launches = 0

# kernel name (chip_smoke.py's JSON line) -> wrapper with a `launches` counter
COUNTERS = {"qmm_tc_variant": qmm_tc_variant, "qmm_variant": qmm_variant, "int4_dot": int4_dot,
            "row_checksum": row_checksum, "q4_0_gemv_warps": q4_0_gemv_warps,
            "q4_k_variant": q4_k_variant, "q6_k_variant": q6_k_variant}
