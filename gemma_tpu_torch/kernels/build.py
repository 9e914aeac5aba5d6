"""Build and bind the port's CUDA kernels.

`gemma_tpu_torch/csrc/*.cu` compile at first use, with nvcc for Hopper
(`-gencode arch=compute_90a,code=sm_90a`), one nvcc process per source, all
started together, and link into one shared library with a plain C interface
under `gemma_tpu_torch/build/`, named by a hash of the sources and flags so
an edit rebuilds and an unchanged tree reuses the build. The library is
loaded with ctypes: pointers and the CUDA stream pass as `c_void_p`. Each C
entry point returns `cudaGetLastError()` after its launches, and `check`
raises on anything but 0.

There is no fallback: a missing nvcc or a failed build raises
`KernelBuildError` (with nvcc's stderr), never returns None.

`build_library` also builds a patched copy of the sources (the variants of
`gemma_tpu_torch/tools/probe_variants.py`), and `using` runs the wrappers
through such a build.

`workspace` keeps the persistent scratch and tickets that kernels which
merge their splits in the same launch share, one pair a stream, and
`matmul_scratch` the quantized matmuls' scratch sizes, a query a shape.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"

NVCC_FLAGS = (  # compile flags of each source; the link adds -shared
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# format codes of gt_matmul_work_bytes (csrc/q4_0_matmul.cu)
FORMAT_CODES = {"q4_0": 0, "q8_0": 1, "q4_k": 2, "q6_k": 3}
INT8_CODE = 2  # int8 K/V with f32 scales

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (all return a cudaError_t as int)
SIGNATURES = {
    # x, x_dtype, qs, scales, y, work, tickets, M, N, K, stream
    "gt_q4_0_matmul": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # x, x_dtype, qs, scales, y, work, tickets, M, N, K, stream
    "gt_q8_0_matmul": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # x, x_dtype, qs, scales, dm, y, work, tickets, M, N, K, stream
    "gt_q4_k_matmul": (_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # x, x_dtype, ql, qh, sc, d, y, work, tickets, M, N, K, stream
    "gt_q6_k_matmul": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # q, k, v, k_scale, v_scale, kv_limit, out, part_m, part_l, part_o,
    # B, Hq, Hkv, S, D, q_dtype, kv_dtype, split, window, softcap, stream
    "gt_decode_attention": (_P,) * 10 + (_I,) * 9 + (_F, _P),
    # q, k_pages, v_pages, k_scale, v_scale, page_table, kv_limit, out, part_m, part_l, part_o,
    # B, Hq, Hkv, page_size, max_pages, D, q_dtype, kv_dtype, window, softcap, stream
    "gt_paged_attention": (_P,) * 11 + (_I,) * 9 + (_F, _P),
    # q, k_pages, v_pages, k_scale, v_scale, page_table, kv_limit, out, work, tickets,
    # B, Hq, Hkv, page_size, max_pages, D, q_dtype, kv_dtype, split, window, softcap, stream
    "gt_paged_attention_tc": (_P,) * 10 + (_I,) * 10 + (_F, _P),
    # q, k, v, k_scale, v_scale, kv_limit, out, work, tickets,
    # B, Hq, Hkv, S, D, q_dtype, kv_dtype, split, window, softcap, stream
    "gt_decode_attention_tc": (_P,) * 9 + (_I,) * 9 + (_F, _P),
    # q, k, v, k_scale, v_scale, kv_limit, out, work, tickets,
    # B, Hq, Hkv, S, D, q_dtype, kv_dtype, split, window, softcap, stream
    "gt_decode_attention_g1": (_P,) * 9 + (_I,) * 9 + (_F, _P),
    # q, k_pages, v_pages, k_scale, v_scale, page_table, kv_limit, out, work, tickets,
    # B, Hq, Hkv, page_size, max_pages, D, q_dtype, kv_dtype, split, window, softcap, stream
    "gt_paged_attention_g1": (_P,) * 10 + (_I,) * 10 + (_F, _P),
    # q, k, v, positions, kv_limit, out, B, T, Hq, Hkv, S, D, row warps, window, softcap, stream
    "gt_flash_attention_tc": (_P,) * 6 + (_I,) * 8 + (_F, _P),
    # the same for f32 q, k, v and out at the plan's row warps (no row-warps argument)
    "gt_flash_attention_tf32": (_P,) * 6 + (_I,) * 7 + (_F, _P),
    # the decode-GEMV instruments (ops/qmm_variants.py)
    # x, mode, qs, scales, sc_dtype, y, M, N, K, stream
    "gt_qmm_variant": (_P, _I, _P, _P, _I, _P, _I, _I, _I, _P),
    # x, w, y, M, N, K, stream
    "gt_int4_dot": (_P, _P, _P, _I, _I, _I, _P),
    # four (array, row_bytes, width), out, N, stream
    "gt_row_checksum": (_P, _I, _I) * 4 + (_P, _I, _P),
    # x, qs, scales, y, N, K, warps, stream
    "gt_q4_0_gemv_warps": (_P, _P, _P, _P, _I, _I, _I, _P),
    # x, mode, qs, scales, dm, y, N, K, stream
    "gt_q4_k_variant": (_P, _I, _P, _P, _P, _P, _I, _I, _P),
    # x, mode, a0, a1, a2, a3, y, N, K, stream
    "gt_q6_k_variant": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _P),
}


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # time of the build this process ran, if any


def sources(csrc: Path | None = None) -> list[Path]:
    csrc = csrc or CSRC
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of gemma_tpu_torch build only where the CUDA toolkit is installed. "
        "Tensors on the CPU use the plain PyTorch versions and need no build."
    )


def library_path(csrc: Path | None = None, build_dir: Path | None = None) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return (build_dir or BUILD_DIR) / f"libgemma_tpu_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> str:
    """Run nvcc commands side by side; their stderr, or KernelBuildError."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate()[1] for p in procs]
    for cmd, proc, err in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{err}")
    return "".join(outs)


def _compile(out: Path, csrc: Path) -> None:
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cus = sorted(csrc.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in cus]
    try:
        # ptxas -v: registers, shared memory and spills of every kernel
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for src, o in zip(cus, objs)])
        _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    except KernelBuildError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file


def build_library(csrc: Path | None = None, build_dir: Path | None = None,
                  entries: tuple[str, ...] | None = None) -> ctypes.CDLL:
    """The library of the sources under `csrc` (default: the package's),
    built into `build_dir` unless a build of the same sources is there, and
    bound: `entries` of SIGNATURES (default: all), each of which it must
    have."""
    global build_seconds
    path = library_path(csrc, build_dir)
    if not path.exists():
        t0 = time.perf_counter()
        _compile(path, csrc or CSRC)
        build_seconds = time.perf_counter() - t0
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelBuildError(f"cannot load {path}: {e}") from e
    for name in entries or SIGNATURES:
        if not hasattr(lib, name):
            raise KernelBuildError(f"{path} has no entry point {name}")
        fn = getattr(lib, name)
        fn.argtypes = list(SIGNATURES[name])
        fn.restype = ctypes.c_int
    lib.gt_error_string.argtypes = [ctypes.c_int]
    lib.gt_error_string.restype = ctypes.c_char_p
    # format, x_dtype, M, N, K, &tickets -> bytes of a quantized matmul's
    # f32 scratch; sets the count of its tickets (ints kept at 0 between
    # launches)
    lib.gt_matmul_work_bytes.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.gt_matmul_work_bytes.restype = ctypes.c_size_t
    # launches of the TF32 tile (csrc/dq_tile_tf32.cuh) so far in this process
    lib.gt_dq_tile_tf32_launches.argtypes = []
    lib.gt_dq_tile_tf32_launches.restype = ctypes.c_ulonglong
    # launches of the GEMV with f32 x (csrc/dq_gemv.cuh) so far in this process
    lib.gt_dq_gemv_f32_launches.argtypes = []
    lib.gt_dq_gemv_f32_launches.restype = ctypes.c_ulonglong
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = build_library()
        return _lib


@contextlib.contextmanager
def using(lib: ctypes.CDLL):
    """Every wrapper launches through `lib` (another build, as
    `build_library` returns) inside the block."""
    global _lib
    with _lock:
        prev, _lib = _lib, lib
    try:
        yield lib
    finally:
        with _lock:
            _lib = prev


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load().gt_error_string(err).decode()
        raise KernelLaunchError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_scratch: dict[tuple, tuple[int, int]] = {}


def matmul_scratch(lib: ctypes.CDLL, fmt: int, x_dtype: int, M: int, N: int, K: int) -> tuple[int, int]:
    """(bytes of f32 scratch, tickets) of a quantized matmul through `lib`
    at (format code, dtype code, M, N, K): `gt_matmul_work_bytes`, asked
    once a library and shape."""
    key = (lib, fmt, x_dtype, M, N, K)
    got = _scratch.get(key)
    if got is None:
        tickets = ctypes.c_int(0)
        got = _scratch[key] = (lib.gt_matmul_work_bytes(fmt, x_dtype, M, N, K, ctypes.byref(tickets)),
                               tickets.value)
    return got


_workspaces: dict[tuple[torch.device, int], tuple[torch.Tensor, torch.Tensor]] = {}


def workspace(device: torch.device, stream: int, floats: int, tickets: int):
    """(f32 scratch of >= `floats`, i32 tickets of >= `tickets`, all 0) on
    `device`, one pair for each stream (`stream`: its cudaStream_t), kept
    between calls and grown on demand: the tensor-core and G = 1 decode
    attention cores' (ops/attention.py, and through pages
    ops/paged_attention.py) and the
    quantized matmuls' K-split scratch and the GEMV's tickets
    (ops/quant_matmul.py). Each kernel leaves its tickets at
    0, so the launches that share a pair run in order on their stream.
    Growth allocates: a launch captured in a CUDA graph needs its pair
    sized beforehand, at the largest batch and S and the widest weight
    whose matmul splits K."""
    ws = _workspaces.get((device, stream))
    if ws is None or ws[0].numel() < floats or ws[1].numel() < tickets:
        floats = max(floats, 0 if ws is None else ws[0].numel())
        tickets = max(tickets, 0 if ws is None else ws[1].numel())
        ws = (torch.empty(floats, dtype=torch.float32, device=device),
              torch.zeros(tickets, dtype=torch.int32, device=device))
        _workspaces[(device, stream)] = ws
    return ws
