"""The benches' shared harness: the card line, L2-cold device times, and
exact launch tallies.

Timing on the card: CUDA events around R back-to-back launches after a
warm-up, the median of `reps` repetitions. Two things keep that a device
time of the kernel as its real caller meets it:
* L2 cold: the launches rotate over C copies of their operands, with C x
  (bytes per copy) >= COLD_BYTES, twice the H100's 50 MB L2, so no launch
  finds its operand in L2 (in a decode step every weight is cold: the
  model's other weights pass between two uses). R is a multiple of C.
* Host cost hidden: a wrapper call costs the host tens of microseconds,
  more than a small kernel runs. Before each repetition the stream runs
  `torch.cuda._sleep` for longer than the host takes to enqueue the R
  launches (measured in the warm-up), so the launches run back to back on
  the device between the two events.

On the CPU (`--device cpu`, the plain versions) the times are host wall
times of one call and say nothing of the card: every line says so.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import time

import torch

from ..ops import qmm_variants as qv
from ..quant.qtensor import QTensor
from ..utils.device import H100_SXM

HBM_BPS = H100_SXM[0] * 1e9  # H100 SXM HBM3 (NVIDIA data sheet, 700 W)
# H100 SXM dense bf16 tensor-core rate (data sheet, 700 W). A GEMV's
# products of bf16 x with small-integer weights are exact there, summed in
# f32 with the scale applied per block after (the main path's gdot form),
# so this is the card's rate for the function, whatever the kernel uses.
BF16_FLOPS = H100_SXM[1]
COLD_BYTES = 100e6  # twice the H100's 50 MB L2
MIN_LAUNCHES = 20  # launches per repetition, at least
# copies at most: R stays under the launch queue's ~1024 entries, which
# would otherwise block the host mid-repetition; operands under 0.4 MB
# (the probe's) then stay partly in L2
MAX_COPIES = 256
CPU_NOTE = "(cpu: plain PyTorch versions; host times, meaningless for the card)"

_cycles_per_ms: float | None = None


def clock(dev: torch.device) -> str:
    """Whose time a bench's lines give: "device" on the card, "host" on the
    CPU (plain versions, host wall times)."""
    return "device" if dev.type == "cuda" else "host"


def card_line(dev: torch.device) -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of the
    card (the benches print it first), or the CPU note."""
    if dev.type != "cuda":
        return f"cpu {CPU_NOTE}"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[dev.index or 0]


def copies_for(nbytes: int, dev: torch.device) -> int:
    """Copies of `nbytes` of operands that together fill COLD_BYTES, at
    most MAX_COPIES (one on the CPU, where nothing is timed for the card)."""
    return min(MAX_COPIES, max(1, math.ceil(COLD_BYTES / nbytes))) if dev.type == "cuda" else 1


def replicate(args: tuple, copies: int) -> list[tuple]:
    """`copies` argument tuples: `args` itself, then clones of each tensor
    in it (QTensors and dicts of tensors too); other values are shared."""
    def clone(a):
        if isinstance(a, torch.Tensor):
            return a.clone()
        if isinstance(a, dict):
            return {k: clone(v) for k, v in a.items()}
        if isinstance(a, QTensor):
            return QTensor(a.fmt, **{k: v.clone() for k, v in a.arrays.items()})
        return a
    return [args] + [tuple(clone(a) for a in args) for _ in range(copies - 1)]


def nbytes(*items) -> int:
    """Bytes of the tensors in `items` (QTensors and dicts of tensors too)."""
    total = 0
    for a in items:
        if isinstance(a, torch.Tensor):
            total += a.numel() * a.element_size()
        elif isinstance(a, dict):
            total += nbytes(*a.values())
        elif isinstance(a, QTensor):
            total += nbytes(*a.arrays.values())
    return total


def _sleep_cycles(ms: float) -> int:
    """GPU clock cycles that `torch.cuda._sleep` spins for about `ms`."""
    global _cycles_per_ms
    if _cycles_per_ms is None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        torch.cuda.synchronize()
        _cycles_per_ms = 20_000_000 / start.elapsed_time(end)
    return int(ms * _cycles_per_ms)


def time_us(fn, arg_sets: list[tuple], dev: torch.device, reps: int = 5,
            launches: int = MIN_LAUNCHES) -> float:
    """Median µs per call of fn(*arg_sets[i % C]). On the
    card: CUDA events around R >= `launches` calls (R a multiple of C)
    behind a sleep that outlasts their enqueue, `reps` repetitions after a
    warm-up; on the CPU: the median host time of single calls."""
    C = len(arg_sets)
    if dev.type != "cuda":
        times = []
        for i in range(max(1, reps)):
            t0 = time.perf_counter()
            fn(*arg_sets[i % C])
            times.append((time.perf_counter() - t0) * 1e6)
        return statistics.median(times)
    R = C * max(1, math.ceil(launches / C))
    for a in arg_sets:  # warm-up: first calls, allocator
        fn(*a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(R):
        fn(*arg_sets[i % C])
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(_sleep_cycles(2.0 * enqueue_ms + 1.0))
        start.record()
        for i in range(R):
            fn(*arg_sets[i % C])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / R)
    return statistics.median(times)


def bound_us(nbytes_: float, flops: float) -> tuple[float, str]:
    """(least µs the card could take, "bytes" or "operations"): nbytes over
    HBM bandwidth against flops at the bf16 tensor-core rate."""
    t_bytes, t_ops = nbytes_ / HBM_BPS * 1e6, flops / BF16_FLOPS * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rate_line(us: float, nbytes_: float, flops: float, dev: torch.device) -> str:
    """`us`, GB/s at `nbytes_` and its fraction of 3.35 TB/s, and the bound,
    as the reference's tools print them."""
    b, term = bound_us(nbytes_, flops)
    line = (f"{us:10.2f} us {nbytes_ / us / 1e3:8.1f} GB/s {nbytes_ / us / 1e3 / (HBM_BPS / 1e9):6.3f} "
            f"of {HBM_BPS / 1e12:.2f} TB/s; bound {b:.2f} us ({term})")
    return line if dev.type == "cuda" else f"{line} {CPU_NOTE}"


class Tally:
    """Calls of each wrapper made by a bench, to hold the wrappers' launch
    counters to (on the card every call launches its kernel once)."""

    def __init__(self):
        self.calls: dict[str, int] = {}
        for op in qv.COUNTERS.values():
            op.launches = 0

    def call(self, name: str, fn):
        """fn, counted under `name` at every call."""
        def counted(*args):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*args)
        return counted

    def report(self, dev: torch.device) -> str:
        """The `launches {...}` line; raises on the card if a counter
        differs from the calls made."""
        counts = {name: qv.COUNTERS[name].launches for name in self.calls}
        if dev.type == "cuda" and counts != self.calls:
            raise RuntimeError(f"launch counters {counts} != calls {self.calls}")
        return "launches " + json.dumps(counts if dev.type == "cuda" else
                                        {name: 0 for name in self.calls})


def check(name: str, got: torch.Tensor, ref: torch.Tensor, rtol: float | None) -> str:
    """got against ref: within rtol x max|ref| (float), or equal (rtol
    None); raises otherwise. Returns the `max|diff|` text."""
    if rtol is None:
        if not torch.equal(got, ref):
            raise RuntimeError(f"{name}: differs from its plain version "
                               f"({int((got != ref).sum())} values)")
        return "exact"
    err = (got.float() - ref.float()).abs().max().item()
    tol = rtol * ref.abs().max().item() + 1e-6
    if not (torch.isfinite(got).all() and err <= tol):
        raise RuntimeError(f"{name}: max|diff| {err:.3e} > tol {tol:.3e}")
    return f"max|diff| {err:.2e} (tol {tol:.2e})"


def attn_err(got: torch.Tensor, ref: torch.Tensor, tol: float) -> tuple[float, float, float, float]:
    """(max|diff|, worst ratio, least and largest row scale) of attention
    output `got` against its plain version `ref` ([..., D]). Each row (one
    query of one head) is held to tol x its scale, min(1, max|ref| of the
    row): a row that averages n keys of values ~0.3 is ~0.3 / sqrt(n) in
    size (~0.05 at 4096 keys), so one absolute tolerance for every row
    would let a dropped split or key tile pass at long caches. A row with
    no valid key (scale 0) must be exactly 0. The check passes iff the
    worst ratio |diff| / (tol x scale) is <= 1 (and `got` is finite)."""
    diff = (got.float() - ref.float()).abs()
    scale = ref.float().abs().amax(dim=-1, keepdim=True).clamp(max=1.0)
    ratio = torch.where(scale > 0, diff / (tol * scale), torch.where(diff > 0, math.inf, 0.0))
    if not torch.isfinite(got).all():
        ratio = torch.full_like(ratio, math.inf)
    return (diff.max().item(), ratio.max().item(), scale.min().item(), scale.max().item())


def random_qtensor(fmt: str, rows: int, cols: int, gen: torch.Generator, dev) -> QTensor:
    """Random payload bytes and tables of a `fmt` weight [rows, cols], the
    scales sized for outputs near 1 (exact f16)."""
    def bytes_(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)

    def scales(base, *shape):
        return ((torch.rand(*shape, generator=gen, device=dev) + 0.5) * base).to(torch.float16)

    if fmt == "q4_0":
        return QTensor("q4_0", qs=bytes_(rows, cols // 2), scales=scales(0.005, rows, cols // 32))
    if fmt == "q8_0":
        return QTensor("q8_0", qs=bytes_(rows, cols).view(torch.int8),
                       scales=scales(3e-4, rows, cols // 32))
    if fmt == "q4_k":
        return QTensor("q4_k", qs=bytes_(rows, cols // 2), scales=bytes_(rows, cols // 256, 12),
                       dm=scales(1e-4, rows, cols // 256, 2))
    return QTensor("q6_k", ql=bytes_(rows, cols // 2), qh=bytes_(rows, cols // 4),
                   sc=bytes_(rows, cols // 16).view(torch.int8), d=scales(2e-5, rows, cols // 256))


def generator(dev: torch.device, seed: int = 0) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def bf16_x(rows: int, cols: int, gen: torch.Generator, dev) -> torch.Tensor:
    return torch.randn(rows, cols, generator=gen, device=dev).to(torch.bfloat16)


# the serving and step benches' models: --model name -> config
MODELS = ("gemma2b", "gemma7b", "tiny")


def model_config(name: str):
    """Gemma-2B and Gemma-7B at their published widths, or "tiny":
    `testing.TINY_KERNEL_CONFIG`, the smallest geometry the CUDA attention
    kernels take (the reference's tiny model is a bf16 TINY_CONFIG; the
    port fabricates block formats only)."""
    from ..models import GEMMA_2B, GEMMA_7B
    from ..testing import TINY_KERNEL_CONFIG

    return {"gemma2b": GEMMA_2B, "gemma7b": GEMMA_7B, "tiny": TINY_KERNEL_CONFIG}[name]


def token_ids(n: int, vocab: int, offset: int = 0) -> list[int]:
    """The reference benches' prompt [2 + (j + offset) % 1000 for j < n],
    wrapped inside a vocabulary smaller than 1002 (the tiny model's 512)."""
    mod = min(1000, vocab - 2)
    return [2 + (j + offset) % mod for j in range(n)]


def reset_launches() -> None:
    """Set every kernel launch counter of the main path's ops to 0."""
    from ..utils.verify import launch_counters

    for _, op, attr in launch_counters():
        setattr(op, attr, 0)


def launches_line(dev: torch.device) -> str:
    """`launches {...}`: the main path's kernel launch counters that moved
    since `reset_launches`. On the card every wrapper call launches its
    kernel or raises, and a plain version runs there only while an op's
    `set_force_plain` is on (`utils.verify`): this raises if one is on, or
    if no kernel was launched. On the CPU the plain versions run and the
    line reads `launches {}`."""
    from ..ops import attention as att
    from ..ops import paged_attention as pat
    from ..ops import quant_matmul as qmm
    from ..utils.verify import read_launches

    counts = {name: n for name, n in read_launches().items() if n}
    if dev.type == "cuda":
        forced = [m.__name__ for m in (qmm, att, pat) if m.forcing_plain()]
        if forced:
            raise RuntimeError(f"plain versions forced on the card by {forced}")
        if not counts:
            raise RuntimeError("no kernel was launched on the card")
    return "launches " + json.dumps(counts)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile_busy(fn, dev: torch.device, match: str = r"$^"):
    """(device busy ms, device kernels, device ms of the kernels whose name
    matches the regular expression `match`) of one call of fn, from
    torch.profiler: the sum of the kernels' device times and their count,
    as chip_smoke.py reads a decode step's busy time. Nones on the CPU,
    where nothing runs on a card."""
    if dev.type != "cuda":
        fn()
        return None, None, None
    import re

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    events = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    return (sum(e.self_device_time_total for e in events) / 1e3, sum(e.count for e in events),
            sum(e.self_device_time_total for e in events if re.search(match, e.key)) / 1e3)
