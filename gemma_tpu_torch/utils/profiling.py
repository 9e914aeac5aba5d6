"""Profiling: named spans, counters, and a roofline ledger.

Counterpart of `gemma_tpu/utils/profiling.py`, with its API and report
format: accumulating named spans with call counts and exclusive time,
named counters, a prefix-grouped percentage report, and a roofline ledger
that records bytes moved and FLOPs per execution and reports achieved
against peak bandwidth and compute. `torch_trace(logdir)` captures a
`torch.profiler` trace around a region for kernel-level drill-down (the
reference's `xla_trace`).

Usage::

    from gemma_tpu_torch.utils import profiling as prof
    prof.enable()
    with prof.span("decode.step"):
        ...
    prof.add_count("tokens", 128)
    prof.roofline("q4_0_matmul", seconds=t, bytes_moved=nb, flops=fl)
    print(prof.report())

Spans measure host wall-clock. CUDA work is asynchronous, so a span around
a launch measures its enqueue unless the caller synchronizes: in the
sampled-synchronous mode (`enable(sync_every=N)`) the engine calls
`torch.cuda.synchronize()` every Nth decode dispatch, so span groups
measure device time. Disabled (the default), every call is a no-op that
touches no tensor.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from dataclasses import dataclass, field

from .device import H100_SXM


@dataclass
class _SpanStat:
    total_s: float = 0.0
    excl_s: float = 0.0  # total minus time spent in nested spans
    count: int = 0


@dataclass
class _RooflineStat:
    total_s: float = 0.0
    bytes_moved: int = 0
    flops: int = 0
    count: int = 0


@dataclass
class _State:
    enabled: bool = False
    spans: dict[str, _SpanStat] = field(default_factory=lambda: collections.defaultdict(_SpanStat))
    counters: dict[str, float] = field(default_factory=lambda: collections.defaultdict(float))
    rooflines: dict[str, _RooflineStat] = field(
        default_factory=lambda: collections.defaultdict(_RooflineStat))
    lock: threading.Lock = field(default_factory=threading.Lock)
    # peaks for the roofline report (the H100 SXM's); override via
    # set_peaks() or autoset_peaks()
    peak_hbm_gbs: float = H100_SXM[0]
    peak_flops: float = H100_SXM[1]
    # sampled-synchronous mode: the engine synchronizes every Nth decode
    # dispatch, so span groups measure device time, not queueing. 0 = off.
    sync_every: int = 0


_state = _State()
_tls = threading.local()


def enable(sync_every: int | None = None) -> None:
    _state.enabled = True
    if sync_every is not None:
        _state.sync_every = sync_every


def sync_every() -> int:
    """Engine hook: synchronize every Nth decode dispatch (0 = never).
    Only meaningful while profiling is enabled."""
    return _state.sync_every if _state.enabled else 0


def disable() -> None:
    _state.enabled = False


def is_enabled() -> bool:
    return _state.enabled


def autoset_peaks() -> None:
    """Set roofline peaks from the visible device (`device.device_peaks`)."""
    from .device import device_peaks

    hbm, flops = device_peaks()
    set_peaks(hbm_gbs=hbm, flops=flops)


def reset() -> None:
    with _state.lock:
        _state.spans.clear()
        _state.counters.clear()
        _state.rooflines.clear()


def set_peaks(hbm_gbs: float | None = None, flops: float | None = None) -> None:
    if hbm_gbs is not None:
        _state.peak_hbm_gbs = hbm_gbs
    if flops is not None:
        _state.peak_flops = flops


@contextlib.contextmanager
def span(name: str):
    """Accumulating named interval. Each span also records EXCLUSIVE time
    (total minus nested spans on the same thread), so group sums in the
    report reconcile with wall-clock instead of double-counting parents and
    children."""
    if not _state.enabled:
        yield
        return
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(0.0)  # nested-child time accumulator for this span
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        child = stack.pop()
        if stack:
            stack[-1] += dt
        with _state.lock:
            st = _state.spans[name]
            st.total_s += dt
            st.excl_s += dt - child
            st.count += 1


def add_count(name: str, value: float = 1.0) -> None:
    """Named counter channel."""
    if not _state.enabled:
        return
    with _state.lock:
        _state.counters[name] += value


def count_once(name: str) -> None:
    """Set counter `name` to 1 if it is not there yet: a histogram of the
    distinct keys seen (the matmul shapes of `ops.linear`)."""
    if not _state.enabled:
        return
    with _state.lock:
        _state.counters.setdefault(name, 1.0)


def roofline(name: str, seconds: float, bytes_moved: int, flops: int = 0) -> None:
    """Record one execution against the roofline ledger."""
    if not _state.enabled:
        return
    with _state.lock:
        st = _state.rooflines[name]
        st.total_s += seconds
        st.bytes_moved += bytes_moved
        st.flops += flops
        st.count += 1


def report(group_depth: int = 1) -> str:
    """Prefix-grouped report with % of total, plus the counters and the
    roofline table."""
    lines: list[str] = []
    with _state.lock:
        total = sum(s.excl_s for s in _state.spans.values())
        if _state.spans:
            lines.append(f"== spans (exclusive total {total*1e3:.1f} ms) ==")
            groups: dict[str, list[tuple[str, _SpanStat]]] = collections.defaultdict(list)
            for name, st in _state.spans.items():
                prefix = ".".join(name.split(".")[:group_depth])
                groups[prefix].append((name, st))
            for prefix in sorted(groups, key=lambda p: -sum(s.excl_s for _, s in groups[p])):
                gtotal = sum(s.excl_s for _, s in groups[prefix])
                pct = 100.0 * gtotal / total if total else 0.0
                lines.append(f"[{prefix}] {gtotal*1e3:10.2f} ms  {pct:6.2f} %")
                for name, st in sorted(groups[prefix], key=lambda kv: -kv[1].excl_s):
                    lines.append(
                        f"  {name:<40} {st.excl_s*1e3:10.2f} ms excl "
                        f"({st.total_s*1e3:.2f} incl)  x{st.count:<6d}"
                        f" {st.total_s/st.count*1e6:9.1f} us/call"
                    )
        if _state.counters:
            lines.append("== counters ==")
            for name, v in sorted(_state.counters.items()):
                lines.append(f"  {name:<40} {v:g}")
        if _state.rooflines:
            lines.append("== roofline (achieved vs peak) ==")
            for name, st in sorted(_state.rooflines.items(), key=lambda kv: -kv[1].total_s):
                bw = st.bytes_moved / st.total_s / 1e9 if st.total_s else 0.0
                fl = st.flops / st.total_s / 1e12 if st.total_s else 0.0
                bw_pct = 100.0 * bw / _state.peak_hbm_gbs
                fl_pct = 100.0 * fl * 1e12 / _state.peak_flops
                bound = "BW" if bw_pct >= fl_pct else "FLOP"
                lines.append(
                    f"  {name:<32} x{st.count:<6d} {st.total_s*1e3:9.2f} ms "
                    f"{bw:8.1f} GB/s ({bw_pct:5.1f}% peak) "
                    f"{fl:7.2f} TFLOP/s ({fl_pct:5.1f}% peak) [{bound}-bound]"
                )
    return "\n".join(lines) if lines else "(profiling: no data)"


@contextlib.contextmanager
def torch_trace(logdir: str):
    """Capture a torch.profiler trace (CPU and, where there is one, CUDA
    activity) around a region, written to `logdir` as a Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
