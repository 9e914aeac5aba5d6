"""Golden-tensor dump / differential-testing harness.

Counterpart of `gemma_tpu/utils/tensor_dump.py`, taking torch tensors:
* dumps are ``.npy`` (dtype and shape kept; bf16 widened to f32, which
  numpy cannot hold);
* comparison is tolerance-aware (`atol`/`rtol` with a max/mean error
  report and the first mismatch);
* the capture hook: `capture()` opens a context that the model's forward
  (`models/gemma.py`: `inp_embd`, `blk.{i}.attn_out`, `blk.{i}.ffn_out`,
  `result_norm`, `result_output`, the reference's names) reports named
  activations into, filtered by the reference's `name:tensor` dump-list
  format.

`record` is safe in the hot path: with no capture open it returns before
it touches the tensor (no copy, no host sync). A capture copies each
matching tensor to the host, which waits for the device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import threading
import warnings
from pathlib import Path

import numpy as np
import torch

_local = threading.local()


def _to_numpy(value) -> np.ndarray:
    """numpy-ify a tensor or array; bf16 and fp8 tensors are widened to f32
    on the way (`.float().cpu()`), since numpy has no such dtypes."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(value)


# ---------------------------------------------------------------------------
# Capture context
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Capture:
    patterns: tuple[str, ...]
    values: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def wants(self, name: str) -> bool:
        return any(fnmatch.fnmatch(name, p) for p in self.patterns)

    def record(self, name: str, value) -> None:
        if self.wants(name):
            self.values[name] = _to_numpy(value)


@contextlib.contextmanager
def capture(patterns: list[str] | tuple[str, ...] = ("*",)):
    """Collect named activations emitted via `record` inside this context."""
    cap = Capture(tuple(patterns))
    prev = getattr(_local, "capture", None)
    _local.capture = cap
    try:
        yield cap
    finally:
        _local.capture = prev
        if not cap.values:
            warnings.warn(f"tensor_dump.capture recorded nothing: no recorded name matched "
                          f"{list(patterns)}", stacklevel=2)


def record(name: str, value) -> None:
    """Report a named activation to the active capture context; a no-op
    that touches nothing of `value` when none is active."""
    cap = getattr(_local, "capture", None)
    if cap is not None:
        cap.record(name, value)


# ---------------------------------------------------------------------------
# Dump / compare
# ---------------------------------------------------------------------------

def dump_tensor(name: str, value, directory: str | Path, mode: str = "source") -> Path:
    """Write `<dir>/<name>_<mode>.npy` (the reference's naming)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"{_sanitize(name)}_{mode}.npy"
    np.save(path, _to_numpy(value))
    return path


def load_tensor(name: str, directory: str | Path, mode: str = "target") -> np.ndarray:
    return np.load(Path(directory) / f"{_sanitize(name)}_{mode}.npy")


def _sanitize(name: str) -> str:
    return name.replace("/", "_").replace(":", "_")


@dataclasses.dataclass
class DiffResult:
    name: str
    ok: bool
    max_abs: float
    max_rel: float
    mean_abs: float
    first_mismatch: tuple | None
    shape_mismatch: bool = False

    def __str__(self) -> str:
        if self.shape_mismatch:
            return f"[{self.name}] SHAPE MISMATCH"
        s = "OK " if self.ok else "FAIL"
        loc = f" first@{self.first_mismatch}" if self.first_mismatch else ""
        return (
            f"[{self.name}] {s} max_abs={self.max_abs:.3e} "
            f"max_rel={self.max_rel:.3e} mean_abs={self.mean_abs:.3e}{loc}"
        )


def compare_tensors(
    name: str,
    source,
    target,
    atol: float = 1e-3,
    rtol: float = 1e-2,
) -> DiffResult:
    """Tolerance-aware diff with first-mismatch reporting."""
    source = np.asarray(_to_numpy(source), np.float32)
    target = np.asarray(_to_numpy(target), np.float32)
    if source.shape != target.shape:
        return DiffResult(name, False, np.inf, np.inf, np.inf, None, shape_mismatch=True)
    diff = np.abs(source - target)
    denom = np.abs(target) + 1e-12
    ok_mask = diff <= atol + rtol * np.abs(target)
    ok = bool(ok_mask.all())
    first = None
    if not ok:
        first = tuple(int(i) for i in np.argwhere(~ok_mask)[0])
    return DiffResult(
        name,
        ok,
        float(diff.max(initial=0.0)),
        float((diff / denom).max(initial=0.0)),
        float(diff.mean()) if diff.size else 0.0,
        first,
    )


def compare_with_golden(
    values: dict[str, np.ndarray],
    directory: str | Path,
    atol: float = 1e-3,
    rtol: float = 1e-2,
) -> list[DiffResult]:
    """Diff captured activations against `<dir>/<name>_target.npy` dumps."""
    return [
        compare_tensors(n, v, load_tensor(n, directory, "target"), atol, rtol)
        for n, v in sorted(values.items())
    ]


# ---------------------------------------------------------------------------
# Dump-list config (the reference's format: "name:tensor_name", // comments)
# ---------------------------------------------------------------------------

def parse_dump_list(path: str | Path) -> list[tuple[str, str]]:
    """Parse the dump-list format: one `label:tensor_name` per line; `//`
    starts a comment."""
    out: list[tuple[str, str]] = []
    for raw in Path(path).read_text().splitlines():
        line = raw.split("//", 1)[0].strip()
        if not line:
            continue
        label, _, tensor = line.partition(":")
        if not tensor:
            raise ValueError(f"bad dump-list line: {raw!r}")
        out.append((label.strip(), tensor.strip()))
    return out
