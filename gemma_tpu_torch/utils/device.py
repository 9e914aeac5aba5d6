"""Per-device peak numbers for roofline accounting.

Counterpart of `gemma_tpu/utils/device.py`: a lookup by
`torch.cuda.get_device_name()` that returns (HBM GB/s, dense bf16 FLOP/s).
Its one entry is the card the port is built for, the H100 SXM, from NVIDIA's
data sheet at its 700 W limit (a card set to a lower `power.limit` runs
slower under load: print the limit beside a number). The profiler, the
CLI and the benches' harness (`tools/_timing.py`) read these numbers from
here. A CPU or an unknown device gets the reference's nominal pair, with a
warning that says so.
"""
from __future__ import annotations

import warnings

# H100 SXM (the name "NVIDIA H100 80GB HBM3"): HBM3 bandwidth and the dense
# bf16 tensor-core rate, NVIDIA data sheet at 700 W
H100_SXM = (3350.0, 989e12)
# its float32 rate outside the tensor cores (data sheet): the bound of the
# f32 evaluation routes (the plain-FMA tiles and the FMA flash kernel)
H100_F32_FLOPS = 67e12
# its dense TF32 tensor-core rate (data sheet): the bound of q4_k's and
# q6_k's f32 route (csrc/dq_tile_tf32.cuh), at two passes of it
H100_TF32_FLOPS = 495e12
# name substring (lower case) -> (HBM GB/s, dense bf16 FLOP/s)
_PEAKS = [("h100 80gb hbm3", H100_SXM)]
NOMINAL = (100.0, 1e12)  # the reference's pair for a CPU or an unknown device


def peaks_for(name: str) -> tuple[float, float]:
    """(HBM GB/s, dense bf16 FLOP/s) of the device called `name`; the
    nominal pair, with a warning, for a name the table does not hold."""
    low = name.lower()
    for sub, peaks in _PEAKS:
        if sub in low:
            return peaks
    warnings.warn(f"no peak numbers for device {name!r}: using the nominal {NOMINAL}",
                  stacklevel=2)
    return NOMINAL


def device_peaks(device=None) -> tuple[float, float]:
    """(HBM GB/s, dense bf16 FLOP/s) of `device` (default: the current
    CUDA device, or the CPU where there is none)."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return peaks_for(f"{device.type} (no accelerator)")
    return peaks_for(torch.cuda.get_device_name(device))
