"""Probe: the int4 paths of the card, each held against the reference
probe's own formulas.

The counterpart of the reference's `tools/probe_int4.py`, which asked
whether Mosaic took int4 refs in a Pallas kernel. The card has no int4
dtype in its compute path: the port packs int4 as nibbles in u8 and unpacks
them in registers. Its three kernels:

  kernel   int4 -> bf16, times bf16 scales, dot [8, 512] x [512, 256]: the
           bf16sc mode of `qmm_variant` with f32 scales (rounded to bf16)
  kernel2  int4 -> bf16 dot, no scale, [8, 2048] x [2048, 512]: the noscale
           mode of `qmm_variant`
  kernel3  int8 x int4 -> int32, [8, 512] x [512, 256]: `int4_dot` (__dp4a
           on nibbles sign-extended to int8), exact

Each prints OK or WRONG (and raises on WRONG), with its L2-cold time. The
tolerances: kernel rounds each scale and each weight to bf16 (2^-9
relative each), 1e-2 of the output's scale against the f32 formula;
kernel2's products are exact, 1e-5.

    python -m gemma_tpu_torch.tools.probe_int4 [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..models.params import resolve_device
from ..ops import qmm_variants as qv
from . import _timing as T

M = qv.GEMV_M


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.double() - ref.double()).abs().max() / (ref.double().abs().max() + 1e-9)).item()


def _line(ok: bool, what: str, detail: str) -> str:
    line = f"{what} {'OK' if ok else 'WRONG'}: {detail}"
    print(line, flush=True)
    if not ok:
        raise RuntimeError(line)
    return line


def run(dev: torch.device, reps: int = 5) -> dict:
    tally = T.Tally()
    print(T.card_line(dev), flush=True)
    gen = T.generator(dev)
    K, N = 512, 256
    vals = torch.randint(-8, 8, (K, N), generator=gen, device=dev, dtype=torch.int8)  # [K, N]
    w4 = qv.pack_int4(vals.T.contiguous())
    _line(torch.equal(qv.int4_values(w4), vals.T), "int4 nibbles (u8 [N, K/2]) on the device",
          f"{tuple(w4.shape)} round-trips {tuple(vals.T.shape)}")
    out = {}

    def timed(name, kernel, args):
        us = T.time_us(kernel, T.replicate(args, T.copies_for(T.nbytes(*args), dev)), dev, reps)
        out[name] = us
        return f"{us:.2f} us L2 cold" + ("" if dev.type == "cuda" else f" {T.CPU_NOTE}")

    # kernel: int4 * bf16(scale) in bf16, dot with bf16 x
    x = T.bf16_x(M, K, gen, dev)
    sc = torch.randn(K // 32, N, generator=gen, device=dev)  # f32 [K/32, N], the probe's
    qs = qv.pack_q4_0_values(vals.T.contiguous())
    sc_t = sc.T.contiguous()
    k1 = tally.call("qmm_variant", lambda *a: qv.qmm_variant("bf16sc", *a))
    got = k1(x, qs, sc_t)
    ref = x.float() @ (vals.float() * sc.repeat_interleave(32, dim=0))  # probe_int4.py:72-74
    err = _rel_err(got, ref)
    exact = T.check("probe kernel", got, qv.qmm_variant_plain("bf16sc", x, qs, sc_t), 1e-4)
    _line(err <= 1e-2, "int4 * bf16 scale dot (kernel)",
          f"rel err {err:.2e} against the f32 formula (tol 1e-2); plain version {exact}; "
          + timed("kernel", k1, (x, qs, sc_t)))

    # kernel2: tiled int4 dot, no scale
    K2, N2 = 2048, 512
    vals2 = torch.randint(-8, 8, (K2, N2), generator=gen, device=dev, dtype=torch.int8)
    x2 = T.bf16_x(M, K2, gen, dev)
    qs2 = qv.pack_q4_0_values(vals2.T.contiguous())
    ones = torch.ones(N2, K2 // 32, device=dev)
    k2 = tally.call("qmm_variant", lambda *a: qv.qmm_variant("noscale", *a))
    got = k2(x2, qs2, ones)
    err = _rel_err(got, x2.float() @ vals2.float())  # probe_int4.py:113
    _line(err <= 1e-5, "tiled int4 dot (kernel2)",
          f"rel err {err:.2e} (tol 1e-5); " + timed("kernel2", k2, (x2, qs2, ones)))

    # kernel3: int8 x int4 -> int32
    xi8 = torch.randint(-100, 100, (M, K), generator=gen, device=dev, dtype=torch.int8)
    k3 = tally.call("int4_dot", qv.int4_dot)
    got = k3(xi8, w4)
    ref = (xi8.double() @ vals.double()).to(torch.int32)  # probe_int4.py:133
    _line(torch.equal(got, ref), "int8 x int4 -> int32 dot (kernel3)",
          "exact; " + timed("kernel3", k3, (xi8, w4)))
    print(tally.report(dev), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(resolve_device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
