"""Patched builds of the kernels, timed side by side on the card: the
measurements behind the tensor-core GEMV's constants (`csrc/dq_gemv.cuh`)
and the tile plan (`csrc/dq_tile.cuh`), and ablations that say where a
kernel's time goes.

    python -m gemma_tpu_torch.tools.probe_variants gemv [--variants base,tw16,...] [--fmt q4_0,q8_0]
    python -m gemma_tpu_torch.tools.probe_variants tile [--variants ...] [--fmt q8_0] [--ms 17,64,203]

A variant is a list of text substitutions in a copy of
`gemma_tpu_torch/csrc/`, built into `gemma_tpu_torch/build/variants/<name>/`
(`kernels/build.py build_library`). For each main-path shape of q4_0
(Gemma-2B) and q8_0 (Gemma-7B), and each M (gemv: the serving step's 8;
tile: the prefill rows), a line gives the library call (torch.matmul of
the weight dequantized to bf16 beforehand) and each variant's time, all
device ms with L2 cold (`_timing.py`). Variants named `ab_*` drop a part
of the kernel and compute wrong results, so they are timed only; every
other variant is first held to the plain version within 1e-4 x max|ref|.
Runs on the card only.
"""
from __future__ import annotations

import argparse
import shutil

import torch

from ..kernels import build
from ..ops import quant_matmul as qmm
from ..quant.qtensor import dequant
from . import _timing as T

GV, TL = "dq_gemv.cuh", "dq_tile.cuh"
_PLAN = ("  const DqTilePlan p = dq_tile_plan(M, N, K);\n"
         "  if (p.splits > 1 && work == nullptr) return cudaErrorInvalidValue;\n")


def _forced(bm: int, bn: int) -> list[tuple[str, str, str]]:
    """The tile at bm x bn whatever the plan says (its K splits kept)."""
    return [(TL, _PLAN, f"  return launch_dq_tile_shape<F, {bm}, {bn}>(x, w, y, work, M, N, K, "
                        f"dq_splits(M, N, K, {bm}, {bn}), s);\n" + _PLAN)]


def _gv(old: str, new: str) -> tuple[str, str, str]:
    return (GV, old, new)


# name -> (file, old text, new text) substitutions in a copy of csrc/
VARIANTS: dict[str, list[tuple[str, str, str]]] = {
    "base": [],
    # the GEMV's constants
    "tw4": [_gv("kGvTargetWarps = 8;", "kGvTargetWarps = 4;")],
    "tw16": [_gv("kGvTargetWarps = 8;", "kGvTargetWarps = 16;")],
    "st3": [_gv("kGvStages = 4;", "kGvStages = 3;")],
    "st6": [_gv("kGvStages = 4;", "kGvStages = 6;")],
    "w2": [_gv("kGvWarps = 4;", "kGvWarps = 2;")],
    "w8": [_gv("kGvWarps = 4;", "kGvWarps = 8;")],
    "sl1024": [_gv("kGvSliceMax = 2048;", "kGvSliceMax = 1024;")],
    "sk256": [_gv("kGvStageK = 128;", "kGvStageK = 256;"),
              _gv("kGvScaleWords = 3;", "kGvScaleWords = 5;")],
    "nosplit": [_gv("kGvSliceMin = 512;", "kGvSliceMin = 1 << 30;")],
    # the tile's shape, forced
    "f64x64": _forced(64, 64), "f64x128": _forced(64, 128), "f128x64": _forced(128, 64),
    "f128x128": _forced(128, 128),
    # ablations of the tile: a part dropped
    "ab_nodeq": [(TL, "      F::store(src + r * F::kRaw", "      if (false) F::store(src + r * F::kRaw")],
    "ab_nomma": [(TL, "    if (rows && mma_first) mma_step(k);", ""),
                 (TL, "    if (rows && !mma_first) mma_step(k);", "")],
    "ab_noload": [(TL, "    if (k + S - 1 < steps) issue(k + S - 1);", "")],
    "ab_nosync": [(TL, "    cp_async_wait<S - 3>();  // step k + 2 has landed\n    __syncthreads();",
                   "    cp_async_wait<S - 3>();")],
    # ablations of the GEMV
    "ab_gv_nomma": [_gv("          mma_16816(f, a, __byte_perm(xv.x, xv.y, 0x5410), "
                        "__byte_perm(xv.x, xv.y, 0x7632));",
                        "          f[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ xv.x ^ xv.y);")],
    "ab_gv_noload": [_gv("    if (st + kS - 1 < nstages) issue(st + kS - 1);", "")],
}

# the main path's shapes (chip_smoke.py MATMUL_SHAPES): q4_0 Gemma-2B, q8_0 Gemma-7B
SHAPES = {
    "q4_0": [("qkv", 2560, 2048), ("attn_out", 2048, 2048), ("gate_up", 32768, 2048),
             ("down", 2048, 16384), ("head", 256000, 2048)],
    "q8_0": [("qkv", 12288, 3072), ("attn_out", 3072, 4096), ("gate_up", 49152, 3072),
             ("down", 3072, 24576), ("head", 256000, 3072)],
}


def patched_sources(name: str) -> dict[str, str]:
    """The text of each source file variant `name` changes; raises unless
    every substitution's old text occurs exactly once."""
    out: dict[str, str] = {}
    for f, old, new in VARIANTS[name]:
        text = out.get(f) or (build.CSRC / f).read_text()
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} occurs {text.count(old)} times in {f}")
        out[f] = text.replace(old, new)
    return out


def build_variant(name: str):
    """The kernel library of variant `name`, built from a patched copy."""
    root = build.BUILD_DIR / "variants" / name
    csrc = root / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(build.CSRC, csrc)
    for f, text in patched_sources(name).items():
        (csrc / f).write_text(text)
    return build.build_library(csrc, root)


def run(mode: str, names: list[str], fmts: list[str], ms: list[int], dev: torch.device) -> None:
    libs = {name: build_variant(name) for name in names}
    gen = T.generator(dev)
    for fmt in fmts:
        for sname, N, K in SHAPES[fmt]:
            if mode == "tile" and sname == "head":
                continue  # a prefill runs the head at its last row only
            qt = T.random_qtensor(fmt, N, K, gen, dev)
            for M in ms:
                x = T.bf16_x(M, K, gen, dev)
                ref = qmm.PLAIN[fmt](x, qt)
                w16 = dequant(qt, torch.bfloat16)
                lib_ms = T.time_us(lambda a, b: torch.matmul(a, b.T),
                                   T.replicate((x, w16), T.copies_for(T.nbytes(x, w16), dev)),
                                   dev) / 1e3
                del w16
                readings = []
                for name, lib in libs.items():
                    with build.using(lib):
                        if not name.startswith("ab_"):
                            T.check(f"{fmt} {sname} M={M} variant {name}", qmm.MATMULS[fmt](x, qt),
                                    ref, 1e-4)
                        args = T.replicate((x, qt), T.copies_for(T.nbytes(x, qt), dev))
                        readings.append(f"{name} {T.time_us(qmm.MATMULS[fmt], args, dev) / 1e3:.4f}")
                        del args
                print(f"{fmt} {sname} M={M} N={N} K={K}: library {lib_ms:.4f}; " + "; ".join(readings),
                      flush=True)
            del qt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("gemv", "tile"))
    ap.add_argument("--variants", default="base,tw4,tw16,st3,st6,w2,w8,sl1024,sk256,nosplit",
                    help="comma-separated names of VARIANTS")
    ap.add_argument("--fmt", default="q4_0,q8_0")
    ap.add_argument("--ms", default=None, help="rows of x (gemv: 8; tile: 17,64,203)")
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("probe_variants: no CUDA device (it times builds of the kernels on the card)")
    dev = torch.device("cuda", 0)
    ms = [int(m) for m in (args.ms or ("8" if args.mode == "gemv" else "17,64,203")).split(",")]
    print(T.card_line(dev), flush=True)
    run(args.mode, names, args.fmt.split(","), ms, dev)


if __name__ == "__main__":
    main()
