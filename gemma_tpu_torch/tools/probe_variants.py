"""Patched builds of the kernels, timed side by side on the card: the
measurements behind the tensor-core GEMV's constants (`csrc/dq_gemv.cuh`)
and the tile plan (`csrc/dq_tile.cuh`), and ablations that say where a
kernel's time goes; and the tensor-core attention kernels' launch shapes.

    python -m gemma_tpu_torch.tools.probe_variants gemv [--variants base,tw16,...] [--fmt q4_k,q6_k] [--ms 1,8]
    python -m gemma_tpu_torch.tools.probe_variants tile [--variants ...] [--fmt q8_0] [--ms 17,64,203]
    python -m gemma_tpu_torch.tools.probe_variants attn
    python -m gemma_tpu_torch.tools.probe_variants mutants

`attn` needs no patched build: at the main path's attention shapes (and
S = 4096, bench_prefill's), each in bf16 with D = 256, it holds the flash
kernel's 4 warps as 1, 2 or 4 row warps (the rest splitting the keys)
and the decode kernel at 32-256 keys a
block (both arms) to the plain version (2e-2 of each row's scale,
`_timing.attn_err`: p rounds to bf16 against a local max), and times each,
decode beside the split-S kernel and its combine launch (the route of
G = 1), device ms with the operands warm (as chip_smoke.py).
`tools/parent_turn.py` times the parent's kernels.

`mutants` checks that check: it builds MUTANTS, the attention kernels with
a planted fault (a decode split or a flash key tile dropped), and holds
each, and the unpatched kernels, to the plain version at the S = 4096
shapes, where a row averages thousands of keys; it fails unless the
unpatched kernels pass and every mutant fails.

A variant is a list of text substitutions in a copy of
`gemma_tpu_torch/csrc/`, built into `gemma_tpu_torch/build/variants/<name>/`
(`kernels/build.py build_library`). For each main-path shape of q4_0
(Gemma-2B), q8_0 (Gemma-7B), q4_k and q6_k (Gemma-2B q4_k_m, and q6_k's
deep-K shape), and each M (gemv: the decode step's 1 and the serving
step's 8; tile: the prefill rows), a line gives the library call (torch.matmul of
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
    "sl256": [_gv("kGvSliceMin = 512;", "kGvSliceMin = 256;")],
    # the K-quants' split target alone (q4_0 and q8_0 keep theirs)
    "ktw2": [_gv("kGvSuperTargetWarps = 4;", "kGvSuperTargetWarps = 2;")],
    "ktw8": [_gv("kGvSuperTargetWarps = 4;", "kGvSuperTargetWarps = 8;")],
    "ktw16": [_gv("kGvSuperTargetWarps = 4;", "kGvSuperTargetWarps = 16;")],
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
    # no weight bytes copied at all (the x slice still is)
    "ab_gv_noload": [_gv("    F::copy(w, ring + (st % kS) * F::kStage, lane, n0, N, K, "
                         "klo + st * F::kStageK, khi);", "")],
    # how the GEMV sums its K splits: by ticket in the same launch at every
    # grid, or in a second launch at every grid; four outputs a thread of
    # the ticket sum at every M
    "tk_all": [_gv("kGvTicketBlocks = 4;", "kGvTicketBlocks = 1 << 20;")],
    "tk_none": [_gv("kGvTicketBlocks = 4;", "kGvTicketBlocks = 0;")],
    "sum4": [_gv("  switch ((M * kGvWarps * 16 + kGvWarps * 32 - 1) / (kGvWarps * 32)) {",
                 "  switch (4) {")],
    # no split sum: the splits' partials stay in the workspace, no ticket is taken
    "ab_gv_nosum": [_gv("  if (tickets == nullptr) return;", "  return;"),
                    _gv("  if (p.splits > 1 && !ticket) {", "  if (false) {")],
    # the K-quants' scale decode (`prepare`): the table keeps what it held
    "ab_gv_noprep": [_gv("      F::prepare(ring + (st % kS) * F::kStage, table, lane, n0, K, "
                         "klo + st * F::kStageK);", "")],
}

# the main path's shapes (chip_smoke.py MATMUL_SHAPES): q4_0 Gemma-2B, q8_0
# Gemma-7B, q4_k and q6_k Gemma-2B q4_k_m (and q6_k's deep-K shape)
SHAPES = {
    "q4_0": [("qkv", 2560, 2048), ("attn_out", 2048, 2048), ("gate_up", 32768, 2048),
             ("down", 2048, 16384), ("head", 256000, 2048)],
    "q8_0": [("qkv", 12288, 3072), ("attn_out", 3072, 4096), ("gate_up", 49152, 3072),
             ("down", 3072, 24576), ("head", 256000, 3072)],
    "q4_k": [("attn_q", 2048, 2048), ("attn_k", 256, 2048), ("attn_out", 2048, 2048),
             ("gate_up", 32768, 2048), ("down", 2048, 16384)],
    "q6_k": [("attn_v", 256, 2048), ("deep_k", 2048, 16384), ("head", 256000, 2048)],
}


# name -> substitutions that plant a fault in an attention kernel
MUTANTS: dict[str, list[tuple[str, str, str]]] = {
    # the decode kernel's last block merges every split but split 1
    "drop_split_1": [("decode_attention.cu",
                      "const float w = ls > 0.f ? expf(sw[sp_ * G + h] - mx) : 0.f;",
                      "const float w = ls > 0.f && sp_ != 1 ? expf(sw[sp_ * G + h] - mx) : 0.f;")],
    # the flash kernel loads ring step 5 (64 keys at D = 256) but never multiplies it
    "drop_step_5": [("flash_attention.cu", "    compute(i);\n    __syncthreads();  // stage i % 2",
                     "    if (i != 5) compute(i);\n    __syncthreads();  // stage i % 2")],
}


def patched_sources(name: str) -> dict[str, str]:
    """The text of each source file variant or mutant `name` changes; raises
    unless every substitution's old text occurs exactly once."""
    out: dict[str, str] = {}
    for f, old, new in {**VARIANTS, **MUTANTS}[name]:
        text = out.get(f) or (build.CSRC / f).read_text()
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} occurs {text.count(old)} times in {f}")
        out[f] = text.replace(old, new)
    return out


def build_variant(name: str):
    """The kernel library of variant or mutant `name`, built from a patched
    copy."""
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


# attention shapes: flash (name, T, first position, S, kv_limit, Hq, Hkv),
# decode (name, S, kv_limits, Hq, Hkv); Gemma-2B's heads (8, 1), Gemma-7B's (16, 16)
SERVE_LIMITS = [1, 64, 65, 203, 300, 512, 203, 64]  # chip_smoke.py's serving rows
FLASH_SHAPES = (("Gemma-2B T=203", 203, 0, 512, 203, 8, 1),
                ("Gemma-7B T=203", 203, 0, 512, 203, 16, 16),
                ("Gemma-2B T=2048", 2048, 0, 4096, 2048, 8, 1),
                ("Gemma-7B T=2048", 2048, 0, 4096, 2048, 16, 16),
                ("Gemma-2B chunk 3584-4095", 512, 3584, 4096, 4096, 8, 1))
DECODE_SHAPES = (("Gemma-2B", 512, [204], 8, 1), ("Gemma-2B", 512, [512], 8, 1),
                 ("Gemma-2B", 4096, [2048], 8, 1), ("Gemma-2B", 4096, [4096], 8, 1),
                 ("Gemma-2B serving", 512, SERVE_LIMITS, 8, 1), ("Gemma-7B", 512, [204], 16, 16),
                 ("Gemma-7B serving", 512, SERVE_LIMITS, 16, 16), ("Gemma-7B", 4096, [4096], 16, 16),
                 # the other groups of the Gemma family: G = 2 (Gemma-2 2B), G = 4 (Gemma-3 1B)
                 ("G=2 heads", 512, [204], 8, 4), ("G=2 serving", 512, SERVE_LIMITS, 8, 4),
                 ("G=4 heads", 512, [204], 4, 1), ("G=4 serving", 512, SERVE_LIMITS, 4, 1))
SPLITS = (32, 64, 128, 256)
ATT_TOL = 2e-2


def _held(name: str, got, ref) -> None:
    """Raise unless got is within ATT_TOL of each row's scale of ref."""
    ratio = T.attn_err(got, ref, ATT_TOL)[1]
    if ratio > 1.0:
        raise RuntimeError(f"{name}: |diff| {ratio:.3f} x {ATT_TOL} of its row's scale")


def _flash(lib, q, k, v, pos, lim, row_warps: int):
    """One launch of the tensor-core flash kernel at `row_warps` on bf16
    inputs, through its C entry point."""
    B, T_, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), lim.data_ptr(), out.data_ptr(),
            B, T_, Hq, Hkv, S, D)
    err = lib.gt_flash_attention_tc(*args, row_warps, 0, 0.0, build.stream_ptr(q.device))
    build.check(err, f"flash at {row_warps} row warps")
    return out


def _decode(lib, split: int, q, k, v, lim, k_scale=None, v_scale=None, tc: bool = True):
    """One launch of the decode kernel on bf16 q at `split` keys a block:
    the tensor-core kernel, or (tc=False) the split-S kernel and its
    combine, through the C entry points."""
    from ..ops import attention as att

    B, _, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G, n = Hq // Hkv, -(-S // split)
    out = torch.empty_like(q)
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if k_scale is not None else (None, None)
    kvd = att.kv_dtype_code(k, k_scale)
    stream = build.stream_ptr(q.device)
    if tc:
        work, tickets = build.workspace(q.device, stream, B * Hkv * n * G * (D + 2), B * Hkv)
        err = lib.gt_decode_attention_tc(q.data_ptr(), k.data_ptr(), v.data_ptr(), *scales,
                                         lim.data_ptr(), out.data_ptr(), work.data_ptr(),
                                         tickets.data_ptr(), B, Hq, Hkv, S, D, kvd, split, 0, 0.0, stream)
    else:
        parts = torch.empty(B * Hkv * n * G * (D + 2), dtype=torch.float32, device=q.device)
        pm, pl = parts.data_ptr(), parts[B * Hkv * n * G:].data_ptr()
        po = parts[2 * B * Hkv * n * G:].data_ptr()
        err = lib.gt_decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), *scales, lim.data_ptr(),
                                      out.data_ptr(), pm, pl, po, B, Hq, Hkv, S, D,
                                      build.DTYPE_CODES[q.dtype], kvd, split, 0, 0.0, stream)
    build.check(err, f"decode tc={tc} split={split}")
    return out


def run_attention(dev: torch.device) -> None:
    from ..ops import attention as att
    from ..runtime.kv_cache import quantize_kv

    gen = T.generator(dev)
    D = 256
    lib = build.load()

    def rnd(*shape):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.3).to(torch.bfloat16)

    def ms(fn):
        return T.time_us(lambda: fn(), [()], dev) / 1e3

    for name, T_, p0, S, limit, hq, hkv in FLASH_SHAPES:
        q, k, v = rnd(1, T_, hq, D), rnd(1, hkv, S, D), rnd(1, hkv, S, D)
        pos = torch.arange(p0, p0 + T_, dtype=torch.int32, device=dev)[None]
        lim = torch.tensor([limit], dtype=torch.int32, device=dev)
        ref = att.flash_attention_plain(q, k, v, pos, lim)
        flops = 4 * hq * D * sum(min(p + 1, limit) for p in range(p0, p0 + T_))
        readings = []
        for rw in (1, 2, 4):
            _held(f"flash {name} {rw} row warps", _flash(lib, q, k, v, pos, lim, rw), ref)
            t = ms(lambda: _flash(lib, q, k, v, pos, lim, rw))
            readings.append(f"{rw} row warps x {4 // rw} key groups {t:.4f} "
                            f"({flops / t / 1e9:.1f} TFLOP/s)")
        print(f"flash {name} S={S}: device ms, warm: " + "; ".join(readings), flush=True)
        del q, k, v, ref

    for name, S, limits, hq, hkv in DECODE_SHAPES:
        B = len(limits)
        q, k, v = rnd(B, 1, hq, D), rnd(B, hkv, S, D), rnd(B, hkv, S, D)
        lim = torch.tensor(limits, dtype=torch.int32, device=dev)
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        for arm, args in (("bf16", (k, v)), ("int8", (k8, v8, ks, vs))):
            ref = att.decode_attention_plain(q, args[0], args[1], lim, 0.0, 0, *args[2:])
            readings = []
            for split, tc in ((att.DECODE_SPLIT, False), *((sp, True) for sp in SPLITS)):
                def call(split=split, tc=tc):
                    return _decode(lib, split, q, args[0], args[1], lim, *args[2:], tc=tc)

                _held(f"decode {name} {arm} split {split} tc={tc}", call(), ref)
                readings.append(f"{split} keys a block {ms(call):.4f}" if tc
                                else f"split-S kernel {ms(call):.4f}")
            print(f"decode {name} {arm} S={S} Hq={hq} Hkv={hkv} limits={limits}: device ms, warm "
                  f"(route: {att.decode_route(torch.bfloat16, hq // hkv, S)}): " + "; ".join(readings),
                  flush=True)
        del q, k, v, k8, v8


def run_mutants(dev: torch.device) -> None:
    """The unpatched attention kernels and each of MUTANTS against the plain
    versions at the S = 4096 shapes of FLASH_SHAPES and DECODE_SHAPES
    (decode: both arms), through the public wrappers; one line a reading,
    with max|diff| beside the row-scaled ratio."""
    from ..ops import attention as att
    from ..runtime.kv_cache import quantize_kv

    D = 256
    libs = {"unpatched": build.load(), **{name: build_variant(name) for name in MUTANTS}}
    gen = T.generator(dev)

    def rnd(*shape):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.3).to(torch.bfloat16)

    cases = []  # (reading, kernel call, plain output)
    for name, T_, p0, S, limit, hq, hkv in FLASH_SHAPES:
        if S == 4096:
            q, k, v = rnd(1, T_, hq, D), rnd(1, hkv, S, D), rnd(1, hkv, S, D)
            pos = torch.arange(p0, p0 + T_, dtype=torch.int32, device=dev)[None]
            lim = torch.tensor([limit], dtype=torch.int32, device=dev)
            cases.append((f"flash {name}", lambda q=q, k=k, v=v, pos=pos, lim=lim:
                          att.flash_attention(q, k, v, pos, lim),
                          att.flash_attention_plain(q, k, v, pos, lim)))
    for name, S, limits, hq, hkv in DECODE_SHAPES:
        if S == 4096 and att.decode_route(torch.bfloat16, hq // hkv, S)[0] == "tc":
            B = len(limits)
            q, k, v = rnd(B, 1, hq, D), rnd(B, hkv, S, D), rnd(B, hkv, S, D)
            lim = torch.tensor(limits, dtype=torch.int32, device=dev)
            (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
            for arm, (kk, vv, sk, sv) in (("bf16", (k, v, None, None)), ("int8", (k8, v8, ks, vs))):
                cases.append((f"decode {name} S={S} limits={limits} {arm}",
                              lambda q=q, kk=kk, vv=vv, lim=lim, sk=sk, sv=sv:
                              att.decode_attention(q, kk, vv, lim, k_scale=sk, v_scale=sv),
                              att.decode_attention_plain(q, kk, vv, lim, k_scale=sk, v_scale=sv)))
    failed = {}
    for lname, lib in libs.items():
        with build.using(lib):
            for reading, call, ref in cases:
                err, ratio, lo, hi = T.attn_err(call(), ref, ATT_TOL)
                failed.setdefault(lname, []).append(ratio > 1.0)
                print(f"{lname} {reading}: max|diff| {err:.3e} (an absolute {ATT_TOL} "
                      f"{'fails' if err > ATT_TOL else 'passes'}); worst |diff| / ({ATT_TOL} x row "
                      f"scale) {ratio:.3f} ({'fails' if ratio > 1.0 else 'passes'}); row scales "
                      f"{lo:.3e}-{hi:.3e}", flush=True)
    if any(failed["unpatched"]) or not all(any(failed[name]) for name in MUTANTS):
        raise SystemExit("mutants: the unpatched kernels must pass and every mutant must fail")
    print("mutants: the unpatched kernels pass; every mutant fails", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("gemv", "tile", "attn", "mutants"))
    ap.add_argument("--variants", default="base,tw4,tw16,st3,st6,w2,w8,sl1024,sk256,nosplit",
                    help="comma-separated names of VARIANTS")
    ap.add_argument("--fmt", default="q4_0,q8_0")
    ap.add_argument("--ms", default=None, help="rows of x (gemv: 1,8; tile: 17,64,203)")
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("probe_variants: no CUDA device (it times builds of the kernels on the card)")
    dev = torch.device("cuda", 0)
    if args.mode in ("attn", "mutants"):
        print(T.card_line(dev), flush=True)
        (run_attention if args.mode == "attn" else run_mutants)(dev)
        return
    ms = [int(m) for m in (args.ms or ("1,8" if args.mode == "gemv" else "17,64,203")).split(",")]
    print(T.card_line(dev), flush=True)
    run(args.mode, names, args.fmt.split(","), ms, dev)


if __name__ == "__main__":
    main()
