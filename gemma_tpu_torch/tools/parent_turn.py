"""Parent against change on the card, in turns: the quantized-matmul GEMVs,
the attention kernels and the end-to-end paths they move, measured by the
same code in two trees.

    python -m gemma_tpu_torch.tools.parent_turn --parent DIR

DIR is the parent commit unpacked (`git archive`) beside this tree. The
command runs one turn in a fresh process in each tree, in the order
parent, change, change, parent, each from its tree's root with that tree
on PYTHONPATH (its own kernels, built at first use, and its own
`chip_smoke.py`). A turn prints, tagged with its tree:
* device ms, L2 cold, of each format's quantized matmul at M = 1 (the
  decode step), 2, 4 and 8 (the serving step's rows) on the main path's shapes of
  `probe_variants` (q4_0, q8_0, q4_k, q6_k); each format's outputs at M =
  1-8 on the same seeded inputs, compared across the trees at the end
  (max|diff| / max|parent|: 0 where the two compute bit for bit alike);
  device ms, warm, of
  `flash_attention` and `decode_attention` (both arms) at the attention
  shapes of `probe_variants attn` (this tree's tables, handed to every
  turn), all through the public wrappers, so each tree takes its own
  kernels and routes;
* chip_smoke's `main_path` for Gemma-2B q4_0 and q4_k_m (prefill wall and
  device profile, decode step, host profile);
* a device profile of a 2048-token Gemma-2B q4_0 prefill (busy time by
  kernel);
* `bench_prefill` q4_0 and chip_smoke's `serving` over the dense bf16 and
  int8 caches.
Then DECODE_ROUNDS more rounds in the same order, each turn a fresh
process that only decodes (`decode_turn`): batch-1 tok/s of Gemma-2B q4_k_m
and q4_0, several runs without a profiler, and the host µs of one call of
the quantized-matmul wrapper. The card's `nvidia-smi` line heads each turn.
Runs on the card only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

D = 256


def kernel_times(dev: torch.device, flash_shapes, decode_shapes) -> dict[str, float]:
    """Device ms of the public attention wrappers at probe_variants'
    FLASH_SHAPES and DECODE_SHAPES (decode: both arms)."""
    import gemma_tpu_torch.ops.attention as att
    from gemma_tpu_torch.runtime.kv_cache import quantize_kv
    from gemma_tpu_torch.tools import _timing as T

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rnd(*shape):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.3).to(torch.bfloat16)

    def ms(fn):
        return T.time_us(lambda: fn(), [()], dev) / 1e3

    res = {}
    for name, T_, p0, S, limit, hq, hkv in flash_shapes:
        q, k, v = rnd(1, T_, hq, D), rnd(1, hkv, S, D), rnd(1, hkv, S, D)
        pos = torch.arange(p0, p0 + T_, dtype=torch.int32, device=dev)[None]
        lim = torch.tensor([limit], dtype=torch.int32, device=dev)
        res[f"flash {name}"] = ms(lambda: att.flash_attention(q, k, v, pos, lim))
    for name, S, limits, hq, hkv in decode_shapes:
        B = len(limits)
        q, k, v = rnd(B, 1, hq, D), rnd(B, hkv, S, D), rnd(B, hkv, S, D)
        lim = torch.tensor(limits, dtype=torch.int32, device=dev)
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        at = f"{name} S={S} Hq={hq} Hkv={hkv} limits={limits}"
        res[f"decode {at}"] = ms(lambda: att.decode_attention(q, k, v, lim))
        res[f"decode int8 {at}"] = ms(lambda: att.decode_attention(q, k8, v8, lim, k_scale=ks,
                                                                    v_scale=vs))
    return res


MATMUL_MS = (1, 2, 4, 8)  # the decode step's rows and the serving step's


def matmul_times(dev: torch.device, shapes: dict) -> dict[str, float]:
    """Device ms, L2 cold, of the public quantized matmuls at `shapes`
    (probe_variants' SHAPES: format -> (name, N, K)) and MATMUL_MS, bf16 x."""
    import gemma_tpu_torch.ops.quant_matmul as qmm
    from gemma_tpu_torch.tools import _timing as T

    gen = T.generator(dev)
    res = {}
    for fmt, rows in shapes.items():
        for name, N, K in rows:
            qt = T.random_qtensor(fmt, N, K, gen, dev)
            for M in MATMUL_MS:
                x = T.bf16_x(M, K, gen, dev)
                args = T.replicate((x, qt), T.copies_for(T.nbytes(x, qt), dev))
                res[f"{fmt} {name} M={M} N={N} K={K}"] = T.time_us(qmm.MATMULS[fmt], args, dev) / 1e3
                del args
            del qt
    return res


# (format, N, K) of the outputs compared across the trees: ragged N and K
# (odd counts of scales), and Gemma-2B's down
OUTPUT_SHAPES = (("q4_0", 1000, 1056), ("q4_0", 2048, 16384), ("q8_0", 999, 1056),
                 ("q8_0", 3072, 4096), ("q4_k", 999, 1280), ("q4_k", 2048, 16384),
                 ("q6_k", 999, 1280), ("q6_k", 2048, 16384))


def matmul_outputs(dev: torch.device) -> dict[str, torch.Tensor]:
    """Each format's quantized matmul at OUTPUT_SHAPES and M = 1-8, bf16 x,
    on inputs from a fixed seed (so the same in every tree): y on the CPU."""
    import gemma_tpu_torch.ops.quant_matmul as qmm
    from gemma_tpu_torch.tools import _timing as T

    gen = T.generator(dev, seed=5)
    out = {}
    for fmt, N, K in OUTPUT_SHAPES:
        qt = T.random_qtensor(fmt, N, K, gen, dev)
        for M in range(1, 9):
            out[f"{fmt} N={N} K={K} M={M}"] = qmm.MATMULS[fmt](T.bf16_x(M, K, gen, dev), qt).cpu()
    return out


def turn(tag: str, shapes: dict, outputs: str | None = None) -> None:
    """One turn, in the tree of the current directory."""
    if not torch.cuda.is_available():
        raise SystemExit("parent_turn: no CUDA device (it times the kernels on the card)")
    sys.path.insert(0, os.getcwd())  # this tree's chip_smoke.py
    import chip_smoke as c
    from gemma_tpu_torch.kernels import build
    from gemma_tpu_torch.models import GEMMA_2B
    from gemma_tpu_torch.runtime import Engine, EngineConfig
    from gemma_tpu_torch.testing import make_params
    from gemma_tpu_torch.tools import bench_prefill

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.load()
    card = c.device_line()
    print(tag, card, f"build+load {time.perf_counter() - t0:.1f} s", flush=True)
    print(tag, "quantized matmuls device ms, L2 cold:",
          json.dumps(matmul_times(dev, shapes["matmul"])), flush=True)
    if outputs:
        torch.save(matmul_outputs(dev), outputs)
    times = kernel_times(dev, shapes["flash"], shapes["decode"])
    print(tag, "kernels device ms, warm:", json.dumps(times), flush=True)
    c.main_path(torch, dev, card, "Gemma-2B", "q4_0")
    c.main_path(torch, dev, card, "Gemma-2B", "q4_k_m")
    model = make_params(GEMMA_2B, "q4_0", seed=0, device=dev)
    eng = Engine(GEMMA_2B, model, EngineConfig(max_seq_len=4096, max_batch=1))
    med, prof = c.prefill_profile(torch, eng, [2 + i % 1000 for i in range(2048)], runs=3)
    print(tag, f"prefill T=2048 Gemma-2B q4_0: {med:.3f} ms wall (median of 3); {prof}", flush=True)
    del eng, model
    torch.cuda.empty_cache()
    print(tag, "bench_prefill", bench_prefill.run(dev, ("q4_0",)), flush=True)
    c.serving(torch, dev, card, "Gemma-2B", "q4_0", runs=c.SERVE_RUNS[:2])
    print(tag, "turn done", f"{time.perf_counter() - t0:.1f} s", flush=True)


DECODE_ROUNDS = 3  # rounds of decode turns: 12 processes, 30 decodes a tree and format
DECODE_RUNS = 5  # decodes of NEW_TOKENS a format in a decode turn
HOST_CALLS = 400  # wrapper calls a host reading: device time < host time, queue not full


def decode_turn(tag: str) -> None:
    """One decode turn, in the tree of the current directory: Gemma-2B
    q4_k_m and q4_0, DECODE_RUNS batch-1 greedy decodes of chip_smoke's
    prompt and NEW_TOKENS each (wall tok/s, no profiler), and the host µs
    of one bf16 M = 1 call of the quantized-matmul wrapper at attn_k (q4_k,
    N = 256: K split) and qkv (q4_0), back to back (the device's part is
    shorter, so the wall is the host's)."""
    if not torch.cuda.is_available():
        raise SystemExit("parent_turn: no CUDA device (it times the kernels on the card)")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as c
    import gemma_tpu_torch.ops.quant_matmul as qmm
    from gemma_tpu_torch.models import GEMMA_2B
    from gemma_tpu_torch.runtime import Engine, EngineConfig
    from gemma_tpu_torch.testing import make_params
    from gemma_tpu_torch.tools import _timing as T

    dev = torch.device("cuda", 0)
    gen = T.generator(dev)
    host = {}
    for fmt, N, K in (("q4_k", 256, 2048), ("q4_0", 2560, 2048)):
        qt, x = T.random_qtensor(fmt, N, K, gen, dev), T.bf16_x(1, K, gen, dev)
        for _ in range(2):  # the first pass builds, loads and warms
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                qmm.MATMULS[fmt](x, qt)
            torch.cuda.synchronize()
        host[f"{fmt} N={N} K={K}"] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    print(tag, c.device_line(), "host us a quantized-matmul call, M = 1:", json.dumps(host), flush=True)
    prompt = [2 + (i * 7919) % (GEMMA_2B.vocab_size - 2) for i in range(c.PROMPT_LEN)]
    for fmt in ("q4_k_m", "q4_0"):
        model = make_params(GEMMA_2B, fmt, seed=0, device=dev)
        eng = Engine(GEMMA_2B, model, EngineConfig(max_seq_len=c.MAX_SEQ_LEN, max_batch=1))
        eng.generate([prompt[:16]], 4)  # warm-up
        rates = []
        for _ in range(DECODE_RUNS):
            logits, cache = eng.prefill([prompt])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.generate_from(logits, cache, c.NEW_TOKENS)
            torch.cuda.synchronize()
            rates.append(c.NEW_TOKENS / (time.perf_counter() - t0))
        print(tag, f"decode Gemma-2B {fmt} tok/s, {DECODE_RUNS} runs of {c.NEW_TOKENS} tokens:",
              json.dumps([round(r, 2) for r in rates]), flush=True)
        del eng, model, cache, logits
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the parent commit's tree: run the four turns")
    ap.add_argument("--turn", help="run one turn in the current directory's tree, with this tag")
    ap.add_argument("--shapes", help="(with --turn) the attention shapes, as JSON")
    ap.add_argument("--outputs", help="(with --turn) save the matmul outputs to this file")
    ap.add_argument("--decode", action="store_true", help="(with --turn) a decode turn")
    args = ap.parse_args(argv)
    if args.turn:
        if args.decode:
            decode_turn(args.turn)
        else:
            turn(args.turn, json.loads(args.shapes), args.outputs)
        return 0
    if not args.parent:
        ap.error("give --parent DIR (or --turn TAG --shapes JSON)")
    from .probe_variants import DECODE_SHAPES, FLASH_SHAPES, SHAPES

    shapes = json.dumps({"matmul": SHAPES, "flash": FLASH_SHAPES, "decode": DECODE_SHAPES})
    change = Path(__file__).resolve().parents[2]
    order = ("parent", "change", "change", "parent")
    with tempfile.TemporaryDirectory() as tmp:
        saved = {tag: Path(tmp) / f"{tag}.pt" for tag in ("parent", "change")}
        for i, tag in enumerate(order * (1 + DECODE_ROUNDS)):
            tree = Path(args.parent).resolve() if tag == "parent" else change
            env = {**os.environ, "PYTHONPATH": str(tree)}
            if i >= len(order):
                extra = ["--decode"]
            else:
                extra = ["--shapes", shapes] + ([] if saved[tag].exists() else ["--outputs", str(saved[tag])])
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--turn", tag, *extra],
                                  cwd=tree, env=env, timeout=900)
            if proc.returncode != 0:
                return proc.returncode
            if i == len(order) - 1:
                ref, got = (torch.load(saved[tag]) for tag in ("parent", "change"))
                diffs = {k: ((got[k] - ref[k]).abs().max() / ref[k].abs().max()).item() for k in ref}
                print("matmul outputs, max|change - parent| / max|parent|:", json.dumps(diffs),
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
