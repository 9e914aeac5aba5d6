"""Parent against change on the card, in turns: the attention kernels and
the end-to-end paths they move, measured by the same code in two trees.

    python -m gemma_tpu_torch.tools.parent_turn --parent DIR

DIR is the parent commit unpacked (`git archive`) beside this tree. The
command runs one turn in a fresh process in each tree, in the order
parent, change, change, parent, each from its tree's root with that tree
on PYTHONPATH (its own kernels, built at first use, and its own
`chip_smoke.py`). A turn prints, tagged with its tree:
* device ms, warm, of `flash_attention` and `decode_attention` (both
  arms) at the attention shapes of `probe_variants attn` (this tree's
  tables, handed to every turn), through the public wrappers, so each tree
  takes its own kernels and routes;
* chip_smoke's `main_path` for Gemma-2B q4_0 (prefill wall and device
  profile, decode step, host profile);
* a device profile of a 2048-token Gemma-2B q4_0 prefill (busy time by
  kernel);
* `bench_prefill` q4_0 and chip_smoke's `serving` over the dense bf16 and
  int8 caches.
The card's `nvidia-smi` line heads each turn. Runs on the card only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
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


def turn(tag: str, shapes: dict) -> None:
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
    times = kernel_times(dev, shapes["flash"], shapes["decode"])
    print(tag, "kernels device ms, warm:", json.dumps(times), flush=True)
    c.main_path(torch, dev, card, "Gemma-2B", "q4_0")
    model = make_params(GEMMA_2B, "q4_0", seed=0, device=dev)
    eng = Engine(GEMMA_2B, model, EngineConfig(max_seq_len=4096, max_batch=1))
    med, prof = c.prefill_profile(torch, eng, [2 + i % 1000 for i in range(2048)], runs=3)
    print(tag, f"prefill T=2048 Gemma-2B q4_0: {med:.3f} ms wall (median of 3); {prof}", flush=True)
    del eng, model
    torch.cuda.empty_cache()
    print(tag, "bench_prefill", bench_prefill.run(dev, ("q4_0",)), flush=True)
    c.serving(torch, dev, card, "Gemma-2B", "q4_0", runs=c.SERVE_RUNS[:2])
    print(tag, "turn done", f"{time.perf_counter() - t0:.1f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the parent commit's tree: run the four turns")
    ap.add_argument("--turn", help="run one turn in the current directory's tree, with this tag")
    ap.add_argument("--shapes", help="(with --turn) the attention shapes, as JSON")
    args = ap.parse_args(argv)
    if args.turn:
        turn(args.turn, json.loads(args.shapes))
        return 0
    if not args.parent:
        ap.error("give --parent DIR (or --turn TAG --shapes JSON)")
    from .probe_variants import DECODE_SHAPES, FLASH_SHAPES

    shapes = json.dumps({"flash": FLASH_SHAPES, "decode": DECODE_SHAPES})
    change = Path(__file__).resolve().parents[2]
    for tag in ("parent", "change", "change", "parent"):
        tree = Path(args.parent).resolve() if tag == "parent" else change
        env = {**os.environ, "PYTHONPATH": str(tree)}
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--turn", tag,
                               "--shapes", shapes], cwd=tree, env=env, timeout=900)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
