"""Does a decode step cost more in a larger allocated cache at the same live
length?

The counterpart of the reference's `tools/probe_cache_cost.py`, which found
its Gemma-7B decode step at ~2K live keys slower in a 4096-slot cache than
in a 2048-slot one and probed where the allocation-sized cost lay. Here
the same five programs run in the port's idiom at Gemma-7B's geometry (L
28 layers, B 1, H 16 KV heads = query heads, D 256, bf16) at S = 2048 and
4096 slots with the live limit 1990, each a chain of `--steps` steps:

* `write`: `KVCache.write_token` of one token into each of the L layers
  (slot 100 + step, the token `new` + step + layer), in place;
* `attn-via-slice`: `decode_attention` over each layer's `k[layer]` view
  of one stacked [L, B, H, S, D] tensor;
* `attn-prelisted`: the same over L separate per-layer tensors;
* `combined`: per layer, write the query's token at slot limit + step,
  then attend over limit + step + 1 keys, as `Engine.decode_step` does,
  through a `KVCache` whose layers are views of one stacked tensor;
* `per-layer-combined`: the same through a `KVCache` of its own per-layer
  tensors (the port's layout).

Each attention's output feeds the next query (q + out[..., :1, :1] x 1e-8,
the reference's chain). A line gives the device ms a step (CUDA events
around one program behind a sleep, `_timing.time_us`) and the host's wall
ms a step (the program and a synchronize), the medians of `--reps`; the
last lines give each probe's 4096 / 2048 ratio, then a `launches {...}` line
of the decode attention kernels the programs launched. On the CPU
(`--device cpu`) the plain versions run and the times say nothing of the
card.

    python -m gemma_tpu_torch.tools.probe_cache_cost [--sizes 2048,4096] [--steps 2] [--device cpu]
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from ..models.params import resolve_device
from ..ops import attention as att
from ..runtime.kv_cache import KVCache
from . import _timing as T

L, B, H, D = 28, 1, 16, 256  # Gemma-7B: 28 layers, 16 KV heads of 256
SIZES = (2048, 4096)
LIMIT = 1990
# chained steps a program (the reference's 8): a step launches ~10 kernels a
# layer, and a program stays under the launch queue that the sleep ahead of
# it must hold (~1000 entries)
STEPS = 2
WRITE_AT = 100  # the write probe's first slot
PROBES = ("write", "attn-via-slice", "attn-prelisted", "combined", "per-layer-combined")


def make_state(probe: str, S: int, limit: int, dev, layers: int = L, heads: int = H, d: int = D,
               seed: int = 0) -> dict:
    """The inputs of `probe` at S slots: seeded normal values x 0.3 in
    bf16 (the write probe's cache zeros), kv_limit [B] = limit; "k" / "v"
    as one stacked tensor or a list, and "cache" a `KVCache` over them."""
    gen = T.generator(dev, seed)

    def rnd(*shape):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.3).to(torch.bfloat16)

    st = {"q": rnd(B, 1, heads, d), "lim": torch.full((B,), limit, dtype=torch.int32, device=dev)}
    if probe == "write":
        k = [torch.zeros(B, heads, S, d, dtype=torch.bfloat16, device=dev) for _ in range(2 * layers)]
        st["k"], st["v"], st["new"] = k[:layers], k[layers:], rnd(B, 1, heads, d)
    elif probe in ("attn-via-slice", "combined"):
        st["k"], st["v"] = rnd(layers, B, heads, S, d), rnd(layers, B, heads, S, d)
    else:
        st["k"] = [rnd(B, heads, S, d) for _ in range(layers)]
        st["v"] = [rnd(B, heads, S, d) for _ in range(layers)]
    st["cache"] = KVCache(list(st["k"]), list(st["v"]), st["lim"].clone())
    return st


def run_steps(probe: str, st: dict, steps: int):
    """`steps` chained steps of `probe` on `st`, its caches updated in
    place; the last attention output (the write probe: None)."""
    q, lim, cache = st["q"], st["lim"], st["cache"]
    layers = len(cache.k)
    if probe == "write":
        at = torch.full_like(lim, min(WRITE_AT, cache.max_len - steps))
        for step in range(steps):
            for layer in range(layers):
                kn = st["new"] + (step + layer)
                cache.write_token(layer, at + step, kn, kn)
        return None
    out, qq = None, q
    for step in range(steps):
        for layer in range(layers):
            if probe.endswith("combined"):
                kn = qq + layer
                cache.write_token(layer, lim + step, kn, kn)
                out = att.decode_attention(qq, cache.k[layer], cache.v[layer], lim + step + 1)
            else:
                out = att.decode_attention(qq, st["k"][layer], st["v"][layer], lim)
            qq = q + out[:, :, :1, :1] * 1e-8
    return out


def measure(probe: str, S: int, limit: int, steps: int, dev, reps: int = 5,
            **geometry) -> tuple[float, float]:
    """(device ms, wall ms) a step of `probe` at S slots."""
    st = make_state(probe, S, limit, dev, **geometry)
    run_steps(probe, st, steps)  # warm-up
    device = T.time_us(lambda: run_steps(probe, st, steps), [()], dev, reps, launches=1) / 1e3 / steps
    walls = []
    for _ in range(reps):
        T.sync(dev)
        t0 = time.perf_counter()
        run_steps(probe, st, steps)
        T.sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3 / steps)
    del st
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return device, statistics.median(walls)


def run(dev: torch.device, sizes=SIZES, limit: int = LIMIT, steps: int = STEPS, reps: int = 5,
        **geometry) -> dict:
    """{(probe, S): (device ms, wall ms)} a step, a line each, then each
    probe's ratio of the largest S to the smallest."""
    g = {"layers": L, "heads": H, "d": D, **geometry}
    T.reset_launches()
    print(T.card_line(dev), flush=True)
    print(f"cache cost: L={g['layers']} B={B} H={g['heads']} D={g['d']} bf16, live limit {limit}, "
          f"{steps} chained steps a program; {T.clock(dev)} ms a step (CUDA events on the card), wall ms "
          f"a step", flush=True)
    out = {}
    for S in sizes:
        for probe in PROBES:
            dev_ms, wall_ms = out[(probe, S)] = measure(probe, S, limit, steps, dev, reps, **geometry)
            line = (f"  S={S}: {probe:20s} {dev_ms:8.3f} ms/step {T.clock(dev)} {wall_ms:8.3f} ms/step "
                    f"wall")
            print(line if dev.type == "cuda" else f"{line} {T.CPU_NOTE}", flush=True)
    lo, hi = min(sizes), max(sizes)
    for probe in PROBES:
        (d_lo, w_lo), (d_hi, w_hi) = out[(probe, lo)], out[(probe, hi)]
        print(f"  {probe:20s} S={hi} / S={lo}: {T.clock(dev)} {d_hi / d_lo:.3f}, wall {w_hi / w_lo:.3f}",
              flush=True)
    print(T.launches_line(dev), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", default=",".join(map(str, SIZES)), help="cache slots, comma-separated")
    p.add_argument("--limit", type=int, default=LIMIT, help="live keys")
    p.add_argument("--steps", type=int, default=STEPS, help="chained steps a program")
    p.add_argument("--layers", type=int, default=L)
    p.add_argument("--heads", type=int, default=H)
    p.add_argument("--head-dim", type=int, default=D)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    sizes = [int(s) for s in args.sizes.split(",")]
    if args.limit + args.steps > min(sizes):
        p.error("the limit plus the steps must fit the smallest cache")
    run(dev, sizes, args.limit, args.steps, layers=args.layers, heads=args.heads, d=args.head_dim)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
