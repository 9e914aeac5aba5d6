"""Decode attention's keys a block against cache length.

The counterpart of the reference's `tools/bench_decode_attn.py`, which swept
its Pallas kernel's block_s at Gemma-2B's heads (Hq 8, Hkv 1, D 256) over S
= 512, 4096 and 8192 at live limits 500, 4000 and 8000. Here the launch
shape is the decode core's keys a block (`split`, the multiples of 16 it
takes from 32 to 512, through its C entry point, `_launch.decode`; the one
`ops/attention.py decode_tc_split(S)` picks is marked `*`), in four arms:
bf16 q over a bf16 or an int8 cache, and f32 q over an f32 (`f32`) or an
int8 cache (`f32_int8`), all on the tensor-core core at G = 8. `--heads 7b`
runs the core for one query row (G = 1) at Gemma-7B's heads (Hq = Hkv = 16)
instead. Beside each arm, the split-S kernel and its combine launch (the
route of G > 8, 64 keys a block) on the same inputs.

Each line gives device µs and the GB/s of the live K + V tiles, as the
reference counts them (ceil(limit / split) x split keys; int8: each key's
two f32 scales too), L2 cold (`_timing.py`: the launches rotate over copies
of the cache). Every kernel output is first held to the plain version
(2e-2 of each row's scale; f32 over f32: 1e-4). On the CPU (`--device
cpu`) the plain version runs for every split and the times say nothing of
the card.

    python -m gemma_tpu_torch.tools.bench_decode_attn [--heads 2b|7b] [--sizes 512:500,4096:4000,8192:8000]
        [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..models.params import resolve_device
from ..ops import attention as att
from ..runtime.kv_cache import quantize_kv
from . import _launch
from . import _timing as T

HEADS = {"2b": (8, 1), "7b": (16, 16)}  # (Hq, Hkv)
D = 256
SIZES = ((512, 500), (4096, 4000), (8192, 8000))  # (S, live limit), the reference's
SPLITS = (32, 64, 128, 256, 512)
ARMS = ("bf16", "int8", "f32", "f32_int8")
TOL = {"bf16": 2e-2, "int8": 2e-2, "f32": 1e-4, "f32_int8": 2e-2}  # of each row's scale


def make_inputs(S: int, limit: int, hq: int, hkv: int, dev, d: int = D, seed: int = 0):
    """({arm: (q [1, 1, hq, d], k, v [1, hkv, S, d], k_scale, v_scale)}, kv_limit):
    seeded normal values x 0.3, the int8 arms the cache quantized
    (`quantize_kv`), bf16 arms rounded to bf16."""
    gen = T.generator(dev, seed)
    q = torch.randn(1, 1, hq, d, generator=gen, device=dev) * 0.3
    k, v = (torch.randn(1, hkv, S, d, generator=gen, device=dev) * 0.3 for _ in range(2))
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    bf = [x.to(torch.bfloat16) for x in (q, k, v)]
    lim = torch.tensor([limit], dtype=torch.int32, device=dev)
    return {"bf16": (*bf, None, None), "int8": (bf[0], k8, v8, ks, vs), "f32": (q, k, v, None, None),
            "f32_int8": (q, k8, v8, ks, vs)}, lim


def live_bytes(arm: str, limit: int, split: int, S: int, hkv: int, d: int = D) -> int:
    """K + V bytes of the live tiles, the reference's count: ceil(limit /
    split) x split keys (at most S), each of K and V at the cache's element
    size (int8: and its f32 scale)."""
    keys = min(-(-limit // split) * split, S)
    per_key = {"bf16": 2 * d, "f32": 4 * d}.get(arm, d + 4)
    return 2 * keys * hkv * per_key


def run(dev: torch.device, heads: str = "2b", sizes=SIZES, splits=SPLITS, reps: int = 5) -> list[dict]:
    """Each (S, limit, arm) at each split and the split-S kernel: records
    {"S", "limit", "arm", "split" (or "split-S"), "us", "gbs", "out"}, one
    line each."""
    from ..kernels import build

    hq, hkv = HEADS[heads]
    kind = "g1" if hq == hkv else "tc"
    lib = build.load() if dev.type == "cuda" else None
    print(T.card_line(dev), flush=True)
    print(f"decode attention, keys a block against cache length: {heads} heads (Hq={hq} Hkv={hkv} "
          f"D={D}), the {'core for one query row' if kind == 'g1' else 'tensor-core core'} beside the "
          f"split-S kernel and its combine; {T.clock(dev)} us L2 cold, GB/s of the live K + V tiles; "
          f"* decode_tc_split(S)", flush=True)
    records = []
    for S, limit in sizes:
        by_arm, lim = make_inputs(S, limit, hq, hkv, dev)
        for arm in ARMS:
            args = by_arm[arm]
            ref = att.decode_attention_plain(args[0], args[1], args[2], lim, 0.0, 0, *args[3:])
            sets = T.replicate((*args, lim), T.copies_for(T.nbytes(*args[1:]), dev))
            for split in (*splits, "split-S"):
                keys = att.DECODE_SPLIT if split == "split-S" else split
                if dev.type == "cuda":
                    def fn(q, k, v, ks, vs, lim_, keys=keys, kd="split" if split == "split-S" else kind):
                        return _launch.decode(lib, keys, q, k, v, lim_, ks, vs, kind=kd)
                else:
                    def fn(q, k, v, ks, vs, lim_):
                        return att.decode_attention_plain(q, k, v, lim_, 0.0, 0, ks, vs)
                out = fn(*args, lim)
                ratio = T.attn_err(out, ref, TOL[arm])[1]
                if ratio > 1.0:
                    raise RuntimeError(f"decode {arm} S={S} split {split}: |diff| {ratio:.3f} x "
                                       f"{TOL[arm]} of its row's scale")
                us = T.time_us(fn, sets, dev, reps)
                gbs = live_bytes(arm, limit, keys, S, hkv) / us / 1e3
                mark = "*" if split == att.decode_tc_split(S) else " "
                label = (f"split-S ({att.DECODE_SPLIT} keys, + combine)" if split == "split-S"
                         else f"split={split:4d}{mark}")
                line = f"  {arm:8s} S={S:5d} limit={limit:5d} {label} {us:9.2f} us {gbs:7.1f} GB/s"
                print(line if dev.type == "cuda" else f"{line} {T.CPU_NOTE}", flush=True)
                records.append({"S": S, "limit": limit, "arm": arm, "split": split, "us": us, "gbs": gbs,
                                "out": out})
            del sets
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--heads", choices=sorted(HEADS), default="2b")
    p.add_argument("--sizes", default=",".join(f"{S}:{lim}" for S, lim in SIZES),
                   help="S:limit pairs, comma-separated")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    run(dev, args.heads, [tuple(int(x) for x in pair.split(":")) for pair in args.sizes.split(",")])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
