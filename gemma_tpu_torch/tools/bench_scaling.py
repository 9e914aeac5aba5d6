"""Scaling efficiency of `TPEngine`'s decode at growing mesh sizes.

The counterpart of the reference's `tools/bench_scaling.py`: decode tokens/s
of greedy generation (`TPEngine.generate_greedy`, `tokens` new tokens after
a warm-up of 4) on meshes of 1, 2, 4, ... ranks, data-parallel by default
(`--tp` ranks a model group; the batch is `--batch` rows a data group),
then `multihost.scaling_efficiency` against the smallest mesh. Each mesh
size is its own group of spawned ranks (this module with `--rank`), joined
over `tcp://127.0.0.1`.

* `--device cuda` (the default): NCCL, one rank a card, mesh sizes up to
  the card count. One card measures one rank only.
* `--device cpu`: gloo ranks on this host's CPU. They share its cores, so
  the numbers are about the collectives' path and the harness, not
  scaling (as the reference says of virtual CPU devices).

The model is the tool's small config (4 layers, d_model 512, 4 heads of
128, the CUDA attention kernels' smallest head_dim, d_ff 1024, vocab
2048) in q4_0, random weights from a seed (`testing.make_params`, each rank
drawing its shard).

    python -m gemma_tpu_torch.tools.bench_scaling [--device cpu] [--max-ranks 4] [--tp 1]
        [--tokens 32] [--batch 2]

Prints one line a mesh size and a JSON summary.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..models.config import GemmaConfig
from ..parallel import multihost
from ..parallel.sharding import make_mesh
from ..parallel.shard_decode import TPEngine
from ..testing import make_params

CFG = GemmaConfig(
    vocab_size=2048, d_model=512, n_layers=4, n_heads=4, n_kv_heads=4,
    head_dim=128, d_ff=1024, context_length=256,
)
WARMUP = 4


def rank_main(args) -> None:
    """One rank of a mesh of `args.world`: its decode tokens/s (rank 0 prints it)."""
    cuda = args.device == "cuda"
    if not cuda:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.world))
    multihost.initialize(args.coordinator, args.world, args.rank, timeout=300)
    mesh = make_mesh(args.world // args.tp, args.tp, backend="nccl" if cuda else "gloo",
                     device=f"cuda:{args.rank}" if cuda else "cpu")
    batch = args.batch * (args.world // args.tp)
    params = make_params(CFG, "q4_0", seed=0, device=mesh.device,
                         tp=(mesh.model.index, mesh.model.size))
    eng = TPEngine(CFG, params, mesh, max_seq_len=128, max_batch=batch)
    prompts = [[1, 5 + i, 9, 300 + i] for i in range(batch)]
    eng.generate_greedy(prompts, WARMUP)
    if cuda:
        torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    out = eng.generate_greedy(prompts, args.tokens)  # ends with the host's read of the tokens
    dt = time.perf_counter() - t0
    if out.shape != (batch, args.tokens):
        raise RuntimeError(f"generated {out.shape}, expected {(batch, args.tokens)}")
    if args.rank == 0:
        print(json.dumps({"tokens_per_sec": args.tokens * batch / dt, "batch": batch}), flush=True)
    torch.distributed.destroy_process_group()


def measure(args, n: int) -> tuple[float, int]:
    """Spawn a mesh of n ranks; (rank 0's tokens/s, global batch)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = os.pathsep.join([str(Path(__file__).resolve().parents[2]),
                                         env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gemma_tpu_torch.tools.bench_scaling", "--rank", str(r),
         "--world", str(n), "--coordinator", f"tcp://127.0.0.1:{port}", "--device", args.device,
         "--tp", str(args.tp), "--tokens", str(args.tokens), "--batch", str(args.batch)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env) for r in range(n)]
    try:
        outs = [p.communicate(timeout=1800) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise RuntimeError(f"mesh of {n}: rank {r} exited {p.returncode}:\n{err[-3000:]}")
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    return got["tokens_per_sec"], got["batch"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--max-ranks", type=int, default=None,
                    help="largest mesh (default: the card count; 4 on the CPU)")
    ap.add_argument("--tp", type=int, default=1, help="ranks a model group")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=2, help="rows a data group")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return 0
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench_scaling: no CUDA device (pass --device cpu to run gloo ranks "
                             "on the CPU)")
        limit = min(args.max_ranks or torch.cuda.device_count(), torch.cuda.device_count())
        kind = f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, nccl"
        print(f"one rank a card over NCCL, meshes up to {limit} of {torch.cuda.device_count()} "
              "cards", flush=True)
    else:
        limit = args.max_ranks or 4
        kind = "cpu, gloo"
        print("gloo ranks on this host's CPU share its cores: these numbers measure the "
              "collectives' path and the harness, not scaling", flush=True)
    results: dict[int, float] = {}
    for n in (1, 2, 4, 8, 16):
        if n > limit or n % args.tp:
            continue
        tps, batch = measure(args, n)
        results[n] = tps
        print(f"mesh={n:3d} (tp={args.tp}) batch={batch}: {tps:9.1f} tok/s", flush=True)
    if not results:
        raise SystemExit(f"bench_scaling: no mesh size up to {limit} is a multiple of tp={args.tp}")
    eff = multihost.scaling_efficiency(results)
    print(json.dumps({
        "metric": "scaling_efficiency",
        "tokens_per_sec": {str(k): round(v, 1) for k, v in results.items()},
        "efficiency": {str(k): round(v, 3) for k, v in eff.items()},
        "devices": kind,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
