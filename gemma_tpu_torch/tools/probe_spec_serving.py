"""Where the batched speculative serving tick's time goes, against the plain
decode block of the same batch.

The counterpart of the reference's `tools/probe_spec_serving.py`, on the
port's speculative `Scheduler` at full Gemma-2B width (q4_0, random weights
from a seed), 8 slots of 64-token prompts, k = 7 pinned, blocks of 4
ticks, two blocks in flight. With every slot active and no admission in
the loop it reads:

  issue    host ms to issue one block (`_spec_issue`: its ~4 forwards'
           launches, no sync), the median over the blocks;
  drain    host ms of `_spec_drain` with one more block in flight (the wait
           for its packed copy, then the emission), the median;
  wall     ms a block of the pipelined loop;
  busy     device ms a block from torch.profiler (the kernels' own time),
           and the idle share 1 - busy / wall;
  tokens   a slot emits a verify forward;

then the same for `Engine.block` of 8 plain decode steps a block on the
same batch. On the CPU (`--device cpu`) a tiny config runs the plain
versions; its times say nothing of the card.

    python -m gemma_tpu_torch.tools.probe_spec_serving [--blocks 4] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..models import GEMMA_2B
from ..models.params import resolve_device
from ..ops import attention as att
from ..runtime import Engine, EngineConfig, Request, Scheduler
from ..testing import TINY_KERNEL_CONFIG, make_params
from . import _timing as T

SLOTS = 8
PROMPT = 64
PLAIN_BLOCK = 8


def run(dev: torch.device, blocks: int = 4) -> dict:
    card = T.card_line(dev)
    print(card, flush=True)
    cpu = dev.type != "cuda"
    cfg = TINY_KERNEL_CONFIG if cpu else GEMMA_2B
    eng = Engine(cfg, make_params(cfg, "q4_0", seed=0, device=dev),
                 EngineConfig(max_seq_len=512, max_batch=SLOTS))
    sched = Scheduler(eng, speculative=True, spec_k=7, spec_block=4, spec_min_accept=0.0)
    for i in range(SLOTS):
        sched.submit(Request(f"r{i}", [2 + (j + i) % 1000 for j in range(PROMPT)],
                             max_new_tokens=400))
    sched._admit()
    if len(sched.active) != SLOTS:
        raise RuntimeError(f"{len(sched.active)} of {SLOTS} slots active")
    sched.step_spec()  # first launches, allocator
    T.sync(dev)
    flash0 = att.flash_attention.launches

    emitted0 = sum(len(r.tokens) for r in sched.active.values())
    issue, drain = [], []
    t0 = time.perf_counter()
    for _ in range(blocks):
        t1 = time.perf_counter()
        sched._spec_issue()
        t2 = time.perf_counter()
        if len(sched._spec_pending) >= 2:
            sched._spec_drain()
        issue.append((t2 - t1) * 1e3)
        drain.append((time.perf_counter() - t2) * 1e3)
    while sched._spec_pending:
        sched._spec_drain()
    wall = (time.perf_counter() - t0) * 1e3 / blocks
    per_verify = (sum(len(r.tokens) for r in sched.active.values()) - emitted0) / (
        blocks * sched.spec.block * SLOTS)

    def spec_blocks():
        for _ in range(blocks):
            sched._spec_issue()
        while sched._spec_pending:
            sched._spec_drain()

    busy = (T.profile_busy(spec_blocks, dev)[0] or 0.0) / blocks  # 0 on the CPU
    if len(sched.active) != SLOTS:  # 1 + 2 x blocks blocks of at most 32 tokens a slot
        raise RuntimeError("a slot finished inside the probe: run fewer blocks")
    ticks = sched.spec.block
    forwards = att.flash_attention.launches - flash0
    spec = {"issue_ms": statistics.median(issue), "drain_ms": statistics.median(drain[1:]),
            "wall_ms_block": wall, "busy_ms_block": busy, "ticks_a_block": ticks,
            "tokens_per_verify": per_verify,
            "idle_share": 1 - busy / wall if busy else None}

    # the plain decode block on the same batch and cache
    logits, gen = sched._logits, torch.Generator(device=dev)
    eng.block(logits, gen, sched.cache, PLAIN_BLOCK)  # first launches
    T.sync(dev)
    p_issue = []
    t0 = time.perf_counter()
    for _ in range(blocks):
        t1 = time.perf_counter()
        toks, logits, _ = eng.block(logits, gen, sched.cache, PLAIN_BLOCK)
        p_issue.append((time.perf_counter() - t1) * 1e3)
        toks.cpu()
    p_wall = (time.perf_counter() - t0) * 1e3 / blocks
    p_busy = (T.profile_busy(lambda: [eng.block(logits, gen, sched.cache, PLAIN_BLOCK)
                                      for _ in range(blocks)], dev)[0] or 0.0) / blocks
    plain = {"issue_ms": statistics.median(p_issue), "wall_ms_block": p_wall,
             "busy_ms_block": p_busy, "steps_a_block": PLAIN_BLOCK,
             "idle_share": 1 - p_busy / p_wall if p_busy else None}
    note = "" if not cpu else " " + T.CPU_NOTE
    print(f"speculative, {SLOTS} slots, k=7, {ticks} ticks a block: issue p50 {spec['issue_ms']:.2f} "
          f"ms, drain p50 {spec['drain_ms']:.2f} ms, wall {wall:.2f} ms a block "
          f"({wall / ticks:.2f} a tick), device busy {busy:.2f} ms a block ({busy / ticks:.2f} a "
          f"verify forward); {per_verify:.2f} tokens a slot a verify{note}", flush=True)
    print(f"plain, {SLOTS} slots, {PLAIN_BLOCK} steps a block: issue p50 {plain['issue_ms']:.2f} ms, "
          f"wall {p_wall:.2f} ms a block ({p_wall / PLAIN_BLOCK:.2f} a step), device busy "
          f"{p_busy:.2f} ms a block ({p_busy / PLAIN_BLOCK:.2f} a step){note}", flush=True)
    out = {"speculative": spec, "plain": plain}
    print(json.dumps({"metric": f"spec_serving_tick_{'tiny' if cpu else 'gemma2b'}_q4_0", **out,
                      "slots": SLOTS, "blocks": blocks, "device": card,
                      "verify_forwards_launched": forwards}), flush=True)
    if not cpu and forwards == 0:
        raise RuntimeError("no verify forward reached the flash kernel")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(resolve_device(args.device), args.blocks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
