"""serve(): the serving entry point, for one process.

Counterpart of `gemma_tpu/runtime/serving.py` `serve`: submit every request
to a continuous-batching `Scheduler` and drive it to completion. The port
runs in one process on one device, so there is no routing of requests
across hosts (the reference's `jax.process_count` branch). Prefill/decode
disaggregation across processes (`roles`, `transport`) is not ported yet;
in one process it is a second `Engine`, passed as `prefill_engine`.
"""
from __future__ import annotations

from typing import Sequence

from .sampler import SamplingParams
from .scheduler import Request, Scheduler


def serve(
    engine,
    requests: Sequence[Request],
    *,
    sampling: SamplingParams = SamplingParams(),
    block: int = 1,
    max_steps: int | None = None,
    seed: int = 0,
    prefill_engine=None,
    on_token=None,
    roles=None,
    transport=None,
    speculative: bool = False,
    spec_k: int = 7,
    spec_block: int = 4,
) -> Scheduler:
    """Drive `requests` to completion; returns the finished Scheduler
    (results in `.finished`, metrics in `.stats()`).

    block: decode steps per issued block (`Scheduler.run`).
    prefill_engine: engine for admission prefills (default `engine`).
    speculative, spec_k, spec_block: batched prompt-lookup speculation
    (greedy, dense cache; adaptive k: `Scheduler`)."""
    if roles is not None:
        raise NotImplementedError(
            "serve(roles=...) is not ported to gemma_tpu_torch yet: host roles come with "
            "torch.distributed (ROADMAP queue 1, item 9)"
        )
    if transport is not None:
        raise NotImplementedError(
            "serve(transport=...) is not ported to gemma_tpu_torch yet: the cross-process KV "
            "hand-off is ROADMAP queue 1, item 8"
        )
    sched = Scheduler(engine, sampling=sampling, seed=seed, on_token=on_token,
                      prefill_engine=prefill_engine, speculative=speculative, spec_k=spec_k,
                      spec_block=spec_block)
    for r in requests:
        sched.submit(r)
    sched.run(max_steps=max_steps, block=block)
    return sched
