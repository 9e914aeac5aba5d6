"""serve(): the serving entry point, in one process or across several.

Counterpart of `gemma_tpu/runtime/serving.py` `serve`: submit every request
to a continuous-batching `Scheduler` and drive it to completion.

Across processes (`parallel.multihost`): every process calls `serve()` with
the SAME request list and admits only its hash-routed subset
(`multihost.local_requests`). With `roles`, prefill-only processes serve
admission prefills at `transport` (`kv_transfer.serve_prefill_host`) and
decode processes fetch them from there (`kv_transfer.RemotePrefillClient`):
each K/V chunk crosses the process boundary as a byte-exact frame. With
roles, requests are routed over the decode processes only, so every request
is decoded exactly once; the reference routes over every process first, and
a request that lands on a prefill-only process is never decoded. In one
process, disaggregation is a second `Engine`, passed as `prefill_engine`.

`engine` may be a `parallel.shard_decode.TPEngine`: every rank of its mesh
calls `serve()` with the same requests and runs the same Scheduler on them
(SPMD), so they are not routed over the mesh's processes.
"""
from __future__ import annotations

from typing import Sequence

from ..parallel import multihost
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
    roles=None,
    prefill_engine=None,
    transport=None,
    route_across_hosts: bool = True,
    on_token=None,
    speculative: bool = False,
    spec_k: int = 7,
    spec_block: int = 4,
) -> Scheduler:
    """Drive `requests` to completion; returns the finished Scheduler
    (results in `.finished`, metrics in `.stats()`).

    engine: `runtime.Engine` or `parallel.shard_decode.TPEngine`.
    block: decode steps per issued block (`Scheduler.run`).
    roles: `multihost.HostRoles` for prefill/decode disaggregation; None =
        every process does both.
    prefill_engine: engine for admission prefills (default `engine`; with
        disaggregated roles in ONE process, pass the prefill engine here).
    transport: the cross-process hand-off's address ((host, port) TCP or an
        AF_UNIX path, `runtime.kv_transfer`). A prefill-only process serves
        prefills there until each decode process has connected and
        disconnected, and returns an empty Scheduler; a decode process
        fetches its admission prefills from there, onto `engine.device`.
    route_across_hosts: admit only this process's hash-routed share of
        `requests` when there are several processes.
    speculative, spec_k, spec_block: batched prompt-lookup speculation
        (greedy, dense cache; adaptive k: `Scheduler`)."""
    reqs = list(requests)
    tensor_parallel = hasattr(engine, "mesh")  # the mesh's ranks serve the same requests
    if route_across_hosts and multihost.process_count() > 1 and not tensor_parallel:
        hosts = roles.decode_hosts if roles is not None else None
        reqs = multihost.local_requests(reqs, hosts=hosts)
    if roles is not None and not roles.is_decode():
        if transport is not None:
            from .kv_transfer import serve_prefill_host

            serve_prefill_host(engine, transport, max_connections=len(roles.decode_hosts))
        # without a transport the prefill engine lives in the decode process
        # (passed there as prefill_engine=): nothing runs here
        return Scheduler(engine, sampling=sampling, seed=seed)
    owned_client = None
    if prefill_engine is None and transport is not None:
        from .kv_transfer import RemotePrefillClient

        prefill_engine = owned_client = RemotePrefillClient(transport, device=engine.device)
    try:
        sched = Scheduler(engine, sampling=sampling, seed=seed, on_token=on_token,
                          prefill_engine=prefill_engine, speculative=speculative, spec_k=spec_k,
                          spec_block=spec_block)
        for r in reqs:
            sched.submit(r)
        sched.run(max_steps=max_steps, block=block)
    finally:
        if owned_client is not None:  # the disconnect ends the prefill host's loop
            owned_client.close()
    return sched
