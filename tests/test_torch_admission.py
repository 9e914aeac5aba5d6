"""`Scheduler(admit_per_tick=)`: the port's admissions tick by tick
against the JAX package's Scheduler on the same requests, on a tiny model.

One q4_0 GGUF of `TINY_KERNEL_CONFIG` is loaded into the JAX package and
carried into the port by `from_jax_params`; both run f32 activations (the
reference's Pallas kernels in interpret mode, the port's plain versions),
as in tests/test_torch_serving.py, whose scheduling scenarios hold the
capped streams over every cache arm. Greedy streams alone cannot show the
cap: here the requests active in each slot after every block and the
decode steps must be the reference's too.
"""
import pytest
import torch

import jax.numpy as jnp

from gemma_tpu.runtime import Engine as JaxEngine
from gemma_tpu.runtime import EngineConfig as JaxEngineConfig
from gemma_tpu.runtime.scheduler import Request as JaxRequest
from gemma_tpu.runtime.scheduler import Scheduler as JaxScheduler
from gemma_tpu_torch.runtime import Engine, EngineConfig, Request, Scheduler
from test_torch_tool_benches import one_torch_thread, tiny_f32  # noqa: F401 (shared fixtures)

# id -> (prompt, max_new_tokens): "e" and "f" are longer than two chunks,
# so they admit chunk by chunk when overlap is on
REQUESTS = {
    "a": ([1, 7, 300], 10),
    "b": ([1, 44, 260, 9, 77], 10),
    "c": (list(range(3, 19)), 10),
    "d": ([1, 33], 10),
    "e": (list(range(5, 35)), 10),
    "f": (list(range(40, 80)), 10),
}
ARMS = {"dense": (False, False), "paged": (True, False), "paged_int8": (True, True)}
ENGINE = dict(max_seq_len=64, max_batch=3, page_size=16, prefill_chunk=16)


@pytest.fixture(autouse=True)
def _xla_reference_paths(monkeypatch):
    # other modules set this process-wide; the reference runs its kernels
    # in interpret mode only where a test pins it
    monkeypatch.delenv("GEMMA_TPU_INTERPRET_KERNELS", raising=False)


def _ticks(sched, request, block: int = 2):
    """Drive `sched` over REQUESTS by step_block(block): the (slot, id) of
    every active request after each block, the streams and the decode
    steps."""
    for rid, (prompt, n) in REQUESTS.items():
        sched.submit(request(rid, prompt, max_new_tokens=n))
    ticks = []
    while len(sched.finished) < len(REQUESTS):
        sched.step_block(block)
        ticks.append(sorted((slot, r.id) for slot, r in sched.active.items()))
    return ticks, {r.id: r.tokens for r in sched.finished}, sched.stats()["decode_steps"]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("arm", list(ARMS))
def test_admit_per_tick_admits_what_the_reference_admits(tiny_f32, arm, overlap, monkeypatch,
                                                         one_torch_thread):
    """Scheduler(admit_per_tick=1) and (admit_per_tick=None) against the JAX
    Scheduler, dense, paged and paged int8 caches, overlapped admission off
    and on (an overlapped admission counts when it starts): every block's
    active (slot, id) pairs, the decode steps and the streams. The capped
    and uncapped streams are equal; the cap admits one request at the
    first block and takes more steps. 5-15 s a case."""
    jcfg, jparams, tcfg, model = tiny_f32
    paged, quant = ARMS[arm]
    got = {}
    for cap in (1, None):
        with monkeypatch.context() as mp:
            mp.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")
            ref = _ticks(JaxScheduler(JaxEngine(jcfg, jparams, JaxEngineConfig(
                kv_dtype=jnp.float32, kv_quantized=quant, paged=paged, donate_cache=False,
                **ENGINE)), admit_per_tick=cap, overlap_admission=overlap), JaxRequest)
        got[cap] = _ticks(Scheduler(Engine(tcfg, model, EngineConfig(
            kv_dtype=torch.float32, kv_quantized=quant, paged=paged, **ENGINE)),
            admit_per_tick=cap, overlap_admission=overlap), Request)
        assert got[cap] == ref, cap
    assert got[1][1] == got[None][1]
    assert len(got[1][0][0]) == 1 and len(got[None][0][0]) == 3
    assert got[1][2] > got[None][2]
