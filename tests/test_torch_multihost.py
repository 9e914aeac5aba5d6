"""Serving across processes: `gemma_tpu_torch.parallel.multihost` against the
JAX package's `gemma_tpu.parallel.multihost`, and `serve(roles=...,
transport=...)` across two real processes joined by a gloo group.

Routing, roles and scaling efficiency give the reference's results for the
same arguments. `initialize` is a no-op without arguments or environment,
and raises where the reference carries on as one process. The two-rank run
happens in spawned subprocesses, so no process group is left in the test
process: rank 1 serves prefills at an AF_UNIX path, rank 0 decodes every
request (routing with roles goes over the decode processes only; the
reference routes over both ranks and never decodes what lands on rank 1),
and the streams equal the JAX Scheduler's on the same GGUF (f32
activations, `mode="dequant"`, Pallas kernels in interpret mode).
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import pytest
import torch.distributed as dist

import jax.numpy as jnp

from gemma_tpu.gguf import GGUFReader
from gemma_tpu.models.params import load_params as jax_load_params
from gemma_tpu.parallel import multihost as jax_multihost
from gemma_tpu.runtime import Engine as JaxEngine
from gemma_tpu.runtime import EngineConfig as JaxEngineConfig
from gemma_tpu.runtime.scheduler import Request as JaxRequest
from gemma_tpu.runtime.scheduler import Scheduler as JaxScheduler
from gemma_tpu_torch.parallel import multihost
from gemma_tpu_torch.testing import TINY_KERNEL_CONFIG, make_gguf

ROOT = Path(__file__).resolve().parents[1]


class R:
    def __init__(self, id):
        self.id = id


@pytest.mark.parametrize("n", range(1, 9))
def test_route_request_matches_jax(n):
    ids = [f"req-{i}" for i in range(1000)]
    ours = [multihost.route_request(i, n) for i in ids]
    assert ours == [jax_multihost.route_request(i, n) for i in ids]
    assert set(ours) == set(range(n))


@pytest.mark.parametrize("hosts", [None, (1, 3)])
def test_local_requests_partition_the_list(monkeypatch, hosts):
    """Every process given the same list admits a disjoint share; the shares
    cover the list, over all four processes or over `hosts` only."""
    reqs = [R(f"req-{i}") for i in range(64)]
    shares = {}
    for me in range(4):
        monkeypatch.setattr(multihost, "process_index", lambda me=me: me)
        shares[me] = [r.id for r in multihost.local_requests(reqs, 4, hosts=hosts)]
    ids = [i for share in shares.values() for i in share]
    assert sorted(ids) == sorted(r.id for r in reqs)
    if hosts is None:
        assert all(shares[me] == [r.id for r in reqs if jax_multihost.route_request(r.id, 4) == me]
                   for me in range(4))
    else:
        assert shares[0] == shares[2] == [] and shares[1] and shares[3]
    monkeypatch.setattr(multihost, "process_index", lambda: 0)
    assert [r.id for r in multihost.local_requests(reqs, 1)] == [r.id for r in reqs]


def test_host_roles_and_scaling_efficiency_match_jax():
    for ours, theirs in ((multihost.HostRoles.uniform(4), jax_multihost.HostRoles.uniform(4)),
                         (multihost.HostRoles.uniform(), jax_multihost.HostRoles.uniform()),
                         (multihost.HostRoles.disaggregated(1, 4),
                          jax_multihost.HostRoles.disaggregated(1, 4)),
                         (multihost.HostRoles.disaggregated(3, 4),
                          jax_multihost.HostRoles.disaggregated(3, 4))):
        assert (ours.prefill_hosts, ours.decode_hosts) == (theirs.prefill_hosts,
                                                           theirs.decode_hosts)
        assert [(ours.is_prefill(p), ours.is_decode(p)) for p in range(5)] == [
            (theirs.is_prefill(p), theirs.is_decode(p)) for p in range(5)]
        assert (ours.is_prefill(), ours.is_decode()) == (theirs.is_prefill(), theirs.is_decode())
    for n_prefill, n in ((4, 4), (0, 4), (1, 1)):
        with pytest.raises(ValueError):
            multihost.HostRoles.disaggregated(n_prefill, n)
        with pytest.raises(ValueError):
            jax_multihost.HostRoles.disaggregated(n_prefill, n)
    rates = {1: 100.0, 2: 190.0, 4: 340.0, 8: 600.0}
    assert multihost.scaling_efficiency(rates) == jax_multihost.scaling_efficiency(rates)
    assert multihost.scaling_efficiency({2: 50.0, 4: 90.0}) == pytest.approx({2: 1.0, 4: 0.9})


def test_initialize_without_arguments_or_environment_is_a_no_op(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    multihost.initialize()
    assert not dist.is_initialized()
    assert (multihost.process_count(), multihost.process_index()) == (1, 0)
    with pytest.raises(ValueError, match="together"):
        multihost.initialize("127.0.0.1:1", 2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_raises_on_a_coordinator_that_cannot_be_reached():
    """Rank 1 of 2 with nothing listening at the coordinator: it raises
    within its 2 s timeout, and no group is left behind."""
    t0 = time.monotonic()
    with pytest.raises(Exception) as err:
        multihost.initialize(f"127.0.0.1:{_free_port()}", 2, 1, timeout=2)
    assert isinstance(err.value, (RuntimeError, TimeoutError)), repr(err.value)
    assert time.monotonic() - t0 < 60
    assert not dist.is_initialized()


_RANK = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
from gemma_tpu_torch.gguf.reader import GGUFReader
from gemma_tpu_torch.models.params import load_params
from gemma_tpu_torch.parallel import multihost
from gemma_tpu_torch.runtime import Engine, EngineConfig, Request, serve

path, coordinator, rank, transport, requests = sys.argv[1:6]
multihost.initialize(coordinator, 2, int(rank), timeout=120)
cfg, model = load_params(GGUFReader(path), "cpu", mode="dequant")
cfg = dataclasses.replace(cfg, activation_dtype="float32")
eng = Engine(cfg, model, EngineConfig(max_seq_len=64, max_batch=2, kv_dtype=torch.float32))
roles = multihost.HostRoles((1,), (0,))  # rank 1 prefills, rank 0 decodes
sched = serve(eng, [Request(i, p, n) for i, p, n in json.loads(requests)], roles=roles,
              transport=transport, block=2)
print(json.dumps({"rank": multihost.process_index(), "count": multihost.process_count(),
                  "decode": roles.is_decode(), "streams": {r.id: r.tokens for r in sched.finished},
                  "admitted": sched.stats()["requests"]}))
dist.destroy_process_group()
"""

REQUESTS = [(f"r{i}", [1 + i, 7, 300 - i, 42][: 2 + i % 3] + list(range(9, 9 + 3 * i)), 5)
            for i in range(6)]


def test_two_processes_decode_every_request_exactly_once(tmp_path, monkeypatch):
    path = make_gguf(tmp_path / "tiny.gguf", TINY_KERNEL_CONFIG, seed=3)
    # the reference's routing over both ranks would send these to rank 1,
    # a prefill-only process, and never decode them
    assert {jax_multihost.route_request(i, 2) for i, _, _ in REQUESTS} == {0, 1}
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "MASTER_ADDR", "WORLD_SIZE")}
    env["PYTHONPATH"] = str(ROOT)
    coordinator = f"tcp://127.0.0.1:{_free_port()}"
    with tempfile.TemporaryDirectory(prefix="kvt") as short:  # an AF_UNIX path < 108 bytes
        transport = os.path.join(short, "prefill.sock")
        procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(path), coordinator, str(rank),
                                   transport, json.dumps(REQUESTS)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                  env=env, cwd=tmp_path)
                 for rank in (0, 1)]
        try:
            outs = [p.communicate(timeout=240) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert not os.path.exists(transport)
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    decode, prefill = (json.loads(out.strip().splitlines()[-1]) for out, _ in outs)
    assert (decode["rank"], decode["count"], decode["decode"]) == (0, 2, True)
    assert (prefill["rank"], prefill["count"], prefill["decode"]) == (1, 2, False)
    assert prefill["streams"] == {} and prefill["admitted"] == 0

    jcfg, jparams = jax_load_params(GGUFReader(path), mode="dequant")
    jcfg = dataclasses.replace(jcfg, activation_dtype="float32")
    monkeypatch.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")
    ref = JaxScheduler(JaxEngine(jcfg, jparams, JaxEngineConfig(
        max_seq_len=64, max_batch=2, kv_dtype=jnp.float32, donate_cache=False)))
    for rid, prompt, n in REQUESTS:
        ref.submit(JaxRequest(rid, prompt, max_new_tokens=n))
    ref.run(block=2)
    assert decode["admitted"] == len(REQUESTS)
    assert decode["streams"] == {r.id: r.tokens for r in ref.finished}
