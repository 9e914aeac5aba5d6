"""The cross-process prefill -> decode hand-off (`gemma_tpu_torch.runtime.kv_transfer`)
against the JAX package's (`gemma_tpu.runtime.kv_transfer`).

One q4_0 GGUF of `TINY_KERNEL_CONFIG` is loaded by both packages with
`mode="dequant"` (the worker's load: bf16 weights) and run with f32
activations. Prefill hosts are real processes, `python -m
gemma_tpu_torch.runtime.kv_transfer --device cpu --dtype float32`, one per
KV format: "f32" (f32 cache, no chunks) and "int8_chunked" (int8 cache,
24-token chunks, so a prompt of 25-32 tokens hands over 48 slots where its
length rounded to 16-key pages would be 32: the host's chunk must reach
the decode side's page allocation).

Frames are held bit for bit in both directions against the JAX codec. The
remote tuple equals the port's local `prefill_standalone` bit for bit and
the JAX `Engine.prefill_standalone` within 1e-5 of the largest |value|
(tests/test_torch_model.py's f32 tolerance: the same arithmetic up to the
order of f32 sums). Greedy streams through `serve()` with the remote
prefills equal the JAX Scheduler's (Pallas kernels in interpret mode) on
four cache arms.
"""
import dataclasses
import io
import json
import os
import queue
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gemma_tpu.gguf import GGUFReader
from gemma_tpu.models.params import load_params as jax_load_params
from gemma_tpu.runtime import Engine as JaxEngine
from gemma_tpu.runtime import EngineConfig as JaxEngineConfig
from gemma_tpu.runtime import kv_transfer as jax_kv
from gemma_tpu.runtime.scheduler import Request as JaxRequest
from gemma_tpu.runtime.scheduler import Scheduler as JaxScheduler
from gemma_tpu_torch.models import load_params
from gemma_tpu_torch.parallel.multihost import HostRoles
from gemma_tpu_torch.runtime import Engine, EngineConfig, Request, serve
from gemma_tpu_torch.runtime import kv_transfer as kv
from gemma_tpu_torch.testing import TINY_KERNEL_CONFIG, make_gguf

ROOT = Path(__file__).resolve().parents[1]
MAX_SEQ_LEN = 64
PAGE = 16
HOST_CHUNK = 24  # != PAGE
# id -> (prompt, max_new_tokens): "b" and "d" are longer than a chunk
REQUESTS = {
    "a": ([1, 7, 300], 6),
    "b": (list(range(3, 29)), 6),
    "c": ([1, 44, 260, 9, 77], 6),
    "d": (list(range(40, 70)), 6),
}
ARMS = {  # name -> (paged, kv_quantized, prefill host)
    "dense": (False, False, "f32"),
    "dense_int8": (False, True, "int8_chunked"),
    "paged": (True, False, "f32"),
    "paged_int8": (True, True, "int8_chunked"),
}
HOSTS = {  # prefill host -> (worker flags, connections the module makes)
    "f32": ([], 1 + 2 * 2),
    "int8_chunked": (["--kv-quantized", "--prefill-chunk", str(HOST_CHUNK)], 2 * 2 + 1),
}


@pytest.fixture(autouse=True)
def _xla_reference_paths(monkeypatch):
    # other modules set this process-wide; the reference runs its kernels
    # in interpret mode only inside `reference_streams`
    monkeypatch.delenv("GEMMA_TPU_INTERPRET_KERNELS", raising=False)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = make_gguf(tmp_path_factory.mktemp("kvt") / "tiny.gguf", TINY_KERNEL_CONFIG, seed=3)
    reader = GGUFReader(path)
    jcfg, jparams = jax_load_params(reader, mode="dequant")
    tcfg, model = load_params(reader, device="cpu", mode="dequant")
    jcfg, tcfg = (dataclasses.replace(c, activation_dtype="float32") for c in (jcfg, tcfg))
    return path, jcfg, jparams, tcfg, model


def _engine(tiny, *, kv_dtype=torch.float32, **kw):
    _, _, _, tcfg, model = tiny
    return Engine(tcfg, model, EngineConfig(max_seq_len=MAX_SEQ_LEN, kv_dtype=kv_dtype, **kw))


def _jax_engine(tiny, *, kv_dtype=jnp.float32, **kw):
    _, jcfg, jparams, _, _ = tiny
    return JaxEngine(jcfg, jparams, JaxEngineConfig(max_seq_len=MAX_SEQ_LEN, kv_dtype=kv_dtype,
                                                    donate_cache=False, **kw))


class Worker:
    """A spawned prefill worker; its stdout lines are read by a thread."""

    def __init__(self, path, name, flags, connections):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = str(ROOT)
        self.log = Path(path).with_name(f"worker-{name}.log")
        with open(self.log, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "gemma_tpu_torch.runtime.kv_transfer", "--gguf", str(path),
                 "--device", "cpu", "--dtype", "float32", "--max-seq-len", "128",
                 "--max-connections", str(connections), *flags],
                stdout=subprocess.PIPE, stderr=err, text=True, env=env, cwd=ROOT)
        self.lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()
        first = self.next_line()
        assert first.startswith("PORT "), first + self.log.read_text()[-3000:]
        self.address = ("127.0.0.1", int(first.split()[1]))

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line.strip())
        self.lines.put("")

    def next_line(self, timeout=120) -> str:
        return self.lines.get(timeout=timeout)

    def close(self):
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:  # a test of the module did not run
            self.proc.kill()
            self.proc.wait()


@pytest.fixture(scope="module")
def workers(tiny):
    started = {}

    def get(host):
        if host not in started:
            started[host] = Worker(tiny[0], host, *HOSTS[host])
        return started[host]

    yield get
    for w in started.values():
        w.close()


@pytest.fixture(scope="module")
def reference_streams(tiny):
    """The JAX Scheduler's stream of every request, per arm (block 2)."""
    cache = {}

    def get(arm):
        if arm not in cache:
            paged, quant, _ = ARMS[arm]
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")
                sched = JaxScheduler(_jax_engine(tiny, max_batch=2, kv_quantized=quant,
                                                 paged=paged, page_size=PAGE))
                for rid, (prompt, n) in REQUESTS.items():
                    sched.submit(JaxRequest(rid, prompt, max_new_tokens=n))
                sched.run(block=2)
            cache[arm] = {r.id: r.tokens for r in sched.finished}
        return cache[arm]

    return get


def _bits(x) -> np.ndarray:
    """The raw bits of a tensor or array (bf16 as int16), dtype kept otherwise."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.detach().cpu().numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _assert_same_bits(a, b):
    a_bits, b_bits = _bits(a), _bits(b)
    assert a_bits.dtype == b_bits.dtype and a_bits.shape == b_bits.shape
    np.testing.assert_array_equal(a_bits, b_bits)


def _assert_same_tuple(a, b):
    for x, y in zip(a[:3], b[:3]):
        _assert_same_bits(x, y)
    for x, y in zip(a[3], b[3]):
        assert (x is None) == (y is None)
        if x is not None:
            _assert_same_bits(x, y)
    assert int(a[4]) == int(b[4])


FORMATS = {  # name -> (port kv dtype, JAX kv dtype, kv_quantized)
    "bf16": (torch.bfloat16, jnp.bfloat16, False),
    "f32": (torch.float32, jnp.float32, False),
    "int8": (torch.float32, jnp.float32, True),
}
PROMPT = [1, 7, 300, 42, 260, 9, 77, 5, 400, 13]


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_serialize_roundtrip_bit_exact(tiny, fmt):
    kv_dtype, _, quant = FORMATS[fmt]
    pre = _engine(tiny, kv_dtype=kv_dtype, kv_quantized=quant).prefill_standalone(PROMPT)
    assert pre[1].dtype == (torch.int8 if quant else kv_dtype)
    data = kv.serialize_prefill(pre)
    back = kv.deserialize_prefill(data, device="cpu")
    _assert_same_tuple(back, pre)
    assert (back[3][0] is not None) == quant
    assert kv.serialize_prefill(back) == kv.serialize_prefill(back)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_frames_read_to_the_same_bits_in_both_directions(tiny, fmt):
    """The JAX `deserialize_prefill` reads a port frame, and the port's reads
    a JAX frame, to the sender's bits."""
    kv_dtype, jax_dtype, quant = FORMATS[fmt]
    ours = _engine(tiny, kv_dtype=kv_dtype, kv_quantized=quant).prefill_standalone(PROMPT)
    theirs = _jax_engine(tiny, kv_dtype=jax_dtype, kv_quantized=quant).prefill_standalone(PROMPT)
    theirs = jax.tree_util.tree_map(np.asarray, theirs)
    _assert_same_tuple(jax_kv.deserialize_prefill(kv.serialize_prefill(ours)), ours)
    _assert_same_tuple(kv.deserialize_prefill(jax_kv.serialize_prefill(theirs), device="cpu"),
                       theirs)


def _rel_err(a, ref) -> float:
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def test_remote_tuple_matches_local_and_jax(tiny, workers):
    """The worker's tuple equals the port's local prefill_standalone bit for
    bit, and the JAX Engine's within 1e-5 (its vocab padding and bucket
    slots past the port's T sliced off)."""
    client = kv.RemotePrefillClient(workers("f32").address, device="cpu")
    try:
        assert client.ecfg.prefill_chunk == 0 and client.ecfg.kv_dtype == torch.float32
        assert client.handshake["kv_dtype"] == "float32"
        remote = client.prefill_standalone(PROMPT)
    finally:
        client.close()
    assert workers("f32").next_line() == "SERVED 1"
    assert remote[0].device.type == "cpu"
    _assert_same_tuple(remote, _engine(tiny).prefill_standalone(PROMPT))
    ref = jax.tree_util.tree_map(np.asarray, _jax_engine(tiny).prefill_standalone(PROMPT))
    V, T = TINY_KERNEL_CONFIG.vocab_size, remote[1].shape[2]
    assert _rel_err(remote[0], ref[0][:V]) <= 1e-5
    for ours, theirs in zip(remote[1:3], ref[1:3]):
        assert _rel_err(ours, theirs[:, :, :T]) <= 1e-5
    assert remote[4] == ref[4] == len(PROMPT)


@pytest.mark.parametrize("via", ["prefill_engine", "roles"])
@pytest.mark.parametrize("arm", list(ARMS))
def test_remote_prefill_streams_match_reference_scheduler(tiny, workers, reference_streams,
                                                          arm, via):
    """serve() with every admission prefilled in the worker gives the JAX
    Scheduler's streams; the worker serves one prefill an admission."""
    paged, quant, host = ARMS[arm]
    worker = workers(host)
    dec = _engine(tiny, max_batch=2, kv_quantized=quant, paged=paged, page_size=PAGE)
    reqs = [Request(rid, *REQUESTS[rid]) for rid in REQUESTS]
    if via == "roles":
        sched = serve(dec, reqs, roles=HostRoles((1,), (0,)), transport=worker.address, block=2)
    else:
        client = kv.RemotePrefillClient(worker.address, device="cpu")
        try:
            if quant:  # the host's chunk sizes the pages: 48 slots, not 32
                assert [client.prefill_len(len(REQUESTS[r][0]), PAGE) for r in "bd"] == [48, 48]
            sched = serve(dec, reqs, prefill_engine=client, block=2)
        finally:
            client.close()
    assert worker.next_line() == f"SERVED {len(REQUESTS)}"
    assert {r.id: r.tokens for r in sched.finished} == reference_streams(arm)
    if paged:  # every page back in the pool
        assert sched.allocator.free_pages == sched.allocator.n_pages - 1


def test_format_mismatch_raises(tiny, workers):
    """An int8 prefill host against a bf16 decode engine: the Scheduler's
    format error, and the connection is closed."""
    dec = _engine(tiny, kv_dtype=torch.bfloat16, max_batch=2)
    worker = workers("int8_chunked")
    with pytest.raises(ValueError, match="KV format"):
        serve(dec, [Request("a", *REQUESTS["a"])], roles=HostRoles((1,), (0,)),
              transport=worker.address)
    assert worker.next_line() == "SERVED 0"


def test_host_disconnect_mid_request_raises(tiny):
    """A host that reads the request and hangs up: ConnectionError."""
    host, peer = socket.socketpair()

    def fake_host():
        with host:
            kv._send_frame(host, json.dumps(kv.engine_handshake(_engine(tiny))).encode())
            assert kv._recv_frame(host) is not None

    t = threading.Thread(target=fake_host)
    t.start()
    client = kv.RemotePrefillClient(peer, device="cpu")
    try:
        with pytest.raises(ConnectionError, match="disconnected"):
            client.prefill_standalone(PROMPT)
    finally:
        client.close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_client_and_worker_refuse_cuda_without_a_card(tiny, monkeypatch):
    """`--device cuda` with no card exits non-zero before it listens, and the
    client and the codec raise: neither moves to the CPU on its own."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-m", "gemma_tpu_torch.runtime.kv_transfer", "--gguf",
                           str(tiny[0]), "--device", "cuda"],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode != 0 and "PORT" not in proc.stdout
    assert "no CUDA device" in proc.stderr
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = kv.serialize_prefill(_engine(tiny).prefill_standalone(PROMPT))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kv.deserialize_prefill(data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kv.RemotePrefillClient(("127.0.0.1", 1))


def test_frame_without_its_arrays_is_refused():
    buf = io.BytesIO()
    np.savez(buf, logits=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="lacks"):
        kv.deserialize_prefill(buf.getvalue(), device="cpu")
