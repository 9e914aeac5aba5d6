"""Cross-process prefill -> decode KV hand-off (disaggregated serving).

Counterpart of `gemma_tpu/runtime/kv_transfer.py`, with its encoding and
protocol. A prefill process runs `Engine.prefill_standalone` and sends the
insert tuple to a decode process, whose `Scheduler` inserts it into its
serving cache:

* `serialize_prefill` / `deserialize_prefill`: the insert tuple (logits,
  K/V sequence, int8 scales, length) as `np.savez` bytes. A bf16 tensor is
  stored as its 16-bit pattern under `<name>__bf16` (uint16), so the round
  trip is bit for bit, and the JAX package's `deserialize_prefill` reads a
  frame of this module (and this module one of the JAX package's) to the
  same bits. `deserialize_prefill` puts the tuple on a device, one copy an
  array through pinned memory.
* framing: an 8-byte little-endian length, then the payload.
* `prefill_server` / `serve_prefill_host`: the prefill process's loop, one
  request frame in and one tuple out, until the peer disconnects.
* `RemotePrefillClient`: what the `Scheduler` reads of a prefill engine
  (`ecfg`, `prefill_len`, `prefill_standalone`), so a decode process
  passes it as `prefill_engine=` and admits through the wire.

Transport is a stream socket: TCP ((host, port)) or an AF_UNIX path.

The handshake has the reference's keys, and one more: `host_prefill_chunk`,
the prefill engine's own chunk. The reference reports `prefill_chunk` 0
(a remote prefill arrives whole, so the decode side must never start a
chunked admission) and sizes T by its power-of-two bucket; the port does not
bucket but rounds T up to whole chunks (`engine.prefill_len`), and the
decode side allocates a paged slot's pages from that T before the prefill
arrives, so it needs the host's chunk.

The worker, `python -m gemma_tpu_torch.runtime.kv_transfer --gguf m.gguf`,
loads a checkpoint (`mode="dequant"`, as the reference's) onto `--device`
(default cuda; without a card it fails, it never runs on the CPU on its
own) and serves prefill connections on a TCP port, printing `PORT <n>`
once it listens and `SERVED <n>` after each connection.
"""
from __future__ import annotations

import io
import json
import os
import socket
import struct
import time
from typing import Any

import numpy as np
import torch

from ..models.params import resolve_device
from .engine import EngineConfig, prefill_len
from .kv_cache import to_device

Address = tuple[str, int] | str


# ---------------------------------------------------------------------------
# Byte-exact tuple serialization
# ---------------------------------------------------------------------------

def _host_array(t) -> tuple[np.ndarray, bool]:
    """(numpy array on the host, whether it holds bf16 bits as uint16)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t), False
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), True
    return t.cpu().numpy(), False


def serialize_prefill(pre) -> bytes:
    """Insert tuple -> bytes (`np.savez`, bf16 as its uint16 bits)."""
    logits, k_seq, v_seq, (k_sc, v_sc), length = pre
    arrays = {"logits": logits, "k_seq": k_seq, "v_seq": v_seq,
              "length": np.asarray(length, np.int64)}
    if k_sc is not None:
        arrays["k_scale"] = k_sc
        arrays["v_scale"] = v_sc
    out: dict[str, np.ndarray] = {}
    for name, t in arrays.items():
        a, bf16 = _host_array(t)
        out[name + "__bf16" if bf16 else name] = a
    buf = io.BytesIO()
    np.savez(buf, **out)
    return buf.getvalue()


def deserialize_prefill(data: bytes, device="cuda"):
    """Bytes -> the insert tuple (logits, k_seq, v_seq, (k_scale, v_scale),
    length), its tensors on `device` (the card unless the caller asks for
    the CPU)."""
    dev = resolve_device(device)
    arrays: dict[str, torch.Tensor] = {}
    with np.load(io.BytesIO(data)) as z:
        for name in z.files:
            a = z[name]
            if name.endswith("__bf16"):
                arrays[name[: -len("__bf16")]] = torch.from_numpy(a.view(np.int16)).view(
                    torch.bfloat16)
            else:
                arrays[name] = torch.from_numpy(a)
    missing = {"logits", "k_seq", "v_seq", "length"} - set(arrays)
    if missing:
        raise ValueError(f"prefill frame lacks {sorted(missing)}")
    length = int(arrays.pop("length"))
    on = {name: to_device(t, dev) for name, t in arrays.items()}
    return on["logits"], on["k_seq"], on["v_seq"], (on.get("k_scale"), on.get("v_scale")), length


# ---------------------------------------------------------------------------
# Framing (length-prefixed) over a stream socket
# ---------------------------------------------------------------------------

def _send_frame(sock: socket.socket, data: bytes) -> None:
    sock.sendall(struct.pack("<Q", len(data)))
    sock.sendall(data)


def _recv_exact(sock: socket.socket, n: int) -> bytearray | None:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(n - got, 1 << 20))
        if not k:
            return None
        got += k
    return buf


def _recv_frame(sock: socket.socket) -> bytearray | None:
    header = _recv_exact(sock, 8)
    if header is None:
        return None
    (n,) = struct.unpack("<Q", header)
    return _recv_exact(sock, n)


# ---------------------------------------------------------------------------
# Prefill host: server loop
# ---------------------------------------------------------------------------

def engine_handshake(engine) -> dict[str, Any]:
    """The prefill engine's KV format (the Scheduler's format check) and its
    rounding of T (`prefill_len`, which sizes a paged slot's pages)."""
    e = engine.ecfg
    return {
        "kv_quantized": bool(e.kv_quantized),
        "kv_dtype": str(e.kv_dtype).removeprefix("torch."),
        # the port does not bucket: T starts from the prompt length
        "prefill_bucket_min": 1,
        # a remote prefill arrives whole: the decode side never starts a
        # chunked admission of its own
        "prefill_chunk": 0,
        "paged": bool(e.paged),
        "page_size": int(e.page_size) if e.paged else 0,
        "max_seq_len": int(e.max_seq_len),
        # the chunks the host itself prefills in, which round T up
        "host_prefill_chunk": int(e.prefill_chunk),
    }


def prefill_server(engine, sock: socket.socket, max_requests: int | None = None) -> int:
    """Serve prefill requests on an accepted connection until the peer
    disconnects (or `max_requests`). Returns the number served.

    Protocol: handshake frame (JSON) out; then per request a JSON frame
    {"prompt": [...], "pad_to": int|null} in, one serialized tuple out."""
    _send_frame(sock, json.dumps(engine_handshake(engine)).encode())
    served = 0
    while max_requests is None or served < max_requests:
        frame = _recv_frame(sock)
        if frame is None:
            break
        req = json.loads(frame.decode())
        pre = engine.prefill_standalone([int(t) for t in req["prompt"]],
                                        pad_to=req.get("pad_to") or None)
        _send_frame(sock, serialize_prefill(pre))
        served += 1
    return served


def serve_prefill_host(engine, address: Address, max_connections: int = 1) -> None:
    """Bind and listen at `address` ((host, port) TCP or an AF_UNIX path)
    and serve prefill connections one after another; returns once
    `max_connections` peers have disconnected. An AF_UNIX path is removed
    when it returns."""
    fam = socket.AF_UNIX if isinstance(address, str) else socket.AF_INET
    try:
        with socket.socket(fam, socket.SOCK_STREAM) as srv:
            if fam == socket.AF_INET:
                srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(address)
            srv.listen(max_connections)
            for _ in range(max_connections):
                conn, _addr = srv.accept()
                with conn:
                    prefill_server(engine, conn)
    finally:
        if fam == socket.AF_UNIX and os.path.exists(address):
            os.unlink(address)


# ---------------------------------------------------------------------------
# Decode host: remote prefill client (Scheduler's prefill_engine surface)
# ---------------------------------------------------------------------------

def _connect(address: Address, timeout: float) -> socket.socket:
    """A stream socket connected to `address`, retried until `timeout`
    seconds have passed (the prefill process may still be loading its
    model); then ConnectionError."""
    fam = socket.AF_UNIX if isinstance(address, str) else socket.AF_INET
    deadline = time.monotonic() + timeout
    while True:
        sock = socket.socket(fam, socket.SOCK_STREAM)
        try:
            sock.connect(address)
            return sock
        except (FileNotFoundError, ConnectionRefusedError) as e:
            sock.close()
            if time.monotonic() >= deadline:
                raise ConnectionError(f"no prefill host at {address!r} after {timeout:g} s") from e
            time.sleep(0.05)


class RemotePrefillClient:
    """What `runtime.Scheduler` reads of a prefill engine: `.ecfg` (the KV
    format check; `prefill_chunk` 0, so admissions never chunk here),
    `.prefill_len` (the host's T, which sizes a paged slot's pages) and
    `.prefill_standalone(prompt, pad_to)`. Each prefill is one request frame
    out and one tuple in, deserialized onto `device` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, address: Address | socket.socket, device="cuda",
                 connect_timeout: float = 300.0):
        self.device = resolve_device(device)
        if isinstance(address, socket.socket):
            self._sock = address
        else:
            self._sock = _connect(address, connect_timeout)
        frame = _recv_frame(self._sock)
        if frame is None:
            self._sock.close()
            raise ConnectionError("prefill host closed the connection before its handshake")
        hs = json.loads(frame.decode())
        kv_dtype = getattr(torch, hs["kv_dtype"], None)
        if not isinstance(kv_dtype, torch.dtype):
            raise ValueError(f"prefill host's kv_dtype {hs['kv_dtype']!r} is not a torch dtype")
        self.handshake = hs
        self.host_prefill_chunk = int(hs["host_prefill_chunk"])
        self.ecfg = EngineConfig(
            max_seq_len=hs["max_seq_len"],
            kv_quantized=hs["kv_quantized"],
            kv_dtype=kv_dtype,
            prefill_chunk=hs["prefill_chunk"],
            paged=hs["paged"],
            page_size=hs["page_size"] or None,
        )

    def prefill_len(self, prompt_len: int, pad_to: int | None = None) -> int:
        """The slots the host's `prefill_standalone` hands over."""
        e = self.ecfg
        return prefill_len(prompt_len, self.host_prefill_chunk, e.page_size if e.paged else None,
                           pad_to)

    def prefill_standalone(self, prompt: list[int], pad_to: int | None = None):
        _send_frame(self._sock, json.dumps({"prompt": [int(t) for t in prompt],
                                            "pad_to": pad_to}).encode())
        frame = _recv_frame(self._sock)
        if frame is None:
            raise ConnectionError("prefill host disconnected")
        pre = deserialize_prefill(frame, self.device)
        T, want = pre[1].shape[2], self.prefill_len(len(prompt), pad_to)
        if T != want:
            raise ValueError(f"prefill host handed over {T} slots for a {len(prompt)}-token "
                             f"prompt, {want} predicted from its handshake")
        return pre

    def close(self) -> None:
        self._sock.close()


# ---------------------------------------------------------------------------
# Worker entry point
# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    """python -m gemma_tpu_torch.runtime.kv_transfer --gguf m.gguf --port 0
    Builds an Engine from the checkpoint and serves prefill requests.
    Prints "PORT <n>" once listening (for the parent to connect)."""
    import argparse
    import dataclasses

    ap = argparse.ArgumentParser(prog="python -m gemma_tpu_torch.runtime.kv_transfer",
                                 description="serve prefills of a GGUF model over TCP")
    ap.add_argument("--gguf", required=True)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--kv-quantized", action="store_true")
    ap.add_argument("--max-seq-len", type=int, default=512)
    ap.add_argument("--max-connections", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill prompts longer than this in chunks of this many tokens")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="activation and KV-cache dtype")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    from ..gguf.reader import GGUFReader
    from ..models.params import load_params
    from .engine import Engine

    cfg, params = load_params(GGUFReader(args.gguf), device, mode="dequant")
    cfg = dataclasses.replace(cfg, activation_dtype=args.dtype)
    engine = Engine(cfg, params, EngineConfig(
        max_seq_len=args.max_seq_len, kv_quantized=args.kv_quantized,
        kv_dtype=getattr(torch, args.dtype), prefill_chunk=args.prefill_chunk))
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as srv:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", args.port))
        srv.listen(args.max_connections)
        print(f"PORT {srv.getsockname()[1]}", flush=True)
        for _ in range(args.max_connections):
            conn, _addr = srv.accept()
            with conn:
                n = prefill_server(engine, conn)
            print(f"SERVED {n}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
