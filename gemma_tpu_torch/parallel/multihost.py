"""Serving across processes: the process group, request routing and host roles.

Counterpart of the process-level half of `gemma_tpu/parallel/multihost.py`,
on `torch.distributed`:

* `initialize` joins the processes into one gloo group. It is a control
  plane only (rank and world size): no tensor collective runs on this
  path, and the K/V hand-off between a prefill and a decode process rides
  `runtime.kv_transfer`'s socket. `process_count` and `process_index` take
  the place of `jax.process_count` and `jax.process_index`.
* requests are routed to processes by a stable hash of their id (crc32,
  the reference's), so every process can be given the same request list
  and admits its own subset (`local_requests`).
* `HostRoles` tags processes as prefill and/or decode hosts.
* `scaling_efficiency`: throughput against linear scaling.
* `make_multihost_mesh`: the (data, model) mesh of `parallel.sharding` laid
  out host-major, with the model axis inside one node's ranks so its
  collectives (two all-reduces a layer and the logits all-gather a step)
  stay on the node's links; only the data axis spans nodes, and a decode
  step sends nothing over it but the sampled token ids.

Where the reference's `initialize` carries on as a single process after any
error, this one raises: a process that meant to join a group and could not
is a fault, not a single-process run.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import zlib
from typing import Sequence

import torch.distributed as dist


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, timeout: float = 300.0) -> None:
    """Join the gloo process group: at `coordinator_address` ("host:port" or
    "tcp://host:port") as rank `process_id` of `num_processes`, or from the
    environment (`env://`: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) when
    no argument is given and MASTER_ADDR and WORLD_SIZE are set. A no-op when
    a group exists, and when neither arguments nor environment name one (a
    single process). Any failure to join, such as a coordinator that cannot
    be reached within `timeout` seconds, raises."""
    if dist.is_initialized():
        return
    wait = datetime.timedelta(seconds=timeout)
    if coordinator_address is None and num_processes is None and process_id is None:
        if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group("gloo", init_method="env://", timeout=wait)
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs coordinator_address, num_processes and process_id "
                         "together")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=url, world_size=num_processes, rank=process_id,
                            timeout=wait)


def process_count() -> int:
    """The group's world size, 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank, 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def make_multihost_mesh(n_model: int | None = None, *, backend: str = "nccl", device="cuda",
                        local_world_size: int | None = None):
    """The (data, model) mesh with the model axis inside each node.

    Ranks are host-major (a node's ranks are consecutive, as launchers
    number them), so model groups of `n_model` consecutive ranks stay on one
    node when n_model divides the node's rank count. `local_world_size`:
    ranks a node (default LOCAL_WORLD_SIZE, else every rank on one node);
    `n_model` defaults to it. Raises where the model axis would cross nodes
    or does not divide a node's ranks. `backend` and `device` as
    `sharding.make_mesh` (the card unless the caller asks for the CPU)."""
    from .sharding import make_mesh

    n = process_count()
    n_local = local_world_size or int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if n % n_local:
        raise ValueError(f"{n} ranks do not fill nodes of {n_local}")
    if n_model is None:
        n_model = n_local
    if n_model > n_local:
        raise ValueError(f"model axis {n_model} exceeds a node's {n_local} ranks: the tensor-"
                         "parallel collectives would cross nodes")
    if n_local % n_model:
        raise ValueError(f"a node's ranks ({n_local}) are not divisible by tp={n_model}")
    return make_mesh(n // n_model, n_model, backend=backend, device=device)


def route_request(request_id: str, n_hosts: int | None = None) -> int:
    """Stable host assignment for cross-host batching."""
    n = n_hosts if n_hosts is not None else process_count()
    return zlib.crc32(request_id.encode()) % n


def local_requests(requests: Sequence, n_hosts: int | None = None,
                   hosts: Sequence[int] | None = None) -> list:
    """The subset of `requests` this process admits (by stable hash of the
    request id). Every process must call this with the SAME request list.
    `hosts`: the processes the requests are spread over (default: all
    `n_hosts`); request r goes to hosts[route_request(r.id, len(hosts))]."""
    if hosts is None:
        hosts = range(n_hosts if n_hosts is not None else process_count())
    hosts = list(hosts)
    me = process_index()
    return [r for r in requests
            if hosts[route_request(getattr(r, "id", str(r)), len(hosts))] == me]


@dataclasses.dataclass(frozen=True)
class HostRoles:
    """Optional prefill/decode disaggregation: which processes prefill and
    which decode. Defaults to every host doing both."""

    prefill_hosts: tuple[int, ...]
    decode_hosts: tuple[int, ...]

    @classmethod
    def uniform(cls, n_hosts: int | None = None) -> "HostRoles":
        n = n_hosts if n_hosts is not None else process_count()
        all_hosts = tuple(range(n))
        return cls(all_hosts, all_hosts)

    @classmethod
    def disaggregated(cls, n_prefill: int, n_hosts: int | None = None) -> "HostRoles":
        """The first `n_prefill` hosts prefill, the rest decode."""
        n = n_hosts if n_hosts is not None else process_count()
        if not 0 < n_prefill < n:
            raise ValueError(f"need 0 < n_prefill < {n}")
        return cls(tuple(range(n_prefill)), tuple(range(n_prefill, n)))

    def is_prefill(self, pid: int | None = None) -> bool:
        return (pid if pid is not None else process_index()) in self.prefill_hosts

    def is_decode(self, pid: int | None = None) -> bool:
        return (pid if pid is not None else process_index()) in self.decode_hosts


def scaling_efficiency(tokens_per_sec: dict[int, float]) -> dict[int, float]:
    """Efficiency vs linear scaling from the smallest measured mesh."""
    base_n = min(tokens_per_sec)
    base = tokens_per_sec[base_n] / base_n
    return {n: tokens_per_sec[n] / (n * base) for n in sorted(tokens_per_sec)}
