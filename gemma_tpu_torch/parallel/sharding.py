"""The (data, model) mesh over processes, its collectives and the placement plan.

Counterpart of `gemma_tpu/parallel/sharding.py` on `torch.distributed`. A
mesh is the world's ranks laid out host-major as [data, model] (rank = d *
n_model + m): each axis is one process group a rank, the ranks that share
its other coordinate, made with the backend the caller names ("nccl" for
one rank a card, "gloo" for ranks on the CPU or sharing a card). The world
group that `multihost.initialize` joins stays the gloo control plane.

`Axis` is one axis as this rank sees it: size, index and group, with the
two collectives tensor parallelism needs, `all_reduce` and `all_gather`,
each counted (calls and bytes) so a step's traffic can be read by axis.
Both take CUDA tensors on both backends: gloo's all_reduce and all_gather
take bf16, f32 and int32 CUDA tensors in place (torch 2.11+cu128 on an
NVIDIA H100; `chip_smoke.py` phase 10 runs them there). The backend is
never switched.

Torch has no compiler that inserts collectives into a program over global
arrays, so the plan here (`param_pspec`, `cache_pspec`: a partition spec a
tensor, the reference's `PartitionSpec` as a tuple of axis names) places
nothing by itself: `shard_params` and `shard_cache` return THIS rank's
shard of each tensor by the plan, and a program that runs on such shards
calls the collectives itself (`parallel.shard_decode.TPEngine`).
"""
from __future__ import annotations

import collections
import os

import torch
import torch.distributed as dist

from ..models.config import GemmaConfig
from ..models.params import resolve_device
from ..quant.qtensor import FORMATS, QTensor, select_cols, select_rows
from ..runtime.kv_cache import KVCache

DATA_AXIS = "data"
MODEL_AXIS = "model"
BACKENDS = ("nccl", "gloo")


class Axis:
    """One mesh axis as this rank sees it. `group` is None only in a process
    with no process group (a mesh of one rank): the collectives are then
    the identity and count nothing."""

    def __init__(self, name: str, size: int, index: int, group, backend: str):
        self.name, self.size, self.index = name, size, index
        self.group, self.backend = group, backend
        self.stats: collections.Counter = collections.Counter()

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the axis, in x's dtype (in place on a contiguous x)."""
        if self.group is None:
            return x
        y = x.contiguous()
        self.stats["all_reduce"] += 1
        self.stats["bytes"] += y.numel() * y.element_size()
        dist.all_reduce(y, group=self.group)
        return y

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """x of every rank of the axis, concatenated along `dim` in axis order."""
        if self.group is None:
            return x
        y = x.contiguous()
        self.stats["all_gather"] += 1
        self.stats["bytes"] += y.numel() * y.element_size() * self.size
        parts = [torch.empty_like(y) for _ in range(self.size)]
        dist.all_gather(parts, y, group=self.group)
        return torch.cat(parts, dim=dim)


class Mesh:
    """A (data, model) mesh: this rank's two `Axis` and its device."""

    def __init__(self, data: Axis, model: Axis, device: torch.device):
        self.data, self.model, self.device = data, model, device
        self.shape = {DATA_AXIS: data.size, MODEL_AXIS: model.size}

    def collective_stats(self) -> dict[str, dict[str, int]]:
        """Collectives and bytes so far, by axis."""
        return {DATA_AXIS: dict(self.data.stats), MODEL_AXIS: dict(self.model.stats)}

    def reset_stats(self) -> None:
        self.data.stats.clear()
        self.model.stats.clear()


def local_rank() -> int:
    """This process's rank on its node: LOCAL_RANK where the launcher sets
    it, else the global rank (one node)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def mesh_device(device) -> torch.device:
    """`device`, with a bare "cuda" resolved to cuda:<local rank>; a CUDA
    device without a card raises."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev}: this machine has {torch.cuda.device_count()} CUDA devices")
    return dev


def make_mesh(n_data: int | None = None, n_model: int | None = None, *, backend: str = "nccl",
              device="cuda") -> Mesh:
    """The (data, model) mesh over the world's ranks (all of them on the
    model axis by default). Every rank calls it with the same arguments: it
    creates each axis's process groups, all with `backend`. On the card
    ("cuda": cuda:<local rank>) unless the caller asks for the CPU, which
    needs backend="gloo". Without a process group it is a mesh of one rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = mesh_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend nccl needs a CUDA device, got {dev}")
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n_model is None:
        n_model = n if n_data is None else n // n_data
    if n_data is None:
        n_data = n // n_model
    if n_data * n_model != n or n_data < 1 or n_model < 1:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} ranks")
    if not dist.is_initialized():
        return Mesh(Axis(DATA_AXIS, 1, 0, None, backend), Axis(MODEL_AXIS, 1, 0, None, backend), dev)
    rank = dist.get_rank()
    d, m = divmod(rank, n_model)
    groups = {}
    # every rank creates every group, in one order
    for i in range(n_data):
        g = dist.new_group([i * n_model + j for j in range(n_model)], backend=backend)
        if i == d:
            groups[MODEL_AXIS] = g
    for j in range(n_model):
        g = dist.new_group([i * n_model + j for i in range(n_data)], backend=backend)
        if j == m:
            groups[DATA_AXIS] = g
    return Mesh(Axis(DATA_AXIS, n_data, d, groups[DATA_AXIS], backend),
                Axis(MODEL_AXIS, n_model, m, groups[MODEL_AXIS], backend), dev)


# ---------------------------------------------------------------------------
# The placement plan
# ---------------------------------------------------------------------------

def _maybe(axis_name: str, dim: int, shard_count: int):
    """Shard a dim on axis_name only if it divides evenly."""
    return axis_name if dim % shard_count == 0 and shard_count > 1 else None


def param_pspec(path: str, shape: tuple[int, ...], mesh: Mesh) -> tuple:
    """Partition spec (an axis name or None a dim) of a parameter by its
    role name, the last part of `path`: q|k|v and gate|up row-sharded
    (out-features), attn_output and ffn_down column-sharded (in-features),
    the embedding and head over vocab rows, norms replicated."""
    tp = mesh.shape[MODEL_AXIS]
    if len(shape) == 1:
        return (None,)
    rows, cols = shape[0], shape[1]
    role = path.rsplit(".", 1)[-1]
    if role in ("attn_q", "attn_k", "attn_v", "ffn_gate", "ffn_up", "attn_qkv", "ffn_gate_up",
                "embed", "output"):
        return (_maybe(MODEL_AXIS, rows, tp), None)
    if role in ("attn_output", "ffn_down"):
        return (None, _maybe(MODEL_AXIS, cols, tp))
    return (None, None)


def _shard(w, spec: tuple, mesh: Mesh):
    """This rank's shard of w by `spec`; a QTensor's columns split at whole
    blocks only, replicated where a shard would cut one."""
    tp, i = mesh.model.size, mesh.model.index
    n = w.shape[0]
    if spec[0] is not None:
        rows = slice(i * n // tp, (i + 1) * n // tp)
        return select_rows(w, rows) if isinstance(w, QTensor) else w[rows].contiguous()
    if len(spec) > 1 and spec[1] is not None:
        k = w.shape[1] // tp
        if isinstance(w, QTensor):
            return select_cols(w, i * k, (i + 1) * k) if k % FORMATS[w.fmt][0] == 0 else w
        return w[:, i * k : (i + 1) * k].contiguous()
    return w


def shard_params(params, mesh: Mesh) -> dict:
    """This rank's shard of every parameter of a `Gemma` module by
    `param_pspec`, by path ("layers.0.attn_qkv", "final_norm.weight", ...).
    The GSPMD layout of the reference, as placement only: a forward over
    these shards would need its collectives inserted by hand, which is what
    `shard_decode` does with its own per-shard layout."""
    out = {}
    for name, mod in params.named_modules():
        if isinstance(mod, QTensor):
            out[name] = _shard(mod, param_pspec(name, mod.shape, mesh), mesh)
            continue
        for bname, b in mod.named_buffers(recurse=False):  # dense matrices, norm weights
            path = f"{name}.{bname}" if name else bname
            out[path] = _shard(b, param_pspec(path, tuple(b.shape), mesh), mesh)
    return out


def cache_pspec(cfg: GemmaConfig, mesh: Mesh, batch: int, quant_scale: bool = False) -> tuple:
    """Spec of one KVCache layer buffer [B, H_kv, S, D] (scale: [B, H_kv,
    S]): batch over data, KV heads over model, each where it divides."""
    b_axis = _maybe(DATA_AXIS, batch, mesh.shape[DATA_AXIS])
    h_axis = _maybe(MODEL_AXIS, cfg.n_kv_heads, mesh.shape[MODEL_AXIS])
    return (b_axis, h_axis, None) if quant_scale else (b_axis, h_axis, None, None)


def shard_cache(cache, cfg: GemmaConfig, mesh: Mesh):
    """This rank's shard of a dense `KVCache` by `cache_pspec`: its batch
    rows and its KV heads, where each divides (else whole); `length` keeps
    the rows' entries."""
    batch = cache.length.shape[0]
    b_axis, h_axis, _, _ = cache_pspec(cfg, mesh, batch)
    rows = slice(None)
    if b_axis is not None:
        nb = batch // mesh.data.size
        rows = slice(mesh.data.index * nb, (mesh.data.index + 1) * nb)
    heads = slice(None)
    if h_axis is not None:
        nh = cfg.n_kv_heads // mesh.model.size
        heads = slice(mesh.model.index * nh, (mesh.model.index + 1) * nh)

    def part(bufs):
        return None if bufs is None else [b[rows, heads].contiguous() for b in bufs]

    return KVCache(part(cache.k), part(cache.v), cache.length[rows].clone(), part(cache.k_scale),
                   part(cache.v_scale))
