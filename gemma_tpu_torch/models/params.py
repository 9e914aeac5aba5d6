"""Parameter loading: GGUF checkpoint -> `Gemma` module on a torch device.

Counterpart of `gemma_tpu/models/params.py`, with the same GGUF tensor names
(`token_embd.weight`, `output_norm.weight`, `blk.{i}.*.weight`):
* q4_0, q8_0, q4_k and q6_k matrices become `QTensor`s in the port's
  layout (exact f16 scales); with `mode="dequant"` they too become dense
  bf16 at load (the reference's mode, `params.py:45-48`), so every
  projection takes `torch.matmul`;
* norms are f32;
* every other type (f32, f16, bf16, q5_k, ...) is dequantized to dense bf16
  through the port's `quant/numpy_ref.py`;
* q|k|v and gate|up are fused into one matrix when their formats match
  (q4_k_m's q6_k attn_v keeps q|k|v split);
* the head is tied to the embedding unless the file has `output.weight`.

`from_jax_params` converts the reference's parameter pytree (leaves as numpy
arrays) into the same module, so tests run both packages on one set of
numbers.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..gguf.reader import GGUFReader
from ..quant import numpy_ref
from ..quant.qtensor import QUANTIZED_TYPES, QTensor, concat_rows, from_ggml, from_jax, select_rows
from .config import GemmaConfig
from .gemma import Gemma

LAYER_TENSORS = (
    "attn_q", "attn_k", "attn_v", "attn_output",
    "ffn_gate", "ffn_up", "ffn_down",
    "attn_norm", "ffn_norm",
)
_NORM_NAMES = {"attn_norm", "ffn_norm"}
# Gemma-2/3 sandwich norms + Gemma-3 QK-norms, present only in those exports
OPTIONAL_LAYER_NORMS = ("post_attention_norm", "post_ffw_norm", "attn_q_norm", "attn_k_norm")


MODES = ("quantized", "dequant")


def _load_tensor(reader: GGUFReader, name: str, device, mode: str = "quantized", *,
                 is_norm: bool = False):
    ti = reader.tensors[name]
    raw = reader.tensor_raw(name)
    if not is_norm and ti.ggml_type in QUANTIZED_TYPES and mode == "quantized":
        return from_ggml(raw, ti.ggml_type, ti.shape, device)
    x = numpy_ref.dequantize(raw, ti.ggml_type, ti.shape)
    t = torch.from_numpy(np.asarray(x, np.float32).reshape(ti.shape))
    return t.to(device) if is_norm else t.to(torch.bfloat16).to(device)


def _maybe_fuse(lp: dict[str, Any], names: tuple[str, ...], fused_name: str) -> None:
    """Fuse row-concatenable projections (q|k|v, gate|up) into one matmul,
    only when every part has the same format (mixed exports stay split)."""
    parts = [lp[n] for n in names]
    if all(isinstance(p, QTensor) for p in parts):
        if len({p.fmt for p in parts}) != 1:
            return
        fused = concat_rows(parts)
    elif not any(isinstance(p, QTensor) for p in parts):
        fused = torch.cat(parts)
    else:
        return
    for n in names:
        del lp[n]
    lp[fused_name] = fused


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device where none is available
    raises rather than running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda, but no CUDA device is available "
                           "(pass --device cpu, or device=\"cpu\", to run the plain PyTorch path)")
    return dev


def load_params(reader: GGUFReader, device="cuda", fuse_projections: bool = True,
                mode: str = "quantized") -> tuple[GemmaConfig, Gemma]:
    """Read (config, model) from a GGUF file onto `device` (the card unless
    the caller asks for the CPU). `mode` "quantized" keeps the block
    formats the kernels take; "dequant" makes every matrix dense bf16."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    device = resolve_device(device)
    cfg = GemmaConfig.from_gguf(reader)
    layers = []
    for i in range(cfg.n_layers):
        lp = {
            t: _load_tensor(reader, f"blk.{i}.{t}.weight", device, mode, is_norm=t in _NORM_NAMES)
            for t in LAYER_TENSORS
        }
        for t in OPTIONAL_LAYER_NORMS:
            if f"blk.{i}.{t}.weight" in reader.tensors:
                lp[t] = _load_tensor(reader, f"blk.{i}.{t}.weight", device, is_norm=True)
        if fuse_projections:
            _maybe_fuse(lp, ("attn_q", "attn_k", "attn_v"), "attn_qkv")
            _maybe_fuse(lp, ("ffn_gate", "ffn_up"), "ffn_gate_up")
        layers.append(lp)
    output = None
    if "output.weight" in reader.tensors:
        output = _load_tensor(reader, "output.weight", device, mode)
    model = Gemma(
        cfg,
        embed=_load_tensor(reader, "token_embd.weight", device, mode),
        final_norm=_load_tensor(reader, "output_norm.weight", device, is_norm=True),
        layers=layers,
        output=output,
    )
    return cfg, model


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a torch tensor of the same dtype; ml_dtypes bf16
    (the reference's bf16 arrays) through its bits."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _from_jax_leaf(leaf, device, rows: int | None = None):
    """One reference leaf -> QTensor (q4_0, q4_k, q6_k or q6_k_v4), dense
    bf16 matrix or f32 norm. `rows` slices the out-feature axis (the
    reference zero-pads a quantized embedding to 2048-row multiples)."""
    if hasattr(leaf, "fmt") and hasattr(leaf, "arrays"):
        qt = from_jax(leaf.fmt, leaf.arrays)
        if rows is not None:
            qt = select_rows(qt, slice(0, rows))
        return qt.to(device)
    a = np.asarray(leaf)
    if a.ndim == 1:
        return torch.from_numpy(a.astype(np.float32)).to(device)
    if a.dtype.name == "bfloat16":
        t = tensor_from_numpy(a)
    else:
        t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    if rows is not None:
        t = t[:rows]
    return t.contiguous().to(device)


def from_jax_params(np_params: dict, cfg: GemmaConfig, device="cpu") -> Gemma:
    """The reference's parameter pytree, leaves as numpy arrays (its
    QTensors keep `fmt` and numpy `arrays`), -> `Gemma` on `device`.

    Undoes the reference's K-major layout and nibble pairing, and slices the
    embedding and head from its padded vocab back to `cfg.vocab_size`."""
    device = torch.device(device)
    layers = [{name: _from_jax_leaf(leaf, device) for name, leaf in lp.items()}
              for lp in np_params["layers"]]
    output = np_params.get("output")
    return Gemma(
        cfg,
        embed=_from_jax_leaf(np_params["embed"], device, rows=cfg.vocab_size),
        final_norm=_from_jax_leaf(np_params["final_norm"], device),
        layers=layers,
        output=None if output is None else _from_jax_leaf(output, device, rows=cfg.vocab_size),
    )
