"""Gemma decoder forward pass (PyTorch).

Counterpart of `gemma_tpu/models/gemma.py`: embed * sqrt(d) -> N x
[RMSNorm -> q|k|v -> (QK-norm) -> NEOX RoPE -> KV write -> attention ->
out-proj -> (post-norm) -> residual -> RMSNorm -> GeGLU FFN -> (post-norm)
-> residual] -> final RMSNorm -> tied-embedding logits (-> final softcap).
The activations the reference records for golden diffs are reported to
`utils.tensor_dump` under its names (`inp_embd`, `blk.{i}.attn_out`,
`blk.{i}.ffn_out`, `result_norm`, `result_output`); with no capture open
that is a no-op.
Gemma-1/2/3 knobs (sandwich norms, QK-norm, per-layer window and rope
base/scale, softcaps) come from `GemmaConfig`.

The rounding points are the reference's: RMSNorm and RoPE in f32 then cast,
q scaled in the activation dtype after RoPE, the embedding scaled in f32
then cast, every projection's f32 result cast to the activation dtype,
GeGLU in f32, and the head in f32.

Weights live in `nn.Module`s: `Gemma` holds the embedding, the final norm
and a `ModuleList` of `DecoderLayer`s; a layer holds its matrices (a
`QTensor` submodule or a dense bf16 buffer, under the GGUF short names:
attn_qkv or attn_q/k/v, attn_output, ffn_gate_up or ffn_gate/ffn_up,
ffn_down) and `RMSNorm`s. The KV cache, dense (`KVCache`) or paged
(`PagedKVCache`), bf16/f32 or int8, is updated in place. Attention follows
the reference's dispatch (`gemma.py:116-133`): a paged cache at T = 1 goes
to the paged kernel; otherwise the layer's K/V as stored (through the page
table when paged), int8 with their scales, go to `attention`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.linear import linear
from ..ops.paged_attention import paged_decode_attention
from ..quant.qtensor import QTensor, gather_dequant
from ..runtime.kv_cache import KVCache
from ..runtime.paged_kv import PagedKVCache
from ..utils.tensor_dump import record
from .config import GemmaConfig


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, base: float, pos_scale: float = 1.0) -> torch.Tensor:
    """NEOX rotary embedding in f32. x: [B, T, H, D]; positions: [B, T]."""
    half = x.shape[-1] // 2
    freqs = torch.pow(base, -torch.arange(half, dtype=torch.float32, device=x.device) / half)
    theta = (positions.to(torch.float32) * pos_scale)[:, :, None, None] * freqs
    cos, sin = torch.cos(theta), torch.sin(theta)
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, weight: torch.Tensor, eps: float):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", weight.to(torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


def _attach(module: nn.Module, name: str, w, eps: float) -> None:
    """A QTensor becomes a submodule, a 1-D tensor an RMSNorm, a matrix a buffer."""
    if isinstance(w, nn.Module):
        module.add_module(name, w)
    elif w.dim() == 1:
        module.add_module(name, RMSNorm(w, eps))
    else:
        module.register_buffer(name, w)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: GemmaConfig, layer_idx: int, weights: dict):
        super().__init__()
        self.layer_idx = layer_idx
        for name, w in weights.items():
            _attach(self, name, w, cfg.rms_eps)

    def has(self, name: str) -> bool:
        return name in self._modules or name in self._buffers

    def forward(self, cfg: GemmaConfig, x, positions, cache: KVCache | PagedKVCache, write_index,
                kv_limit, tp=None):
        return decoder_layer(self, cfg, x, positions, cache, self.layer_idx, write_index, kv_limit,
                             tp)


def decoder_layer(
    lp: DecoderLayer,
    cfg: GemmaConfig,
    x: torch.Tensor,  # [B, T, d_model]
    positions: torch.Tensor,  # [B, T]
    cache: KVCache | PagedKVCache,
    layer_idx: int,
    write_index,  # int chunk start (prefill) or [B] per-sequence start (decode, verify)
    kv_limit: torch.Tensor,  # [B] valid cache slots after this write
    tp=None,  # model-axis group: all-reduce the sharded projections' partial sums
) -> torch.Tensor:
    B, T, _ = x.shape
    h = lp.attn_norm(x)
    if lp.has("attn_qkv"):
        qkv = linear(h, lp.attn_qkv)
        q, k, v = torch.split(qkv, [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    else:
        q, k, v = linear(h, lp.attn_q), linear(h, lp.attn_k), linear(h, lp.attn_v)
    q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)

    if lp.has("attn_q_norm"):  # Gemma-3 per-head QK-norm (before RoPE)
        q = lp.attn_q_norm(q)
        k = lp.attn_k_norm(k)
    rope_base, rope_pos_scale = cfg.layer_rope(layer_idx)
    # the scale rounded to the activation dtype, as a host scalar (a CPU
    # 0-dim tensor costs no host-to-device copy)
    scale = torch.tensor(cfg.effective_query_scale, dtype=x.dtype)
    q = apply_rope(q, positions, rope_base, rope_pos_scale) * scale
    k = apply_rope(k, positions, rope_base, rope_pos_scale)

    if isinstance(write_index, int):
        cache.write_chunk(layer_idx, write_index, k, v)
    elif T == 1:
        cache.write_token(layer_idx, write_index, k, v)
    else:  # per-sequence chunk starts: the speculative verify
        cache.write_chunk_per_seq(layer_idx, write_index, k, v)

    window = cfg.layer_window(layer_idx)
    if isinstance(cache, PagedKVCache) and T == 1:  # pages read in place through the table
        attn = paged_decode_attention(q, cache, layer_idx, kv_limit, cfg.attn_softcap, window)
    else:  # int8 K/V go with their scales: decode reads them in place
        kc, vc, ks, vs = cache.layer_kv(layer_idx)
        attn = attention(q, kc, vc, positions, kv_limit, cfg.attn_softcap, window,
                         k_scale=ks, v_scale=vs)
    attn_out = linear(attn.reshape(B, T, cfg.q_dim), lp.attn_output)
    if tp is not None:  # column-sharded attn_output: partial sums
        attn_out = tp.all_reduce(attn_out)
    if lp.has("post_attention_norm"):  # Gemma-2/3 sandwich norm
        attn_out = lp.post_attention_norm(attn_out)
    x = x + attn_out
    record(f"blk.{layer_idx}.attn_out", x)

    h2 = lp.ffn_norm(x)
    if lp.has("ffn_gate_up"):
        gu = linear(h2, lp.ffn_gate_up).to(torch.float32)
        gate = F.gelu(gu[..., : cfg.d_ff], approximate="tanh")
        up = gu[..., cfg.d_ff :]
    else:
        gate = F.gelu(linear(h2, lp.ffn_gate).to(torch.float32), approximate="tanh")
        up = linear(h2, lp.ffn_up).to(torch.float32)
    ff = linear((gate * up).to(x.dtype), lp.ffn_down)
    if tp is not None:  # column-sharded ffn_down: partial sums
        ff = tp.all_reduce(ff)
    if lp.has("post_ffw_norm"):  # Gemma-2/3 sandwich norm
        ff = lp.post_ffw_norm(ff)
    x = x + ff
    record(f"blk.{layer_idx}.ffn_out", x)
    return x


class Gemma(nn.Module):
    """Weights of one Gemma model; the module-level `forward` runs it."""

    def __init__(self, cfg: GemmaConfig, embed, final_norm: torch.Tensor, layers: list[dict],
                 output=None):
        super().__init__()
        _attach(self, "embed", embed, cfg.rms_eps)
        self.final_norm = RMSNorm(final_norm, cfg.rms_eps)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i, lw) for i, lw in enumerate(layers))
        if output is not None:  # untied head; Gemma ties it to the embedding
            _attach(self, "output", output, cfg.rms_eps)

    @property
    def device(self) -> torch.device:
        return self.final_norm.weight.device

    @property
    def head(self):
        return self.output if "output" in self._modules or "output" in self._buffers else self.embed


def _embed_lookup(embed, tokens: torch.Tensor, dtype: torch.dtype, tp=None) -> torch.Tensor:
    """Token embedding gather. With `tp`, the vocab rows are sharded over
    the model axis: each shard gathers the ids it owns (the others give
    zeros) and one all-reduce assembles the embedding."""
    if tp is not None:
        n_local = embed.shape[0]
        local = tokens.long() - tp.index * n_local
        valid = (local >= 0) & (local < n_local)
        tokens = local.clamp(0, n_local - 1)
    if isinstance(embed, QTensor):  # quantized: dequantize only the gathered rows
        x = gather_dequant(embed, tokens, dtype)
    else:
        x = embed[tokens.long()].to(dtype)
    if tp is not None:
        x = tp.all_reduce(x.masked_fill(~valid[..., None], 0))
    return x


def forward(
    model: Gemma,
    cfg: GemmaConfig,
    tokens: torch.Tensor,  # [B, T] token ids
    positions: torch.Tensor,  # [B, T] absolute positions
    cache: KVCache | PagedKVCache,
    write_index,  # int chunk start (prefill) or [B] per-sequence starts (decode, verify)
    kv_limit: torch.Tensor,  # [B] valid lengths after the write
    logits_at: torch.Tensor | None = None,  # [B] row per sequence; None = all rows
    tp=None,  # model-axis group of a tensor-parallel forward; cfg is then local
) -> torch.Tensor:
    """Full forward; returns logits [B, T, vocab] f32 ([B, 1, vocab] with
    `logits_at`; with `tp`, vocab is this shard's rows). The cache is written
    in place. `cfg` sets the activation dtype (bf16 serving, f32 evaluation)
    for the same weights."""
    x = _embed_lookup(model.embed, tokens, cfg.act_dtype, tp)
    x = (x.to(torch.float32) * math.sqrt(cfg.d_model)).to(cfg.act_dtype)
    record("inp_embd", x)
    for layer in model.layers:
        x = layer(cfg, x, positions, cache, write_index, kv_limit, tp)
    x = model.final_norm(x)
    record("result_norm", x)
    if logits_at is not None:
        rows = torch.arange(x.shape[0], device=x.device)
        x = x[rows, logits_at.long()][:, None]  # [B, 1, d]
    logits = linear(x, model.head, out_dtype=torch.float32)
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    record("result_output", logits)
    return logits
