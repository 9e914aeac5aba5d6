"""Test and smoke fixtures: fabricate Gemma checkpoints without jax.

`make_gguf` writes a valid GGUF file with random weights through the port's
copy of the reference's GGUF writer and ggml codecs (a port of
`gemma_tpu/testing.py` `make_gguf`: the same file for the same arguments,
which tests/test_torch_gguf.py checks; `weight_type="q4_k_m"`
writes the tensors that `python -m gemma_tpu quantize --type q4_k_m` makes
from the same seed's F32 file). `make_params` fabricates a model directly in
the port's layout on a device, for full-width runs where writing and
quantizing a multi-GB GGUF on the host would be slow. `from_jax_cache`
carries a reference KV cache's state into the port's, as
`models.from_jax_params` carries its weights.
"""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch

from .gguf.constants import GGMLType, Keys
from .gguf.writer import GGUFWriter
from .models.config import GemmaConfig
from .models.gemma import Gemma
from .models.params import tensor_from_numpy
from .quant import numpy_ref
from .quant.qtensor import QGROUP, QK_K, QTensor
from .runtime.kv_cache import KVCache
from .runtime.paged_kv import PagedKVCache

TINY_CONFIG = GemmaConfig(
    vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, context_length=128,
)

# Gemma-2-style toy: sandwich norms, softcaps, alternating sliding window
TINY_GEMMA2_CONFIG = GemmaConfig(
    vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, context_length=128,
    sliding_window=16, swa_pattern=2, attn_softcap=50.0, final_softcap=30.0,
)

# Gemma-3-style toy: QK-norm, 5-local/1-global cadence, split rope bases,
# linear rope scaling on the global layers
TINY_GEMMA3_CONFIG = GemmaConfig(
    vocab_size=512, d_model=64, n_layers=6, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, context_length=128,
    sliding_window=16, swa_pattern=6,
    rope_base=1_000_000.0, rope_base_swa=10_000.0, rope_scale=1.0 / 8.0,
)

# The smallest geometry the CUDA attention kernels take (head_dim 128):
# an MQA toy shaped like Gemma-2B, for driving the CLI on the card.
TINY_KERNEL_CONFIG = GemmaConfig(
    vocab_size=512, d_model=256, n_layers=2, n_heads=2, n_kv_heads=1,
    head_dim=128, d_ff=512, context_length=256,
)

# A multi-head toy shaped like Gemma-7B: one query head per KV head (G = 1)
# and q_dim 512 != d_model 256, at the kernels' smallest head_dim.
TINY_MHA_CONFIG = GemmaConfig(
    vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=4,
    head_dim=128, d_ff=512, context_length=256,
)

# Gemma-2 and Gemma-3 at the kernels' widths: TINY_KERNEL_CONFIG's geometry
# with their attention features, so the CUDA kernels take them (G = 2 and
# 4, q_dim 512 != d_model 256; every K a multiple of 256 for q4_k_m).
# Gemma-2: sandwich norms, both softcaps, a 16-key window on even layers.
TINY_GEMMA2_KERNEL_CONFIG = dataclasses.replace(
    TINY_KERNEL_CONFIG, n_heads=4, n_kv_heads=2,
    sliding_window=16, swa_pattern=2, attn_softcap=50.0, final_softcap=30.0,
)
# Gemma-3: QK-norm, sandwich norms, five sliding layers to one global,
# split rope bases with linear scaling on the global layer.
TINY_GEMMA3_KERNEL_CONFIG = dataclasses.replace(
    TINY_KERNEL_CONFIG, n_layers=6, n_heads=4, n_kv_heads=1,
    sliding_window=16, swa_pattern=6,
    rope_base=1_000_000.0, rope_base_swa=10_000.0, rope_scale=1.0 / 8.0,
)

# Full-width Gemma-2 and Gemma-3 text models, the widths of their published
# config.json files (google/gemma-2-2b; google/gemma-3-4b-pt's text_config),
# for fabricated full-width runs on the card. Both scale queries by
# query_pre_attn_scalar 256 ** -0.5, which is head_dim ** -0.5 here.
GEMMA2_2B = GemmaConfig(
    vocab_size=256000, d_model=2304, n_layers=26, n_heads=8, n_kv_heads=4,
    head_dim=256, d_ff=9216, context_length=8192,
    sliding_window=4096, swa_pattern=2, attn_softcap=50.0, final_softcap=30.0,
)
GEMMA3_4B = GemmaConfig(
    vocab_size=262144, d_model=2560, n_layers=34, n_heads=8, n_kv_heads=4,
    head_dim=256, d_ff=10240, context_length=131072,
    sliding_window=1024, swa_pattern=6,
    rope_base=1_000_000.0, rope_base_swa=10_000.0, rope_scale=1.0 / 8.0,
)
# the GGUF architecture of each fabricated model's features
ARCHS = ("gemma", "gemma2", "gemma3")


def default_vocab(n: int) -> tuple[list[str], list[float], list[int]]:
    """SPM-style vocab: specials, byte-fallback tokens, then words."""
    tokens = ["<pad>", "<bos>", "<eos>", "<unk>", "<start_of_turn>", "<end_of_turn>"]
    types = [3, 3, 3, 2, 3, 3]
    scores = [0.0] * 6
    for b in range(256):
        tokens.append(f"<0x{b:02X}>")
        types.append(6)
        scores.append(0.0)
    words = ["▁the", "▁hello", "▁world", "▁a", "he", "llo", "wor", "ld", "▁he",
             "▁wo", "l", "o", "r", "d", "e", "h", "w", "a", "t", "▁", "s", "in",
             "er", "an", "on", "▁to", "▁of", "nd", "▁and", "ing"]
    i = 0
    while len(tokens) < n:
        tokens.append(words[i] if i < len(words) else f"tok{i}")
        types.append(1)
        scores.append(-float(len(tokens)))  # longer id -> lower score
        i += 1
    return tokens[:n], scores[:n], types[:n]


def make_gguf(
    path: str | Path,
    cfg: GemmaConfig = TINY_CONFIG,
    *,
    weight_type: GGMLType | str = GGMLType.Q4_0,
    seed: int = 0,
    scale: float = 0.05,
    arch: str = "gemma",
) -> Path:
    """Write a GGUF checkpoint with random N(0, scale^2) weights.

    `weight_type` (a GGMLType or its lower-case name) applies to all 2-D
    matrices (default q4_0; the reference defaults to F32); norms stay F32.
    "q4_k_m" is llama.cpp's mixed recipe as the reference's `quantize`
    applies it (`gemma_tpu/cli.py` cmd_quantize): q6_k for token_embd and
    attn_v, q4_k for the other matrices, F32 where a row is not a whole
    number of 256-superblocks. Matrix shapes follow the llama.cpp export
    convention ([out, in]).
    """
    if isinstance(weight_type, str) and weight_type != "q4_k_m":
        weight_type = GGMLType[weight_type.upper()]
    rng = np.random.default_rng(seed)
    path = Path(path)
    w = GGUFWriter(path)
    w.add_kv(Keys.ARCHITECTURE, arch)
    w.add_kv(Keys.NAME, "gemma-tpu-synthetic")
    if cfg.sliding_window:
        w.add_kv(f"{arch}.attention.sliding_window", cfg.sliding_window)
    if cfg.attn_softcap:
        w.add_kv(f"{arch}.attn_logit_softcapping", cfg.attn_softcap)
    if cfg.final_softcap:
        w.add_kv(f"{arch}.final_logit_softcapping", cfg.final_softcap)
    w.add_kv(f"{arch}.context_length", cfg.context_length)
    w.add_kv(f"{arch}.embedding_length", cfg.d_model)
    w.add_kv(f"{arch}.block_count", cfg.n_layers)
    w.add_kv(f"{arch}.feed_forward_length", cfg.d_ff)
    w.add_kv(f"{arch}.attention.head_count", cfg.n_heads)
    w.add_kv(f"{arch}.attention.head_count_kv", cfg.n_kv_heads)
    w.add_kv(f"{arch}.attention.key_length", cfg.head_dim)
    w.add_kv(f"{arch}.attention.value_length", cfg.head_dim)
    w.add_kv(f"{arch}.attention.layer_norm_rms_epsilon", cfg.rms_eps)
    w.add_kv(f"{arch}.rope.freq_base", cfg.rope_base)
    if cfg.rope_base_swa:
        w.add_kv(f"{arch}.rope.freq_base_swa", cfg.rope_base_swa)
    if cfg.rope_scale != 1.0:
        w.add_kv(f"{arch}.rope.scaling.type", "linear")
        w.add_kv(f"{arch}.rope.scaling.factor", 1.0 / cfg.rope_scale)

    tokens, scores, types = default_vocab(cfg.vocab_size)
    w.add_kv(Keys.TOKENIZER_MODEL, "llama")
    w.add_kv(Keys.TOKENS, tokens)
    w.add_kv(Keys.SCORES, np.asarray(scores, np.float32))
    w.add_kv(Keys.TOKEN_TYPE, np.asarray(types, np.int32))
    w.add_kv(Keys.BOS_ID, 1)
    w.add_kv(Keys.EOS_ID, 2)
    w.add_kv(Keys.UNK_ID, 3)
    w.add_kv(Keys.PAD_ID, 0)

    def mat(name: str, out_d: int, in_d: int):
        x = rng.normal(0.0, scale, size=(out_d, in_d)).astype(np.float32)
        t = weight_type
        if weight_type == "q4_k_m":
            q6 = name == "token_embd.weight" or name.endswith("attn_v.weight")
            t = GGMLType.Q6_K if q6 else GGMLType.Q4_K
            if in_d % QK_K:
                t = GGMLType.F32
        w.add_tensor(name, numpy_ref.quantize(x, t), (out_d, in_d), t)

    def norm(name: str, d: int):
        # +1 baked in, as llama.cpp's Gemma converter does
        x = (1.0 + rng.normal(0.0, 0.02, size=(d,))).astype(np.float32)
        w.add_tensor(name, x, (d,), GGMLType.F32)

    mat("token_embd.weight", cfg.vocab_size, cfg.d_model)
    norm("output_norm.weight", cfg.d_model)
    for i in range(cfg.n_layers):
        mat(f"blk.{i}.attn_q.weight", cfg.q_dim, cfg.d_model)
        mat(f"blk.{i}.attn_k.weight", cfg.kv_dim, cfg.d_model)
        mat(f"blk.{i}.attn_v.weight", cfg.kv_dim, cfg.d_model)
        mat(f"blk.{i}.attn_output.weight", cfg.d_model, cfg.q_dim)
        mat(f"blk.{i}.ffn_gate.weight", cfg.d_ff, cfg.d_model)
        mat(f"blk.{i}.ffn_up.weight", cfg.d_ff, cfg.d_model)
        mat(f"blk.{i}.ffn_down.weight", cfg.d_model, cfg.d_ff)
        norm(f"blk.{i}.attn_norm.weight", cfg.d_model)
        norm(f"blk.{i}.ffn_norm.weight", cfg.d_model)
        if arch in ("gemma2", "gemma3"):  # sandwich norms
            norm(f"blk.{i}.post_attention_norm.weight", cfg.d_model)
            norm(f"blk.{i}.post_ffw_norm.weight", cfg.d_model)
        if arch == "gemma3":  # per-head QK-norm over head_dim
            norm(f"blk.{i}.attn_q_norm.weight", cfg.head_dim)
            norm(f"blk.{i}.attn_k_norm.weight", cfg.head_dim)
    w.write()
    return path


def make_params(cfg: GemmaConfig, fmt: str = "q4_0", seed: int = 0, device="cpu",
                tp: tuple[int, int] | None = None, arch: str = "gemma",
                centred: bool = False, fill: str = "random") -> Gemma:
    """Fabricate a q4_0, q8_0 or q4_k_m model directly in the port's layout
    on `device`, from a seeded `torch.Generator` on the device.

    Payload bytes are uniform random. q4_0: each row's f16 scales are drawn
    around 1 / (4.6 sqrt(K)) (4.6 is the standard deviation of a uniform
    nibble minus 8); q8_0 around 1 / (73.9 sqrt(K)) (73.9 is that of a
    uniform int8). With `centred`, q4_0's nibbles are uniform in 1..15
    instead, so that q - 8 is symmetric about 0, as ggml's quantizer
    centres them, and its scales are drawn around 1 / (4.32 sqrt(K)) (the
    standard deviation of q - 8): uniform in 0..15, q - 8 has a mean of
    -0.5, 11 % of its spread, which every projection of a random model
    carries into a part shared by all positions, so that attention averages
    hardly depend on which keys they see, and a sliding window moves next to
    nothing (q8_0's mean of -0.5 is 0.7 % of its spread). q4_0 and q8_0 fuse
    q|k|v and gate|up and tie a head of their own format. q4_k_m is the
    reference's recipe (q4_k matrices, q6_k attn_v and the tied
    embedding/head, so q|k|v stay unfused): q4_k tables hold random 6-bit
    sc and mn, with dmin = 7.5 d so a group's mean offsets cancel on
    average; q6_k sub-scales are random int8. Each d is drawn so a weight's
    standard deviation is about 1 / sqrt(K) (the constants are the standard
    deviations of sc * q - 7.5 mn and sc * q), so a projection keeps its
    input's scale and activations stay finite through every layer. Norm
    weights are 1. Throughput does not depend on the values.

    `arch` adds the norms of that architecture, as `make_gguf(..., arch=)`
    writes them and `load_params` names them: "gemma2" the sandwich norms
    (`post_attention_norm`, `post_ffw_norm`), "gemma3" those and the
    per-head QK-norms (`attn_q_norm`, `attn_k_norm`, over head_dim).

    `tp=(index, size)` returns shard `index` of `size` instead
    (`parallel.shard_decode.build_tp_params` of the same model, bit for
    bit): each layer is drawn whole, as above, then cut, so a rank holds
    one layer beyond its shard at a time.

    `fill="zeros"` is the reference's: every payload byte 0, q4_k's 6-bit
    sc and mn and q6_k's sub-scales 1, and every d, dmin and scale as
    drawn (the same draws as `fill="random"`, whose bytes are then
    dropped): a q4_0 weight is -8 d, a q4_k weight -dmin, a q6_k weight
    -32 d and a q8_0 weight 0. Timings do not depend on the values. It
    takes neither `centred` nor `tp`."""
    if fmt not in ("q4_0", "q8_0", "q4_k_m"):
        raise NotImplementedError(f"make_params fabricates q4_0, q8_0 and q4_k_m, got {fmt!r}")
    if arch not in ARCHS:
        raise ValueError(f"make_params fabricates the architectures {ARCHS}, got {arch!r}")
    if fill not in ("random", "zeros"):
        raise ValueError(f"make_params fills 'random' or 'zeros', got {fill!r}")
    zeros = fill == "zeros"
    if zeros and (centred or tp is not None):
        raise ValueError("make_params(fill='zeros') takes neither centred nor tp")
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def bytes_(*shape: int) -> torch.Tensor:
        return torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)

    def payload(*shape: int) -> torch.Tensor:
        b = bytes_(*shape)
        return b.zero_() if zeros else b

    def unit_table(t: torch.Tensor) -> torch.Tensor:
        # q4_k's 12-byte table with every 6-bit sc and mn 1: bytes 0-3 sc
        # 0-3, 4-7 mn 0-3, 8-11 the low nibbles of sc 4-7 | mn 4-7 << 4
        if zeros:
            t[..., :8] = 1
            t[..., 8:] = 0x11
        return t

    def around(base: float, *shape: int) -> torch.Tensor:
        u = torch.rand(*shape, generator=gen, device=device)
        return ((0.5 + u) * base).to(torch.float16)

    def centred_nibbles(*shape: int) -> torch.Tensor:
        lo, hi = (torch.randint(1, 16, shape, generator=gen, device=device, dtype=torch.uint8)
                  for _ in range(2))
        return lo | (hi << 4)

    def q4_0(rows: int, cols: int) -> QTensor:
        if centred:
            return QTensor("q4_0", qs=centred_nibbles(rows, cols // 2),
                           scales=around(1.0 / (4.32 * math.sqrt(cols)), rows, cols // QGROUP))
        return QTensor("q4_0", qs=payload(rows, cols // 2),
                       scales=around(1.0 / (4.6 * math.sqrt(cols)), rows, cols // QGROUP))

    def q8_0(rows: int, cols: int) -> QTensor:
        return QTensor("q8_0", qs=payload(rows, cols).view(torch.int8),
                       scales=around(1.0 / (73.9 * math.sqrt(cols)), rows, cols // QGROUP))

    def q4_k(rows: int, cols: int) -> QTensor:
        # random table bytes are random 6-bit sc and mn: their 16 fields
        # fill all 96 bits of the table
        d = around(1.0 / (258.0 * math.sqrt(cols)), rows, cols // QK_K).float()
        dm = torch.stack([d, 7.5 * d], dim=-1).to(torch.float16)
        return QTensor("q4_k", qs=payload(rows, cols // 2),
                       scales=unit_table(bytes_(rows, cols // QK_K, 12)), dm=dm)

    def q6_k(rows: int, cols: int) -> QTensor:
        ql, qh, sc = payload(rows, cols // 2), payload(rows, cols // 4), bytes_(rows, cols // 16)
        return QTensor("q6_k", ql=ql, qh=qh, sc=(sc.fill_(1) if zeros else sc).view(torch.int8),
                       d=around(1.0 / (1366.0 * math.sqrt(cols)), rows, cols // QK_K))

    def norm(d: int) -> torch.Tensor:
        return torch.ones(d, dtype=torch.float32, device=device)

    def layer() -> dict:
        lp = {"attn_norm": norm(cfg.d_model), "ffn_norm": norm(cfg.d_model)}
        if arch in ("gemma2", "gemma3"):  # sandwich norms
            lp |= {"post_attention_norm": norm(cfg.d_model), "post_ffw_norm": norm(cfg.d_model)}
        if arch == "gemma3":  # per-head QK-norm
            lp |= {"attn_q_norm": norm(cfg.head_dim), "attn_k_norm": norm(cfg.head_dim)}
        if fmt in ("q4_0", "q8_0"):
            mat = q4_0 if fmt == "q4_0" else q8_0
            return lp | {
                "attn_qkv": mat(cfg.q_dim + 2 * cfg.kv_dim, cfg.d_model),
                "attn_output": mat(cfg.d_model, cfg.q_dim),
                "ffn_gate_up": mat(2 * cfg.d_ff, cfg.d_model),
                "ffn_down": mat(cfg.d_model, cfg.d_ff),
            }
        return lp | {
            "attn_q": q4_k(cfg.q_dim, cfg.d_model),
            "attn_k": q4_k(cfg.kv_dim, cfg.d_model),
            "attn_v": q6_k(cfg.kv_dim, cfg.d_model),
            "attn_output": q4_k(cfg.d_model, cfg.q_dim),
            "ffn_gate_up": q4_k(2 * cfg.d_ff, cfg.d_model),
            "ffn_down": q4_k(cfg.d_model, cfg.d_ff),
        }

    if tp is not None:
        from .parallel.shard_decode import local_config, shard_layer, shard_vocab
    index, size = tp or (0, 1)
    layers = [layer() if tp is None else shard_layer(layer(), cfg, size, index)
              for _ in range(cfg.n_layers)]
    embed = {"q4_0": q4_0, "q8_0": q8_0, "q4_k_m": q6_k}[fmt](cfg.vocab_size, cfg.d_model)
    if tp is None:
        return Gemma(cfg, embed=embed, final_norm=norm(cfg.d_model), layers=layers)
    model = Gemma(local_config(cfg, size), embed=shard_vocab(embed, cfg, size, index),
                  final_norm=norm(cfg.d_model), layers=layers)
    model.tp_shard = (index, size)
    return model


def from_jax_cache(np_cache, device="cpu") -> KVCache | PagedKVCache:
    """The reference's `KVCache` or `PagedKVCache` with numpy leaves
    (`jax.tree_util.tree_map(np.asarray, cache)`) -> the port's cache of the
    same state on `device`, so one cache state feeds both packages."""
    def tensors(arrays):
        return None if arrays is None else [tensor_from_numpy(np.asarray(a)).to(device) for a in arrays]

    length = tensor_from_numpy(np.asarray(np_cache.length, np.int32)).to(device)
    if hasattr(np_cache, "page_table"):
        return PagedKVCache(
            tensors(np_cache.k_pages), tensors(np_cache.v_pages),
            tensor_from_numpy(np.asarray(np_cache.page_table, np.int32)).to(device), length,
            tensors(np_cache.k_scale), tensors(np_cache.v_scale),
        )
    return KVCache(tensors(np_cache.k), tensors(np_cache.v), length,
                   tensors(np_cache.k_scale), tensors(np_cache.v_scale))
