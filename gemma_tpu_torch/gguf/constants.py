"""GGUF file-format and ggml-tensor-type constants.

The port's own copy of `gemma_tpu/gguf/constants.py` (the port imports
nothing of the JAX package); tests/test_torch_gguf.py holds the two equal.
It re-specifies, from the public GGUF/ggml spec, the on-disk format that
ggml's `gguf_init_from_file` reads.
"""
from __future__ import annotations

import enum

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32


class GGUFValueType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    """ggml tensor dtypes (subset relevant to LLM GGUF files)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    BF16 = 30


# (block_size_in_elements, type_size_in_bytes) per ggml type.
GGML_TYPE_TRAITS: dict[GGMLType, tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.BF16: (1, 2),
    GGMLType.F64: (1, 8),
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
    GGMLType.I64: (1, 8),
    GGMLType.Q4_0: (32, 18),   # f16 d + 16B nibbles
    GGMLType.Q4_1: (32, 20),   # f16 d + f16 m + 16B nibbles
    GGMLType.Q5_0: (32, 22),   # f16 d + u32 qh + 16B nibbles
    GGMLType.Q5_1: (32, 24),   # f16 d + f16 m + u32 qh + 16B
    GGMLType.Q8_0: (32, 34),   # f16 d + 32 int8
    GGMLType.Q8_1: (32, 36),   # f16 d + f16 s + 32 int8
    GGMLType.Q2_K: (256, 84),
    GGMLType.Q3_K: (256, 110),
    GGMLType.Q4_K: (256, 144),  # f16 d + f16 dmin + 12B scales + 128B qs
    GGMLType.Q5_K: (256, 176),  # + 32B qh
    GGMLType.Q6_K: (256, 210),  # 128B ql + 64B qh + 16B scales + f16 d
    GGMLType.Q8_K: (256, 292),  # f32 d + 256 int8 + 16 i16 bsums
}

QK_K = 256  # K-quant super-block size


def block_size(t: GGMLType) -> int:
    return GGML_TYPE_TRAITS[t][0]


def type_size(t: GGMLType) -> int:
    return GGML_TYPE_TRAITS[t][1]


def row_size(t: GGMLType, n_elements: int) -> int:
    """Bytes for a row of n_elements of type t (must be block-multiple)."""
    bs, ts = GGML_TYPE_TRAITS[t]
    if n_elements % bs != 0:
        raise ValueError(f"row of {n_elements} not a multiple of block {bs} for {t.name}")
    return n_elements // bs * ts


# Standard GGUF metadata keys for Gemma-family models, as read by the
# reference at gemma_model.cpp:403-415 and 212-226.
class Keys:
    ARCHITECTURE = "general.architecture"
    NAME = "general.name"
    ALIGNMENT = "general.alignment"
    FILE_TYPE = "general.file_type"
    QUANT_VERSION = "general.quantization_version"

    # model hyper-params; {arch} is e.g. "gemma"
    CONTEXT_LENGTH = "{arch}.context_length"
    EMBEDDING_LENGTH = "{arch}.embedding_length"
    BLOCK_COUNT = "{arch}.block_count"
    FEED_FORWARD_LENGTH = "{arch}.feed_forward_length"
    HEAD_COUNT = "{arch}.attention.head_count"
    HEAD_COUNT_KV = "{arch}.attention.head_count_kv"
    KEY_LENGTH = "{arch}.attention.key_length"
    VALUE_LENGTH = "{arch}.attention.value_length"
    RMS_EPS = "{arch}.attention.layer_norm_rms_epsilon"
    ROPE_FREQ_BASE = "{arch}.rope.freq_base"
    # Gemma-3: sliding-window layers rope at a different (local) base, and
    # global layers apply linear position scaling (llama.cpp keys)
    ROPE_FREQ_BASE_SWA = "{arch}.rope.freq_base_swa"
    ROPE_SCALING_TYPE = "{arch}.rope.scaling.type"
    ROPE_SCALING_FACTOR = "{arch}.rope.scaling.factor"
    # gemma-2/3 style extras
    SLIDING_WINDOW = "{arch}.attention.sliding_window"
    LOGIT_SOFTCAP = "{arch}.final_logit_softcapping"
    ATTN_SOFTCAP = "{arch}.attn_logit_softcapping"

    TOKENIZER_MODEL = "tokenizer.ggml.model"
    TOKENS = "tokenizer.ggml.tokens"
    SCORES = "tokenizer.ggml.scores"
    TOKEN_TYPE = "tokenizer.ggml.token_type"
    BOS_ID = "tokenizer.ggml.bos_token_id"
    EOS_ID = "tokenizer.ggml.eos_token_id"
    UNK_ID = "tokenizer.ggml.unknown_token_id"
    PAD_ID = "tokenizer.ggml.padding_token_id"
    ADD_BOS = "tokenizer.ggml.add_bos_token"
    ADD_EOS = "tokenizer.ggml.add_eos_token"
    ADD_SPACE_PREFIX = "tokenizer.ggml.add_space_prefix"


class TokenType(enum.IntEnum):
    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6
