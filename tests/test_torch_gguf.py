"""The port's own copies of the reference's framework-free modules against
the originals: `gemma_tpu_torch.gguf` (reader, writer, constants),
`gemma_tpu_torch.quant.numpy_ref` and `gemma_tpu_torch.tokenizer`.

No tolerance anywhere: the copies must compute exactly what the originals
compute, so files, bytes, dequantized values (compared as bit patterns, NaN
included) and token ids are held equal.
"""
import dataclasses

import numpy as np
import pytest

from gemma_tpu import cli as jax_cli
from gemma_tpu import testing as jax_testing
from gemma_tpu.gguf import GGMLType as JaxGGMLType
from gemma_tpu.gguf import GGUFReader as JaxGGUFReader
from gemma_tpu.gguf import GGUFWriter as JaxGGUFWriter
from gemma_tpu.quant import numpy_ref as jax_numpy_ref
from gemma_tpu.tokenizer import Tokenizer as JaxTokenizer
from gemma_tpu_torch import testing
from gemma_tpu_torch.gguf import GGMLType, GGUFReader, block_size, type_size
from gemma_tpu_torch.quant import numpy_ref
from gemma_tpu_torch.tokenizer import Tokenizer

TEXTS = ["hello world", "the hello", "world of the worlds and hello", "a", "",
         "<start_of_turn>user\nhello<end_of_turn>", "héllo ☃ wörld", "hello " * 20]


def _meta(reader):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in reader.metadata.items()}


def _infos(reader):
    return [(t.name, tuple(t.shape), int(t.ggml_type), bytes(reader.tensor_raw(t.name)))
            for t in reader]


def test_reference_file_reads_the_same(tmp_path, rng):
    """A file written by the reference's GGUFWriter reads the same through
    the port's GGUFReader: metadata, tensor infos and raw bytes."""
    path = tmp_path / "ref.gguf"
    w = JaxGGUFWriter(path)
    w.add_kv("general.architecture", "gemma")
    w.add_kv("general.name", "copy-check")
    w.add_kv("gemma.block_count", 3)
    w.add_kv("gemma.rope.freq_base", 10000.0)
    w.add_kv("gemma.flag", True)
    w.add_kv("tokenizer.ggml.tokens", ["<pad>", "▁a", "b"])
    w.add_kv("tokenizer.ggml.scores", np.asarray([0.0, -1.5, -2.0], np.float32))
    w.add_kv("tokenizer.ggml.token_type", np.asarray([3, 1, 1], np.int32))
    for name, t, shape in (("a", JaxGGMLType.F32, (3, 32)), ("b", JaxGGMLType.F16, (2, 64)),
                           ("c", JaxGGMLType.Q8_0, (4, 64)), ("d", JaxGGMLType.Q4_K, (2, 256)),
                           ("e", JaxGGMLType.BF16, (5,))):
        x = rng.normal(size=shape).astype(np.float32)
        w.add_tensor(name, jax_numpy_ref.quantize(x, t), shape, t)
    w.write()
    ref, ours = JaxGGUFReader(path), GGUFReader(path)
    assert ours.architecture == ref.architecture == "gemma"
    assert _meta(ours) == _meta(ref)
    assert _infos(ours) == _infos(ref)
    assert [t.ggml_type for t in ours] == [GGMLType.F32, GGMLType.F16, GGMLType.Q8_0,
                                           GGMLType.Q4_K, GGMLType.BF16]


@pytest.mark.parametrize("weight_type", ["q4_0", "q8_0", "f32"])
def test_make_gguf_writes_the_reference_file(weight_type, tmp_path):
    """The port's make_gguf writes the reference make_gguf's file, byte for
    byte (through the copied writer and codecs)."""
    ref = jax_testing.make_gguf(tmp_path / "ref.gguf", jax_testing.TINY_GEMMA2_CONFIG,
                                weight_type=JaxGGMLType[weight_type.upper()], seed=3, arch="gemma2")
    ours = testing.make_gguf(tmp_path / "ours.gguf", testing.TINY_GEMMA2_CONFIG,
                             weight_type=weight_type, seed=3, arch="gemma2")
    assert ours.read_bytes() == ref.read_bytes()


def test_make_gguf_q4_k_m_is_the_reference_quantize(tmp_path):
    """make_gguf(weight_type="q4_k_m") holds what `python -m gemma_tpu
    quantize --type q4_k_m` writes from the same seed's F32 file: the same
    metadata (but the file type the quantizer records) and tensors."""
    widths = dict(d_model=256, head_dim=64, d_ff=512)
    f32 = jax_testing.make_gguf(tmp_path / "f32.gguf",
                                dataclasses.replace(jax_testing.TINY_CONFIG, **widths),
                                weight_type=JaxGGMLType.F32, seed=5)
    args = jax_cli.build_parser().parse_args(
        ["quantize", str(f32), str(tmp_path / "ref.gguf"), "--type", "q4_k_m"])
    assert args.fn(args) == 0
    ours = GGUFReader(testing.make_gguf(tmp_path / "ours.gguf",
                                        dataclasses.replace(testing.TINY_CONFIG, **widths),
                                        weight_type="q4_k_m", seed=5))
    ref = JaxGGUFReader(tmp_path / "ref.gguf")
    ref_meta = _meta(ref)
    ref_meta.pop("general.file_type")
    assert _meta(ours) == ref_meta
    assert _infos(ours) == _infos(ref)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("ggml_type", jax_numpy_ref.supported_dequant_types(),
                         ids=lambda t: t.name)
def test_numpy_ref_copy_is_bit_exact(ggml_type, rng):
    """quantize (where the reference has an encoder) and dequantize equal the
    reference's bit for bit, for every type its numpy_ref decodes; decoders
    without an encoder get random payload bytes."""
    t = GGMLType(int(ggml_type))
    assert numpy_ref.supported_dequant_types() == [GGMLType(int(x)) for x in
                                                   jax_numpy_ref.supported_dequant_types()]
    n = 2 * 256
    x = (rng.normal(size=(2, 256)) * rng.uniform(0.01, 3.0, size=(2, 1))).astype(np.float32)
    try:
        raw = jax_numpy_ref.quantize(x, ggml_type)
    except NotImplementedError:
        with pytest.raises(NotImplementedError):
            numpy_ref.quantize(x, t)
        raw = rng.integers(0, 256, size=n // block_size(t) * type_size(t), dtype=np.uint8).tobytes()
    else:
        assert numpy_ref.quantize(x, t) == raw
    ours = numpy_ref.dequantize(raw, t, (2, 256))
    ref = jax_numpy_ref.dequantize(raw, ggml_type, (2, 256))
    assert ours.shape == ref.shape == (2, 256)
    np.testing.assert_array_equal(_bits(ours), _bits(ref))


def test_tokenizer_copy_encodes_and_decodes_the_same(tmp_path):
    path = testing.make_gguf(tmp_path / "tiny.gguf", testing.TINY_CONFIG, seed=0)
    ours = Tokenizer.from_gguf(GGUFReader(path))
    ref = JaxTokenizer.from_gguf(JaxGGUFReader(path))
    for text in TEXTS:
        ids = ours.encode(text)
        assert ids == ref.encode(text), text
        assert ours.encode(text, add_bos=False) == ref.encode(text, add_bos=False), text
        assert ours.decode(ids) == ref.decode(ids), text
    every = list(range(testing.TINY_CONFIG.vocab_size))
    assert ours.decode(every) == ref.decode(every)
    assert dataclasses.asdict(ours.special) == dataclasses.asdict(ref.special)
