"""gemma_tpu_torch q4_0 layout against the reference's codecs.

Tolerance: none. q4_0 dequant is f32 scale * (q - 8) in both packages, so
every comparison here is bit-exact: against `numpy_ref.dequantize` from the
GGUF bytes (exact f16 scales), and against the JAX `dequant` through
`from_jax_q4_0` (the reference's bf16-rounded scales, exact in f16).
"""
import numpy as np
import pytest
import torch

from gemma_tpu.gguf import GGMLType, GGUFReader, GGUFWriter
from gemma_tpu.quant import numpy_ref
from gemma_tpu.quant.qtensor import dequant as jax_dequant
from gemma_tpu.quant.qtensor import gather_dequant as jax_gather_dequant
from gemma_tpu.quant.qtensor import quantize_array
from gemma_tpu_torch.quant.qtensor import (
    QTensor,
    dequant,
    from_ggml,
    from_jax_q4_0,
    gather_dequant,
    pack_q4_0,
)

SHAPES = [(8, 64), (48, 256), (3, 1024)]


def _q4_0_gguf(path, shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = GGUFWriter(path)
    w.add_kv("general.architecture", "gemma")
    w.add_tensor("w", numpy_ref.quantize(x, GGMLType.Q4_0), shape, GGMLType.Q4_0)
    w.write()
    return GGUFReader(path)


@pytest.mark.parametrize("shape", SHAPES)
def test_dequant_bit_exact_vs_numpy_ref(shape, tmp_path):
    reader = _q4_0_gguf(tmp_path / "q.gguf", shape, seed=sum(shape))
    ti = reader.tensors["w"]
    raw = reader.tensor_raw("w")
    qt = from_ggml(raw, ti.ggml_type, ti.shape, "cpu")
    assert qt.shape == shape and qt.qs.dtype == torch.uint8 and qt.scales.dtype == torch.float16
    nbytes = qt.qs.numel() + qt.scales.numel() * 2
    assert nbytes * 8 / (shape[0] * shape[1]) == 4.5  # ggml's wire density
    ref = numpy_ref.dequantize(raw, GGMLType.Q4_0, shape)
    np.testing.assert_array_equal(dequant(qt, torch.float32).numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_from_jax_q4_0_bit_exact(shape, rng):
    x = rng.normal(size=shape).astype(np.float32)
    jqt = quantize_array(x, "q4_0")
    qt = from_jax_q4_0({k: np.asarray(v) for k, v in jqt.arrays.items()})
    ref = np.asarray(jax_dequant(jqt, dtype=np.float32))
    np.testing.assert_array_equal(dequant(qt, torch.float32).numpy(), ref)


def test_pack_keeps_ggml_block_bytes(rng):
    """The port's qs rows are ggml's payload bytes, block after block."""
    shape = (4, 96)
    raw = np.frombuffer(numpy_ref.quantize(rng.normal(size=shape).astype(np.float32),
                                           GGMLType.Q4_0), np.uint8)
    qs, scales = pack_q4_0(raw, shape)
    blocks = raw.reshape(shape[0], shape[1] // 32, 18)
    np.testing.assert_array_equal(qs, blocks[:, :, 2:].reshape(shape[0], -1))
    np.testing.assert_array_equal(scales.view(np.uint8).reshape(shape[0], -1, 2), blocks[:, :, :2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_dequant_matches_rows_and_reference(dtype, rng):
    x = rng.normal(size=(40, 128)).astype(np.float32)
    jqt = quantize_array(x, "q4_0")
    qt = from_jax_q4_0({k: np.asarray(v) for k, v in jqt.arrays.items()})
    idx = np.array([[3, 0, 39], [7, 7, 12]], np.int32)
    got = gather_dequant(qt, torch.from_numpy(idx), dtype)
    assert got.shape == (2, 3, 128) and got.dtype == dtype
    torch.testing.assert_close(got, dequant(qt, dtype)[torch.from_numpy(idx).long()], rtol=0, atol=0)
    ref = np.array(jax_gather_dequant(jqt, idx, dtype=np.float32))
    torch.testing.assert_close(got, torch.from_numpy(ref).to(dtype), rtol=0, atol=0)


@pytest.mark.parametrize("ggml_type", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0])
def test_unported_formats_raise(ggml_type, rng):
    shape = (4, 256)
    raw = numpy_ref.quantize(rng.normal(size=shape).astype(np.float32), ggml_type)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        from_ggml(raw, ggml_type, shape, "cpu")


def test_load_params_q4_k_raises(tmp_path):
    """A q4_k checkpoint reaching the loader names the ROADMAP item."""
    from gemma_tpu_torch.models import GemmaConfig, load_params
    from gemma_tpu_torch.testing import make_gguf

    cfg = GemmaConfig(vocab_size=300, d_model=256, n_layers=1, n_heads=2, n_kv_heads=1,
                      head_dim=128, d_ff=512)
    path = make_gguf(tmp_path / "k.gguf", cfg, weight_type=GGMLType.Q4_K)
    with pytest.raises(NotImplementedError, match="q4_k.*ROADMAP"):
        load_params(GGUFReader(path))


def test_from_jax_q4_0_rejects_f16_overflow():
    qs = np.zeros((16, 2), np.uint8)
    bits = np.full((1, 2), 0x47C8, np.uint16)  # bf16 102400.0: above f16's 65504
    import ml_dtypes

    with pytest.raises(ValueError, match="f16"):
        from_jax_q4_0({"qs": qs, "scales": bits.view(ml_dtypes.bfloat16)})


def test_qtensor_validates_buffers():
    with pytest.raises(TypeError):
        QTensor(torch.zeros(2, 16, dtype=torch.uint8), torch.zeros(2, 1, dtype=torch.float32))
    with pytest.raises(ValueError):
        QTensor(torch.zeros(2, 16, dtype=torch.uint8), torch.zeros(2, 2, dtype=torch.float16))
