"""gemma_tpu_torch q4_0, q8_0, q4_k and q6_k layouts against the reference's
codecs.

Tolerances:
* none for dequant against `numpy_ref.dequantize` from the GGUF bytes (the
  reference's and the port's copy): the port computes the same f32
  operations in the same order (q4_0 scale * (q - 8), q8_0 scale * q, q4_k
  (d * sc) * q - dmin * mn, q6_k (d * sc) * q) from ggml's exact f16
  scales, so every value is bit-exact;
* none for the `from_jax_*` converters: they rebuild ggml's block bytes
  from the reference's arrays (its hi/lo bf16 superscales are exact) and
  must reproduce the port's packing of the original bytes exactly;
* none against the JAX q4_0, q8_0 and q6_k `dequant` (the same products;
  `from_jax_q8_0` carries the reference's bf16-rounded scales); the
  JAX q4_k dequant folds as sc * (q - 8) + (8 sc - mn), another rounding
  order than ggml's, so it is held within 4 f32 ulps of the largest
  weight (and one bf16 ulp after a cast to bf16).
"""
import numpy as np
import pytest
import torch

from gemma_tpu.gguf import GGMLType, GGUFReader, GGUFWriter
from gemma_tpu.quant import numpy_ref
from gemma_tpu_torch.quant import numpy_ref as port_numpy_ref
from gemma_tpu.quant.qtensor import dequant as jax_dequant
from gemma_tpu.quant.qtensor import gather_dequant as jax_gather_dequant
from gemma_tpu.quant.qtensor import quantize_array
from gemma_tpu_torch.quant.qtensor import (
    QTensor,
    concat_rows,
    dequant,
    from_ggml,
    from_jax,
    from_jax_q4_0,
    from_jax_q8_0,
    gather_dequant,
    pack_q4_0,
    pack_q8_0,
    pack_q4_k,
    pack_q6_k,
    select_rows,
)

SHAPES = [(8, 64), (48, 256), (3, 1024)]
KQUANT_SHAPES = [(8, 512), (3, 1024), (4, 8192)]
KQUANTS = {"q4_k": (GGMLType.Q4_K, 4.5), "q6_k": (GGMLType.Q6_K, 6.5625)}


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
    packed = pack_q4_0(raw, shape)
    qs, scales = packed["qs"], packed["scales"]
    blocks = raw.reshape(shape[0], shape[1] // 32, 18)
    np.testing.assert_array_equal(qs, blocks[:, :, 2:].reshape(shape[0], -1))
    np.testing.assert_array_equal(scales.view(np.uint8).reshape(shape[0], -1, 2), blocks[:, :, :2])


@pytest.mark.parametrize("fmt", ["q4_0", "q8_0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_dequant_matches_rows_and_reference(dtype, fmt, rng):
    x = rng.normal(size=(40, 128)).astype(np.float32)
    jqt = quantize_array(x, fmt)
    qt = from_jax(jqt.fmt, {k: np.asarray(v) for k, v in jqt.arrays.items()})
    assert qt.fmt == fmt
    idx = np.array([[3, 0, 39], [7, 7, 12]], np.int32)
    got = gather_dequant(qt, torch.from_numpy(idx), dtype)
    assert got.shape == (2, 3, 128) and got.dtype == dtype
    torch.testing.assert_close(got, dequant(qt, dtype)[torch.from_numpy(idx).long()], rtol=0, atol=0)
    ref = np.array(jax_gather_dequant(jqt, idx, dtype=np.float32))
    torch.testing.assert_close(got, torch.from_numpy(ref).to(dtype), rtol=0, atol=0)


def _q8_0(shape, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    raw = numpy_ref.quantize(x, GGMLType.Q8_0)
    return x, raw, from_ggml(raw, GGMLType.Q8_0, shape, "cpu")


@pytest.mark.parametrize("shape", SHAPES)
def test_q8_0_dequant_bit_exact_vs_numpy_ref(shape):
    """Against the reference's numpy_ref and the port's copy, at ggml's
    8.5 bpw."""
    _, raw, qt = _q8_0(shape, seed=sum(shape))
    assert qt.fmt == "q8_0" and qt.shape == shape
    assert qt.qs.dtype == torch.int8 and qt.scales.dtype == torch.float16
    nbytes = sum(a.numel() * a.element_size() for a in qt.arrays.values())
    assert nbytes * 8 / (shape[0] * shape[1]) == 8.5
    got = dequant(qt, torch.float32).numpy()
    np.testing.assert_array_equal(got, numpy_ref.dequantize(raw, GGMLType.Q8_0, shape))
    np.testing.assert_array_equal(got, port_numpy_ref.dequantize(raw, GGMLType.Q8_0, shape))


def test_pack_q8_0_keeps_ggml_block_bytes(rng):
    shape = (3, 96)
    raw = np.frombuffer(numpy_ref.quantize(rng.normal(size=shape).astype(np.float32),
                                           GGMLType.Q8_0), np.uint8)
    packed = pack_q8_0(raw, shape)
    blocks = raw.reshape(3, 3, 34)
    np.testing.assert_array_equal(packed["qs"].view(np.uint8), blocks[:, :, 2:].reshape(3, -1))
    np.testing.assert_array_equal(packed["scales"].view(np.uint8).reshape(3, -1, 2), blocks[:, :, :2])


@pytest.mark.parametrize("shape", SHAPES)
def test_from_jax_q8_0_matches_from_ggml(shape):
    """The reference's q8_0 (`qs` i8 [K, N], bf16 `scales` [K/32, N]) of the
    same values converts to from_ggml's QTensor: the payload equal, the
    scales equal to ggml's f16 rounded to bf16 as the reference rounds them,
    and the dequantized matrix equal to the JAX dequant."""
    x, _, qt = _q8_0(shape, seed=3 + shape[0])
    jqt = quantize_array(x, "q8_0")
    got = from_jax(jqt.fmt, {k: np.asarray(v) for k, v in jqt.arrays.items()})
    assert got.fmt == "q8_0" and got.shape == shape
    assert torch.equal(got.qs, qt.qs)
    assert torch.equal(got.scales, qt.scales.to(torch.bfloat16).to(torch.float16))
    ref = np.asarray(jax_dequant(jqt, dtype=np.float32))
    np.testing.assert_array_equal(dequant(got, torch.float32).numpy(), ref)
    assert torch.equal(from_jax_q8_0({k: np.asarray(v) for k, v in jqt.arrays.items()}).qs, qt.qs)


def _kquant(fmt, shape, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    raw = numpy_ref.quantize(x, KQUANTS[fmt][0])
    return x, raw, from_ggml(raw, KQUANTS[fmt][0], shape, "cpu")


@pytest.mark.parametrize("fmt", list(KQUANTS))
@pytest.mark.parametrize("shape", KQUANT_SHAPES)
def test_kquant_dequant_bit_exact_vs_numpy_ref(fmt, shape):
    _, raw, qt = _kquant(fmt, shape, seed=sum(shape))
    assert qt.fmt == fmt and qt.shape == shape
    nbytes = sum(a.numel() * a.element_size() for a in qt.arrays.values())
    assert nbytes * 8 / (shape[0] * shape[1]) == KQUANTS[fmt][1]  # ggml's wire density
    ref = numpy_ref.dequantize(raw, KQUANTS[fmt][0], shape)
    np.testing.assert_array_equal(dequant(qt, torch.float32).numpy(), ref)


@pytest.mark.parametrize("fmt", list(KQUANTS))
def test_pack_kquant_slices_ggml_blocks(fmt, rng):
    """The port's buffers are ggml's superblock fields, block after block."""
    shape = (3, 512)
    raw = np.frombuffer(numpy_ref.quantize(rng.normal(size=shape).astype(np.float32),
                                           KQUANTS[fmt][0]), np.uint8)
    if fmt == "q4_k":
        blocks = raw.reshape(3, 2, 144)
        arrays = pack_q4_k(raw, shape)
        fields = {"dm": (0, 4), "scales": (4, 16), "qs": (16, 144)}
    else:
        blocks = raw.reshape(3, 2, 210)
        arrays = pack_q6_k(raw, shape)
        fields = {"ql": (0, 128), "qh": (128, 192), "sc": (192, 208), "d": (208, 210)}
    for name, (a, b) in fields.items():
        got = np.ascontiguousarray(arrays[name]).view(np.uint8).reshape(3, 2, b - a)
        np.testing.assert_array_equal(got, blocks[:, :, a:b], err_msg=name)


def _jax_arrays(jqt):
    return {k: np.asarray(v) for k, v in jqt.arrays.items()}


@pytest.mark.parametrize("fmt", list(KQUANTS))
@pytest.mark.parametrize("shape", KQUANT_SHAPES[:2])
def test_from_jax_kquant_reproduces_ggml_bytes(fmt, shape):
    x, _, qt = _kquant(fmt, shape, seed=7 + shape[0])
    jqt = quantize_array(x, fmt)
    assert jqt.fmt == fmt  # the split-plane q6_k at shallow K
    got = from_jax(jqt.fmt, _jax_arrays(jqt))
    for name, ref in qt.arrays.items():
        assert torch.equal(got.arrays[name], ref), name


def test_from_jax_q6_k_v4_reproduces_ggml_bytes(monkeypatch):
    """The reference's deep-K int8 q6_k layout (kernel `_q6_k_v4_kernel`)
    converts into the port's one q6_k layout."""
    monkeypatch.setenv("GEMMA_TPU_Q6K_DEEPK", "8192")
    x, _, qt = _kquant("q6_k", (4, 8192), seed=11)
    jqt = quantize_array(x, "q6_k")
    assert jqt.fmt == "q6_k_v4"
    got = from_jax(jqt.fmt, _jax_arrays(jqt))
    assert got.fmt == "q6_k"
    for name, ref in qt.arrays.items():
        assert torch.equal(got.arrays[name], ref), name


@pytest.mark.parametrize("fmt", list(KQUANTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kquant_gather_dequant_matches_rows_and_reference(fmt, dtype):
    x = np.random.default_rng(5).normal(size=(40, 512)).astype(np.float32)
    jqt = quantize_array(x, fmt)
    qt = from_jax(jqt.fmt, _jax_arrays(jqt))
    idx = np.array([[3, 0, 39], [7, 7, 12]], np.int32)
    got = gather_dequant(qt, torch.from_numpy(idx), dtype)
    assert got.shape == (2, 3, 512) and got.dtype == dtype
    torch.testing.assert_close(got, dequant(qt, dtype)[torch.from_numpy(idx).long()], rtol=0, atol=0)
    ref = torch.from_numpy(np.array(jax_gather_dequant(jqt, idx, dtype=np.float32)))
    if fmt == "q6_k":
        torch.testing.assert_close(got, ref.to(dtype), rtol=0, atol=0)
    else:
        wmax = float(ref.abs().max())
        ulps = 4 * 2.0**-23 if dtype == torch.float32 else 2.0**-8
        torch.testing.assert_close(got.float(), ref, rtol=0, atol=ulps * wmax)


def test_select_and_concat_rows(rng):
    _, _, a = _kquant("q4_k", (6, 512), seed=1)
    _, _, b = _kquant("q4_k", (2, 512), seed=2)
    ab = concat_rows([a, b])
    assert ab.fmt == "q4_k" and ab.shape == (8, 512)
    torch.testing.assert_close(dequant(ab), torch.cat([dequant(a), dequant(b)]), rtol=0, atol=0)
    torch.testing.assert_close(dequant(select_rows(ab, slice(0, 6))), dequant(a), rtol=0, atol=0)
    _, _, c = _kquant("q6_k", (2, 512), seed=3)
    with pytest.raises(ValueError):
        concat_rows([a, c])


def test_from_jax_q4_0_rejects_f16_overflow():
    qs = np.zeros((16, 2), np.uint8)
    bits = np.full((1, 2), 0x47C8, np.uint16)  # bf16 102400.0: above f16's 65504
    import ml_dtypes

    with pytest.raises(ValueError, match="f16"):
        from_jax_q4_0({"qs": qs, "scales": bits.view(ml_dtypes.bfloat16)})


def test_qtensor_validates_buffers():
    with pytest.raises(TypeError):
        QTensor("q4_0", qs=torch.zeros(2, 16, dtype=torch.uint8),
                scales=torch.zeros(2, 1, dtype=torch.float32))
    with pytest.raises(ValueError):
        QTensor("q4_0", qs=torch.zeros(2, 16, dtype=torch.uint8),
                scales=torch.zeros(2, 2, dtype=torch.float16))
    with pytest.raises(ValueError):  # K = 128 is not a whole q4_k superblock
        QTensor("q4_k", qs=torch.zeros(2, 64, dtype=torch.uint8),
                scales=torch.zeros(2, 0, 12, dtype=torch.uint8),
                dm=torch.zeros(2, 0, 2, dtype=torch.float16))
    with pytest.raises(ValueError):  # a q6_k buffer missing
        QTensor("q6_k", ql=torch.zeros(2, 128, dtype=torch.uint8))
    with pytest.raises(ValueError):
        QTensor("q8_0", qs=torch.zeros(2, 32, dtype=torch.int8))
