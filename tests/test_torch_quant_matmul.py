"""Quantized matmuls: the port's plain versions against the JAX kernels.

The JAX `quant_matmul` runs its Pallas kernels (`_q4_0_kernel`,
`_q8_0_kernel`, `_q4_k_kernel`, `_q6_k_kernel`, `_q6_k_v4_kernel`) in
interpret mode on the
CPU; both sides get the same weights (`from_jax_*` carries the reference's
scales exactly) and the same activations. The JAX K-quant kernels need
K % 1024 == 0 (their metadata tiles), so the K-quant shapes are 1024-deep
multiples.

Tolerances, by regime (the reference switches its dot dtype at M = 8):
* q4_0 and q8_0 (whose bf16 scales `from_jax_q8_0` carries exactly):
  M <= 8, bf16 or f32 x, and M > 8 with bf16 x: both sides form identical
  products (f32 weights and x; or bf16-rounded weights and bf16 x, whose
  products are exact in f32) and differ only in the order of f32 sums:
  rtol 1e-5 of the output's scale.
* M > 8 with f32 x: the port keeps f32 (the reference's own dispatch sends
  f32 activations to an f32 dequant + dot, quant_matmul.py:375-380), while
  the JAX kernel called directly rounds x and weights to bf16: 2e-2 of
  the output's scale against the kernel, and 1e-5 against the reference's
  f32 dispatch.
* q4_k at M > 8 with bf16 x: 1e-5, since both round bf16(d*sc * (q - 8))
  and add the per-32 affine part in f32 (measured <= 3.1e-7).
* q6_k at M > 8 with bf16 x: 1e-2. The port rounds the true weight
  bf16((d*sc) * q); the reference rounds (d*sc) * (q + 24) and adds its
  -24 fold in f32, so each weight differs by up to a bf16 ulp of a value
  up to twice its size (measured <= 3.6e-3).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gemma_tpu.ops.quant_matmul import quant_matmul
from gemma_tpu.quant.qtensor import dequant_t, quantize_array
from gemma_tpu_torch.ops.linear import linear
from gemma_tpu_torch.ops.quant_matmul import (
    PLAIN,
    q4_0_matmul,
    q4_0_matmul_plain,
    q4_k_matmul,
    q6_k_matmul,
    q8_0_matmul,
)
from gemma_tpu_torch.quant.qtensor import dequant, from_jax

SHAPES = [(256, 512), (384, 1024)]  # (N, K): the JAX kernel's tile-compatible sizes
KQUANT_SHAPES = [(256, 1024), (128, 2048)]


@pytest.fixture(autouse=True)
def _interpret_kernels(monkeypatch):
    # other test modules set this process-wide; `quant_matmul` runs the
    # Pallas kernels in interpret mode on the CPU either way, and the pin
    # keeps any dispatch through `register_all` on the kernels too
    monkeypatch.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")


def _weights(fmt, N, K, seed):
    rng = np.random.default_rng(seed)
    jqt = quantize_array(rng.normal(size=(N, K)).astype(np.float32) * 0.05, fmt)
    return jqt, from_jax(jqt.fmt, {k: np.asarray(v) for k, v in jqt.arrays.items()})


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


@pytest.mark.parametrize("fmt", ["q4_0", "q8_0"])
@pytest.mark.parametrize("N,K", SHAPES)
# 2: the card's tensor-core GEMV below its n8 tile; 17 and 70: ragged
# against the 64-row tensor-core tiles
@pytest.mark.parametrize("M", [1, 2, 8, 16, 17, 64, 70])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_matches_jax_kernel(M, N, K, dtype, fmt):
    """`q4_0_matmul_plain` and `q8_0_matmul_plain` against `_q4_0_kernel`
    and `_q8_0_kernel` in interpret mode."""
    jqt, qt = _weights(fmt, N, K, seed=M + N)
    assert qt.fmt == fmt and qt.shape == (N, K)
    x = np.random.default_rng(M).normal(size=(M, K)).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))

    got = PLAIN[fmt](xt, qt)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    ref = np.asarray(quant_matmul(xj, jqt))
    scale = float(np.abs(ref).max())
    if dtype == "float32" and M > 8:
        assert _max_err(got, ref) <= 2e-2 * scale
        f32_dispatch = np.asarray(jnp.dot(xj, dequant_t(jqt, jnp.float32)))
        assert _max_err(got, f32_dispatch) <= 1e-5 * scale
    else:
        assert _max_err(got, ref) <= 1e-5 * scale


@pytest.mark.parametrize("fmt", ["q4_k", "q6_k"])
@pytest.mark.parametrize("N,K", KQUANT_SHAPES)
# 17 and 70: ragged against the card's 64-row tensor-core tiles
@pytest.mark.parametrize("M", [1, 8, 16, 17, 64, 70])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kquant_plain_matches_jax_kernel(fmt, M, N, K, dtype):
    jqt, qt = _weights(fmt, N, K, seed=N)
    x = np.random.default_rng(M).normal(size=(M, K)).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))

    got = PLAIN[fmt](xt, qt)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    ref = np.asarray(quant_matmul(xj, jqt))
    scale = float(np.abs(ref).max())
    if M <= 8:
        assert _max_err(got, ref) <= 1e-5 * scale
    elif dtype == "float32":
        assert _max_err(got, ref) <= 2e-2 * scale
        f32_dispatch = np.asarray(jnp.dot(xj, dequant_t(jqt, jnp.float32)))
        assert _max_err(got, f32_dispatch) <= 1e-5 * scale
    else:
        assert _max_err(got, ref) <= (1e-5 if fmt == "q4_k" else 1e-2) * scale


@pytest.mark.parametrize("M", [1, 9])
def test_q6_k_v4_plain_matches_jax_kernel(M, monkeypatch):
    """The reference's deep-K int8 q6_k (`_q6_k_v4_kernel`) and the port's
    one q6_k layout compute the same function; at M = 9 both round the true
    weight to bf16, so the tolerance is tight at both M."""
    monkeypatch.setenv("GEMMA_TPU_Q6K_DEEPK", "8192")
    jqt, qt = _weights("q6_k", 128, 8192, seed=M)
    assert jqt.fmt == "q6_k_v4" and qt.fmt == "q6_k"
    x = np.random.default_rng(M).normal(size=(M, 8192)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    ref = np.asarray(quant_matmul(xj, jqt))
    assert _max_err(PLAIN["q6_k"](xt, qt), ref) <= 1e-5 * float(np.abs(ref).max())


def test_wrapper_on_cpu_is_the_plain_version():
    _, qt = _weights("q4_0", 256, 512, seed=3)
    x = torch.randn(2, 5, 512, dtype=torch.bfloat16)
    y = q4_0_matmul(x, qt)
    assert y.shape == (2, 5, 256)
    torch.testing.assert_close(y, q4_0_matmul_plain(x, qt), rtol=0, atol=0)


def test_wrapper_refuses_other_devices():
    """No fallback: only a CPU tensor takes the plain path."""
    _, qt = _weights("q4_0", 256, 512, seed=4)
    with pytest.raises(ValueError):
        q4_0_matmul(torch.empty(1, 512, device="meta"), qt)
    with pytest.raises(ValueError):
        q4_0_matmul(torch.empty(1, 256), qt)


@pytest.mark.parametrize("fmt,op", [("q4_k", q4_k_matmul), ("q6_k", q6_k_matmul),
                                    ("q8_0", q8_0_matmul)])
def test_kquant_wrappers_refuse_other_devices_and_formats(fmt, op):
    _, qt = _weights(fmt, 128, 1024, seed=6)
    x = torch.randn(3, 1024, dtype=torch.bfloat16)
    torch.testing.assert_close(op(x, qt), PLAIN[fmt](x, qt), rtol=0, atol=0)
    with pytest.raises(ValueError):
        op(torch.empty(1, 1024, device="meta"), qt)
    with pytest.raises(ValueError):
        op(torch.empty(1, 512), qt)
    other = q6_k_matmul if op is q4_k_matmul else q4_k_matmul
    with pytest.raises(ValueError, match=fmt):
        other(x, qt)


def test_linear_dispatch():
    _, qt = _weights("q4_0", 256, 512, seed=5)
    x = torch.randn(3, 512, dtype=torch.bfloat16)
    y = linear(x, qt)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, q4_0_matmul_plain(x, qt).to(torch.bfloat16), rtol=0, atol=0)
    assert linear(x, qt, out_dtype=torch.float32).dtype == torch.float32
    # a dense weight: bf16 operands, f32 accumulation
    w = dequant(qt, torch.bfloat16)
    ref = (x.float() @ w.float().T).to(torch.bfloat16)
    torch.testing.assert_close(linear(x, w), ref, rtol=0, atol=0)


@pytest.mark.parametrize("fmt", ["q4_k", "q6_k", "q8_0"])
def test_linear_dispatches_kquants_by_format(fmt):
    _, qt = _weights(fmt, 128, 1024, seed=8)
    x = torch.randn(2, 9, 1024, dtype=torch.bfloat16)  # M = 18: the prefill regime
    y = linear(x, qt, out_dtype=torch.float32)
    torch.testing.assert_close(y, PLAIN[fmt](x, qt), rtol=0, atol=0)
