"""q4_0 matmul: the port's plain version against the JAX q4_0 kernel.

The JAX `quant_matmul` runs its Pallas `_q4_0_kernel` in interpret mode on
the CPU; both sides get the same weights (`from_jax_q4_0` carries the
reference's bf16-rounded scales exactly) and the same activations.

Tolerances, by regime (the reference switches its dot dtype at M = 8):
* M <= 8, bf16 or f32 x, and M > 8 with bf16 x: both sides form identical
  products (f32 weights and x; or bf16-rounded weights and bf16 x, whose
  products are exact in f32) and differ only in the order of f32 sums:
  rtol 1e-5 of the output's scale.
* M > 8 with f32 x: the port keeps f32 (the reference's own dispatch sends
  f32 activations to an f32 dequant + dot, quant_matmul.py:375-380), while
  the JAX kernel called directly rounds x and weights to bf16: 2e-2 of
  the output's scale against the kernel, and 1e-5 against the reference's
  f32 dispatch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gemma_tpu.ops.quant_matmul import quant_matmul
from gemma_tpu.quant.qtensor import dequant_t, quantize_array
from gemma_tpu_torch.ops.linear import linear
from gemma_tpu_torch.ops.quant_matmul import q4_0_matmul, q4_0_matmul_plain
from gemma_tpu_torch.quant.qtensor import dequant, from_jax_q4_0

SHAPES = [(256, 512), (384, 1024)]  # (N, K): the JAX kernel's tile-compatible sizes


def _weights(N, K, seed):
    rng = np.random.default_rng(seed)
    jqt = quantize_array(rng.normal(size=(N, K)).astype(np.float32) * 0.05, "q4_0")
    return jqt, from_jax_q4_0({k: np.asarray(v) for k, v in jqt.arrays.items()})


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


@pytest.mark.parametrize("N,K", SHAPES)
@pytest.mark.parametrize("M", [1, 8, 16, 64])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_matches_jax_kernel(M, N, K, dtype):
    jqt, qt = _weights(N, K, seed=M + N)
    x = np.random.default_rng(M).normal(size=(M, K)).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))

    got = q4_0_matmul_plain(xt, qt)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    ref = np.asarray(quant_matmul(xj, jqt))
    scale = float(np.abs(ref).max())
    if dtype == "float32" and M > 8:
        assert _max_err(got, ref) <= 2e-2 * scale
        f32_dispatch = np.asarray(jnp.dot(xj, dequant_t(jqt, jnp.float32)))
        assert _max_err(got, f32_dispatch) <= 1e-5 * scale
    else:
        assert _max_err(got, ref) <= 1e-5 * scale


def test_wrapper_on_cpu_is_the_plain_version():
    _, qt = _weights(256, 512, seed=3)
    x = torch.randn(2, 5, 512, dtype=torch.bfloat16)
    y = q4_0_matmul(x, qt)
    assert y.shape == (2, 5, 256)
    torch.testing.assert_close(y, q4_0_matmul_plain(x, qt), rtol=0, atol=0)


def test_wrapper_refuses_other_devices():
    """No fallback: only a CPU tensor takes the plain path."""
    _, qt = _weights(256, 512, seed=4)
    with pytest.raises(ValueError):
        q4_0_matmul(torch.empty(1, 512, device="meta"), qt)
    with pytest.raises(ValueError):
        q4_0_matmul(torch.empty(1, 256), qt)


def test_linear_dispatch():
    _, qt = _weights(256, 512, seed=5)
    x = torch.randn(3, 512, dtype=torch.bfloat16)
    y = linear(x, qt)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, q4_0_matmul_plain(x, qt).to(torch.bfloat16), rtol=0, atol=0)
    assert linear(x, qt, out_dtype=torch.float32).dtype == torch.float32
    # a dense weight: bf16 operands, f32 accumulation
    w = dequant(qt, torch.bfloat16)
    ref = (x.float() @ w.float().T).to(torch.bfloat16)
    torch.testing.assert_close(linear(x, w), ref, rtol=0, atol=0)
