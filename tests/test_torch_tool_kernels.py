"""The decode-GEMV instruments: the port's plain versions against the Pallas
kernels of the reference's tools/ in interpret mode on the CPU.

Each test builds the tool's `pl.pallas_call` the way the tool's launcher
does, with `interpret=True` and one grid step (bk = K, bn = N); the tools'
own launchers hard-wire TPU tiles. Both sides get the same weights: the
tool's K-paired signed nibbles are repacked into the port's layout, its
bf16 hi/lo superscales carried as exact f16, and its split q6_k planes
packed by the tool's own `pack_split` from the values the port's ggml
planes hold.

Tolerances: 1e-5 x max|ref| where both sides form f32 products (sums in
another order); 2e-5 where both round the weight to bf16 (the tool's own
interpret tolerance, bench_q6k_variants.py:204); exact for the int32 dot.
The probe's kernels are closures in its `main()`: they are held against
the probe's numpy formulas (probe_int4.py:71-75, 113, 133).
"""
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gemma_tpu.ops import quant_matmul as jqmm
from gemma_tpu.quant.qtensor import quantize_array
from gemma_tpu_torch.gguf.constants import GGMLType
from gemma_tpu_torch.ops import qmm_variants as qv
from gemma_tpu_torch.quant import qtensor as pqt

ROOT = Path(__file__).resolve().parents[1]
M = 8
_CACHE_FLAGS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
                "jax_traceback_in_locations_limit")


@pytest.fixture(scope="module")
def tools():
    """The reference's tool modules, imported from tools/ (importing them
    sets JAX's compile-cache flags; they are put back afterwards)."""
    saved = {f: getattr(jax.config, f) for f in _CACHE_FLAGS}
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import bench_q4k_variants
        import bench_q6k_variants
        import bench_qmm_variants
    finally:
        sys.path.remove(str(ROOT / "tools"))
        for f, v in saved.items():
            jax.config.update(f, v)
    return {"qmm": bench_qmm_variants, "q4k": bench_q4k_variants, "q6k": bench_q6k_variants}


def _call(kernel, in_arrays, in_block_shapes, n_out, out_dtype=jnp.float32):
    """One-grid-step interpret-mode pallas_call of the tools' launchers:
    grid (1, 1, 1), full blocks, an f32 [M, n_out] accumulator."""
    return pl.pallas_call(
        kernel,
        grid=(1, 1, 1),
        in_specs=[pl.BlockSpec(s, lambda m, n, k, r=len(s): (0,) * r) for s in in_block_shapes],
        out_specs=pl.BlockSpec((M, n_out), lambda m, n, k: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((M, n_out), out_dtype),
        scratch_shapes=[pltpu.VMEM((M, n_out), jnp.float32)],
        interpret=True,
    )(*in_arrays)


def _max_rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _torch(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, bf16 arrays (ml_dtypes) as torch.bfloat16."""
    a = np.array(a)  # a writable copy
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _port_q4_0_payload(qs_t: np.ndarray) -> torch.Tensor:
    """The tool's K-paired signed nibbles u8 [K/2, N] -> the port's q4_0
    payload u8 [N, K/2] of the same values."""
    u = pqt._nibbles(qs_t)  # [N, K] unsigned, u - 8 the signed value
    return qv.pack_q4_0_values(torch.from_numpy(u.astype(np.int16) - 8))


def _x(K, seed):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal((M, K)), jnp.bfloat16)
    return x, _torch(np.asarray(x))


# --- #9: tools/bench_qmm_variants.py _kernel ------------------------------

QMM_CASES = [  # (mode, the tool's scale dtype), every mode of the tool
    ("f32dot", jnp.bfloat16), ("f32dot", jnp.float32), ("f32dot", jnp.uint16),
    ("rsc", jnp.bfloat16), ("rsc", jnp.float32), ("rsc", jnp.uint16), ("f32sc", jnp.float32),
    ("bf16sc", jnp.bfloat16), ("rscb", jnp.bfloat16), ("u16sc", jnp.uint16),
    ("noscale", jnp.float32), ("gdot", jnp.bfloat16), ("gdot", jnp.uint16),
]


def _qmm_inputs(K, N, sc_dtype, seed):
    rng = np.random.default_rng(seed)  # as the tool's `measure` draws them
    qs_t = rng.integers(0, 256, size=(K // 2, N), dtype=np.uint8)
    sc16 = rng.standard_normal((K // 32, N)).astype(np.float16)
    if sc_dtype == jnp.uint16:
        return qs_t, sc16.view(np.uint16), _torch(sc16.T)
    sc = np.asarray(sc16, np.float32).astype(ml_dtypes.bfloat16 if sc_dtype == jnp.bfloat16
                                             else np.float32)
    return qs_t, sc, _torch(sc.T)


def _tool_qmm(tools, mode, x, qs_t, sc):
    K, N = x.shape[1], qs_t.shape[1]
    if mode == "gdot":
        x = x.reshape(M, K // 32, 32).transpose(1, 0, 2)  # the launcher's [G, M, 32]
    kernel = functools.partial(tools["qmm"]._kernel, nsteps=1, mode=mode)
    return np.asarray(_call(kernel, (x, jnp.asarray(qs_t), jnp.asarray(sc)),
                            (x.shape, qs_t.shape, sc.shape), N))


@pytest.mark.parametrize("mode,sc_dtype", QMM_CASES)
def test_qmm_variant_plain_matches_tool_kernel(tools, mode, sc_dtype):
    K = N = 256
    qs_t, sc, sc_port = _qmm_inputs(K, N, sc_dtype, seed=len(mode))
    x, xt = _x(K, seed=1)
    ref = _tool_qmm(tools, mode, x, qs_t, sc)
    # the bench's op; on the CPU its plain version
    got = qv.qmm_tc_variant(mode, xt, _port_q4_0_payload(qs_t), sc_port)
    f32_products = qv.VARIANT_MODES[mode] in (0, 3, 4)
    assert _max_rel(got, ref) <= (1e-5 if f32_products else 2e-5)


def test_stream_checksum_reads_the_tool_streams_bytes(tools):
    """The tool's stream mode sums its payload bytes and u16 scales; the
    port's checksum, given the same bytes row by row, sums to the same
    total (its layout-bound per-row values are held to the plain version
    on the card)."""
    K = N = 256
    qs_t, sc, sc_port = _qmm_inputs(K, N, jnp.uint16, seed=3)
    x, _ = _x(K, seed=3)
    ref = _tool_qmm(tools, "stream", x, qs_t, sc)
    per_row = qv.row_checksum(torch.from_numpy(np.ascontiguousarray(qs_t.T)), sc_port)
    total = int(per_row.to(torch.int64).sum())
    assert total == int(qs_t.astype(np.int64).sum() + sc.astype(np.int64).sum())
    assert ref[0, 0] == 2 * np.float32(total)  # acc[0, 0] + acc, one step


# --- #10: tools/bench_bn_sweep.py call (the production _q4_0_kernel) -------

@pytest.mark.parametrize("bn", [128, 256])
def test_q4_0_gemv_warps_plain_matches_production_kernel_at_forced_bn(bn, monkeypatch):
    monkeypatch.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")
    N, K = 512, 1024
    jqt = quantize_array(np.random.default_rng(bn).normal(size=(N, K)).astype(np.float32) * 0.05,
                         "q4_0")
    arrays = {k: np.asarray(v) for k, v in jqt.arrays.items()}
    qt = pqt.from_jax_q4_0(arrays)
    x, xt = _x(K, seed=bn)
    bk = jqmm._pick_bk(K, "q4_0")
    ref = pl.pallas_call(  # bench_bn_sweep.py:43-66 with interpret=True
        functools.partial(jqmm._q4_0_kernel, nsteps=K // bk, f32dot=True),
        grid=(1, N // bn, K // bk),
        in_specs=[pl.BlockSpec((M, bk), lambda m, n, k: (m, k)),
                  pl.BlockSpec((bk // 2, bn), lambda m, n, k: (k, n)),
                  pl.BlockSpec((bk // 32, bn), lambda m, n, k: (k, n))],
        out_specs=pl.BlockSpec((M, bn), lambda m, n, k: (m, n)),
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32),
        scratch_shapes=[pltpu.VMEM((M, bn), jnp.float32)],
        interpret=True,
    )(x, jnp.asarray(arrays["qs"]), jnp.asarray(arrays["scales"]))
    for warps in qv.WARPS:
        assert _max_rel(qv.q4_0_gemv_warps(xt, qt, warps), ref) <= 1e-5


# --- #11: tools/bench_q4k_variants.py _kernel -----------------------------

def _q4k_inputs(K, N, seed):
    """A reference q4_k QTensor as the tool's arrays (sc6, mn6 and the bf16
    quad from its `meta`) and as the port's QTensor: the same weights."""
    jqt = quantize_array(np.random.default_rng(seed).normal(size=(N, K)).astype(np.float32) * 0.05,
                         "q4_k")
    arrays = {k: np.asarray(v) for k, v in jqt.arrays.items()}
    S = K // 256
    meta = arrays["meta"].view(np.uint8).reshape(S, 24, N)
    sc6 = np.ascontiguousarray(meta[:, 0:8]).reshape(K // 32, N).view(np.int8)
    mn6 = np.ascontiguousarray(meta[:, 8:16]).reshape(K // 32, N).view(np.int8)
    bits = meta[:, 16:20].astype(np.uint16) | (meta[:, 20:24].astype(np.uint16) << 8)
    dm = bits.view(ml_dtypes.bfloat16).reshape(K // 64, N)
    return arrays["qs"], sc6, mn6, dm, pqt.from_jax_q4_k(arrays)


@pytest.mark.parametrize("mode", list(qv.Q4_K_MODES))
def test_q4_k_variant_plain_matches_tool_kernel(tools, mode):
    K, N = 1024, 128
    qs_t, sc6, mn6, dm, qt = _q4k_inputs(K, N, seed=11)
    x, xt = _x(K, seed=12)
    xs = np.asarray(x, np.float32).reshape(M, K // 32, 32).sum(-1).T
    sc_in = sc6.astype(np.float32).astype(ml_dtypes.bfloat16) if mode == "q4_0ref" else sc6
    kernel = functools.partial(tools["q4k"]._kernel, nsteps=1, mode=mode)
    ins = (x, jnp.asarray(xs), jnp.asarray(qs_t), jnp.asarray(sc_in), jnp.asarray(mn6),
           jnp.asarray(dm))
    ref = np.asarray(_call(kernel, ins, [a.shape for a in ins], N))
    if mode == "nohilo":
        w = qv.q4_k_hi_parts(qt)
        d_hi = dm.astype(np.float32).reshape(K // 256, 4, N)[:, :2]  # the tool's hi rows
        assert np.array_equal(w.dm.float().numpy().transpose(1, 2, 0), d_hi)
    elif mode == "q4_0ref":  # q4_0's function on the tool's nibbles, sc6 as scales
        w = pqt.QTensor("q4_0", qs=_port_q4_0_payload(qs_t),
                        scales=torch.from_numpy(sc6.T.astype(np.float16).copy()))
    else:
        w = qt
    assert _max_rel(qv.q4_k_variant(mode, xt, w), ref) <= 1e-5


# --- #12: tools/bench_q6k_variants.py _kernel -----------------------------

def _q6k_inputs(tools, K, N, seed):
    """The tool's `make_inputs` at [N, K] (q, sc8, hi/lo d, split planes by
    its `pack_split`), and the port's q6_k QTensor of the same weights."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-32, 32, size=(K, N), dtype=np.int8)
    sc8 = rng.integers(-64, 64, size=(K // 16, N), dtype=np.int8)
    d_hi = (rng.uniform(0.5, 1.0, size=(K // 256, N)) * 0.01).astype(np.float16)
    d4 = np.zeros((K // 256, 4, N), dtype=ml_dtypes.bfloat16)
    d32 = d_hi.astype(np.float32)
    d4[:, 0::2] = d32.astype(ml_dtypes.bfloat16)[:, None, :]
    d4[:, 1::2] = (d32 - d4[:, 0].astype(np.float32)).astype(ml_dtypes.bfloat16)[:, None, :]
    d = d4.reshape(K // 64, N)
    ql, qh = tools["q6k"].pack_split(q)
    u = (q.T.astype(np.int16) + 32).astype(np.uint8)
    blocks = pqt._q6_k_blocks(np.ascontiguousarray(u), sc8, d)
    qt = pqt.from_ggml(blocks.tobytes(), GGMLType.Q6_K, (N, K), "cpu")
    return q, sc8, d, ql, qh, qt


@pytest.mark.parametrize("mode", ["prod", "split_f32", "split_int", "stream"])
def test_q6_k_variant_plain_matches_tool_kernel(tools, mode):
    K, N = 1024, 128
    q, sc8, d, ql, qh, qt = _q6k_inputs(tools, K, N, seed=13)
    x, xt = _x(K, seed=14)
    xs16 = np.asarray(x, np.float32).reshape(M, K // 16, 16).sum(-1).T
    pay, qh_in = (q, qh[:1]) if mode == "prod" else (ql, qh)
    kernel = functools.partial(tools["q6k"]._kernel, nsteps=1, mode=mode)
    ins = (x, jnp.asarray(xs16), jnp.asarray(pay), jnp.asarray(qh_in), jnp.asarray(sc8),
           jnp.asarray(d))
    ref = np.asarray(_call(kernel, ins, [a.shape for a in ins], N))
    if mode == "stream":
        # the tool: 1e-20 x the float sum of its split planes; the port: a
        # wrapping integer sum of its ggml planes, held to numpy here
        s = sum(float(a.astype(np.float64).sum()) for a in (ql, qh, sc8, d.astype(np.float32)))
        assert np.allclose(ref, s * 1e-20, rtol=1e-5)
        raw = [a.numpy().reshape(N, -1) for a in qt.arrays.values()]
        want = sum(a.view({1: np.uint8, 2: np.uint16}[a.itemsize]).astype(np.int64).sum(-1)
                   for a in raw)
        assert np.array_equal(qv.row_checksum(*qt.arrays.values()).numpy(),
                              ((want + 2**31) % 2**32 - 2**31).astype(np.int32))
        return
    arrays = qv.q6_k_int8_payload(qt) if mode == "prod" else qt.arrays
    assert torch.equal(qv.q6_k_int8_payload(qt)["qs"], torch.from_numpy(q.T.copy()))
    assert _max_rel(qv.q6_k_variant(mode, xt, arrays), ref) <= 1e-5


# --- #13: tools/probe_int4.py kernel, kernel2, kernel3 --------------------

def test_probe_kernel_bf16sc_matches_probe_formula():
    """kernel: int4 -> bf16, x bf16(scale), dot [8, 512] x [512, 256]."""
    rng = np.random.default_rng(0)
    vals = rng.integers(-8, 8, size=(512, 256), dtype=np.int8)
    x = np.asarray(jnp.asarray(rng.standard_normal((M, 512)), jnp.bfloat16), np.float32)
    sc = rng.standard_normal((512 // 32, 256)).astype(np.float32)
    got = qv.qmm_variant("bf16sc", torch.from_numpy(x).bfloat16(),
                         qv.pack_q4_0_values(torch.from_numpy(vals.T.copy())),
                         torch.from_numpy(sc.T.copy()))
    ref = x @ (vals.astype(np.float32) * np.repeat(sc, 32, axis=0))  # probe_int4.py:72-74
    assert _max_rel(got, ref) <= 1e-2  # each scale and weight rounded to bf16
    exact_w = (torch.from_numpy(vals.T.astype(np.float32))
               * torch.from_numpy(sc.T.copy()).bfloat16().float().repeat_interleave(32, -1))
    # against the same bf16-rounded weights: only the f32 sums' order differs
    assert _max_rel(got, torch.from_numpy(x) @ exact_w.bfloat16().float().T) <= 1e-6


def test_probe_kernel2_noscale_matches_probe_formula():
    """kernel2: int4 -> bf16 dot, [8, 2048] x [2048, 512]."""
    rng = np.random.default_rng(1)
    vals = rng.integers(-8, 8, size=(2048, 512), dtype=np.int8)
    x = np.asarray(jnp.asarray(rng.standard_normal((M, 2048)), jnp.bfloat16), np.float32)
    got = qv.qmm_variant("noscale", torch.from_numpy(x).bfloat16(),
                         qv.pack_q4_0_values(torch.from_numpy(vals.T.copy())),
                         torch.ones(512, 2048 // 32))
    assert _max_rel(got, x @ vals.astype(np.float32)) <= 1e-5  # probe_int4.py:113


@pytest.mark.parametrize("K,N", [(512, 256), (1024, 96)])
def test_int4_dot_matches_probe_formula(K, N):
    """kernel3: int8 x int4 -> int32, exact (probe_int4.py:133)."""
    rng = np.random.default_rng(K)
    vals = rng.integers(-8, 8, size=(K, N), dtype=np.int8)
    xi8 = rng.integers(-100, 100, size=(M, K)).astype(np.int8)
    w = qv.pack_int4(torch.from_numpy(vals.T.copy()))
    assert torch.equal(qv.int4_values(w), torch.from_numpy(vals.T.copy()))
    got = qv.int4_dot(torch.from_numpy(xi8), w)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), xi8.astype(np.int32) @ vals.astype(np.int32))
