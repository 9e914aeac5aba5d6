"""The port's whole slice against the JAX package on the three tiny configs.

One q4_0 GGUF per config (`gemma_tpu.testing.make_gguf`) is loaded into the
JAX package, and into the port twice: through `from_jax_params` (the same
numbers as the reference, its bf16-rounded scales included) and through
`load_params` (ggml's exact f16 scales). The JAX model runs its XLA paths
(GEMMA_TPU_INTERPRET_KERNELS unset); the port runs its plain versions.

Tolerances, relative to the largest |logit|:
* f32 activations and cache, `from_jax_params`: 1e-5 — identical
  arithmetic up to the order of f32 sums (measured ~6e-7);
* f32, `load_params`: 2e-2 — the reference rounds each q4_0 scale to bf16
  (up to 2^-9 relative per weight; measured <= 0.6 %);
* bf16 activations: 5e-2 — the same bf16 rounding points on inputs that
  differ in their last bits (measured <= 2.2 %); prefill top-1 must agree.
Greedy streams must be identical in f32.

The q4_k_m slice runs the same three configs widened to d_model 256,
head_dim 64 and d_ff 512, so every K is a whole number of 256-superblocks.
Its GGUF is the reference's mixed recipe (q4_k, with q6_k attn_v and
embedding), written by the port's `make_gguf` and checked tensor for tensor
against `python -m gemma_tpu quantize --type q4_k_m` of the same seed's F32
file. Both port loads carry ggml's exact weights, so they get one set of
tolerances:
* f32: 1e-5 of the largest |logit| — the JAX q4_k dequant folds
  sc * (q - 8) + offs, ulps from ggml's (d*sc) * q - dmin*mn, and sums run
  in another order (measured <= 1e-6); greedy streams identical;
* bf16: 5e-2 — the reference's XLA path rounds each whole dequantized
  weight to bf16, the port keeps f32 weights at M <= 8 and the q4_k affine
  part in f32 above (measured <= 1.5e-2); prefill top-1 must agree.

The q8_0 slice runs `TINY_CONFIG` and `TINY_MHA_CONFIG` (multi-head, one
query head per KV head, q_dim != d_model, as Gemma-7B) from a q8_0 GGUF,
with the q4_0 tolerances: the reference rounds q8_0 scales to bf16 as it
rounds q4_0's, and the port keeps ggml's f16 (`load_params`) or carries the
reference's bf16 values (`from_jax_params`).
"""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gemma_tpu import cli as jax_cli
from gemma_tpu.gguf import GGMLType, GGUFReader
from gemma_tpu.models.params import load_params as jax_load_params
from gemma_tpu.runtime import Engine as JaxEngine
from gemma_tpu.runtime import EngineConfig as JaxEngineConfig
from gemma_tpu.testing import TINY_CONFIG, TINY_GEMMA2_CONFIG, TINY_GEMMA3_CONFIG, make_gguf
from gemma_tpu_torch.models import from_jax_params, load_params
from gemma_tpu_torch.quant.qtensor import QTensor
from gemma_tpu_torch.runtime import Engine, EngineConfig, KVCache, SamplingParams, Scheduler
from gemma_tpu_torch.testing import TINY_CONFIG as PORT_TINY_CONFIG
from gemma_tpu_torch.testing import TINY_KERNEL_CONFIG, TINY_MHA_CONFIG
from gemma_tpu_torch.testing import make_gguf as port_make_gguf
from gemma_tpu_torch.testing import make_params

ARCHS = {"gemma": TINY_CONFIG, "gemma2": TINY_GEMMA2_CONFIG, "gemma3": TINY_GEMMA3_CONFIG}
# every K a multiple of 256 (the q4_k / q6_k superblock)
KQUANT_WIDTHS = dict(d_model=256, head_dim=64, d_ff=512)
PROMPT = [1, 7, 300, 42, 260, 9, 77, 5, 400, 13]
Q8_0_CONFIGS = {"tiny": PORT_TINY_CONFIG, "tiny_mha": TINY_MHA_CONFIG}


@pytest.fixture(autouse=True)
def _xla_reference_paths(monkeypatch):
    # other test modules set this process-wide; the reference model here
    # runs its XLA paths, traced inside each test
    monkeypatch.delenv("GEMMA_TPU_INTERPRET_KERNELS", raising=False)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    cache = {}

    def get(arch):
        if arch not in cache:
            path = make_gguf(tmp_path_factory.mktemp(arch) / "m.gguf", ARCHS[arch],
                             weight_type=GGMLType.Q4_0, seed=7, arch=arch)
            reader = GGUFReader(path)
            jcfg, jparams = jax_load_params(reader)
            tcfg, from_gguf = load_params(reader, device="cpu")
            from_jax = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
            cache[arch] = (jcfg, jparams, tcfg, from_jax, from_gguf)
        return cache[arch]

    return get


@pytest.fixture(scope="module")
def q4_k_m_models(tmp_path_factory):
    """(port GGUF path, reference-quantized path, models) per arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            d = tmp_path_factory.mktemp(f"{arch}_q4_k_m")
            cfg = dataclasses.replace(ARCHS[arch], **KQUANT_WIDTHS)
            path = port_make_gguf(d / "m.gguf", cfg, weight_type="q4_k_m", seed=7, arch=arch)
            f32 = make_gguf(d / "f32.gguf", cfg, weight_type=GGMLType.F32, seed=7, arch=arch)
            args = jax_cli.build_parser().parse_args(
                ["quantize", str(f32), str(d / "ref.gguf"), "--type", "q4_k_m"])
            assert args.fn(args) == 0
            reader = GGUFReader(path)
            jcfg, jparams = jax_load_params(reader)
            tcfg, from_gguf = load_params(reader, device="cpu")
            from_jax = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
            cache[arch] = (path, d / "ref.gguf", (jcfg, jparams, tcfg, from_jax, from_gguf))
        return cache[arch]

    return get


def _engines(models, arch, dtype, max_seq_len=64, batch=1):
    jcfg, jparams, tcfg, from_jax, from_gguf = models(arch)
    jc = dataclasses.replace(jcfg, activation_dtype=dtype)
    tc = dataclasses.replace(tcfg, activation_dtype=dtype)
    je = JaxEngine(jc, jparams, JaxEngineConfig(max_seq_len=max_seq_len, max_batch=batch,
                                                kv_dtype=jnp.dtype(dtype), donate_cache=False))
    ecfg = EngineConfig(max_seq_len=max_seq_len, max_batch=batch, kv_dtype=getattr(torch, dtype))
    return je, Engine(tc, from_jax, ecfg), Engine(tc, from_gguf, ecfg)


def _rel_err(a, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(a, np.float32) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_config_matches_reference(models, arch):
    jcfg, _, tcfg, from_jax, _ = models(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert from_jax.embed.shape == (jcfg.vocab_size, jcfg.d_model)  # vocab padding undone


@pytest.mark.parametrize("arch", list(ARCHS))
def test_f32_prefill_logits_and_greedy_stream(models, arch):
    je, te, ge = _engines(models, arch, "float32")
    ref = np.asarray(je.prefill([PROMPT])[0][0])
    assert _rel_err(te.prefill([PROMPT])[0][0], ref) <= 1e-5
    assert _rel_err(ge.prefill([PROMPT])[0][0], ref) <= 2e-2
    ref_toks = je.generate([PROMPT], 16)[0]
    assert len(ref_toks) == 16
    assert te.generate([PROMPT], 16)[0] == ref_toks
    assert ge.generate([PROMPT], 16)[0] == ref_toks


@pytest.mark.parametrize("arch", list(ARCHS))
def test_bf16_prefill_logits_and_top1(models, arch):
    je, te, ge = _engines(models, arch, "bfloat16")
    ref = np.asarray(je.prefill([PROMPT])[0][0])
    for eng in (te, ge):
        got = eng.prefill([PROMPT])[0][0]
        assert got.dtype == torch.float32
        assert _rel_err(got, ref) <= 5e-2
        assert int(got.argmax()) == int(ref.argmax())


@pytest.mark.parametrize("arch", ["gemma", "gemma2"])
def test_batch2_generations_independent(models, arch):
    """Sequences of different lengths in one batch do not contaminate each
    other, and the batch matches the reference's batch."""
    a, b = [1, 7, 300], [1, 44, 260, 9, 77, 5, 31]
    je, te, _ = _engines(models, arch, "float32", batch=2)
    both = te.generate([a, b], 6)
    assert both == [te.generate([a], 6)[0], te.generate([b], 6)[0]]
    assert both == je.generate([a, b], 6)


def test_dense_checkpoint_matches_reference(tmp_path):
    """F32 matrices load as dense bf16 in both packages: the dense `linear`
    path and dense `from_jax_params` leaves, held like the q4_0 ones."""
    path = make_gguf(tmp_path / "f32.gguf", TINY_CONFIG, weight_type=GGMLType.F32, seed=3)
    reader = GGUFReader(path)
    jcfg, jparams = jax_load_params(reader)
    tcfg, from_gguf = load_params(reader, device="cpu")
    from_jax = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    assert from_gguf.layers[0].attn_qkv.dtype == torch.bfloat16
    jc, tc = (dataclasses.replace(c, activation_dtype="float32") for c in (jcfg, tcfg))
    je = JaxEngine(jc, jparams, JaxEngineConfig(max_seq_len=32, kv_dtype=jnp.float32,
                                                donate_cache=False))
    ref = np.asarray(je.prefill([PROMPT])[0][0])
    for model in (from_jax, from_gguf):
        eng = Engine(tc, model, EngineConfig(max_seq_len=32, kv_dtype=torch.float32))
        assert _rel_err(eng.prefill([PROMPT])[0][0], ref) <= 1e-5


def test_capacity_budget_matches_reference(models):
    je, te, _ = _engines(models, "gemma", "float32", max_seq_len=16)
    out = te.generate([PROMPT], 20)[0]
    assert len(out) == 16 - len(PROMPT)
    assert out == je.generate([PROMPT], 20)[0]
    for eng in (je, te):
        with pytest.raises(ValueError, match="capacity"):
            eng.generate_fused([PROMPT], 20)
    assert list(te.generate_fused([PROMPT], 6)[0]) == out
    assert te.generate([PROMPT], 0) == [[]]


def test_decode_steps_match_full_prefill(models):
    """Logits of incremental decode equal a full prefill's: KV cache slots,
    masks and RoPE offsets line up."""
    _, te, _ = _engines(models, "gemma3", "float32")
    logits, cache = te.prefill([PROMPT[:3]])
    for t in range(3, len(PROMPT)):
        logits, cache = te.decode_step(torch.tensor([PROMPT[t]], dtype=torch.int32), cache)
        full = te.prefill([PROMPT[: t + 1]])[0]
        assert _rel_err(logits, full) <= 1e-5
    assert int(cache.length[0]) == len(PROMPT)


def test_unported_engine_options_raise():
    """Paged, int8 and chunked caches are legal, and speculative scheduling
    refuses a paged cache and sampling that is not greedy with a ValueError,
    as the reference's does. (`serve`'s `roles` and `transport` are ported:
    tests/test_torch_kv_transfer.py and tests/test_torch_multihost.py.)"""
    cfg = PORT_TINY_CONFIG
    eng = Engine(cfg, make_params(cfg, seed=0), EngineConfig(max_seq_len=16))
    paged = Engine(cfg, eng.params, EngineConfig(max_seq_len=16, paged=True, page_size=16))
    with pytest.raises(ValueError, match="dense cache"):
        Scheduler(paged, speculative=True)
    with pytest.raises(ValueError, match="greedy sampling"):
        Scheduler(eng, SamplingParams(temperature=0.7), speculative=True)
    assert Scheduler(eng, speculative=True).spec.k == 7
    ecfg = EngineConfig(paged=True, kv_quantized=True, prefill_chunk=64)
    assert ecfg.page_size == 64
    assert KVCache.create(cfg, 1, 8, quantized=True).quantized


@pytest.mark.parametrize("arch", list(ARCHS))
def test_q4_k_m_gguf_matches_reference_quantize(q4_k_m_models, arch):
    path, ref_path, _ = q4_k_m_models(arch)
    ours, ref = GGUFReader(path), GGUFReader(ref_path)
    assert set(ours.tensors) == set(ref.tensors)
    for ti in ours:
        assert ti.ggml_type == ref.tensors[ti.name].ggml_type, ti.name
        assert bytes(ours.tensor_raw(ti.name)) == bytes(ref.tensor_raw(ti.name)), ti.name
    types = {ti.name: ti.ggml_type for ti in ours}
    assert types["token_embd.weight"] == types["blk.0.attn_v.weight"] == GGMLType.Q6_K
    assert types["blk.0.attn_q.weight"] == types["blk.0.ffn_down.weight"] == GGMLType.Q4_K


@pytest.mark.parametrize("arch", list(ARCHS))
def test_q4_k_m_layout_matches_reference(q4_k_m_models, arch):
    """q|k|v stay unfused (attn_v is q6_k) and gate|up fuse, as in the
    reference; the embedding is q6_k with its vocab padding undone."""
    _, _, (jcfg, jparams, _, from_jax, from_gguf) = q4_k_m_models(arch)
    jl = jparams["layers"][0]
    assert "attn_qkv" not in jl and "ffn_gate_up" in jl and jl["attn_v"].fmt == "q6_k"
    for model in (from_jax, from_gguf):
        layer = model.layers[0]
        assert not layer.has("attn_qkv") and layer.has("ffn_gate_up")
        fmts = {n: getattr(layer, n).fmt for n in ("attn_q", "attn_k", "attn_v", "attn_output",
                                                   "ffn_gate_up", "ffn_down")}
        assert fmts == {"attn_q": "q4_k", "attn_k": "q4_k", "attn_v": "q6_k",
                        "attn_output": "q4_k", "ffn_gate_up": "q4_k", "ffn_down": "q4_k"}
        assert model.embed.fmt == "q6_k" and model.embed.shape == (jcfg.vocab_size, jcfg.d_model)
    for name, buf in from_jax.named_buffers():
        torch.testing.assert_close(buf, dict(from_gguf.named_buffers())[name], rtol=0, atol=0)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_q4_k_m_f32_prefill_logits_and_greedy_stream(q4_k_m_models, arch):
    je, te, ge = _engines(lambda a: q4_k_m_models(a)[2], arch, "float32")
    ref = np.asarray(je.prefill([PROMPT])[0][0])
    for eng in (te, ge):
        assert _rel_err(eng.prefill([PROMPT])[0][0], ref) <= 1e-5
    ref_toks = je.generate([PROMPT], 16)[0]
    assert len(ref_toks) == 16
    assert te.generate([PROMPT], 16)[0] == ref_toks
    assert ge.generate([PROMPT], 16)[0] == ref_toks


@pytest.mark.parametrize("arch", list(ARCHS))
def test_q4_k_m_bf16_prefill_logits_and_top1(q4_k_m_models, arch):
    je, te, ge = _engines(lambda a: q4_k_m_models(a)[2], arch, "bfloat16")
    ref = np.asarray(je.prefill([PROMPT])[0][0])
    for eng in (te, ge):
        got = eng.prefill([PROMPT])[0][0]
        assert _rel_err(got, ref) <= 5e-2
        assert int(got.argmax()) == int(ref.argmax())


def test_make_params_q4_k_m_recipe():
    """The fabricated q4_k_m model has the recipe's formats and stays finite."""
    cfg = dataclasses.replace(PORT_TINY_CONFIG, **KQUANT_WIDTHS)
    model = make_params(cfg, "q4_k_m", seed=0)
    layer = model.layers[0]
    assert isinstance(model.embed, QTensor) and model.embed.fmt == "q6_k"
    assert layer.attn_v.fmt == "q6_k" and layer.ffn_gate_up.fmt == "q4_k"
    assert not layer.has("attn_qkv")
    eng = Engine(cfg, model, EngineConfig(max_seq_len=32))
    logits, _ = eng.prefill([PROMPT])
    assert bool(torch.isfinite(logits).all()) and float(logits.std()) > 0


@pytest.fixture(scope="module")
def q8_0_models(tmp_path_factory):
    """(jcfg, jparams, tcfg, from_jax, from_gguf) of a q8_0 GGUF per config."""
    cache = {}

    def get(name):
        if name not in cache:
            path = port_make_gguf(tmp_path_factory.mktemp(f"{name}_q8_0") / "m.gguf",
                                  Q8_0_CONFIGS[name], weight_type="q8_0", seed=7)
            reader = GGUFReader(path)
            jcfg, jparams = jax_load_params(reader)
            tcfg, from_gguf = load_params(reader, device="cpu")
            from_jax = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
            cache[name] = (jcfg, jparams, tcfg, from_jax, from_gguf)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(Q8_0_CONFIGS))
def test_q8_0_layout_matches_reference(q8_0_models, name):
    """q|k|v and gate|up fuse, as in the reference, and the tied embedding
    is q8_0 with its vocab padding undone."""
    jcfg, jparams, tcfg, from_jax, from_gguf = q8_0_models(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert jparams["layers"][0]["attn_qkv"].fmt == "q8_0"
    for model in (from_jax, from_gguf):
        layer = model.layers[0]
        assert layer.attn_qkv.fmt == layer.ffn_gate_up.fmt == layer.attn_output.fmt == "q8_0"
        assert layer.attn_qkv.shape == (tcfg.q_dim + 2 * tcfg.kv_dim, tcfg.d_model)
        assert layer.attn_output.shape == (tcfg.d_model, tcfg.q_dim)
        assert model.embed.fmt == "q8_0" and model.embed.shape == (tcfg.vocab_size, tcfg.d_model)


@pytest.mark.parametrize("name", list(Q8_0_CONFIGS))
def test_q8_0_f32_prefill_logits_and_greedy_stream(q8_0_models, name):
    je, te, ge = _engines(lambda _: q8_0_models(name), name, "float32")
    ref = np.asarray(je.prefill([PROMPT])[0][0])
    assert _rel_err(te.prefill([PROMPT])[0][0], ref) <= 1e-5
    assert _rel_err(ge.prefill([PROMPT])[0][0], ref) <= 2e-2
    ref_toks = je.generate([PROMPT], 16)[0]
    assert len(ref_toks) == 16
    assert te.generate([PROMPT], 16)[0] == ref_toks
    assert ge.generate([PROMPT], 16)[0] == ref_toks


@pytest.mark.parametrize("name", list(Q8_0_CONFIGS))
def test_q8_0_bf16_prefill_logits_and_top1(q8_0_models, name):
    je, te, ge = _engines(lambda _: q8_0_models(name), name, "bfloat16")
    ref = np.asarray(je.prefill([PROMPT])[0][0])
    for eng in (te, ge):
        got = eng.prefill([PROMPT])[0][0]
        assert _rel_err(got, ref) <= 5e-2
        assert int(got.argmax()) == int(ref.argmax())


def test_make_params_q8_0():
    """The fabricated q8_0 model fuses q|k|v and gate|up, ties a q8_0 head,
    and stays finite on the multi-head geometry."""
    model = make_params(TINY_MHA_CONFIG, "q8_0", seed=0)
    layer = model.layers[0]
    assert model.embed.fmt == layer.attn_qkv.fmt == layer.ffn_gate_up.fmt == "q8_0"
    assert layer.attn_qkv.qs.dtype == torch.int8
    eng = Engine(TINY_MHA_CONFIG, model, EngineConfig(max_seq_len=32))
    logits, _ = eng.prefill([PROMPT])
    assert bool(torch.isfinite(logits).all()) and float(logits.std()) > 0


# sha256 of make_params(TINY_KERNEL_CONFIG, fmt, seed=1)'s buffers by name, as
# drawn before `fill` existed: the default fill="random" keeps every byte
RANDOM_DRAWS = {
    "q4_0": "3f3c0c1e5b83fa779fc2dfe4c6ee2b6dd2517961827601ce3198dcfbb09a3429",
    "q8_0": "46d4ea1194d48aefc758be8edd526de710acb3bab1ef29862c027c4ab48bd459",
    "q4_k_m": "6604486b2b6fa7cbcbf303ccfb1b3cf1aa240063b4bc487a1070ee8589a58ce1",
}
PAYLOADS = {"q4_0": ("qs",), "q8_0": ("qs",), "q4_k": ("qs",), "q6_k": ("ql", "qh")}


def _digest(model) -> str:
    h = hashlib.sha256()
    for name, b in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update((b.view(torch.int16) if b.dtype == torch.bfloat16 else b).contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("fmt", list(RANDOM_DRAWS))
def test_make_params_random_fill_keeps_its_draws(fmt):
    assert _digest(make_params(TINY_KERNEL_CONFIG, fmt, seed=1, fill="random")) == RANDOM_DRAWS[fmt]
    assert _digest(make_params(TINY_KERNEL_CONFIG, fmt, seed=1)) == RANDOM_DRAWS[fmt]


@pytest.mark.parametrize("fmt", list(RANDOM_DRAWS))
def test_make_params_zeros_fill(fmt):
    """fill="zeros": every payload byte 0, every scale the random fill's
    (nonzero), q4_k's sc and mn and q6_k's sub-scales 1; the weights are
    -8 d (q4_0), 0 (q8_0), -dmin (q4_k) and -32 d (q6_k); logits finite."""
    from gemma_tpu_torch.quant.qtensor import dequant, q4_k_group_scales

    zeros = make_params(TINY_KERNEL_CONFIG, fmt, seed=1, fill="zeros")
    drawn = dict(make_params(TINY_KERNEL_CONFIG, fmt, seed=1).named_modules())
    qts = [(name, m) for name, m in zeros.named_modules() if isinstance(m, QTensor)]
    assert len(qts) == len(zeros.layers) * (4 if fmt != "q4_k_m" else 6) + 1
    for name, qt in qts:
        for key, a in qt.arrays.items():
            if key in PAYLOADS[qt.fmt]:
                assert not bool(a.any()), (name, key)
            elif key == "sc":
                assert bool((a == 1).all()), name
            elif key != "scales" or qt.fmt != "q4_k":
                assert torch.equal(a, drawn[name].arrays[key]) and bool((a != 0).all()), (name, key)
        w = dequant(qt)
        if qt.fmt == "q4_0":
            want = -8 * qt.scales.float().repeat_interleave(32, dim=1)
        elif qt.fmt == "q8_0":
            want = torch.zeros_like(w)
        elif qt.fmt == "q4_k":
            sc, mn = q4_k_group_scales(qt.scales, qt.dm)
            assert torch.equal(sc, qt.dm[..., 0:1].float().expand_as(sc))  # every sc 1
            want = -mn.reshape(w.shape[0], -1).repeat_interleave(32, dim=1)  # every mn 1: -dmin
            assert torch.equal(mn, qt.dm[..., 1:2].float().expand_as(mn))
        else:
            want = -32 * qt.d.float().repeat_interleave(256, dim=1)
        torch.testing.assert_close(w, want, rtol=1e-6, atol=0)
    logits, _ = Engine(TINY_KERNEL_CONFIG, zeros, EngineConfig(max_seq_len=32)).prefill([PROMPT])
    assert bool(torch.isfinite(logits).all())


def test_make_params_zeros_fill_refuses_centred_and_shards():
    with pytest.raises(ValueError, match="neither centred nor tp"):
        make_params(TINY_KERNEL_CONFIG, fill="zeros", centred=True)
    with pytest.raises(ValueError, match="neither centred nor tp"):
        make_params(TINY_KERNEL_CONFIG, fill="zeros", tp=(0, 2))
    with pytest.raises(ValueError, match="fills"):
        make_params(TINY_KERNEL_CONFIG, fill="ones")
