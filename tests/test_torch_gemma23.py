"""Gemma-2 and Gemma-3 at the CUDA kernels' widths: the port against the JAX
package.

`TINY_GEMMA2_KERNEL_CONFIG` (sandwich norms, both softcaps, a 16-key window
on even layers, 4 query heads over 2 KV heads) and
`TINY_GEMMA3_KERNEL_CONFIG` (QK-norm, sandwich norms, five sliding layers
to one global, rope bases 1e6 and 1e4 with linear scale 1/8 on the global
layer, 4 query heads over 1 KV head) keep head_dim 128, which the CUDA
attention kernels take, so `chip_smoke.py` phase 5 runs the same configs on
the card. One GGUF per (config, format) from the port's
`make_gguf(..., arch=)` is read by both packages. q4_k_m loads from it in
both; q4_0 and q8_0 reach the port through `from_jax_params`, because the
port's own load keeps ggml's exact f16 scales where the reference rounds
them to bf16 (ROADMAP, "Expected differences"). The JAX model runs its XLA
paths (GEMMA_TPU_INTERPRET_KERNELS unset); the port its plain versions.

Tolerances, of the largest |logit|: f32 prefill logits 1e-5 (the same
arithmetic up to the order of f32 sums), and 30-token greedy streams from a
20-token prompt equal, past the 16-key window, over a dense and a paged
cache; bf16 5e-2 with the prompt's last top-1 equal (the same rounding
points on inputs that differ in their last bits).

The lane-by-lane emulations of the kernels (`tools/tc_emulation.py`) are
held to the plain versions at the shapes these models give them: the
tensor-core decode core at G = 2 and D = 256 with softcap and window
(Gemma-2-2B's and Gemma-3-4B's heads), through a page table, flash over a
chunk that crosses the window's lower edge, and q4_k's GEMV at an odd count
of superblocks (Gemma-2-2B's K = 2304 is nine).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gemma_tpu.gguf import GGUFReader
from gemma_tpu.models.params import load_params as jax_load_params
from gemma_tpu.runtime import Engine as JaxEngine
from gemma_tpu.runtime import EngineConfig as JaxEngineConfig
from gemma_tpu_torch import testing
from gemma_tpu_torch.models import from_jax_params, load_params
from gemma_tpu_torch.ops.attention import (decode_attention_plain, decode_route,
                                           flash_attention_plain)
from gemma_tpu_torch.ops.paged_attention import gather_pages
from gemma_tpu_torch.ops.quant_matmul import PLAIN
from gemma_tpu_torch.runtime import Engine, EngineConfig
from gemma_tpu_torch.tools import tc_emulation as emu
from gemma_tpu_torch.tools._timing import attn_err, random_qtensor
from gemma_tpu_torch.utils.verify import verify_device_kernels

CONFIGS = {"gemma2": testing.TINY_GEMMA2_KERNEL_CONFIG, "gemma3": testing.TINY_GEMMA3_KERNEL_CONFIG}
FORMATS = ("q4_0", "q4_k_m", "q8_0")
PROMPT = [2 + (i * 37) % 500 for i in range(20)]  # 20 tokens, past the 16-key window
NEW_TOKENS = 30
MAX_SEQ_LEN = 64
PAGE = 16
CASES = [(arch, fmt) for arch in CONFIGS for fmt in FORMATS]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # the tiny models' decode steps are many small ops: one intra-op thread
    # runs them fastest, and keeps this file from crowding other workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _xla_reference_paths(monkeypatch):
    # other test modules set this process-wide; the reference model here
    # runs its XLA paths
    monkeypatch.delenv("GEMMA_TPU_INTERPRET_KERNELS", raising=False)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(path, jcfg, jparams, tcfg, port model, f32 reference) per (arch,
    format); the f32 reference is the JAX Engine's prefill logits and
    greedy stream."""
    cache = {}

    def get(arch, fmt):
        if (arch, fmt) not in cache:
            path = testing.make_gguf(tmp_path_factory.mktemp(f"{arch}_{fmt}") / "m.gguf",
                                     CONFIGS[arch], weight_type=fmt, seed=7, arch=arch)
            reader = GGUFReader(path)
            jcfg, jparams = jax_load_params(reader)
            if fmt == "q4_k_m":
                tcfg, model = load_params(reader, device="cpu")
            else:
                tcfg = load_params(reader, device="cpu")[0]
                model = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
            je = JaxEngine(dataclasses.replace(jcfg, activation_dtype="float32"), jparams,
                           JaxEngineConfig(max_seq_len=MAX_SEQ_LEN, kv_dtype=jnp.float32,
                                           donate_cache=False))
            ref = (np.asarray(je.prefill([PROMPT])[0][0]), je.generate([PROMPT], NEW_TOKENS)[0])
            cache[arch, fmt] = (path, jcfg, jparams, tcfg, model, ref)
        return cache[arch, fmt]

    return get


def _rel_err(a, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(a, np.float32) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("arch,fmt", CASES)
def test_config_from_the_gguf(models, arch, fmt):
    """Both packages read the config that was written, every Gemma-2/3
    field included (rms_eps as the file's f32)."""
    _, jcfg, _, tcfg, _, _ = models(arch, fmt)
    assert tcfg == dataclasses.replace(CONFIGS[arch], rms_eps=float(np.float32(CONFIGS[arch].rms_eps)))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("arch,fmt", CASES)
def test_f32_prefill_logits_and_greedy_stream(models, arch, fmt, cache):
    _, _, _, tcfg, model, (ref_logits, ref_toks) = models(arch, fmt)
    ecfg = EngineConfig(max_seq_len=MAX_SEQ_LEN, kv_dtype=torch.float32, paged=cache == "paged",
                        page_size=PAGE)
    eng = Engine(dataclasses.replace(tcfg, activation_dtype="float32"), model, ecfg)
    assert _rel_err(eng.prefill([PROMPT])[0][0], ref_logits) <= 1e-5
    assert len(ref_toks) == NEW_TOKENS
    assert eng.generate([PROMPT], NEW_TOKENS)[0] == ref_toks


@pytest.mark.parametrize("arch,fmt", CASES)
def test_bf16_prefill_logits_and_top1(models, arch, fmt):
    _, jcfg, jparams, tcfg, model, _ = models(arch, fmt)
    je = JaxEngine(jcfg, jparams, JaxEngineConfig(max_seq_len=MAX_SEQ_LEN, donate_cache=False))
    ref = np.asarray(je.prefill([PROMPT])[0][0])
    got = Engine(tcfg, model, EngineConfig(max_seq_len=MAX_SEQ_LEN)).prefill([PROMPT])[0][0]
    assert _rel_err(got, ref) <= 5e-2
    assert int(got.argmax()) == int(ref.argmax())


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_verify_device_kernels_prefills_in_chunks(models, arch):
    """`verify_device_kernels(prefill_chunk=)` (chip_smoke.py phase 4d's
    long prompts) prefills both sides in chunks; on the CPU both sides are
    the plain versions (|d| 0) and its stream is the chunking Engine's
    greedy stream, past the window."""
    _, _, _, tcfg, model, _ = models(arch, "q4_0")
    res = verify_device_kernels(tcfg, model, PROMPT, n_decode=8, max_seq_len=MAX_SEQ_LEN, prefill_chunk=8)
    assert res["ok"] and res["max_abs"] == 0 and len(res["stream"]) == 8
    eng = Engine(tcfg, model, EngineConfig(max_seq_len=MAX_SEQ_LEN, prefill_chunk=8))
    assert res["stream"] == eng.generate([PROMPT], 8)[0]


NORMS = {"gemma2": ("post_attention_norm", "post_ffw_norm"),
         "gemma3": ("post_attention_norm", "post_ffw_norm", "attn_q_norm", "attn_k_norm")}


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_from_jax_params_carries_the_gemma23_norms(models, arch):
    """The sandwich norms (and Gemma-3's QK-norms) reach the port through
    `from_jax_params` with the reference's values, which are the GGUF's."""
    path, _, jparams, tcfg, model, _ = models(arch, "q4_0")
    from_gguf = load_params(GGUFReader(path), device="cpu")[1]
    for i, layer in enumerate(model.layers):
        for name in NORMS[arch]:
            got = getattr(layer, name).weight
            assert torch.equal(got, torch.from_numpy(np.array(jparams["layers"][i][name], np.float32)))
            assert torch.equal(got, getattr(from_gguf.layers[i], name).weight)
        assert {n for n in layer._modules if "norm" in n} == {"attn_norm", "ffn_norm", *NORMS[arch]}


@pytest.mark.parametrize("arch", ["gemma", *CONFIGS])
@pytest.mark.parametrize("fmt", FORMATS)
def test_make_params_has_the_names_and_shapes_of_load_params(tmp_path, arch, fmt):
    cfg = CONFIGS.get(arch, testing.TINY_KERNEL_CONFIG)
    path = testing.make_gguf(tmp_path / "m.gguf", cfg, weight_type=fmt, seed=1, arch=arch)
    loaded = load_params(GGUFReader(path), device="cpu")[1]
    made = testing.make_params(cfg, fmt, seed=1, arch=arch)

    def layout(model):
        return {n: (tuple(b.shape), b.dtype) for n, b in model.named_buffers()}

    assert layout(made) == layout(loaded)
    made_fmts = {n: m.fmt for n, m in made.named_modules() if hasattr(m, "fmt")}
    assert made_fmts == {n: m.fmt for n, m in loaded.named_modules() if hasattr(m, "fmt")}


@pytest.mark.parametrize("centred", [False, True])
def test_make_params_q4_0_weights(centred):
    """q4_0's fabricated nibbles: uniform in 0..15 by default (weights with
    a mean of -0.5 nibble steps, 11 % of their spread), in 1..15 with
    `centred` (no mean: chip_smoke.py phase 4d's windows move the output
    only on such weights); a weight's spread about 1 / sqrt(K) either way."""
    from gemma_tpu_torch.quant.qtensor import dequant

    qt = testing.make_params(testing.TINY_KERNEL_CONFIG, "q4_0", seed=3,
                             centred=centred).layers[0].ffn_gate_up
    nib = torch.cat([qt.qs & 15, qt.qs >> 4])
    assert int(nib.min()) == (1 if centred else 0) and int(nib.max()) == 15
    w = dequant(qt, torch.float32)
    mean = float(w.mean()) / float(w.std())
    assert abs(mean) < 0.02 if centred else -0.13 < mean < -0.09
    assert 0.9 < float(w.std()) * 256 ** 0.5 < 1.1


def test_make_params_refuses_an_unknown_arch():
    with pytest.raises(ValueError, match="architectures"):
        testing.make_params(testing.TINY_KERNEL_CONFIG, arch="gemma4")


# (config, vocab, d_model, layers, heads, KV heads, head_dim, d_ff, window,
# pattern, attention softcap, final softcap, rope base, local rope base,
# rope scale): the published config.json widths
FULL_WIDTH = [
    (testing.GEMMA2_2B, 256000, 2304, 26, 8, 4, 256, 9216, 4096, 2, 50.0, 30.0, 10000.0, 0.0, 1.0),
    (testing.GEMMA3_4B, 262144, 2560, 34, 8, 4, 256, 10240, 1024, 6, 0.0, 0.0, 1e6, 1e4, 1 / 8),
]


@pytest.mark.parametrize("row", FULL_WIDTH, ids=["Gemma-2-2B", "Gemma-3-4B"])
def test_full_width_configs_hold_the_published_widths(row):
    cfg, *want = row
    assert [cfg.vocab_size, cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.sliding_window, cfg.swa_pattern, cfg.attn_softcap, cfg.final_softcap,
            cfg.rope_base, cfg.rope_base_swa, cfg.rope_scale] == want
    assert cfg.effective_query_scale == 256 ** -0.5
    assert cfg.q_dim == 2048 != cfg.d_model and cfg.n_heads // cfg.n_kv_heads == 2
    # every K a whole number of q4_k superblocks (Gemma-2-2B's d_model: nine)
    assert all(k % 256 == 0 for k in (cfg.d_model, cfg.q_dim, cfg.d_ff))
    sliding = [cfg.layer_window(i) > 0 for i in range(cfg.n_layers)]
    assert sliding == [i % cfg.swa_pattern != cfg.swa_pattern - 1 for i in range(cfg.n_layers)]
    assert cfg.layer_rope(cfg.swa_pattern - 1) == (cfg.rope_base, cfg.rope_scale)
    assert cfg.layer_rope(0) == (cfg.rope_base_swa or cfg.rope_base, 1.0)
    # bf16 queries at G = 2 take the tensor-core decode core
    assert decode_route(torch.bfloat16, 2, 4608)[0] == "tc"


def _qkv(B, T, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.3).to(torch.bfloat16)
            for s in ((B, T, Hq, D), (B, Hkv, S, D), (B, Hkv, S, D))]


# Gemma-2-2B's and Gemma-3-4B's heads (8 over 4, D = 256) on the decode
# core, windows that bind, split as the route sets it at these S: B, S,
# limits, softcap, window
DECODE_CASES = [(1, 320, [300], 50.0, 96), (2, 256, [200, 40], 0.0, 64)]


@pytest.mark.parametrize("B,S,limits,cap,window", DECODE_CASES)
def test_decode_core_at_g2_d256_matches_plain(B, S, limits, cap, window):
    q, k, v = _qkv(B, 1, S, 8, 4, 256, seed=S)
    lim = torch.tensor(limits, dtype=torch.int32)
    split = decode_route(torch.bfloat16, 2, S)[1]
    ref = decode_attention_plain(q, k, v, lim, cap, window)
    got = torch.from_numpy(emu.decode(q, k, v, lim, cap, window, split=split))
    assert attn_err(got, ref, 2e-2)[1] <= 1.0
    # through 64-key pages, shuffled over the pool: the same tiles, bit for bit
    ps, maxp = 64, -(-S // 64)
    perm = torch.from_numpy(np.random.default_rng(5).permutation(B * maxp) + 1).to(torch.int32)
    table = perm.reshape(B, maxp)
    kp = torch.zeros(B * maxp + 1, 4, ps, 256, dtype=torch.bfloat16)
    vp = torch.zeros_like(kp)
    for b in range(B):
        for j in range(maxp):
            kp[table[b, j]] = k[b, :, j * ps:(j + 1) * ps]
            vp[table[b, j]] = v[b, :, j * ps:(j + 1) * ps]
    assert torch.equal(gather_pages(kp, table), k) and torch.equal(gather_pages(vp, table), v)
    paged = emu.paged_decode(q, kp, vp, table, lim, cap, window, split=split)
    assert np.array_equal(paged, got.numpy())


@pytest.mark.parametrize("pos0,T,limit,cap,window", [(80, 32, 112, 50.0, 96), (48, 32, 80, 0.0, 64)])
def test_flash_over_a_chunk_across_the_window_edge_matches_plain(pos0, T, limit, cap, window):
    """A prefill chunk at positions pos0.. whose first rows see every key and
    whose later rows lose keys below the window (Gemma-2-2B's and Gemma-3-4B's
    heads)."""
    q, k, v = _qkv(1, T, 128, 8, 4, 256, seed=pos0)
    positions = (pos0 + torch.arange(T, dtype=torch.int32))[None]
    lim = torch.tensor([limit], dtype=torch.int32)
    ref = flash_attention_plain(q, k, v, positions, lim, cap, window)
    got = torch.from_numpy(emu.flash(q, k, v, positions, lim, cap, window))
    assert attn_err(got, ref, 2e-2)[1] <= 1.0


@pytest.mark.parametrize("M", [1, 8])
@pytest.mark.parametrize("N", [19, 40])
def test_q4_k_gemv_at_an_odd_superblock_count_matches_plain(N, M):
    gen = torch.Generator().manual_seed(N + M)
    qt = random_qtensor("q4_k", N, 2304, gen, "cpu")
    for x in (torch.randn(M, 2304, generator=gen).to(torch.bfloat16), torch.randn(M, 2304, generator=gen)):
        ref = PLAIN["q4_k"](x, qt).numpy()
        assert np.abs(emu.gemv(x, qt) - ref).max() <= 1e-5 * np.abs(ref).max()
