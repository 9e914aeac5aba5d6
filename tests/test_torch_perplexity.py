"""The port's perplexity (`gemma_tpu_torch/utils/perplexity.py`, the CLI
`perplexity`) against the JAX package, and the Δppl gate against ggml's
arithmetic.

* `evaluate` on an F32 GGUF (`TINY_CONFIG`; both packages load its
  matrices as dense bf16): f32 activations give identical products, summed
  in another order, so |Δnll| <= 1e-5 of the NLL, and the scored token
  count is equal, with a partial tail window too (80 tokens, ctx 32: the
  reference pads the tail and masks it, the port runs it at its own
  length). bf16 activations round at the same points from inputs that can
  differ in their last bit: 1e-3 of the NLL (measured 1.7e-5; f32
  measured 5-7e-8).
* The Δppl gate (`tools/ppl_gate.py`): the port evaluating a ggml-quantized
  checkpoint against the independent numpy forward (`ref_numpy_gemma`,
  ggml's f32 arithmetic on the reference's `numpy_ref` dequant) of the same
  checkpoint. The port keeps ggml's exact f16 scales, so only the order of
  f32 sums differs: the bound is 1e-4 of the reference ppl, where the JAX
  package's CI gate (bf16 scales, `tests/test_utils.py`) allows 4e-3. At
  the gate's own configuration (vocab 2048, d_model 512, 4 layers) on a
  corpus sampled from the f32 model at temperature 0.8, the absolute gate
  |Δppl| <= 0.05 holds too, with the same relative bound. The gate lives
  here and not in a port tool: it reads the numpy forward from `tests/`,
  which the port's sources may not import.
"""
import json
import math

import numpy as np
import pytest
import torch

import ref_numpy_gemma
from gemma_tpu import cli as jax_cli
from gemma_tpu.gguf import GGUFReader
from gemma_tpu.models import load_params as jax_load_params
from gemma_tpu.models.config import GemmaConfig as JaxGemmaConfig
from gemma_tpu.quant import numpy_ref as ref_numpy_codecs
from gemma_tpu.utils import perplexity as jax_perplexity
from gemma_tpu_torch import cli
from gemma_tpu_torch.models import load_params
from gemma_tpu_torch.models.config import GemmaConfig
from gemma_tpu_torch.runtime import Engine, EngineConfig, SamplingParams
from gemma_tpu_torch.testing import TINY_CONFIG, make_gguf
from gemma_tpu_torch.utils import perplexity

# tests/test_utils.py's Δppl configuration (every K a multiple of 256)
GATE_TEST_CFG = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
                     head_dim=64, d_ff=256, context_length=128)
# tools/ppl_gate.py's CFG, CTX and N_TOKENS
PPL_GATE_CFG = dict(vocab_size=2048, d_model=512, n_layers=4, n_heads=8, n_kv_heads=2,
                    head_dim=64, d_ff=1024, context_length=512)
PPL_GATE_CTX, PPL_GATE_TOKENS = 128, 384
GATE_FORMATS = ("q4_0", "q8_0", "q4_k")


@pytest.fixture(autouse=True)
def _xla_reference_paths(monkeypatch):
    # other test modules set this process-wide; the reference runs its XLA paths
    monkeypatch.delenv("GEMMA_TPU_INTERPRET_KERNELS", raising=False)


@pytest.fixture(scope="module")
def f32_models(tmp_path_factory):
    path = make_gguf(tmp_path_factory.mktemp("ppl") / "m.gguf", TINY_CONFIG, weight_type="f32",
                     seed=3)
    reader = GGUFReader(path)
    jcfg, jparams = jax_load_params(reader, mode="dequant")
    tcfg, model = load_params(reader, device="cpu")
    return path, jcfg, jparams, tcfg, model


@pytest.mark.parametrize("n_tokens,ctx,stride,precision,rel", [
    (33, 33, None, "float32", 1e-5),  # one whole window
    (80, 32, None, "float32", 1e-5),  # two windows and a 16-token tail
    (80, 32, 24, "float32", 1e-5),  # overlapping windows
    (80, 32, None, "bfloat16", 1e-3),
])
def test_evaluate_matches_reference(f32_models, n_tokens, ctx, stride, precision, rel):
    _, jcfg, jparams, tcfg, model = f32_models
    toks = np.random.default_rng(0).integers(260, 500, size=n_tokens).astype(np.int32)
    ref = jax_perplexity.evaluate(jparams, jcfg, toks, ctx=ctx, stride=stride, precision=precision)
    got = perplexity.evaluate(model, tcfg, toks, ctx=ctx, stride=stride, precision=precision)
    assert got.n_tokens == ref.n_tokens
    assert abs(got.nll - ref.nll) <= rel * ref.nll, (got, ref)
    assert got.ppl == pytest.approx(math.exp(got.nll))
    assert tcfg.activation_dtype == "bfloat16"  # the caller's config is left as it was


def _numpy_ppl(reader, cfg, toks: np.ndarray, ctx: int) -> float:
    """tools/ppl_gate.py's `numpy_ppl`: the same windows through the numpy
    forward on the reference codecs' dequantized weights."""
    weights = {ti.name: ref_numpy_codecs.dequantize(reader.tensor_raw(ti.name), ti.ggml_type,
                                                    ti.shape) for ti in reader}
    total, n = 0.0, 0
    for start in range(0, max(1, len(toks) - 1), ctx):
        window = toks[start : start + ctx]
        if len(window) < 2:
            break
        logits = ref_numpy_gemma.forward(weights, cfg, list(window))[:-1].astype(np.float64)
        logits -= logits.max(axis=-1, keepdims=True)
        logp = logits - np.log(np.exp(logits).sum(axis=-1, keepdims=True))
        total += -logp[np.arange(len(window) - 1), window[1:]].sum()
        n += len(window) - 1
    return math.exp(total / n)


@pytest.mark.parametrize("fmt", GATE_FORMATS)
def test_delta_ppl_vs_ggml_reference(tmp_path, fmt):
    """tests/test_utils.py's gate shape: random tokens (ppl ~ 1e4, where
    only a relative bound means anything), ctx 64, f32 activations."""
    cfg = GemmaConfig(**GATE_TEST_CFG)
    toks = np.random.default_rng(2).integers(260, 500, size=96).astype(np.int32)
    path = make_gguf(tmp_path / f"{fmt}.gguf", cfg, weight_type=fmt, seed=5, scale=0.08)
    reader = GGUFReader(path)
    tcfg, model = load_params(reader, device="cpu")
    ppl = perplexity.evaluate(model, tcfg, toks, ctx=64).ppl
    ref = _numpy_ppl(reader, JaxGemmaConfig(**GATE_TEST_CFG), toks, 64)
    assert abs(ppl - ref) <= 1e-4 * ref, (fmt, ppl, ref)


@pytest.fixture(scope="module")
def gate_corpus(tmp_path_factory):
    """tools/ppl_gate.py's corpus: PPL_GATE_TOKENS tokens sampled from the
    f32 checkpoint (seed 7, scale 0.08) at temperature 0.8, top-k 64, in
    runs that each fit one PPL_GATE_CTX window, by the port's engine."""
    d = tmp_path_factory.mktemp("gate")
    cfg = GemmaConfig(**PPL_GATE_CFG)
    path = make_gguf(d / "f32.gguf", cfg, weight_type="f32", seed=7, scale=0.08)
    tcfg, model = load_params(GGUFReader(path), device="cpu", mode="dequant")
    eng = Engine(tcfg, model, EngineConfig(max_seq_len=PPL_GATE_CTX))
    corpus = [1]
    while len(corpus) < PPL_GATE_TOKENS:
        k = PPL_GATE_CTX - 1
        room = k - (len(corpus) % k) if len(corpus) % k else k
        corpus += eng.generate([corpus[-min(len(corpus), 8):]],
                               max_new_tokens=min(room, PPL_GATE_TOKENS - len(corpus)),
                               sampling=SamplingParams(temperature=0.8, top_k=64),
                               seed=len(corpus))[0]
    return d, cfg, np.asarray(corpus[:PPL_GATE_TOKENS], np.int32)


@pytest.mark.parametrize("fmt", GATE_FORMATS)
def test_delta_ppl_gate_at_the_gate_config(gate_corpus, fmt):
    """The absolute gate, |Δppl| <= 0.05, at tools/ppl_gate.py's
    configuration and corpus (a model-sampled corpus, ppl of a few hundred
    at most, where 0.05 is a real bound); and 1e-4 relative."""
    d, cfg, toks = gate_corpus
    path = make_gguf(d / f"{fmt}.gguf", cfg, weight_type=fmt, seed=7, scale=0.08)
    reader = GGUFReader(path)
    tcfg, model = load_params(reader, device="cpu")
    ppl = perplexity.evaluate(model, tcfg, toks, ctx=PPL_GATE_CTX).ppl
    ref = _numpy_ppl(reader, JaxGemmaConfig(**PPL_GATE_CFG), toks, PPL_GATE_CTX)
    assert ref < 1e3, ref  # a peaked corpus, not uniform-vocab noise
    assert abs(ppl - ref) <= 0.05, (fmt, ppl, ref)
    assert abs(ppl - ref) <= 1e-4 * ref, (fmt, ppl, ref)


@pytest.mark.parametrize("mode", ["quantized", "dequant"])
def test_cli_perplexity_matches_reference_cli(tmp_path, capsys, mode):
    """`python -m gemma_tpu_torch perplexity --device cpu` prints the
    reference CLI's keys; the token count is equal and the perplexity
    within 1e-5 of it in dequant mode (the same bf16 weights, f32
    activations; measured 9e-8). Quantized, the reference's CPU path
    rounds q4_0 scales and then each dequantized weight to bf16 where the
    port keeps ggml's f16 scales and f32 weights: 2e-3 (measured 1.4e-4)."""
    path = make_gguf(tmp_path / "m.gguf", TINY_CONFIG, seed=3)
    text = tmp_path / "corpus.txt"
    text.write_text("hello world the hello world of worlds " * 12)
    common = ["--text-file", str(text), "--window", "32", "--mode", mode]
    assert cli.main(["perplexity", str(path), "--device", "cpu", *common]) == 0
    ours = json.loads(capsys.readouterr().out)
    args = jax_cli.build_parser().parse_args(["perplexity", str(path), *common])
    assert args.fn(args) == 0
    ref = json.loads(capsys.readouterr().out)
    assert set(ours) == set(ref) == {"perplexity", "tokens"}
    assert ours["tokens"] == ref["tokens"] > 32
    rel = 1e-5 if mode == "dequant" else 2e-3
    assert ours["perplexity"] == pytest.approx(ref["perplexity"], rel=rel)


def test_evaluate_runs_where_the_weights_lie(f32_models, monkeypatch):
    """The windows go to the model's device; with the weights on the CPU
    nothing touches CUDA."""
    _, _, _, tcfg, model = f32_models
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("synchronized CUDA"))
    res = perplexity.evaluate(model, tcfg, list(range(260, 300)), ctx=16)
    assert res.n_tokens == 15 + 15 + 7 and math.isfinite(res.ppl)
