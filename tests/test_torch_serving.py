"""Continuous-batching serving: the port's Scheduler, serve() and CLI `serve`
against the JAX package's, on a tiny model.

One q4_0 GGUF of `TINY_KERNEL_CONFIG` (head_dim 128, the smallest the
reference's paged kernel takes) is loaded into the JAX package and carried
into the port by `from_jax_params`; both run f32 activations. The
reference's Scheduler runs its Pallas decode and paged kernels in interpret
mode (GEMMA_TPU_INTERPRET_KERNELS=1, pinned while it runs), the port its
plain versions. Four cache arms: dense and paged, each with the cache in
the activation dtype (f32) or int8.

Greedy streams must be identical per request: with f32 activations both
packages compute the same numbers up to the order of f32 sums (the
weights' tolerance is 1e-5 in tests/test_torch_model.py), and the int8
arms quantize bit for bit alike and round p * vs to bf16 at the same point
(tests/test_torch_attention.py). A request's stream does not depend on how
it was scheduled (batch neighbours, block size, chunked or overlapped
admission, a separate prefill engine, waiting for pages), so each
scheduling scenario is held against the one reference run of its arm.

One more scenario serves a q8_0 GGUF of `TINY_MHA_CONFIG` (multi-head, one
query head per KV head, as Gemma-7B) on the dense f32 cache, held to the
reference's streams the same way.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gemma_tpu import cli as jax_cli
from gemma_tpu.gguf import GGUFReader
from gemma_tpu.models.params import load_params as jax_load_params
from gemma_tpu.runtime import Engine as JaxEngine
from gemma_tpu.runtime import EngineConfig as JaxEngineConfig
from gemma_tpu.runtime.scheduler import Request as JaxRequest
from gemma_tpu.runtime.scheduler import Scheduler as JaxScheduler
from gemma_tpu_torch import cli
from gemma_tpu_torch.models import from_jax_params, load_params
from gemma_tpu_torch.runtime import Engine, EngineConfig, Request, Scheduler, serve
from gemma_tpu_torch.testing import TINY_KERNEL_CONFIG, TINY_MHA_CONFIG, make_gguf

MAX_SEQ_LEN = 64
PAGE = 16
CHUNK = 16
# id -> (prompt, max_new_tokens): short prompts (T < page), an exact page
# multiple, chunked (<= 2 chunks) and overlapped (> 2 chunks) admissions;
# "long" and "idle" make the idle-slot scenario
REQUESTS = {
    "a": ([1, 7, 300], 10),
    "b": ([1, 44, 260, 9, 77], 10),
    "c": (list(range(3, 19)), 10),
    "d": ([1, 33], 10),
    "e": (list(range(5, 35)), 10),
    "f": (list(range(40, 80)), 10),
    "long": ([1, 5, 311], 50),
    "idle": (list(range(100, 130)), 2),
}
# waits for pages it can never get: finishes empty
NEVER_FITS = {"huge": (list(range(2, 62)), 10)}
ARMS = {  # name -> (paged, kv_quantized)
    "dense": (False, False),
    "dense_int8": (False, True),
    "paged": (True, False),
    "paged_int8": (True, True),
}


@pytest.fixture(autouse=True)
def _xla_reference_paths(monkeypatch):
    # other modules set this process-wide; the reference runs its kernels
    # only inside `reference_streams`
    monkeypatch.delenv("GEMMA_TPU_INTERPRET_KERNELS", raising=False)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = make_gguf(tmp_path_factory.mktemp("serving") / "tiny.gguf", TINY_KERNEL_CONFIG, seed=3)
    reader = GGUFReader(path)
    jcfg, jparams = jax_load_params(reader)
    tcfg, _ = load_params(reader, device="cpu")
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    jcfg, tcfg = (dataclasses.replace(c, activation_dtype="float32") for c in (jcfg, tcfg))
    return path, jcfg, jparams, tcfg, model


def _jax_engine(tiny, arm):
    _, jcfg, jparams, _, _ = tiny
    paged, quant = ARMS[arm]
    return JaxEngine(jcfg, jparams, JaxEngineConfig(
        max_seq_len=MAX_SEQ_LEN, max_batch=3, kv_dtype=jnp.float32, kv_quantized=quant,
        paged=paged, page_size=PAGE, prefill_chunk=CHUNK, donate_cache=False))


def _engine(tiny, arm, **kw):
    _, _, _, tcfg, model = tiny
    paged, quant = ARMS[arm]
    ecfg = dict(max_seq_len=MAX_SEQ_LEN, max_batch=3, kv_dtype=torch.float32, kv_quantized=quant,
                paged=paged, page_size=PAGE, prefill_chunk=CHUNK) | kw
    return Engine(tcfg, model, EngineConfig(**ecfg))


@pytest.fixture(scope="module")
def reference_streams(tiny):
    """The JAX Scheduler's stream of every request, per arm (block 4)."""
    cache = {}

    def get(arm):
        if arm not in cache:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")
                sched = JaxScheduler(_jax_engine(tiny, arm))
                for rid, (prompt, n) in REQUESTS.items():
                    sched.submit(JaxRequest(rid, prompt, max_new_tokens=n))
                sched.run(block=4)
            cache[arm] = ({r.id: r.tokens for r in sched.finished}, sched.stats())
        return cache[arm]

    return get


def _run(sched: Scheduler, ids, block) -> dict:
    for rid in ids:
        sched.submit(Request(rid, *(REQUESTS | NEVER_FITS)[rid]))
    if block == "step_block":
        while len(sched.finished) < len(ids):
            sched.step_block(3)
    else:
        sched.run(block=block)
    return {r.id: r.tokens for r in sched.finished}


@pytest.mark.parametrize("arm", list(ARMS))
def test_serve_matches_reference_scheduler(tiny, reference_streams, arm):
    """serve() over every request at block 4: the reference's streams, and
    its decode steps and discarded tokens (the same scheduling policy)."""
    ref, ref_stats = reference_streams(arm)
    assert all(len(ref[rid]) == n for rid, (_, n) in REQUESTS.items())
    sched = serve(_engine(tiny, arm), [Request(rid, *REQUESTS[rid]) for rid in REQUESTS], block=4)
    assert {r.id: r.tokens for r in sched.finished} == ref
    stats = sched.stats()
    for key in ("requests", "decode_steps", "tokens_discarded", "total_tokens"):
        assert stats[key] == ref_stats[key], key
    assert stats["p50_ttft_s"] is not None and stats["p99_ttft_s"] >= stats["p50_ttft_s"]


def _scenario(tiny, arm, name):
    """(scheduler, request ids, block, expected overrides) of one scenario."""
    ids = ["a", "b", "c", "d", "e", "f"]
    if name == "per_token":
        return Scheduler(_engine(tiny, arm)), ids, 1, {}
    if name == "synchronous_chunks":  # long prompts prefill in chunks at admission
        return Scheduler(_engine(tiny, arm), overlap_admission=False), ids, 4, {}
    if name == "disaggregated":  # admissions on a second engine of another geometry
        pre = _engine(tiny, arm, max_seq_len=128, max_batch=1, paged=False, prefill_chunk=32)
        return Scheduler(_engine(tiny, arm, max_batch=2), prefill_engine=pre), ids, 4, {}
    if name == "step_block":  # unpipelined blocks of 3, driven by hand
        return Scheduler(_engine(tiny, arm)), ids, "step_block", {}
    if name == "slot_reuse":  # one slot serves every request in turn
        return Scheduler(_engine(tiny, arm, max_batch=1)), ids, 2, {}
    if name == "admit_per_tick":  # one admission a tick, every prompt prefilled whole
        return Scheduler(_engine(tiny, arm), admit_per_tick=1, overlap_admission=False), ids, 4, {}
    if name == "admit_per_tick_overlapped":  # one a tick; "e" and "f" admit chunk by chunk
        return Scheduler(_engine(tiny, arm), admit_per_tick=1), ids, 4, {}
    if name == "pool_exhaustion":  # 4 usable pages: requests wait for pages
        # "huge" needs 5 pages: it can never fit and finishes empty
        return Scheduler(_engine(tiny, arm, n_pages=5)), ids + ["huge"], 4, {"huge": []}
    # the idle-slot repair: "idle" finishes after 2 tokens, and its slot
    # decodes ~48 more ticks while "long" runs, past the 64 slots of its row
    assert name == "idle_slot"
    return Scheduler(_engine(tiny, arm, max_batch=2)), ["idle", "long"], 1, {}


SCENARIOS = ["per_token", "step_block", "synchronous_chunks", "disaggregated", "slot_reuse",
             "pool_exhaustion", "idle_slot", "admit_per_tick", "admit_per_tick_overlapped"]


@pytest.mark.parametrize("arm,scenario", [(a, s) for a in ARMS for s in SCENARIOS
                                          if s != "pool_exhaustion" or ARMS[a][0]])
def test_scheduling_keeps_reference_streams(tiny, reference_streams, arm, scenario):
    ref, _ = reference_streams(arm)
    sched, ids, block, override = _scenario(tiny, arm, scenario)
    got = _run(sched, ids, block)
    assert got == {rid: override.get(rid, ref.get(rid)) for rid in ids}
    if scenario == "idle_slot":
        assert sched.stats()["decode_steps"] > MAX_SEQ_LEN - len(REQUESTS["idle"][0])
    if ARMS[arm][0]:  # every page back in the pool
        assert sched.allocator.free_pages == sched.allocator.n_pages - 1


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("chunk", [0, CHUNK])
def test_prefill_len_is_what_the_allocator_predicts(tiny, paged, chunk):
    """prefill_standalone hands over exactly Scheduler._prefill_T slots for
    short prompts (T < page), exact page multiples and chunked prompts."""
    eng = _engine(tiny, "paged_int8" if paged else "dense", prefill_chunk=chunk)
    sched = Scheduler(eng)
    for L in (2, PAGE, PAGE + 1, 2 * CHUNK + 8):
        pre = eng.prefill_standalone(list(range(1, L + 1)), pad_to=PAGE if paged else None)
        assert pre[1].shape[2] == sched._prefill_T(L)
        if paged:
            assert pre[1].shape[2] % PAGE == 0 and pre[1].dtype == torch.int8
        assert pre[4] == L


def test_paged_and_chunked_engine_match_dense(tiny):
    """Engine.generate on a paged cache (identity page layout) and with
    chunked prefill gives the dense engine's streams, bf16 and int8."""
    prompts = [list(range(3, 40)), [1, 7, 300]]
    for quant in (False, True):
        arms = ("dense_int8", "paged_int8") if quant else ("dense", "paged")
        want = _engine(tiny, arms[0], max_batch=2, prefill_chunk=0).generate(prompts, 8)
        assert _engine(tiny, arms[1], max_batch=2).generate(prompts, 8) == want
        assert _engine(tiny, arms[0], max_batch=2).generate(prompts, 8) == want


def test_kv_format_mismatch_rejected(tiny):
    with pytest.raises(ValueError, match="KV format"):
        Scheduler(_engine(tiny, "dense"), prefill_engine=_engine(tiny, "dense_int8"))


@pytest.mark.parametrize("flags", [[], ["--paged", "--kv-quant", "--page-size", "16",
                                        "--prefill-chunk", "16"]])
def test_cli_serve_matches_reference_cli(tiny, tmp_path, capsys, flags):
    """`python -m gemma_tpu_torch serve --device cpu` prints the reference
    CLI's per-request texts and token counts, one JSON line each."""
    path = tiny[0]
    pf = tmp_path / "prompts.txt"
    pf.write_text("hello world\nthe hello\nworld\nhello hello the world of worlds\n")
    common = ["--prompts-file", str(pf), "--batch", "2", "--max-new-tokens", "6", "--block", "2",
              "--max-seq-len", "64", "--no-eos", *flags]

    def rows(out):
        return [{k: r[k] for k in ("id", "text", "tokens")}
                for r in map(json.loads, out.strip().splitlines())]

    assert cli.main(["serve", str(path), "--device", "cpu", *common]) == 0
    ours = capsys.readouterr()
    args = jax_cli.build_parser().parse_args(["serve", str(path), *common])
    assert args.fn(args) == 0
    ref = capsys.readouterr()
    assert rows(ours.out) == rows(ref.out) and len(rows(ours.out)) == 4
    assert json.loads(ours.err.strip().splitlines()[-1])["requests"] == 4


def test_q8_0_multi_head_serve_matches_reference_scheduler(tmp_path):
    """serve() of a q8_0 multi-head model on the dense f32 cache: the JAX
    Scheduler's streams, decode steps and discarded tokens."""
    path = make_gguf(tmp_path / "mha.gguf", TINY_MHA_CONFIG, weight_type="q8_0", seed=5)
    reader = GGUFReader(path)
    jcfg, jparams = jax_load_params(reader)
    tcfg, _ = load_params(reader, device="cpu")
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    jcfg, tcfg = (dataclasses.replace(c, activation_dtype="float32") for c in (jcfg, tcfg))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")
        ref = JaxScheduler(JaxEngine(jcfg, jparams, JaxEngineConfig(
            max_seq_len=MAX_SEQ_LEN, max_batch=3, kv_dtype=jnp.float32, donate_cache=False)))
        for rid, (prompt, n) in REQUESTS.items():
            ref.submit(JaxRequest(rid, prompt, max_new_tokens=n))
        ref.run(block=4)
    sched = serve(Engine(tcfg, model, EngineConfig(max_seq_len=MAX_SEQ_LEN, max_batch=3,
                                                   kv_dtype=torch.float32)),
                  [Request(rid, *REQUESTS[rid]) for rid in REQUESTS], block=4)
    streams = {r.id: r.tokens for r in sched.finished}
    assert streams == {r.id: r.tokens for r in ref.finished}
    assert all(len(streams[rid]) == n for rid, (_, n) in REQUESTS.items())
    for key in ("requests", "decode_steps", "tokens_discarded", "total_tokens"):
        assert sched.stats()[key] == ref.stats()[key], key
