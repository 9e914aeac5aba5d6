"""Prompt-lookup speculative decoding: the port's `runtime/speculative.py`,
its speculative Scheduler, `serve(speculative=True)` and the CLI's
`--speculative`, against the JAX package's, on a tiny model.

One q4_0 GGUF of `TINY_KERNEL_CONFIG` (weights N(0, 0.1^2), so that greedy
streams change token now and then and also settle into runs the drafts can
predict) is loaded into the JAX package and carried into the port by
`from_jax_params`; both run f32 activations. The reference's verify
forwards (T = k + 1) take its XLA attention on the CPU (its Pallas flash
kernel takes T in multiples of its 128-row block), and its plain decode
runs its Pallas kernels in interpret mode (GEMMA_TPU_INTERPRET_KERNELS=1,
pinned while it runs); the port runs its plain versions.

Tolerances: the verify forward's logits within 1e-5 of their largest
|value| (the f32 tolerance of tests/test_torch_model.py: the same
arithmetic up to the order of f32 sums); cache writes of the same K/V equal
bit for bit (the int8 quantization is the reference's, bit for bit); the
bigram drafts, every token stream and the Scheduler's step counts exact.
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
from gemma_tpu.models import gemma as jax_gemma
from gemma_tpu.models.params import load_params as jax_load_params
from gemma_tpu.runtime import Engine as JaxEngine
from gemma_tpu.runtime import EngineConfig as JaxEngineConfig
from gemma_tpu.runtime.kv_cache import KVCache as JaxKVCache
from gemma_tpu.runtime.scheduler import Request as JaxRequest
from gemma_tpu.runtime.scheduler import Scheduler as JaxScheduler
from gemma_tpu.runtime.speculative import SpecDecoder as JaxSpecDecoder
from gemma_tpu.runtime.speculative import get_decoder as jax_get_decoder
from gemma_tpu_torch import cli
from gemma_tpu_torch.models import forward, from_jax_params, load_params
from gemma_tpu_torch.runtime import (Engine, EngineConfig, KVCache, PagedKVCache, Request,
                                     Scheduler, SpecDecoder, serve)
from gemma_tpu_torch.testing import TINY_GEMMA2_CONFIG, TINY_KERNEL_CONFIG, make_gguf

MAX_SEQ_LEN = 256
SCALE = 0.1
# tests/test_speculative.py's prompts: cyclic, a twist, none, short
PROMPTS = [
    [1, 7, 9, 7, 9, 7, 9, 7, 9, 7, 9, 7, 9],
    [1, 4, 5, 6, 4, 5, 6, 4, 5, 6, 4, 5],
    [1, 33, 402, 17, 250, 96, 311, 42],
    [1, 5],
]
N_NEW = 40
SPEC_SHAPES = [(4, 2), (8, 4)]  # (k, block)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # the port's tiny eager steps are thousands of small ops: one thread
    # runs them as fast alone, and does not spin against other workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _xla_reference_paths(monkeypatch):
    # other modules set this process-wide; the reference runs its kernels
    # only where a test pins it
    monkeypatch.delenv("GEMMA_TPU_INTERPRET_KERNELS", raising=False)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = make_gguf(tmp_path_factory.mktemp("spec") / "tiny.gguf", TINY_KERNEL_CONFIG, seed=3,
                     scale=SCALE)
    reader = GGUFReader(path)
    jcfg, jparams = jax_load_params(reader)
    tcfg, _ = load_params(reader, device="cpu")
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    jcfg, tcfg = (dataclasses.replace(c, activation_dtype="float32") for c in (jcfg, tcfg))
    return path, jcfg, jparams, tcfg, model


def _engine(tiny, **kw) -> Engine:
    *_, tcfg, model = tiny
    return Engine(tcfg, model, EngineConfig(**(dict(max_seq_len=MAX_SEQ_LEN,
                                                    kv_dtype=torch.float32) | kw)))


@pytest.fixture(scope="module")
def jax_engine(tiny):
    """JAX engines by option, built once: each caches its compiled
    speculative programs (`get_decoder`)."""
    _, jcfg, jparams, _, _ = tiny
    engines = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in engines:
            ecfg = dict(max_seq_len=MAX_SEQ_LEN, kv_dtype=jnp.float32, donate_cache=False) | kw
            engines[key] = JaxEngine(jcfg, jparams, JaxEngineConfig(**ecfg))
        return engines[key]

    return get


def _rel_err(a, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(a, np.float32) - ref).max() / np.abs(ref).max())


# -- the per-sequence chunk write and the verify forward ---------------------

B, S, T = 3, 64, 8
STARTS = [5, 30, 60]  # 60 > S - T: clamped to 56, the chunk moved back whole


def _caches(cfg, quantized, rng):
    """The same random dense cache in both packages: (JAX, port)."""
    L, H, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    shape = (B, H, S, D)
    if quantized:
        k = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2 * L)]
        sc = [rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32) for _ in range(2 * L)]
    else:
        k = [rng.normal(0, 0.3, shape).astype(np.float32) for _ in range(2 * L)]
        sc = None
    length = np.array(STARTS, np.int32)
    jc = JaxKVCache(k=tuple(map(jnp.asarray, k[:L])), v=tuple(map(jnp.asarray, k[L:])),
                    length=jnp.asarray(length),
                    k_scale=tuple(map(jnp.asarray, sc[:L])) if sc else None,
                    v_scale=tuple(map(jnp.asarray, sc[L:])) if sc else None)
    tc = KVCache(k=[torch.from_numpy(a.copy()) for a in k[:L]],
                 v=[torch.from_numpy(a.copy()) for a in k[L:]], length=torch.from_numpy(length),
                 k_scale=[torch.from_numpy(a.copy()) for a in sc[:L]] if sc else None,
                 v_scale=[torch.from_numpy(a.copy()) for a in sc[L:]] if sc else None)
    return jc, tc


def _assert_caches_equal(jc, tc):
    parts = [("k", jc.k, tc.k), ("v", jc.v, tc.v)]
    if tc.quantized:
        parts += [("k_scale", jc.k_scale, tc.k_scale), ("v_scale", jc.v_scale, tc.v_scale)]
    for name, ours_ref, ours in parts:
        for layer, (a, b) in enumerate(zip(ours_ref, ours)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{name}[{layer}]")


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_write_chunk_per_seq_matches_reference(tiny, quantized):
    """The same [B, T, H, D] chunk at distinct starts per row, one clamped:
    every cache row and int8 scale equal to the reference's."""
    cfg = tiny[3]
    rng = np.random.default_rng(0)
    jc, tc = _caches(cfg, quantized, rng)
    starts = np.array(STARTS, np.int32)
    for layer in range(cfg.n_layers):
        kn, vn = (rng.normal(0, 0.5, (B, T, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
                  for _ in range(2))
        jc = jc.write_chunk_per_seq(layer, jnp.asarray(starts), jnp.asarray(kn), jnp.asarray(vn))
        assert tc.write_chunk_per_seq(layer, torch.from_numpy(starts), torch.from_numpy(kn),
                                      torch.from_numpy(vn)) is tc
    _assert_caches_equal(jc, tc)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_verify_forward_matches_reference(tiny, quantized):
    """`forward` at T = k + 1 = 8 with a [B] write index (the batched
    verify) against the reference's: logits within 1e-5 of their scale
    (int8 cache: 1e-2, below) and every row's argmax equal; the rows
    outside each chunk untouched; the chunk rows within 1e-5 of the K/V
    scale (f32), or, quantized from those values, int8 within one step and
    scales within 1e-5 at layer 0.

    int8: both packages dequantize the layer's K/V to bf16 for T > 1; the
    reference's attention on the CPU (its XLA path) then rounds the
    normalized p and its output to bf16, while the port's f32 flash keeps
    both in f32 (measured 5.1e-3 of the logits' scale, 2.0e-3 of the next
    layer's scales; those layers' dequantized rows are held to 1e-2). With
    bf16 activations, the card's, both round p to bf16 (ROADMAP section 3)."""
    _, jcfg, jparams, tcfg, model = tiny
    rng = np.random.default_rng(1)
    jc, tc = _caches(tcfg, quantized, rng)
    before = [t.clone() for t in tc.k + tc.v]
    toks = rng.integers(2, tcfg.vocab_size, (B, T)).astype(np.int32)
    starts = np.array(STARTS, np.int32)
    pos = starts[:, None] + np.arange(T, dtype=np.int32)
    lim = starts + T
    ref, jc = jax_gemma.forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos), jc,
                                write_index=jnp.asarray(starts), kv_limit=jnp.asarray(lim))
    got = forward(model, tcfg, torch.from_numpy(toks), torch.from_numpy(pos), tc,
                  write_index=torch.from_numpy(starts), kv_limit=torch.from_numpy(lim))
    assert got.shape == (B, T, tcfg.vocab_size)
    assert _rel_err(got, ref) <= (1e-2 if quantized else 1e-5)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(ref).argmax(-1))
    rows = np.zeros((B, S), bool)
    for b, s in enumerate(np.clip(starts, 0, S - T)):
        rows[b, s : s + T] = True
    L = tcfg.n_layers
    for i, (a, b_, old) in enumerate(zip(list(jc.k) + list(jc.v), tc.k + tc.v, before)):
        # [B, H, S, D] -> [B, S, H, D]: cache rows by (b, slot)
        a, b_, old = (np.moveaxis(np.asarray(x), 2, 1) for x in (a, b_, old))
        np.testing.assert_array_equal(b_[~rows], old[~rows])
        new, want = b_[rows], a[rows]
        if not quantized:
            assert _rel_err(new, want) <= 1e-5
            continue
        sc = [np.moveaxis(np.asarray(x[i % L]), 2, 1)[rows][..., None] for x in (
            tc.k_scale if i < L else tc.v_scale, jc.k_scale if i < L else jc.v_scale)]
        if i % L == 0:  # layer 0's K/V come before any attention: int8 within a step
            assert np.abs(new.astype(np.int32) - want.astype(np.int32)).max() <= 1
            assert _rel_err(sc[0], sc[1]) <= 1e-5
        else:  # later layers carry the attention's bf16 rounding
            assert _rel_err(new * sc[0], want * sc[1]) <= 1e-2
    np.testing.assert_array_equal(np.asarray(jc.length), tc.length.numpy())


def test_paged_cache_refuses_per_sequence_chunks(tiny):
    """No package writes a T > 1 chunk at per-sequence starts into pages:
    the forward raises, naming the dense cache, instead of keeping row 0."""
    eng = _engine(tiny, paged=True, page_size=16, max_batch=2, max_seq_len=64)
    cache = eng.new_cache(2)
    assert isinstance(cache, PagedKVCache)
    toks = torch.ones(2, 4, dtype=torch.int64)
    idx = torch.tensor([3, 9], dtype=torch.int32)
    with pytest.raises(ValueError, match="dense KVCache"):
        forward(eng.params, eng.cfg, toks, idx[:, None] + torch.arange(4, dtype=torch.int32),
                cache, write_index=idx, kv_limit=idx + 4)


# -- the drafts ---------------------------------------------------------------

L_HIST, K_DRAFT = 32, 5


def _history(case, rng):
    """(history [L], hist_len, t_prev, t_cur) of one draft case."""
    h = rng.integers(10, 500, L_HIST).astype(np.int32)
    n = 20
    h[n:] = 0
    t_prev, t_cur = int(h[n - 2]), int(h[n - 1])
    if case == "match":  # the pair earlier at 4 and at 9: the later one wins
        h[4:6] = h[9:11] = (t_prev, t_cur)
    elif case == "near_end":  # a match whose continuation reaches past L - k
        n = L_HIST - 1
        h[:n] = rng.integers(10, 500, n)
        t_prev, t_cur = int(h[n - 2]), int(h[n - 1])
        h[L_HIST - 5 : L_HIST - 3] = (t_prev, t_cur)
    elif case == "excluded":  # only the trailing pair itself, at hist_len - 2
        h[:n - 2][h[:n - 2] == t_prev] = 7
    assert case != "match" or h[9] == t_prev
    return h, n, t_prev, t_cur


DRAFT_CASES = ["match", "none", "near_end", "excluded"]


@pytest.mark.parametrize("case", DRAFT_CASES + ["batched"])
def test_draft_matches_reference(tiny, jax_engine, case):
    """`SpecDecoder._draft` against the reference's, exact: a match (the
    most recent one), none (t_cur repeated), a match whose continuation
    starts past L - k (clipped back), and the trailing pair at hist_len - 2
    (excluded); batched over the four rows against the reference's vmap."""
    rng = np.random.default_rng(DRAFT_CASES.index(case) if case in DRAFT_CASES else 9)
    ref = JaxSpecDecoder(jax_engine(), k=K_DRAFT)
    ours = SpecDecoder(_engine(tiny), k=K_DRAFT)
    rows = [_history(c, rng) for c in (DRAFT_CASES if case == "batched" else [case])]
    h, n, tp, tc = (np.stack([r[i] for r in rows]).astype(np.int32) for i in range(4))
    got = ours._draft(*(torch.from_numpy(x) for x in (h, n, tp, tc)))
    if case == "batched":
        want = jax.vmap(ref._draft)(*map(jnp.asarray, (h, n, tp, tc)))
    else:
        want = ref._draft(*(jnp.asarray(x[0]) for x in (h, n, tp, tc)))[None]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "none":
        assert (got.numpy() == tc[:, None]).all()
    if case == "match":
        assert got[0].tolist() == h[0, 11 : 11 + K_DRAFT].tolist()


# -- batch-1 generation --------------------------------------------------------

@pytest.fixture(scope="module")
def reference_generate(tiny, jax_engine):
    """The reference SpecDecoder's streams by (k, block) and prompt index."""
    cache = {}

    def get(k, block, pi):
        if (k, block, pi) not in cache:
            dec = jax_get_decoder(jax_engine(), k=k, block=block)
            cache[k, block, pi] = (dec.generate(PROMPTS[pi], N_NEW), dec.steps)
        return cache[k, block, pi]

    return get


@pytest.fixture(scope="module")
def greedy(tiny):
    eng = _engine(tiny)
    return {pi: eng.generate_fused([p], N_NEW)[0].tolist() for pi, p in enumerate(PROMPTS)}


@pytest.mark.parametrize("pi", range(len(PROMPTS)), ids=lambda i: f"p{i}")
@pytest.mark.parametrize("k,block", SPEC_SHAPES)
def test_generate_matches_reference_and_greedy(tiny, reference_generate, greedy, pi, k, block):
    """SpecDecoder.generate: the reference's stream and verify forwards, and
    the port's own greedy (`generate_fused`) stream."""
    dec = SpecDecoder(_engine(tiny), k=k, block=block)
    got = dec.generate(PROMPTS[pi], N_NEW)
    ref, ref_steps = reference_generate(k, block, pi)
    assert got == ref == greedy[pi]
    assert dec.steps == ref_steps and dec.steps % block == 0


def test_acceptance_is_exercised(tiny):
    """A prompt whose greedy continuation cycles must emit more tokens than
    verify forwards: accepted drafts attend the K/V the verify wrote for
    their predecessors in the chunk. With the model fixed by its seed, one
    such prompt must be found."""
    eng = _engine(tiny)
    n = 48
    for prompt in ([1, 7], [1, 44, 260], [1, 5, 311], [1, 400, 17], [2, 9]):
        ref = eng.generate_fused([prompt], n)[0].tolist()
        if not any(ref[-16:].count(t) >= 4 for t in set(ref[-16:])):
            continue
        dec = SpecDecoder(eng, k=7, block=2)
        assert dec.generate(prompt, n) == ref
        assert len(ref) > dec.steps, (prompt, dec.steps)
        return
    pytest.fail("no prompt with a cyclic greedy continuation on this model")


def test_int8_cache_gives_its_greedy_stream(tiny, jax_engine):
    """The verify writes int8 K/V with their scales through the per-sequence
    write: the stream equals the int8 engine's greedy one and the
    reference's."""
    prompt = PROMPTS[0]
    eng = _engine(tiny, kv_quantized=True)
    want = eng.generate_fused([prompt], 24)[0].tolist()
    assert SpecDecoder(eng, k=4, block=2).generate(prompt, 24) == want
    assert jax_get_decoder(jax_engine(kv_quantized=True), k=4, block=2).generate(prompt, 24) == want


def test_gemma2_softcaps_and_window(tmp_path):
    """Gemma-2 (sandwich norms, logit softcaps, a sliding window every other
    layer): the stream equals the greedy one and the reference's."""
    path = make_gguf(tmp_path / "g2.gguf", TINY_GEMMA2_CONFIG, weight_type="f32", seed=5,
                     arch="gemma2")
    reader = GGUFReader(path)
    jcfg, jparams = jax_load_params(reader, mode="dequant")
    tcfg, _ = load_params(reader, device="cpu")
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    jcfg, tcfg = (dataclasses.replace(c, activation_dtype="float32") for c in (jcfg, tcfg))
    eng = Engine(tcfg, model, EngineConfig(max_seq_len=MAX_SEQ_LEN, kv_dtype=torch.float32))
    prompt = [1, 5, 11, 5, 11, 5] * 4  # 24 tokens: past the 16-token window
    want = eng.generate_fused([prompt], 24)[0].tolist()
    assert SpecDecoder(eng, k=4, block=2).generate(prompt, 24) == want
    ref = JaxEngine(jcfg, jparams, JaxEngineConfig(max_seq_len=MAX_SEQ_LEN, kv_dtype=jnp.float32,
                                                   donate_cache=False))
    assert JaxSpecDecoder(ref, k=4, block=2).generate(prompt, 24) == want


def test_capacity_guard_and_paged_engine(tiny):
    dec = SpecDecoder(_engine(tiny), k=8, block=4)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        dec.generate(list(range(1, 200)), 60)
    assert dec.generate(list(range(1, 100)), 75)  # 99 + 75 + 81 = 255 rows fit
    with pytest.raises(ValueError, match="dense"):
        SpecDecoder(_engine(tiny, paged=True, page_size=16))


# -- the speculative Scheduler ----------------------------------------------

CHUNK = 16
REQUESTS = {  # id -> (prompt, max_new_tokens)
    "a": ([1, 7, 9, 7, 9, 7], 12),
    "b": ([1, 44, 260, 9, 77], 10),
    "c": ([1, 5, 311, 42], 9),
    "d": ([1, 33], 11),
    "e": ([1, 400, 17, 9, 8, 260], 8),
    "cyc": (PROMPTS[0], 30),
    "long": (list(range(40, 80)), 10),  # > 2 chunks: overlapped admission when chunked
    "one": ([1, 44, 260], 1),  # ends at its first token
}
# EOS ids whose first occurrence lies inside a block (the 16th token of "cyc"'s
# stream, the 6th of "c"'s) or is the first token, emitted at admission ("b")
EOS = {"cyc": 222, "c": 216, "b": 77}
SCENARIOS = {  # name -> (port engine options, Scheduler options, how it is driven)
    "run": ({}, {}, "run"),
    "adaptive_lo": ({}, {"spec_min_accept": 100.0}, "run"),
    "eos": ({}, {}, "run"),
    "overlapped": ({"prefill_chunk": CHUNK}, {}, "run"),
    "int8": ({"kv_quantized": True}, {}, "run"),
    "step_spec": ({}, {"spec_k": 4, "spec_block": 2}, "step_spec"),
}


def _requests(scenario, cls):
    eos = EOS if scenario == "eos" else {}
    return [cls(rid, p, max_new_tokens=n, eos_id=eos.get(rid)) for rid, (p, n) in REQUESTS.items()]


def _drive(sched, reqs, how):
    for r in reqs:
        sched.submit(r)
    if how == "run":
        sched.run()
    else:
        while len(sched.finished) < len(reqs):
            sched.step_spec()
    return {r.id: r.tokens for r in sched.finished}, sched.stats()


@pytest.fixture(scope="module")
def reference_scheduler(jax_engine):
    """The reference speculative Scheduler's streams and stats, by scenario."""
    cache = {}

    def get(scenario):
        if scenario not in cache:
            eng_kw, sched_kw, how = SCENARIOS[scenario]
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")
                sched = JaxScheduler(jax_engine(max_batch=3, **eng_kw), speculative=True,
                                     **sched_kw)
                cache[scenario] = _drive(sched, _requests(scenario, JaxRequest), how)
        return cache[scenario]

    return get


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_scheduler_matches_reference(tiny, reference_scheduler, scenario):
    """Scheduler(speculative=True), 3 slots and 8 requests (slot reuse, a
    request that ends at its first token, an overlapped chunked admission
    where chunked): every stream equal to the reference's and to the port's
    plain Scheduler's, and decode steps, verify forwards and discarded
    tokens equal to the reference's."""
    eng_kw, sched_kw, how = SCENARIOS[scenario]
    eng = _engine(tiny, max_batch=3, **eng_kw)
    sched = Scheduler(eng, speculative=True, **sched_kw)
    if scenario == "adaptive_lo":
        assert sched._spec_lo is not None and sched._spec_lo.k == 1
    got, stats = _drive(sched, _requests(scenario, Request), how)
    ref, ref_stats = reference_scheduler(scenario)
    assert got == ref
    plain, _ = _drive(Scheduler(eng), _requests(scenario, Request), "run")
    assert got == plain
    for key in ("requests", "decode_steps", "spec_forwards", "tokens_discarded", "total_tokens"):
        assert stats[key] == ref_stats[key], key
    assert stats["spec_forwards"] < stats["total_tokens"]  # drafts were accepted
    if scenario == "adaptive_lo":  # k = 1 but for the spec_k probes
        assert 0 < stats["spec_lo_forwards"] < stats["spec_forwards"]
    if scenario == "eos":
        assert got["cyc"][-1] == 222 and len(got["cyc"]) == 16
        assert got["c"][-1] == 216 and len(got["c"]) == 6 and got["b"] == [77]


def test_disaggregated_prefill_engine(tiny):
    """Admission prefills on a second engine of another geometry (chunked,
    longer cache) leave every speculative stream equal to the plain ones."""
    pre = _engine(tiny, max_seq_len=MAX_SEQ_LEN * 2, prefill_chunk=CHUNK)
    dec = _engine(tiny, max_batch=2)
    got, stats = _drive(Scheduler(dec, prefill_engine=pre, speculative=True),
                        _requests("run", Request), "run")
    plain, _ = _drive(Scheduler(dec), _requests("run", Request), "run")
    assert got == plain and stats["spec_forwards"] > 0


def test_idle_slot_speculation_keeps_streams(tiny):
    """An idle slot verifies every tick and its length passes the cache's
    end: its rows land in its own row at [S - T, S), and the request
    admitted there next keeps its stream (2 slots, max_seq_len 128; "idle"
    ends at its first token, "long" at the speculative full limit)."""
    S_ = 128
    eng = _engine(tiny, max_seq_len=S_, max_batch=2)
    reqs = {"idle": (list(range(100, 200)), 1), "long": ([1, 5, 311], 50),
            "next": (list(range(200, 240)), 6)}
    sched = Scheduler(eng, speculative=True, spec_min_accept=0.0)
    for rid in ("idle", "long"):
        sched.submit(Request(rid, *reqs[rid]))
    sched.run()
    assert int(sched.cache.length[sched.finished[0].slot]) > S_  # the idle row ran past S
    sched.submit(Request("next", *reqs["next"]))
    sched.run()
    got = {r.id: r.tokens for r in sched.finished}
    plain, _ = _drive(Scheduler(eng), [Request(rid, *v) for rid, v in reqs.items()], "run")
    assert got == plain


def test_serve_passes_speculation(tiny):
    eng = _engine(tiny, max_batch=3)
    sched = serve(eng, _requests("run", Request), speculative=True, spec_k=4, spec_block=2)
    assert sched.spec.k == 4 and sched.spec.block == 2 and sched.stats()["spec_forwards"] > 0
    plain = serve(eng, _requests("run", Request), block=4)
    assert {r.id: r.tokens for r in sched.finished} == {r.id: r.tokens for r in plain.finished}


# -- the CLI -----------------------------------------------------------------

CLI_COMMON = ["--max-seq-len", "256", "--no-eos", "--speculative", "--spec-k", "4"]


def test_cli_generate_speculative_matches_reference_cli(tiny, capsys):
    path = str(tiny[0])
    args = ["--tokens", ",".join(map(str, PROMPTS[0])), "--max-new-tokens", "24", *CLI_COMMON]
    assert cli.main(["generate", path, "--device", "cpu", *args]) == 0
    ours = capsys.readouterr()
    ref_args = jax_cli.build_parser().parse_args(["generate", path, *args])
    assert ref_args.fn(ref_args) == 0
    ref = capsys.readouterr()
    assert ours.out == ref.out and ours.out.strip()
    assert cli.main(["generate", path, "--device", "cpu", *args[:-3]]) == 0  # plain
    assert capsys.readouterr().out == ours.out


def test_cli_serve_speculative_matches_reference_cli(tiny, tmp_path, capsys):
    path = str(tiny[0])
    pf = tmp_path / "prompts.txt"
    pf.write_text("hello world\nthe hello\nworld\nhello hello the world of worlds\n")
    args = ["--prompts-file", str(pf), "--batch", "2", "--max-new-tokens", "10",
            "--spec-block", "2", *CLI_COMMON]

    def rows(out):
        return [{k: r[k] for k in ("id", "text", "tokens")}
                for r in map(json.loads, out.strip().splitlines())]

    assert cli.main(["serve", path, "--device", "cpu", *args]) == 0
    ours = capsys.readouterr()
    ref_args = jax_cli.build_parser().parse_args(["serve", path, *args])
    assert ref_args.fn(ref_args) == 0
    ref = capsys.readouterr()
    assert rows(ours.out) == rows(ref.out) and len(rows(ours.out)) == 4
    assert json.loads(ours.err.strip().splitlines()[-1])["spec_forwards"] > 0


@pytest.mark.parametrize("command,flags", [
    ("generate", ["--tokens", "1,7,9", "--temperature", "0.7"]),
    ("serve", ["--paged", "--page-size", "16"]),
])
def test_cli_speculative_falls_back_with_a_message(tiny, tmp_path, capsys, command, flags):
    """Sampling that is not greedy, or serve on a paged cache: the CLI says
    on stderr that it ignores --speculative and decodes plainly, as the
    reference's does."""
    pf = tmp_path / "p.txt"
    pf.write_text("hello world\n")
    extra = ["--prompts-file", str(pf), "--batch", "1"] if command == "serve" else []
    argv = [command, str(tiny[0]), "--device", "cpu", "--max-new-tokens", "4", *CLI_COMMON,
            *flags, *extra]
    assert cli.main(argv) == 0
    err = capsys.readouterr().err
    assert "--speculative requires greedy sampling" in err and "ignoring" in err
    if command == "serve":
        assert "spec_forwards" not in json.loads(err.strip().splitlines()[-1])
