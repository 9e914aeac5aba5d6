"""Tensor parallelism: the port's `parallel/sharding.py`, `shard_decode.py`
(`TPEngine`) and `multihost.make_multihost_mesh` against the JAX package's,
case by case as tests/test_shard_map.py and tests/test_multihost.py hold the
reference.

TINY_CONFIG's F32 GGUF (seed 3, mode dequant) is loaded into the JAX
package and carried into the port by `from_jax_params`; both run f32
activations, the dense arm over an f32 cache (its logits against the JAX
Engine's over an f32 cache), the others over the JAX TPEngine's bf16. The JAX
side runs on 8 virtual CPU devices (tests/conftest.py). The port runs as
gloo ranks on the CPU in spawned subprocesses that import nothing of the
JAX package: one group of 4 ranks for the (1, 4) and (2, 2) meshes, one of
2 for (1, 2), both started once for the module, each running every
scenario of its meshes and printing one JSON line a rank.

Tolerances: greedy streams equal token for token; logits within 1e-5 of
their scale (f32 sums in another order: gloo's sum of the shards' partial
sums against XLA's); shard slices of a quantized weight dequantize bit for
bit; column partial sums within 1e-5 of the full product's scale.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gemma_tpu.gguf import GGMLType, GGUFReader
from gemma_tpu.models.params import load_params as jax_load_params
from gemma_tpu.parallel import make_mesh as jax_make_mesh
from gemma_tpu.parallel import multihost as jax_multihost
from gemma_tpu.parallel import sharding as jax_sharding
from gemma_tpu.parallel.shard_decode import TPEngine as JaxTPEngine
from gemma_tpu.parallel.shard_decode import local_config as jax_local_config
from gemma_tpu.quant.qtensor import quantize_array
from gemma_tpu.runtime import Engine as JaxEngine
from gemma_tpu.runtime import EngineConfig as JaxEngineConfig
from gemma_tpu.testing import TINY_CONFIG as JAX_TINY_CONFIG
from gemma_tpu.testing import make_gguf as jax_make_gguf
from gemma_tpu_torch.gguf.reader import GGUFReader as PortReader
from gemma_tpu_torch.models import from_jax_params, load_params
from gemma_tpu_torch.ops.quant_matmul import PLAIN
from gemma_tpu_torch.parallel import multihost, sharding
from gemma_tpu_torch.parallel.shard_decode import (build_tp_params, layer_weights, local_config,
                                                   shard_layer, shard_vocab)
from gemma_tpu_torch.quant.qtensor import dequant, from_jax, select_cols, select_rows
from gemma_tpu_torch.testing import TINY_CONFIG, TINY_KERNEL_CONFIG, make_gguf

ROOT = Path(__file__).resolve().parents[1]
MESHES = [(1, 4), (1, 2), (2, 2)]
NEW = 5
REQUESTS = [("a", [1, 7, 300, 42], 4), ("b", [1, 9], 5), ("c", [1, 5, 11], 3)]
SPEC_REQUESTS = [("a", [1, 7, 300, 42], 8), ("b", [1, 9], 10), ("c", [1, 5, 11], 6)]


def prompts_for(n_data: int) -> list[list[int]]:
    """test_shard_map's prompts: batch 1, or 2 rows over a data axis of 2."""
    batch = 2 if n_data > 1 else 1
    return [[1, 7, 300, 42][: 3 + i] for i in range(batch)]


# One rank of a spawned group: every scenario of its meshes, one JSON line.
_RANK = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
from gemma_tpu_torch.parallel import multihost
from gemma_tpu_torch.parallel.sharding import make_mesh
from gemma_tpu_torch.parallel.shard_decode import TPEngine
from gemma_tpu_torch.runtime import (Engine, EngineConfig, Request, SamplingParams,
                                     Scheduler, serve)

torch.set_num_threads(1)
spec = json.loads(sys.argv[1])
rank = int(sys.argv[2])
multihost.initialize(spec["coordinator"], spec["world"], rank, timeout=120)
saved = torch.load(spec["model"], weights_only=False)
cfg, model = saved["cfg"], saved["model"]
out = {"rank": rank}

def mesh(nd, nm):
    return make_mesh(nd, nm, backend="gloo", device="cpu")

def engine(m, **kw):
    kw.setdefault("max_seq_len", 32)
    return TPEngine(cfg, model, m, **kw)

def rows_of(eng, logits):
    r = eng._rows(logits.shape[0])
    return [r.start, r.stop], logits[r].tolist()

def reqs(table):
    return [Request(i, p, n) for i, p, n in table]

def sampled4(eng):
    logits, cache = eng.prefill([[1, 7, 300]] * 4)
    gen = torch.Generator()
    gen.manual_seed(0)
    return eng.block(logits, gen, cache, 16, SamplingParams(temperature=1.0))[0].tolist()

if spec["world"] == 4:  # the single-device Engine's stream of the same draws
    out["engine_sampled4"] = sampled4(Engine(cfg, model, EngineConfig(
        max_seq_len=32, max_batch=4, kv_dtype=torch.float32)))

for nd, nm in map(tuple, spec["meshes"]):
    m = mesh(nd, nm)
    res = out[f"{nd}x{nm}"] = {"model_group": dist.get_process_group_ranks(m.model.group),
                               "data_group": dist.get_process_group_ranks(m.data.group)}
    prompts = [[1, 7, 300, 42][: 3 + i] for i in range(2 if nd > 1 else 1)]
    B = len(prompts)
    for arm, kw in (("dense", {"kv_dtype": torch.float32}), ("int8", {"kv_quantized": True})):
        eng = engine(m, max_batch=B, **kw)
        res[arm] = eng.generate_greedy(prompts, 5).tolist()
        logits, cache = eng.prefill(prompts)
        tok = logits.argmax(-1).to(torch.int32)  # own rows; the others' are zero
        tok = eng._gather_rows(tok[eng._rows(B)], eng._rows(B), B)
        m.reset_stats()
        step1, cache = eng.decode_step(tok, cache)
        res[arm + "_step_stats"] = m.collective_stats()
        res[arm + "_prefill"] = rows_of(eng, logits)
        res[arm + "_step1"] = rows_of(eng, step1)
        m.reset_stats()
        eng.step(step1, None, cache)
        res[arm + "_sample_stats"] = m.collective_stats()
    if spec["world"] == 4:  # four identical prompts, temperature 1.0, 16 tokens
        res["sampled4"] = sampled4(engine(m, max_batch=4, kv_dtype=torch.float32))
    if nd > 1:
        try:
            engine(m, max_batch=2, paged=True)
            res["paged_raises"] = None
        except ValueError as e:
            res["paged_raises"] = str(e)
        continue
    if nm != 2:
        continue
    for arm, q in (("paged_bf16", False), ("paged_int8", True)):
        eng = engine(m, max_batch=1, paged=True, page_size=16, kv_quantized=q)
        res[arm] = eng.generate_greedy([[1, 7, 300]], 5).tolist()
    for arm, kw in (("sched_dense", {}), ("sched_paged_int8", {"paged": True, "page_size": 16,
                                                                "kv_quantized": True})):
        sched = serve(engine(m, max_batch=2, **kw), reqs(spec["requests"]))
        res[arm] = {r.id: r.tokens for r in sched.finished}
        res[arm + "_stats"] = sched.stats()["requests"]
    eng = engine(m, max_batch=1)
    logits, cache = eng.prefill([[1, 7, 300]])
    gen = torch.Generator()
    gen.manual_seed(0)
    toks, _, _ = eng.block(logits, gen, cache, 3, SamplingParams(temperature=0.8, top_k=40,
                                                                 top_p=0.95))
    res["sampled"] = toks.tolist()
    for arm, kw in (("spec", {"speculative": True, "spec_k": 3, "spec_block": 2}),
                    ("spec_plain", {})):
        s = Scheduler(engine(m, max_seq_len=128, max_batch=2), **kw)
        for r in reqs(spec["spec_requests"]):
            s.submit(r)
        s.run()
        res[arm] = {r.id: r.tokens for r in s.finished}

if spec["world"] == 4:
    mh = out["multihost"] = {}
    m = multihost.make_multihost_mesh(backend="gloo", device="cpu")
    mh["one_node"] = [m.shape["data"], m.shape["model"]]
    m = multihost.make_multihost_mesh(2, backend="gloo", device="cpu", local_world_size=2)
    mh["two_nodes"] = [m.shape["data"], m.shape["model"],
                       dist.get_process_group_ranks(m.model.group)]
    for name, n_model, local in (("across_nodes", 4, 2), ("not_dividing", 3, None)):
        try:
            multihost.make_multihost_mesh(n_model, backend="gloo", device="cpu",
                                          local_world_size=local)
            mh[name] = None
        except ValueError as e:
            mh[name] = str(e)
out["jax_imported"] = any(k == "jax" or k.startswith(("jax.", "gemma_tpu."))
                          or k == "gemma_tpu" for k in sys.modules)
print(json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world: int, meshes, model_path: Path) -> list[subprocess.Popen]:
    spec = {"coordinator": f"tcp://127.0.0.1:{_free_port()}", "world": world,
            "meshes": meshes, "model": str(model_path), "requests": REQUESTS,
            "spec_requests": SPEC_REQUESTS}
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "MASTER_ADDR", "WORLD_SIZE", "LOCAL_WORLD_SIZE",
                        "LOCAL_RANK")}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen([sys.executable, "-c", _RANK, json.dumps(spec), str(rank)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                             cwd=model_path.parent)
            for rank in range(world)]


def _collect(procs) -> list[dict]:
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def _jax_engine_streams(jcfg, jparams, prompts, new, **kw):
    eng = JaxEngine(jcfg, jparams, JaxEngineConfig(max_seq_len=32, max_batch=1,
                                                   donate_cache=False, **kw))
    return [eng.generate([p], max_new_tokens=new)[0] for p in prompts]


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp") / "m.gguf"
    jax_make_gguf(path, JAX_TINY_CONFIG, weight_type=GGMLType.F32, seed=3)
    return path


@pytest.fixture(scope="module")
def runs(model_file):
    """The port's groups (spawned first, they run while the JAX references
    compute) and the JAX references: the TPEngine's streams and first
    decode step at each mesh, the single-device Engine's streams."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("GEMMA_TPU_INTERPRET_KERNELS", raising=False)
        jcfg, jparams = jax_load_params(GGUFReader(model_file), mode="dequant")
        jcfg = dataclasses.replace(jcfg, activation_dtype="float32")
        cfg = dataclasses.replace(load_params(PortReader(model_file), "cpu", mode="dequant")[0],
                                  activation_dtype="float32")
        model = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg)
        saved = model_file.parent / "port.pt"
        torch.save({"cfg": cfg, "model": model}, saved)
        groups = {4: _spawn(4, [(1, 4), (2, 2)], saved), 2: _spawn(2, [(1, 2)], saved)}
        try:
            ref = {}
            for nd, nm in MESHES:
                prompts = prompts_for(nd)
                mesh = jax_make_mesh(nd, nm, devices=jax.devices()[: nd * nm])
                eng = JaxTPEngine(jcfg, jparams, mesh, max_seq_len=32, max_batch=len(prompts))
                ref[(nd, nm)] = {"streams": np.asarray(eng.generate_greedy(
                    prompts, max_new_tokens=NEW)).tolist()}
                # logits: the single-device Engine over an f32 cache (the JAX
                # TPEngine's cache is bf16, whose p rounds at another point
                # than the port's kernels, ROADMAP section 3)
                one = JaxEngine(jcfg, jparams, JaxEngineConfig(
                    max_seq_len=32, max_batch=len(prompts), donate_cache=False,
                    kv_dtype=jnp.float32))
                logits, cache = one.prefill(prompts)
                step1, _ = one.decode_step(jnp.argmax(logits, axis=-1).astype(jnp.int32), cache)
                ref[(nd, nm)] |= {"prefill": np.asarray(logits), "step1": np.asarray(step1)}
            all_prompts = prompts_for(2) + [[1, 7, 300]]
            ref["engine"] = dict(zip(map(tuple, all_prompts), _jax_engine_streams(
                jcfg, jparams, all_prompts, NEW)))
            ref["engine_int8"] = dict(zip(map(tuple, all_prompts), _jax_engine_streams(
                jcfg, jparams, all_prompts, NEW, kv_quantized=True)))
            for name, table in (("requests", REQUESTS), ("spec_requests", SPEC_REQUESTS)):
                for q in (False, True):
                    eng = JaxEngine(jcfg, jparams, JaxEngineConfig(
                        max_seq_len=128, max_batch=1, donate_cache=False, kv_quantized=q))
                    ref[(name, q)] = {i: eng.generate([p], max_new_tokens=n)[0]
                                      for i, p, n in table}
        finally:
            port = {w: _collect(procs) for w, procs in groups.items()}
    ranks = {}
    for w, outs in port.items():
        assert [o["rank"] for o in outs] == list(range(w))
        assert not any(o["jax_imported"] for o in outs)
        for o in outs:
            for key, val in o.items():
                if "x" in key and key[0].isdigit():
                    ranks.setdefault(tuple(map(int, key.split("x"))), []).append(val)
    return {"ref": ref, "port": ranks, "multihost": [o["multihost"] for o in port[4]],
            "engine_sampled4": [o["engine_sampled4"] for o in port[4]]}


def _same_on_every_rank(results, key):
    vals = [r[key] for r in results]
    assert all(v == vals[0] for v in vals), f"{key} differs across ranks: {vals}"
    return vals[0]


@pytest.mark.parametrize("n_data,n_model", MESHES)
def test_tp_engine_matches_jax_and_single_device(runs, n_data, n_model):
    """Greedy streams of the port's TPEngine equal the JAX TPEngine's and
    the single-device Engine's: tp = 4 (2 KV heads: one duplicated head a
    shard), tp = 2 (KV heads sharded), and (2, 2) with the batch over data."""
    got = _same_on_every_rank(runs["port"][(n_data, n_model)], "dense")
    ref = runs["ref"][(n_data, n_model)]["streams"]
    assert got == ref
    assert got == [runs["ref"]["engine"][tuple(p)] for p in prompts_for(n_data)]


@pytest.mark.parametrize("n_data,n_model", MESHES)
@pytest.mark.parametrize("which", ["prefill", "step1"])
def test_tp_logits_match_jax(runs, n_data, n_model, which):
    """The prefill's last-token logits and the first decode step's, each
    rank's own rows, f32 activations over an f32 cache, within 1e-5 of the
    logits' scale of the JAX single-device Engine's."""
    ref = runs["ref"][(n_data, n_model)][which]
    scale = float(np.abs(ref).max())
    for res in runs["port"][(n_data, n_model)]:
        (lo, hi), got = res[f"dense_{which}"]
        assert hi - lo == (1 if n_data > 1 else len(ref))
        assert float(np.abs(np.asarray(got) - ref[lo:hi]).max()) <= 1e-5 * scale


@pytest.mark.parametrize("n_data,n_model", MESHES)
def test_tp_engine_int8_kv_matches_single_device(runs, n_data, n_model):
    got = _same_on_every_rank(runs["port"][(n_data, n_model)], "int8")
    assert got == [runs["ref"]["engine_int8"][tuple(p)] for p in prompts_for(n_data)]


@pytest.mark.parametrize("arm", ["paged_bf16", "paged_int8"])
def test_tp_engine_paged_matches_single_device(runs, arm):
    got = _same_on_every_rank(runs["port"][(1, 2)], arm)
    ref = runs["ref"]["engine_int8" if arm.endswith("int8") else "engine"][(1, 7, 300)]
    assert got == [ref]


def test_tp_engine_paged_rejects_data_axis(runs):
    for res in runs["port"][(2, 2)]:
        assert "data axis" in res["paged_raises"]


@pytest.mark.parametrize("arm", ["sched_dense", "sched_paged_int8"])
def test_scheduler_drives_tp_engine(runs, arm):
    """serve() + Scheduler on a TPEngine, dense and paged int8: every rank
    runs the same Scheduler, and the streams equal the single-device
    Engine's."""
    got = _same_on_every_rank(runs["port"][(1, 2)], arm)
    assert _same_on_every_rank(runs["port"][(1, 2)], arm + "_stats") == len(REQUESTS)
    assert got == runs["ref"][("requests", arm.endswith("int8"))]


def test_tp_engine_sampling_step(runs):
    """Non-greedy sampling: the same torch.Generator seed on every rank of
    the group gives every rank the same in-vocab tokens."""
    toks = np.asarray(_same_on_every_rank(runs["port"][(1, 2)], "sampled"))
    assert toks.shape == (1, 3)
    assert ((toks >= 0) & (toks < TINY_CONFIG.vocab_size)).all()


def test_tp_engine_samples_each_row_over_the_data_axis(runs):
    """Four identical prompts at temperature 1.0 over 16 tokens, one
    generator seed on every rank: on the (2, 2) mesh rows 0 and 2 (one in
    each data group) sample different streams and every rank agrees on
    every token; at data axis 1 the (1, 4) mesh's stream is the
    single-device Engine's, draw for draw."""
    got = np.asarray(_same_on_every_rank(runs["port"][(2, 2)], "sampled4"))
    assert got.shape == (4, 16)
    assert ((got >= 0) & (got < TINY_CONFIG.vocab_size)).all()
    assert not np.array_equal(got[0], got[2]) and not np.array_equal(got[1], got[3])
    engine = runs["engine_sampled4"][0]
    assert all(e == engine for e in runs["engine_sampled4"])
    assert _same_on_every_rank(runs["port"][(1, 4)], "sampled4") == engine


def test_spec_scheduler_drives_tp_engine(runs):
    """The speculative Scheduler on a TPEngine (its spec_verify hook): the
    streams equal the plain TP Scheduler's and the single-device Engine's."""
    got = _same_on_every_rank(runs["port"][(1, 2)], "spec")
    assert got == _same_on_every_rank(runs["port"][(1, 2)], "spec_plain")
    assert got == runs["ref"][("spec_requests", False)]


@pytest.mark.parametrize("arm", ["dense", "int8"])
def test_decode_data_axis_traffic_is_zero(runs, arm):
    """A decode step's forward on a (2, 2) mesh: collectives on the model
    axis only (2 all-reduces a layer, the embedding's, the logits'
    all-gather); the sampling step adds one all-gather of the B token ids
    over the data axis and nothing else there."""
    L = TINY_CONFIG.n_layers
    for res in runs["port"][(2, 2)]:
        fwd, smp = res[f"{arm}_step_stats"], res[f"{arm}_sample_stats"]
        assert fwd["data"] == {}
        assert fwd["model"]["all_reduce"] == 2 * L + 1 and fwd["model"]["all_gather"] == 1
        assert fwd["model"]["bytes"] > 0
        assert smp["data"] == {"all_gather": 1, "bytes": 2 * 4}
        assert smp["model"] == fwd["model"]


def test_mesh_groups(runs):
    """Host-major layout: rank = d * n_model + m."""
    for nd, nm in MESHES:
        for rank, res in enumerate(runs["port"][(nd, nm)]):
            d, m = divmod(rank, nm)
            assert res["model_group"] == [d * nm + j for j in range(nm)]
            assert res["data_group"] == [i * nm + m for i in range(nd)]


def test_make_multihost_mesh_in_four_ranks(runs):
    """One node of 4 ranks: (1, 4); nodes of 2: (2, 2) with each model group
    inside a node; a model axis across nodes or not dividing a node raises."""
    for rank, mh in enumerate(runs["multihost"]):
        assert mh["one_node"] == [1, 4]
        assert mh["two_nodes"] == [2, 2, [0, 1] if rank < 2 else [2, 3]]
        assert "cross nodes" in mh["across_nodes"]
        assert "not divisible" in mh["not_dividing"]


def test_make_multihost_mesh_single_process():
    """One process: a mesh of one rank, as the reference's single host
    gives (n_devices, 1) at n_model = 1; a model axis past the node raises
    in both."""
    mesh = multihost.make_multihost_mesh(backend="gloo", device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert jax_multihost.make_multihost_mesh(n_model=1).shape["model"] == 1
    with pytest.raises(ValueError):
        multihost.make_multihost_mesh(2, backend="gloo", device="cpu")
    with pytest.raises(ValueError):
        jax_multihost.make_multihost_mesh(n_model=len(jax.devices()) * 2)


def test_make_mesh_takes_an_explicit_backend():
    with pytest.raises(ValueError, match="backend"):
        sharding.make_mesh(1, 1, backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="nccl needs a CUDA device"):
        sharding.make_mesh(1, 1, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        sharding.make_mesh(2, 1, backend="gloo", device="cpu")


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_local_config_geometry(tp):
    """As the reference's: heads, KV heads (one duplicated head a shard at
    tp = 4 > 2 KV heads), d_ff and vocab rows a shard."""
    ours, theirs = local_config(TINY_CONFIG, tp), jax_local_config(JAX_TINY_CONFIG, tp)
    assert (ours.n_heads, ours.n_kv_heads, ours.d_ff, ours.vocab_size) == (
        theirs.n_heads, theirs.n_kv_heads, theirs.d_ff, theirs.vocab_size)
    with pytest.raises(ValueError):
        local_config(TINY_CONFIG, 3)
    # the port does not pad the vocab: ceil(V / tp) rows a shard
    assert local_config(dataclasses.replace(TINY_CONFIG, vocab_size=511), 2).vocab_size == 256


def test_param_and_cache_pspec_match_jax():
    """The placement plan by role name equals the reference's."""
    mesh = sharding.Mesh(sharding.Axis("data", 2, 0, None, "gloo"),
                         sharding.Axis("model", 4, 1, None, "gloo"), torch.device("cpu"))
    jmesh = jax_make_mesh(2, 4)
    for path, shape in (("layers.0.attn_qkv", (2560, 2048)), ("layers.0.attn_output", (2048, 2048)),
                        ("layers.3.ffn_down", (2048, 16384)), ("layers.0.ffn_gate_up", (6, 8)),
                        ("embed", (256000, 2048)), ("layers.0.attn_norm", (2048,)),
                        ("layers.0.attn_k", (256, 2048)), ("layers.0.attn_output", (64, 6))):
        assert sharding.param_pspec(path, shape, mesh) == tuple(
            jax_sharding.param_pspec(path, shape, jmesh))
    for batch in (1, 2, 8):
        for q in (False, True):
            assert sharding.cache_pspec(TINY_CONFIG, mesh, batch, q) == tuple(
                jax_sharding.cache_pspec(JAX_TINY_CONFIG, jmesh, batch, q))


def test_shard_params_and_cache_follow_the_plan(tmp_path):
    cfg, model = load_params(PortReader(make_gguf(tmp_path / "m.gguf", TINY_KERNEL_CONFIG, seed=1,
                                                  weight_type="q8_0")), "cpu")
    mesh = sharding.Mesh(sharding.Axis("data", 1, 0, None, "gloo"),
                         sharding.Axis("model", 2, 1, None, "gloo"), torch.device("cpu"))
    shards = sharding.shard_params(model, mesh)
    qkv = model.layers[0].attn_qkv
    assert torch.equal(dequant(shards["layers.0.attn_qkv"]), dequant(qkv)[qkv.shape[0] // 2:])
    out = model.layers[1].attn_output
    assert torch.equal(dequant(shards["layers.1.attn_output"]), dequant(out)[:, out.shape[1] // 2:])
    assert torch.equal(shards["final_norm.weight"], model.final_norm.weight)
    from gemma_tpu_torch.runtime.kv_cache import KVCache

    two_heads = dataclasses.replace(TINY_KERNEL_CONFIG, n_kv_heads=2)
    cache = KVCache.create(two_heads, 4, 8)
    cache.k[0].copy_(torch.arange(cache.k[0].numel()).reshape(cache.k[0].shape))
    part = sharding.shard_cache(cache, two_heads, mesh)
    assert torch.equal(part.k[0], cache.k[0][:, 1:])


FORMATS = {"q4_0": "q4_0", "q8_0": "q8_0", "q4_k_m": "q4_k"}


@pytest.mark.parametrize("weight_type", ["q4_0", "q8_0", "q4_k_m"])
def test_quant_matmul_on_shard_local_weights(tmp_path, weight_type):
    """TINY_KERNEL_CONFIG at tp = 2: every shard-local weight's row and column
    slices dequantize bit for bit to the slices of the full dequantized
    weight; ffn_down's two column partial sums (the plain versions the
    kernels are held to) add up to the full product within 1e-5 of its
    scale; a shard that would cut a k-quant block raises (attn_output's K =
    128 of 256-element q4_k blocks)."""
    cfg, model = load_params(PortReader(make_gguf(tmp_path / "m.gguf", TINY_KERNEL_CONFIG, seed=2,
                                                  weight_type=weight_type)), "cpu")
    layer = {k: getattr(model.layers[0], k) for k in model.layers[0]._modules}
    down = layer["ffn_down"]
    full = dequant(down)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(8, cfg.d_ff)).astype(np.float32))
    y = PLAIN[down.fmt](x, down)
    parts = []
    for i in range(2):
        lo, hi = i * cfg.d_ff // 2, (i + 1) * cfg.d_ff // 2
        local = select_cols(down, lo, hi)
        assert torch.equal(dequant(local), full[:, lo:hi])
        parts.append(PLAIN[down.fmt](x[:, lo:hi], local))
    assert float((parts[0] + parts[1] - y).abs().max()) <= 1e-5 * float(y.abs().max())
    rows = select_rows(down, slice(64, 128))
    assert torch.equal(dequant(rows), full[64:128])
    lw = layer_weights(model.layers[0])
    if weight_type == "q4_k_m":
        with pytest.raises(ValueError, match="whole"):
            shard_layer(lw, cfg, 2, 0)
        return
    for i in range(2):
        local = shard_layer(lw, cfg, 2, i)
        # q|k|v re-fused per shard: its query head, then the one KV head (duplicated)
        q = dequant(layer["attn_qkv"])
        qd, hd = cfg.q_dim, cfg.head_dim
        want = torch.cat([q[i * qd // 2 : (i + 1) * qd // 2], q[qd : qd + hd], q[qd + hd :]])
        assert torch.equal(dequant(local["attn_qkv"]), want)
        assert torch.equal(dequant(local["attn_output"]),
                           dequant(layer["attn_output"])[:, i * qd // 2 : (i + 1) * qd // 2])
    head = shard_vocab(model.embed, cfg, 2, 1)
    assert torch.equal(dequant(head), dequant(model.embed)[256:])


def test_select_cols_matches_the_jax_layout_slice():
    """A column slice of the port's layout is the port's layout of the
    reference's QTensor sliced on its K-granule axis (arrays [K-granule,
    N]); q4_0 and q8_0 at 32-element blocks."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(64, 256)).astype(np.float32)
    for fmt, arrays_of in (("q4_0", lambda a, lo, hi: {"qs": a["qs"][lo // 2 : hi // 2],
                                                        "scales": a["scales"][lo // 32 : hi // 32]}),
                           ("q8_0", lambda a, lo, hi: {"qs": a["qs"][lo:hi],
                                                        "scales": a["scales"][lo // 32 : hi // 32]})):
        jq = quantize_array(w, fmt)
        arrays = {k: np.asarray(a) for k, a in jq.arrays.items()}
        ours = from_jax(fmt, arrays)
        for lo, hi in ((0, 128), (128, 256), (32, 96)):
            assert torch.equal(dequant(select_cols(ours, lo, hi)),
                               dequant(from_jax(fmt, arrays_of(arrays, lo, hi))))
        with pytest.raises(ValueError, match="whole"):
            select_cols(ours, 16, 64)


def test_build_tp_params_is_the_shard_of_make_params(tmp_path):
    """`make_params(tp=...)` draws the same model and cuts the same shard as
    `build_tp_params` of the whole model (the chip's ranks build their shard
    without the whole model)."""
    from gemma_tpu_torch.testing import make_params

    cfg = dataclasses.replace(TINY_KERNEL_CONFIG, n_heads=4)
    whole = make_params(cfg, "q4_0", seed=5)
    for i in range(2):
        mesh = sharding.Mesh(sharding.Axis("data", 1, 0, None, "gloo"),
                             sharding.Axis("model", 2, i, None, "gloo"), torch.device("cpu"))
        a, b = build_tp_params(whole, cfg, mesh), make_params(cfg, "q4_0", seed=5, tp=(i, 2))
        assert a.tp_shard == b.tp_shard == (i, 2)
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def test_bench_scaling_runs_gloo_ranks_on_the_cpu(capsys):
    """tools/bench_scaling.py on the CPU: meshes of 1 and 2 gloo ranks, the
    reference's JSON keys, and the line that says CPU ranks do not measure
    scaling."""
    from gemma_tpu_torch.tools import bench_scaling

    assert bench_scaling.main(["--device", "cpu", "--max-ranks", "2", "--tokens", "2",
                               "--batch", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "not scaling" in lines[0]
    summary = json.loads(lines[-1])
    assert summary["metric"] == "scaling_efficiency" and summary["devices"] == "cpu, gloo"
    assert set(summary["tokens_per_sec"]) == set(summary["efficiency"]) == {"1", "2"}
    assert summary["efficiency"]["1"] == 1.0


def test_place_cache_cuts_a_global_cache():
    """`place_cache` keeps a cache of `new_cache` as it is and cuts a global
    one (`cache_heads` slots, the whole batch) to this rank's KV heads and
    data rows; a paged cache on a data axis raises (`cache_specs`)."""
    from gemma_tpu_torch.parallel.shard_decode import TPEngine, cache_heads
    from gemma_tpu_torch.runtime.kv_cache import KVCache
    from gemma_tpu_torch.testing import make_params

    cfg = dataclasses.replace(TINY_KERNEL_CONFIG, n_heads=4, n_kv_heads=2)
    model = make_params(cfg, "q8_0", seed=1)
    for nd, d, m, tp in ((1, 0, 1, 2), (2, 1, 0, 2), (1, 0, 3, 4)):
        mesh = sharding.Mesh(sharding.Axis("data", nd, d, None, "gloo"),
                             sharding.Axis("model", tp, m, None, "gloo"), torch.device("cpu"))
        eng = TPEngine(cfg, model, mesh, max_seq_len=16, max_batch=4)
        local = eng.new_cache()
        assert eng.place_cache(local) is local and local.k[0].shape[:2] == (4 // nd, 1)
        whole = KVCache.create(dataclasses.replace(cfg, n_kv_heads=cache_heads(cfg, tp)), 4, 16)
        whole.k[0].copy_(torch.arange(whole.k[0].numel()).reshape(whole.k[0].shape))
        want = whole.k[0][d * 4 // nd : (d + 1) * 4 // nd, m : m + 1].clone()
        got = eng.place_cache(whole)
        assert torch.equal(got.k[0], want) and got.length.shape == (4,)
    from gemma_tpu_torch.parallel.shard_decode import cache_specs
    from gemma_tpu_torch.runtime.paged_kv import PagedKVCache

    paged = PagedKVCache.create(eng.lcfg, 4, 9, page_size=8, max_seq_len=16)
    assert cache_specs(cfg, mesh, 4, paged)["k_pages"] == (None, "model", None, None)
    two = sharding.Mesh(sharding.Axis("data", 2, 0, None, "gloo"),
                        sharding.Axis("model", 2, 0, None, "gloo"), torch.device("cpu"))
    with pytest.raises(ValueError, match="data axis"):
        cache_specs(cfg, two, 4, paged)
