"""The port's benches (`gemma_tpu_torch/tools/`) end to end on the CPU at
small shapes, their harness, and the wrappers' argument checks. On the CPU
the benches run the plain versions; on the card (chip_smoke.py phases 7,
11 and 12) they launch the kernels. The serving bench's counts are held to
the JAX package's Scheduler on the same requests; the decode sweep's
outputs to the JAX `decode_attention` at the same block_s, and the cache
probe's programs to the same programs built from the JAX package's
`KVCache` and `decode_attention`."""
import dataclasses
import importlib
import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gemma_tpu.gguf import GGUFReader
from gemma_tpu.ops.attention import decode_attention as jax_decode
from gemma_tpu.models.params import load_params as jax_load_params
from gemma_tpu.runtime import Engine as JaxEngine
from gemma_tpu.runtime import EngineConfig as JaxEngineConfig
from gemma_tpu.runtime.kv_cache import KVCache as JaxKVCache
from gemma_tpu.runtime.scheduler import Request as JaxRequest
from gemma_tpu.runtime.scheduler import Scheduler as JaxScheduler
from gemma_tpu_torch.models import from_jax_params, load_params
from gemma_tpu_torch.ops import qmm_variants as qv
from gemma_tpu_torch.quant.qtensor import QTensor
from gemma_tpu_torch.runtime import Engine, EngineConfig, Request
from gemma_tpu_torch.testing import TINY_KERNEL_CONFIG, make_gguf
from gemma_tpu_torch.tools import _timing as T
from gemma_tpu_torch.tools import (bench_bn_sweep, bench_decode_attn, bench_prefill, bench_q4k_variants,
                                   bench_q6k_variants, bench_qmm_variants, bench_serving,
                                   bench_spec, probe_cache_cost, probe_int4, probe_spec_serving)

CPU = torch.device("cpu")
TOOLS = ["bench_qmm_variants", "bench_bn_sweep", "probe_int4", "bench_q4k_variants",
         "bench_q6k_variants", "bench_prefill", "bench_spec", "probe_spec_serving",
         "bench_serving", "bench_itl", "bench_longctx", "bench_step_parts", "bench_micro",
         "bench_scan", "bench_decode_attn", "probe_cache_cost", "bench_flash", "bench_fmt_kernels",
         "bench_shapes"]
LINE = re.compile(r"\d+\.\d\d us +\d+\.\d GB/s +\d\.\d{3} of 3\.35 TB/s; bound \d+\.\d\d us "
                  r"\((bytes|operations)\)")


def test_bench_qmm_variants_runs_every_config(capsys):
    out = bench_qmm_variants.run([("tiny", 128, 512)], CPU, reps=1)
    assert len(out) == len(bench_qmm_variants.CONFIGS) + 1  # and gdot at M = 1
    assert out[("tiny", "gdot", "float16", 1)]["flops"] * 8 == out[("tiny", "gdot", "float16", 8)]["flops"]
    text = capsys.readouterr().out
    assert text.splitlines()[0].startswith("cpu (cpu: plain PyTorch versions")
    assert len(LINE.findall(text)) == len(bench_qmm_variants.CONFIGS) + 1
    assert "exact" in text and 'launches {"row_checksum": 0, "qmm_variant": 0}' in text


def test_bench_qmm_variants_cli_on_one_shape(capsys):
    assert bench_qmm_variants.main(["attn_out", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "attn_out [2048, 2048]" in text and "ffn_down" not in text
    assert len(LINE.findall(text)) == len(bench_qmm_variants.CONFIGS) + 1


def test_bench_bn_sweep_runs_every_warp_count(capsys):
    out = bench_bn_sweep.run([("tiny", 96, 1024)], CPU, reps=1)
    assert sorted(w for _, w in out) == list(qv.WARPS)
    assert len(LINE.findall(capsys.readouterr().out)) == len(qv.WARPS)


def test_bench_q4k_variants_runs_every_mode(capsys):
    out = bench_q4k_variants.run(CPU, reps=1, n=64, k=1024)
    assert list(out) == list(qv.Q4_K_MODES)
    # nosub reads no 6-bit table; q4_0ref reads f16 scales of the same size
    assert out["nosub"]["bytes"] < out["prod"]["bytes"] == out["q4_0ref"]["bytes"]
    assert len(LINE.findall(capsys.readouterr().out)) == len(qv.Q4_K_MODES)


def test_bench_q6k_variants_runs_every_mode(capsys):
    out = bench_q6k_variants.run(CPU, reps=1, n=64, k=1024)
    assert list(out) == list(bench_q6k_variants.MODES)
    assert out["prod"]["bpw"] == 8.5625 and out["split_int"]["bpw"] == 6.5625
    assert len(LINE.findall(capsys.readouterr().out)) == len(bench_q6k_variants.MODES)


def test_bench_prefill_reports_marginal_rates(capsys):
    """On the CPU: the tiny config at a sixteenth of the card's lengths."""
    out = bench_prefill.run(CPU, fmts=("q4_k_m",), reps=1)
    assert list(out) == ["q4_k_m"]
    assert list(out["q4_k_m"]) == ["mono_T64_to_T128", "chunked_T128_to_T256"]
    assert all(r > 0 for r in out["q4_k_m"].values())
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("cpu (cpu: plain PyTorch versions")
    record = json.loads(lines[-1])
    assert record["metric"] == "prefill_tokens_per_sec_tiny_q4_k_m"
    assert record["unit"] == "tokens/s (marginal)" and record["launches"] == {}
    assert record["mono_T64_to_T128"] == out["q4_k_m"]["mono_T64_to_T128"]


def test_bench_prefill_cli_takes_formats(capsys):
    assert bench_prefill.main(["--fmt", "q4_0", "--fmt", "q8_0", "--device", "cpu"]) == 0
    metrics = [json.loads(line)["metric"] for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert metrics == ["prefill_tokens_per_sec_tiny_q4_0", "prefill_tokens_per_sec_tiny_q8_0"]


@pytest.fixture
def one_torch_thread():
    # the tiny model's eager steps are thousands of small ops: one thread
    # runs them as fast alone, and does not spin against other workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_bench_spec_reports_both_workloads(capsys, one_torch_thread):
    """On the CPU (tiny config, f32-exact plain versions): the speculative
    stream equals plain greedy in both workloads; the repetitive one cycles
    and its drafts are accepted, the random one's drafts all miss."""
    out = bench_spec.run(CPU, tokens=12, reps=1)
    assert list(out) == ["repetitive", "random"]
    assert out["repetitive"]["cycles"] and out["repetitive"]["tokens_per_verify"] > 1
    assert out["random"]["tokens_per_verify"] == 1.0
    assert all(r["first_token_unlike_plain"] is None and r["plain_tok_s"] > 0
               for r in out.values())
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert [r["metric"] for r in records] == ["speculative_decode_tiny_q4_0_repetitive",
                                              "speculative_decode_tiny_q4_0_random"]
    assert records[0]["k"] == 7 and records[0]["block"] == 4


def test_spec_tools_parse_their_arguments(monkeypatch):
    """Both CLIs hand their flags to `run` (which the tests above drive)."""
    calls = []
    for tool in (bench_spec, probe_spec_serving):
        monkeypatch.setattr(tool, "run", lambda *a: calls.append(a))
    assert bench_spec.main(["--k", "3", "--block", "2", "--tokens", "6", "--device", "cpu"]) == 0
    assert probe_spec_serving.main(["--blocks", "2", "--device", "cpu"]) == 0
    assert calls == [(CPU, 3, 2, 6), (CPU, 2)]


def test_probe_spec_serving_reads_both_blocks(capsys, one_torch_thread):
    out = probe_spec_serving.run(CPU, blocks=2)
    assert out["speculative"]["ticks_a_block"] == 4 and out["plain"]["steps_a_block"] == 8
    assert out["speculative"]["tokens_per_verify"] >= 1
    assert out["speculative"]["issue_ms"] > 0 and out["plain"]["wall_ms_block"] > 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["metric"] == "spec_serving_tick_tiny_q4_0" and record["slots"] == 8


def test_probe_int4_prints_ok_lines(capsys):
    assert probe_int4.main(["--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert text.count(" OK: ") == 4 and "WRONG" not in text


@pytest.mark.parametrize("name", TOOLS)
def test_benches_run_on_the_card_by_default(name, monkeypatch):
    """No CUDA device and no `--device cpu`: the CLI's message, no run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(f"gemma_tpu_torch.tools.{name}").main([])


def test_copies_fill_twice_the_l2():
    cuda = torch.device("cuda")
    assert T.copies_for(2048 * 1024 + 2048 * 64 * 2, cuda) == 43  # attn_out: 43 copies
    assert T.copies_for(288_000_000, cuda) == 1  # the head
    assert T.copies_for(1000, cuda) == T.MAX_COPIES
    assert T.copies_for(1000, CPU) == 1
    qt = QTensor("q4_0", qs=torch.zeros(4, 16, dtype=torch.uint8),
                 scales=torch.ones(4, 1, dtype=torch.float16))
    sets = T.replicate((torch.ones(2), qt, {"a": torch.zeros(3)}, 5), 3)
    assert len(sets) == 3 and sets[0][0] is not sets[1][0] and sets[2][3] == 5
    assert sets[1][1].qs.data_ptr() != qt.qs.data_ptr() and torch.equal(sets[1][1].qs, qt.qs)
    assert T.nbytes(*sets[1]) == 8 + 64 + 8 + 12


def test_tally_holds_counters_to_calls():
    tally = T.Tally()
    fn = tally.call("int4_dot", lambda: None)
    fn(), fn()
    assert tally.report(CPU) == 'launches {"int4_dot": 0}'
    with pytest.raises(RuntimeError, match="launch counters"):
        tally.report(torch.device("cuda"))  # no launches were made
    qv.int4_dot.launches = 2
    assert tally.report(torch.device("cuda")) == 'launches {"int4_dot": 2}'
    qv.int4_dot.launches = 0


def test_bound_takes_the_larger_term():
    assert T.bound_us(3.35e6, 0) == pytest.approx((1.0, "bytes"))
    assert T.bound_us(0, 989e6) == pytest.approx((1.0, "operations"))
    # q4_0 at M = 8: 16 flops a 0.5625-byte weight, bound by its bytes
    assert T.bound_us(0.5625e6, 16e6)[1] == "bytes"


def test_row_checksum_wraps_modulo_2_32():
    a = torch.full((2, 4096), -1, dtype=torch.int32)  # 4096 x (2^32 - 1) per row
    b = torch.full((2, 8), 255, dtype=torch.uint8)
    got = qv.row_checksum(a, b)
    want = (4096 * (2**32 - 1) + 8 * 255) % 2**32
    assert got.tolist() == [want - 2**32 if want >= 2**31 else want] * 2


@pytest.mark.parametrize("fn,args,err", [
    (qv.qmm_variant, ("nope", torch.zeros(8, 64, dtype=torch.bfloat16),
                      torch.zeros(4, 32, dtype=torch.uint8), torch.ones(4, 2)), ValueError),
    (qv.qmm_variant, ("u16sc", torch.zeros(8, 64, dtype=torch.bfloat16),
                      torch.zeros(4, 32, dtype=torch.uint8), torch.ones(4, 2)), TypeError),
    (qv.qmm_variant, ("f32dot", torch.zeros(9, 64, dtype=torch.bfloat16),
                      torch.zeros(4, 32, dtype=torch.uint8), torch.ones(4, 2)), ValueError),
    # off the main path's gdot on f16 scales, the modes take M = 8 only
    (qv.qmm_variant, ("f32dot", torch.zeros(4, 64, dtype=torch.bfloat16),
                      torch.zeros(4, 32, dtype=torch.uint8), torch.ones(4, 2)), ValueError),
    (qv.qmm_variant, ("gdot", torch.zeros(1, 64, dtype=torch.bfloat16),
                      torch.zeros(4, 32, dtype=torch.uint8), torch.ones(4, 2)), ValueError),
    (qv.qmm_variant, ("f32dot", torch.zeros(8, 64), torch.zeros(4, 32, dtype=torch.uint8),
                      torch.ones(4, 2)), TypeError),
    (qv.qmm_variant, ("f32dot", torch.zeros(8, 64, dtype=torch.bfloat16, device="meta"),
                      torch.zeros(4, 32, dtype=torch.uint8), torch.ones(4, 2)), ValueError),
    (qv.int4_dot, (torch.zeros(8, 64), torch.zeros(4, 32, dtype=torch.uint8)), TypeError),
    (qv.row_checksum, (torch.zeros(4, 3, dtype=torch.uint8),), ValueError),
])
def test_wrappers_refuse_bad_arguments(fn, args, err):
    with pytest.raises(err):
        fn(*args)


def test_variant_wrappers_check_format_and_rows():
    gen = T.generator(CPU)
    q4k = T.random_qtensor("q4_k", 32, 256, gen, CPU)
    x8 = T.bf16_x(8, 256, gen, CPU)
    with pytest.raises(ValueError, match="q4_0 weight"):
        qv.q4_k_variant("q4_0ref", x8, q4k)
    with pytest.raises(ValueError, match=r"\[8, 256\]"):
        qv.q4_k_variant("prod", x8[:4], q4k)
    with pytest.raises(ValueError, match="warps"):
        qv.q4_0_gemv_warps(x8, qv.q4_0ref_weight(q4k), 64)
    q6k = T.random_qtensor("q6_k", 32, 256, gen, CPU)
    with pytest.raises(ValueError, match="arrays"):
        qv.q6_k_variant("prod", x8, q6k.arrays)
    # the plain versions of the ablations against their definitions
    w = qv.q4_0ref_weight(q4k)
    assert w.fmt == "q4_0" and torch.equal(w.qs, q4k.qs)
    assert float(w.scales.max()) <= 63 and torch.equal(w.scales, w.scales.round())
    q = qv.q6_k_int8_payload(q6k)["qs"]
    assert q.dtype == torch.int8 and int(q.min()) >= -32 and int(q.max()) <= 31
    np.testing.assert_allclose(qv.q6_k_variant("prod", x8, qv.q6_k_int8_payload(q6k)),
                               qv.q6_k_variant("split_int", x8, q6k.arrays), rtol=1e-5, atol=1e-6)


def test_probe_variants_patches_apply_to_the_sources():
    """Every variant of the kernel probe still finds its text in csrc/, once
    (the probe builds and times them on the card only)."""
    from gemma_tpu_torch.tools import probe_variants as pv

    for name in pv.VARIANTS:
        changed = pv.patched_sources(name)
        assert set(changed) <= {"dq_gemv.cuh", "dq_tile.cuh", "dq_tile_tf32.cuh"}, name
        assert bool(changed) == (name != "base"), name
    with pytest.raises(SystemExit, match="no CUDA device"):
        pv.main(["gemv", "--variants", "base"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        pv.main(["tf32", "--variants", "base,tf_cvt", "--fmt", "q4_k,q6_k"])
    with pytest.raises(SystemExit, match="unknown variants"):
        pv.main(["tile", "--variants", "nope"])


def test_probe_mutants_patch_the_attention_kernels_only():
    """Each planted fault of `probe_variants mutants` finds its text once in
    one attention kernel's source (the tensor-core decode core that dense
    and paged decode share, the G = 1 decode core, the flash kernel, or the
    3xTF32 product the f32 flash and decode kernels share), and none of the
    timing variants touches those sources."""
    from gemma_tpu_torch.tools import probe_variants as pv

    sources = {"decode_tc.cuh", "decode_g1.cuh", "flash_attention.cu", "attn_tc.cuh"}
    assert set(pv.MUTANTS) & set(pv.VARIANTS) == set()
    for name in pv.MUTANTS:
        changed = pv.patched_sources(name)
        assert len(changed) == 1 and set(changed) <= sources
    assert {f for name in pv.MUTANTS for f in pv.patched_sources(name)} == sources


def test_attn_err_holds_each_row_to_its_own_scale():
    """`_timing.attn_err` scales the tolerance by each row's max|ref| (at
    most 1): a small row fails on an error a large row would absorb, a row
    of zeros must stay exactly 0, and a non-finite output fails."""
    from gemma_tpu_torch.tools._timing import attn_err

    ref = torch.tensor([[0.5, -0.25], [0.0, 0.0], [0.0125, 0.025], [2.0, 1.0]])
    assert attn_err(ref.clone(), ref, 2e-2) == (0.0, 0.0, 0.0, 1.0)
    got = ref.clone()
    got[0, 1] += 0.005  # 0.5 of 2e-2 x 0.5
    got[3, 0] += 0.01  # 0.5 of 2e-2 x min(1, 2)
    err, ratio, lo, hi = attn_err(got, ref, 2e-2)
    assert err == pytest.approx(0.01) and ratio == pytest.approx(0.5) and (lo, hi) == (0.0, 1.0)
    got[2, 0] += 0.001  # 2 x (2e-2 x 0.025): an absolute 2e-2 would pass it
    assert attn_err(got, ref, 2e-2)[1] == pytest.approx(2.0)
    got[1, 0] = 1e-6
    assert attn_err(got, ref, 2e-2)[1] == float("inf")
    got = ref.clone()
    got[0, 0] = float("nan")
    assert attn_err(got, ref, 2e-2)[1] == float("inf")


def test_attention_probes_run_on_the_card_only(monkeypatch):
    """`probe_variants attn` and `mutants`, and `parent_turn`, run kernels on
    the card: without one they stop before building or loading anything."""
    from gemma_tpu_torch.tools import parent_turn
    from gemma_tpu_torch.tools import probe_variants as pv

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("attn", "mutants"):
        with pytest.raises(SystemExit, match="no CUDA device"):
            pv.main([mode])
    with pytest.raises(SystemExit, match="no CUDA device"):
        parent_turn.main(["--turn", "change", "--shapes", '{"flash": [], "decode": []}'])
    with pytest.raises(SystemExit, match="no CUDA device"):
        parent_turn.main(["--turn", "change", "--decode"])
    with pytest.raises(SystemExit):
        parent_turn.main([])  # neither --parent nor --turn


# the serving and step benches at their smallest arguments on the tiny
# model, and the keys of their last line: the reference tools' own where
# those print JSON (bench_serving, bench_itl, bench_longctx), else the port's
# names for what the reference prints as text
SERVING_KEYS = {"metric", "value", "unit", "requests", "decode_steps", "p50_ttft_s",
                "p99_ttft_s", "block", "wall_s", "admit_per_tick", "prefill_chunk", "kv_quant",
                "fill"}
SMALL_RUNS = {
    "bench_serving": (["--requests", "5", "--batch", "2", "--prompt-len", "12", "--max-new", "4",
                       "--block", "2", "--max-seq-len", "64"], SERVING_KEYS),
    "bench_itl": (["--prompt-len", "40", "--chunk", "8", "--block", "2", "--max-seq-len", "256",
                   "--steady-new", "40", "--repeats", "1"],
                  {"metric", "max_itl_ms_sync", "max_itl_ms_overlap", "prompt_len", "chunk",
                   "block"}),
    "bench_longctx": (["--ctx", "192", "--prefill", "80", "--tokens", "2", "--chunk", "32",
                       "--page-size", "16", "--repeats", "1"],
                      {"metric", "prefill_tokens", "dense", "paged", "page_size_resolved",
                       "dense_int8kv", "paged_int8kv", "page_size", "unit"}),
    "bench_step_parts": (["q4_k_m", "--r", "1", "--reps", "1"],
                         {"metric", "matmuls_ms", "attn_ms", "ew_ms", "step_ms", "tok_s",
                          "attribution_ms", "busy_ms", "kernels_per_token", "chained"}),
    "bench_micro": (["q4_k_m", "--reps", "2"],
                    {"metric", "matmuls", "matmul_sum_ms", "matmul_device_sum_ms", "sdpa_us",
                     "sdpa_device_us", "decode_attention_us", "decode_attention_device_us",
                     "dispatch_us", "step_ms", "tok_s", "peak_gbs"}),
    "bench_scan": (["--steps", "4", "--runs", "1"],
                   {"metric", "chain_ms", "chain_tok_s", "block_ms", "block_tok_s", "scan_ms",
                    "steps", "prompt"}),
}


@pytest.mark.parametrize("name", list(SMALL_RUNS))
def test_serving_and_step_benches_print_their_keys(name, capsys, one_torch_thread):
    """Each bench on the tiny model on the CPU: the card line first, a
    `launches {}` line (the plain versions launch nothing), and a last line
    of exactly its keys (2-6 s a bench)."""
    argv, keys = SMALL_RUNS[name]
    tool = importlib.import_module(f"gemma_tpu_torch.tools.{name}")
    assert tool.main([*argv, "--model", "tiny", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("cpu (cpu: plain PyTorch versions")
    assert "launches {}" in lines
    record = json.loads(lines[-1])
    assert set(record) == keys
    assert "tiny" in record["metric"] or name == "bench_itl"


def test_bench_longctx_runs_the_arms_asked_for(capsys, one_torch_thread):
    """A page-size sweep runs the paged arm alone; the engine's default
    page size is 64 (`page_size_resolved`)."""
    from gemma_tpu_torch.tools import bench_longctx

    assert bench_longctx.main(["--model", "tiny", "--device", "cpu", "--ctx", "192", "--prefill",
                               "70", "--tokens", "2", "--chunk", "64", "--repeats", "1", "--arms",
                               "paged"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(record) == {"metric", "prefill_tokens", "paged", "page_size_resolved", "page_size",
                           "unit"}
    assert record["page_size_resolved"] == 64 and record["page_size"] is None
    with pytest.raises(SystemExit):
        bench_longctx.main(["--device", "cpu", "--arms", "nope"])


def test_bench_serving_reads_its_streams(capsys, one_torch_thread):
    """`--fill centred` fabricates random payloads with centred q4_0 nibbles
    and records it; the `streams` line counts distinct streams and the
    fewest distinct tokens in one (here on made-up requests too). 2-4 s."""
    argv, _ = SMALL_RUNS["bench_serving"]
    assert bench_serving.main([*argv, "--model", "tiny", "--device", "cpu", "--fill",
                               "centred"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["fill"] == "centred"
    words = next(line for line in lines if line.startswith("streams ")).split()
    assert len(words) == 6 and words[2::2] == ["distinct", "fewest"]
    assert 1 <= int(words[3]) <= 5 and 1 <= int(words[5]) <= 4
    done = [Request("a", [1], 3), Request("b", [1], 3), Request("c", [1], 3)]
    for r, tokens in zip(done, ([5, 5, 5], [5, 6, 7], [5, 6, 7])):
        r.tokens = tokens
    assert bench_serving.streams_line(done).split()[2:] == ["distinct", "2", "fewest", "1"]


@pytest.fixture(scope="module")
def tiny_f32(tmp_path_factory):
    """One q4_0 GGUF of TINY_KERNEL_CONFIG in both packages, f32 activations
    (tests/test_torch_admission.py imports it too)."""
    path = make_gguf(tmp_path_factory.mktemp("bench_serving") / "tiny.gguf", TINY_KERNEL_CONFIG,
                     seed=3)
    reader = GGUFReader(path)
    jcfg, jparams = jax_load_params(reader)
    tcfg, _ = load_params(reader, device="cpu")
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    jcfg, tcfg = (dataclasses.replace(c, activation_dtype="float32") for c in (jcfg, tcfg))
    return jcfg, jparams, tcfg, model


@pytest.mark.parametrize("flags", [["--admit-per-tick", "1"], ["--speculative"],
                                   ["--paged", "--kv-quant", "--prefill-chunk", "16",
                                    "--admit-per-tick", "2"]])
def test_bench_serving_counts_what_the_reference_scheduler_counts(tiny_f32, flags, monkeypatch,
                                                                  one_torch_thread):
    """bench_serving's measured run against the JAX Scheduler on the same
    requests over the same model in f32: requests, decode steps, useful
    tokens and streams (speculative: verify forwards too). 6-15 s a case."""
    jcfg, jparams, tcfg, model = tiny_f32
    args = bench_serving.parse_args(["--requests", "7", "--batch", "3", "--prompt-len", "20",
                                     "--max-new", "6", "--block", "2", "--max-seq-len", "64",
                                     "--spec-k", "3", "--spec-block", "2", *flags])
    ecfg = dict(max_seq_len=args.max_seq_len, max_batch=args.batch, paged=args.paged,
                page_size=16, kv_quantized=args.kv_quant, prefill_chunk=args.prefill_chunk)
    got, finished = bench_serving.measure(
        Engine(tcfg, model, EngineConfig(kv_dtype=torch.float32, **ecfg)), args, "tiny_q4_0")
    monkeypatch.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")
    ref = JaxScheduler(JaxEngine(jcfg, jparams, JaxEngineConfig(kv_dtype=jnp.float32,
                                                                 donate_cache=False, **ecfg)),
                       admit_per_tick=args.admit_per_tick, speculative=args.speculative,
                       spec_k=args.spec_k, spec_pipeline=args.spec_pipeline,
                       spec_block=args.spec_block)
    for r in bench_serving.make_requests(args, tcfg.vocab_size, JaxRequest):
        ref.submit(r)
    ref_done = ref.run(block=args.block)
    stats = ref.stats()
    assert got["requests"] == stats["requests"] == args.requests
    assert got["decode_steps"] == stats["decode_steps"]
    assert {r.id: r.tokens for r in finished} == {r.id: r.tokens for r in ref_done}
    useful = sum(min(len(r.tokens), r.max_new_tokens) for r in ref_done)
    assert round(useful / got["wall_s"], 2) == pytest.approx(got["value"], rel=0.05)
    assert got["admit_per_tick"] == args.admit_per_tick
    if args.speculative:
        assert got["speculative"]["spec_forwards"] == stats["spec_forwards"]
        assert got["speculative"]["tokens_discarded"] == stats["tokens_discarded"]


# the reference's last five tools at tiny shapes on the CPU: (argv, the
# regular expression of a reading line, the lines it must print, a line
# that must follow them)
_US = r"\s+[0-9.]+ us"
REF_TOOL_RUNS = {
    "bench_decode_attn": (["--sizes", "64:50,128:100"],
                          r"^\s+(bf16|int8|f32|f32_int8)\s+S=\s+(64|128) limit=\s+(50|100) (split=\s+\d+[ *]|split-S)"
                          r".*" + _US + r"\s+[0-9.]+ GB/s", 2 * 4 * 6, None),
    "bench_flash": (["48"], r"^\s+(row warps [124]|the plan's|scaled_dot_product_attention).*[0-9.]+ us/layer", 5,
                    None),
    "bench_fmt_kernels": (["tiny", "q4_0", "q6_k"], r"^(ffn_down|gate_up|lm_head)\s+(q4_0|q6_k)" + _US, 6,
                          "launches {}"),
    "bench_shapes": (["--model", "tiny"], r"^\s+(qkv|attn_out|gate_up|ffn_down|lm_head|lm_head_pad)\s+\[.*\]" + _US,
                     6, "  sum over decode matmuls (raw lm_head)"),
    "probe_cache_cost": (["--layers", "2", "--heads", "2", "--head-dim", "128", "--sizes", "64,96", "--limit",
                          "40", "--steps", "2"], r"^\s+S=(64|96): \S+\s+[0-9.]+ ms/step host", 10,
                         "  per-layer-combined   S=96 / S=64: host"),
}


@pytest.mark.parametrize("name", list(REF_TOOL_RUNS))
def test_reference_tools_print_their_lines(name, capsys, one_torch_thread):
    """Each of the five on the CPU (plain versions): the card line first,
    then its reading lines, each marked as the CPU's host times, and what
    follows them (the launches, the step's sum, the ratios)."""
    argv, pattern, n, then = REF_TOOL_RUNS[name]
    tool = importlib.import_module(f"gemma_tpu_torch.tools.{name}")
    assert tool.main([*argv, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("cpu (cpu: plain PyTorch versions")
    readings = [line for line in lines if re.match(pattern, line)]
    assert len(readings) == n and all(line.endswith(T.CPU_NOTE) for line in readings)
    assert then is None or any(line.startswith(then) for line in lines)
    if name == "bench_decode_attn":  # the route's split, marked once an arm and size
        assert sum("*" in line for line in readings) == 4 * 2


def test_bench_decode_attn_holds_the_jax_kernel(monkeypatch):
    """The sweep's outputs on the CPU (the plain versions) against the JAX
    package's `decode_attention` (`_decode_kernel` in interpret mode) at
    each split as its block_s, on the same inputs, in every arm: 2e-2 of
    each row's scale (p, or p * vs, rounds to bf16 against other maxima)."""
    monkeypatch.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")
    records = bench_decode_attn.run(CPU, sizes=((64, 50),), splits=(32, 64), reps=1)
    by_arm, lim = bench_decode_attn.make_inputs(64, 50, 8, 1, CPU)
    for r in records:
        if r["split"] == "split-S":
            continue
        q, k, v, ks, vs = by_arm[r["arm"]]
        dtype = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
        jq, jk, jv = (jnp.asarray(x.float().numpy(), dtype) if x.dtype != torch.int8 else jnp.asarray(x.numpy())
                      for x in (q, k, v))
        scales = {} if ks is None else dict(k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()))
        ref = jax_decode(jq, jk, jv, jnp.asarray(lim.numpy()), block_s=r["split"], **scales)
        ratio = T.attn_err(r["out"].float(), torch.from_numpy(np.array(ref, np.float32)), 2e-2)[1]
        assert ratio <= 1.0, (r["arm"], r["split"], ratio)


def _jax_cache_program(probe: str, init: dict, steps: int, limit: int):
    """`probe_cache_cost`'s program `probe` built from the JAX package's
    functions (`KVCache.write_token`, `decode_attention`) on the same
    initial state: (final K and V of each layer, the last output)."""
    bf = jnp.bfloat16
    q = jnp.asarray(init["q"], bf)
    k = tuple(jnp.asarray(x, bf) for x in init["k"])
    v = tuple(jnp.asarray(x, bf) for x in init["v"])
    lim = jnp.asarray([limit], jnp.int32)
    cache = JaxKVCache(k=k, v=v, length=lim)
    out = None
    if probe == "write":
        new = jnp.asarray(init["new"], bf)
        at = min(probe_cache_cost.WRITE_AT, k[0].shape[2] - steps)
        for step in range(steps):
            for layer in range(len(k)):
                kn = new + bf(step + layer)
                cache = cache.write_token(layer, jnp.asarray([at + step], jnp.int32), kn, kn)
        return cache.k, cache.v, None
    qq = q
    for step in range(steps):
        for layer in range(len(k)):
            if probe.endswith("combined"):
                kn = qq + bf(layer)
                cache = cache.write_token(layer, lim + step, kn, kn)
                out = jax_decode(qq, cache.k[layer], cache.v[layer], lim + step + 1)
            else:
                out = jax_decode(qq, k[layer], v[layer], lim)
            qq = q + out[:, :, :1, :1].astype(bf) * bf(1e-8)
    return cache.k, cache.v, out


@pytest.mark.parametrize("probe", probe_cache_cost.PROBES)
def test_probe_cache_cost_runs_the_reference_programs(probe, monkeypatch, one_torch_thread):
    """Each probe's two chained steps at L = 2, H = 2, S = 64, D = 128 on
    the CPU against the same program from the JAX package's functions: the
    final caches equal bit for bit (every write stores the same bf16
    token), the last output within 2e-2 of each row's scale."""
    monkeypatch.setenv("GEMMA_TPU_INTERPRET_KERNELS", "1")
    st = probe_cache_cost.make_state(probe, 64, 40, CPU, layers=2, heads=2, d=128)
    init = {key: ([x.float().numpy() for x in st[key]] if key in ("k", "v") else st[key].float().numpy())
            for key in ("q", "k", "v", "new") if key in st}
    out = probe_cache_cost.run_steps(probe, st, 2)
    ref_k, ref_v, ref_out = _jax_cache_program(probe, init, 2, 40)
    for got, ref in zip((*st["cache"].k, *st["cache"].v), (*ref_k, *ref_v)):
        assert np.array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    if probe == "write":
        assert out is None
    else:
        assert T.attn_err(out.float(), torch.from_numpy(np.array(ref_out, np.float32)), 2e-2)[1] <= 1.0
