"""The port's decode-GEMV benches (`gemma_tpu_torch/tools/`) end to end on
the CPU at small shapes, their harness, and the wrappers' argument checks.
On the CPU the benches run the plain versions; on the card (chip_smoke.py
phase 7) they launch the kernels."""
import importlib
import json
import re

import numpy as np
import pytest
import torch

from gemma_tpu_torch.ops import qmm_variants as qv
from gemma_tpu_torch.quant.qtensor import QTensor
from gemma_tpu_torch.tools import _timing as T
from gemma_tpu_torch.tools import (bench_bn_sweep, bench_prefill, bench_q4k_variants,
                                   bench_q6k_variants, bench_qmm_variants, bench_spec, probe_int4,
                                   probe_spec_serving)

CPU = torch.device("cpu")
TOOLS = ["bench_qmm_variants", "bench_bn_sweep", "probe_int4", "bench_q4k_variants",
         "bench_q6k_variants", "bench_prefill", "bench_spec", "probe_spec_serving"]
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
    and paged decode share, the flash kernel, or the 3xTF32 product the
    f32 flash and decode kernels share), and none of the timing variants
    touches those sources."""
    from gemma_tpu_torch.tools import probe_variants as pv

    sources = {"decode_tc.cuh", "flash_attention.cu", "attn_tc.cuh"}
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
