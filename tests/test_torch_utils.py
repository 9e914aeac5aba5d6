"""The port's diagnostics (`gemma_tpu_torch/utils/`: device, profiling,
tensor_dump, verify), `load_params(mode="dequant")` and the CLI's `bench`,
`quantize`, `--verify`, `--profile` and `--mode`, against the JAX package.

Tolerances:
* `capture_activations`, f32 activations and cache on an F32 GGUF (both
  packages load dense bf16 weights): every activation the reference
  records within 1e-4 of its scale (max |ref|) over the prompt's rows; the
  reference pads T to a bucket, the port does not.
* dequant mode on a q4_0 GGUF: both packages dequantize with ggml's codecs
  to bf16, so f32 logits agree to 1e-5 of their scale and greedy streams
  are equal; bf16 activations to 5e-2 with the same prefill top-1
  (`tests/test_torch_model.py`'s bounds).
* verify on the CPU: both sides run the plain versions, so max |Δ| is 0.
* quantize: the output file equals the reference CLI's byte for byte.
"""
import dataclasses
import functools
import hashlib
import importlib.util
import json
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gemma_tpu import cli as jax_cli
from gemma_tpu.gguf import GGUFReader
from gemma_tpu.models import load_params as jax_load_params
from gemma_tpu.runtime import Engine as JaxEngine
from gemma_tpu.runtime import EngineConfig as JaxEngineConfig
from gemma_tpu.utils import device as jax_device
from gemma_tpu.utils import profiling as jax_profiling
from gemma_tpu.utils import tensor_dump as jax_tensor_dump
from gemma_tpu_torch import cli
from gemma_tpu_torch.models import load_params
from gemma_tpu_torch.ops import attention as att
from gemma_tpu_torch.ops import paged_attention as pat
from gemma_tpu_torch.ops import quant_matmul as qmm
from gemma_tpu_torch.quant.qtensor import QTensor
from gemma_tpu_torch.runtime import Engine, EngineConfig
from gemma_tpu_torch.testing import TINY_CONFIG, TINY_KERNEL_CONFIG, make_gguf
from gemma_tpu_torch.tools import _timing
from gemma_tpu_torch.utils import device, profiling, tensor_dump
from gemma_tpu_torch.utils.verify import format_report, verify_device_kernels

ROOT = Path(__file__).resolve().parents[1]
PROMPT = [1, 7, 300, 42, 260, 9, 77]
# every K a multiple of 256, so the K-quant types of `quantize` apply
KQUANT_CONFIG = dataclasses.replace(TINY_CONFIG, d_model=256, head_dim=64, d_ff=512)


@pytest.fixture(autouse=True)
def _xla_reference_paths(monkeypatch):
    # other test modules set this process-wide; the reference runs its XLA paths
    monkeypatch.delenv("GEMMA_TPU_INTERPRET_KERNELS", raising=False)


@pytest.fixture(autouse=True)
def _profilers_off():
    yield
    for prof in (profiling, jax_profiling):
        prof.enable(sync_every=0)
        prof.disable()
        prof.reset()


@pytest.fixture(scope="module")
def q4_0_path(tmp_path_factory):
    return make_gguf(tmp_path_factory.mktemp("u") / "q4_0.gguf", TINY_CONFIG, seed=3)


@pytest.fixture(scope="module")
def f32_path(tmp_path_factory):
    return make_gguf(tmp_path_factory.mktemp("u") / "f32.gguf", TINY_CONFIG, weight_type="f32",
                     seed=3)


# -- device ------------------------------------------------------------------

def test_device_lookup_by_name():
    assert device.peaks_for("NVIDIA H100 80GB HBM3") == device.H100_SXM == (3350.0, 989e12)
    # the benches' harness reads the same numbers
    assert (_timing.HBM_BPS, _timing.BF16_FLOPS) == (3350.0 * 1e9, 989e12)
    assert all("h100" in name for name, _ in device._PEAKS)  # no TPU entries


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "TPU v5 lite"])
def test_unknown_device_gets_the_nominal_pair(name):
    with pytest.warns(UserWarning, match="nominal"):
        assert device.peaks_for(name) == device.NOMINAL
    with pytest.warns(UserWarning, match="nominal"):
        cpu = device.device_peaks("cpu")
    assert cpu == device.NOMINAL == jax_device.device_peaks()  # the reference on the CPU


# -- profiling ---------------------------------------------------------------

class _Clock:
    """A perf_counter that advances 1.5 ms a reading."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.5e-3
        return self.t


def _drive(prof):
    prof.reset()
    prof.enable()
    with prof.span("outer"):
        with prof.span("op.mul_mat"):
            pass
        with prof.span("op.mul_mat"):
            pass
    with prof.span("op.softmax"):
        pass
    prof.add_count("tokens", 42)
    prof.roofline("q4_0", seconds=0.001, bytes_moved=800_000_000, flops=10**9)
    return prof.report()


def test_report_format_is_the_reference_format(monkeypatch):
    for prof in (profiling, jax_profiling):
        monkeypatch.setattr(prof, "time", _Clock())
        monkeypatch.setattr(prof._state, "peak_hbm_gbs", 3350.0)
        monkeypatch.setattr(prof._state, "peak_flops", 989e12)
    ours, ref = _drive(profiling), _drive(jax_profiling)
    assert ours == ref
    assert "op.mul_mat" in ours and "x2" in ours and "BW-bound" in ours


def test_span_exclusive_accounting(monkeypatch):
    monkeypatch.setattr(profiling, "time", _Clock())
    _drive(profiling)
    spans = profiling._state.spans
    outer, inner = spans["outer"], spans["op.mul_mat"]
    assert inner.excl_s == inner.total_s and inner.count == 2
    assert outer.excl_s == pytest.approx(outer.total_s - inner.total_s, abs=1e-12)
    assert sum(s.excl_s for s in spans.values()) == pytest.approx(
        outer.total_s + spans["op.softmax"].total_s, abs=1e-12)


def _names(report: str) -> set[str]:
    """Span, counter and roofline names of a report, bracketed arguments
    dropped and the matmul histogram's keys folded to `trace.matmul`."""
    names = set()
    for m in re.finditer(r"^  (\S+)", report, re.M):
        name = m.group(1).split("[")[0]
        names.add("trace.matmul" if name.startswith("trace.matmul.") else name)
    return names


def _counters(report: str) -> dict[str, float]:
    section = report.split("== counters ==")[1].split("==")[0]
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"^  (tokens\.\S+)\s+(\S+)$", section, re.M)}


def test_engine_reports_the_reference_names(q4_0_path):
    """After `Engine.generate` and `generate_fused` the report holds every
    span, counter and roofline name the reference's does, and the token
    counters agree."""
    reader = GGUFReader(q4_0_path)
    jcfg, jparams = jax_load_params(reader)
    tcfg, model = load_params(reader, device="cpu")
    reports = []
    for prof, eng in ((jax_profiling, JaxEngine(jcfg, jparams, JaxEngineConfig(
            max_seq_len=32, donate_cache=False))), (profiling, Engine(tcfg, model, EngineConfig(
            max_seq_len=32)))):
        prof.reset()
        prof.enable()
        eng.generate([PROMPT[:3]], max_new_tokens=4)
        eng.generate_fused([PROMPT[:3]], max_new_tokens=4)
        reports.append(prof.report())
        prof.disable()
    ref, ours = reports
    assert {"prefill.dispatch", "decode.dispatch", "decode.block", "decode.steps",
            "tokens.prefilled", "tokens.decoded", "trace.matmul"} <= _names(ref) <= _names(ours)
    assert _counters(ours) == _counters(ref) == {"tokens.prefilled": 6.0, "tokens.decoded": 8.0}
    assert "prefill.dispatch[B=1,T=3]" in ours and "decode.block[n=4]" in ours
    assert "trace.matmul.plain.q4_0[512x64]xM1" in ours  # the tied head at decode


def test_engine_roofline_and_matmul_histogram(q4_0_path, monkeypatch):
    """decode.steps[B=..] counts the weights' bytes and 2 x their elements a
    step; each matmul shape is counted once however often it runs; the
    sampled-synchronous mode synchronizes every Nth decode dispatch."""
    tcfg, model = load_params(GGUFReader(q4_0_path), device="cpu")
    eng = Engine(tcfg, model, EngineConfig(max_seq_len=32, max_batch=2))
    syncs = []
    monkeypatch.setattr(eng, "_sync", lambda: syncs.append(1))
    profiling.enable(sync_every=2)
    eng.generate([PROMPT[:3], PROMPT[:5]], max_new_tokens=5)
    eng.generate([PROMPT[:3], PROMPT[:5]], max_new_tokens=5)
    assert len(syncs) == 4  # steps 2 and 4 of each run
    nbytes = sum(b.numel() * b.element_size() for b in model.buffers())
    nelems = sum(m.shape[0] * m.shape[1] for m in model.modules() if isinstance(m, QTensor))
    nelems += sum(b.numel() for name, b in model.named_buffers()
                  if not isinstance(model.get_submodule(name.rpartition(".")[0]), QTensor))
    assert eng._weight_stats == (nbytes, nelems)
    st = profiling._state.rooflines["decode.steps[B=2]"]
    assert (st.count, st.bytes_moved, st.flops) == (2, 10 * nbytes, 2 * nelems * 10 * 2)
    hist = {k: v for k, v in profiling._state.counters.items() if k.startswith("trace.matmul.")}
    assert len(hist) == 9 and set(hist.values()) == {1.0}  # 4 shapes at M = 10 and 1; the head


def test_profiling_disabled_is_a_no_op(q4_0_path, monkeypatch):
    profiling.disable()
    with profiling.span("x"):
        pass
    profiling.add_count("y")
    profiling.count_once("z")
    profiling.roofline("w", 1.0, 1)
    assert profiling.report() == "(profiling: no data)"
    tcfg, model = load_params(GGUFReader(q4_0_path), device="cpu")
    eng = Engine(tcfg, model, EngineConfig(max_seq_len=32))
    monkeypatch.setattr(eng, "_sync", lambda: pytest.fail("synchronized while disabled"))
    eng.generate([PROMPT[:3]], max_new_tokens=3)
    assert "_weight_stats" not in eng.__dict__  # nothing of the model was walked
    assert profiling.report() == "(profiling: no data)"


def test_torch_trace_writes_a_trace(tmp_path):
    with profiling.torch_trace(str(tmp_path)):
        torch.ones(8) @ torch.ones(8)
    assert list(tmp_path.glob("*.json"))


# -- tensor dump -------------------------------------------------------------

def test_capture_activations_match_reference(f32_path):
    reader = GGUFReader(f32_path)
    jcfg, jparams = jax_load_params(reader, mode="dequant")
    tcfg, model = load_params(reader, device="cpu")
    jcfg, tcfg = (dataclasses.replace(c, activation_dtype="float32") for c in (jcfg, tcfg))
    ref_logits, ref = JaxEngine(jcfg, jparams, JaxEngineConfig(
        max_seq_len=32, kv_dtype=jnp.float32, donate_cache=False)).capture_activations(PROMPT)
    logits, acts = Engine(tcfg, model, EngineConfig(
        max_seq_len=32, kv_dtype=torch.float32)).capture_activations(PROMPT)
    T = len(PROMPT)
    assert {"inp_embd", "result_norm", "result_output", f"blk.{tcfg.n_layers - 1}.ffn_out"} <= set(ref)
    assert set(ref) <= set(acts)
    for name, want in ref.items():
        want = np.asarray(want, np.float32)[:, :T]
        got = acts[name]
        assert got.shape == want.shape, name
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name
    assert logits.shape == (T, tcfg.vocab_size) and logits.dtype == np.float32
    np.testing.assert_array_equal(logits, acts["result_output"][0])
    assert np.abs(logits - np.asarray(ref_logits)[:T]).max() <= 1e-4 * np.abs(ref_logits).max()


def test_capture_patterns_and_golden_diff(f32_path, tmp_path):
    tcfg, model = load_params(GGUFReader(f32_path), device="cpu")
    eng = Engine(tcfg, model, EngineConfig(max_seq_len=32))
    _, acts = eng.capture_activations(PROMPT, patterns=("blk.*.ffn_out",))
    assert set(acts) == {f"blk.{i}.ffn_out" for i in range(tcfg.n_layers)}
    for name, v in acts.items():
        tensor_dump.dump_tensor(name, v, tmp_path, mode="target")
    res = tensor_dump.compare_with_golden(acts, tmp_path, atol=0.0, rtol=0.0)
    assert [r.ok for r in res] == [True] * tcfg.n_layers
    with pytest.warns(UserWarning, match="recorded nothing"):
        eng.capture_activations(PROMPT, patterns=("no_such_tensor",))


def test_record_touches_nothing_without_a_capture():
    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"record read .{name}")

    tensor_dump.record("blk.0.attn_out", Untouchable())


def test_dump_widens_bf16(tmp_path):
    x = torch.randn(3, 5).to(torch.bfloat16)
    path = tensor_dump.dump_tensor("a/b:c", x, tmp_path)
    assert path.name == "a_b_c_source.npy"
    got = np.load(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x.float().numpy())
    np.testing.assert_array_equal(tensor_dump.load_tensor("a/b:c", tmp_path, "source"), got)


def test_compare_tensors_reports_a_mismatch():
    a = np.zeros((2, 3), np.float32)
    b = np.zeros((2, 3), np.float32)
    b[1, 2] = 1.0
    for src, tgt in ((a, b), (torch.from_numpy(a), torch.from_numpy(b).to(torch.bfloat16))):
        res = tensor_dump.compare_tensors("t", src, tgt, atol=1e-6, rtol=0)
        ref = jax_tensor_dump.compare_tensors("t", a, b, atol=1e-6, rtol=0)
        assert not res.ok and res.first_mismatch == (1, 2) and str(res) == str(ref)
    assert tensor_dump.compare_tensors("t", a, np.zeros((3, 2), np.float32)).shape_mismatch


def test_parse_dump_list_matches_reference(tmp_path):
    f = tmp_path / "dump_tensor_list"
    f.write_text("// comment\ninp:inp_tokens\nout:result_output // trailing\n\n"
                 "  blk : blk.0.attn_out \n")
    assert tensor_dump.parse_dump_list(f) == jax_tensor_dump.parse_dump_list(f) == [
        ("inp", "inp_tokens"), ("out", "result_output"), ("blk", "blk.0.attn_out")]
    f.write_text("no separator\n")
    with pytest.raises(ValueError, match="bad dump-list line"):
        tensor_dump.parse_dump_list(f)


# -- verify ------------------------------------------------------------------

@pytest.mark.parametrize("kv_quantized,paged", [(False, False), (True, False), (True, True)])
def test_verify_is_ok_on_the_cpu(q4_0_path, kv_quantized, paged):
    tcfg, model = load_params(GGUFReader(q4_0_path), device="cpu")
    res = verify_device_kernels(tcfg, model, PROMPT, n_decode=3, max_seq_len=64,
                                kv_quantized=kv_quantized, paged=paged, page_size=16)
    assert res["ok"], format_report(res)
    assert len(res["steps"]) == 4 and res["max_abs"] == 0.0
    assert not any(res["kernel_launches"].values()) and not any(res["plain_launches"].values())
    assert "verification: OK" in format_report(res)


def _perturbed(fn):
    @functools.wraps(fn)  # its launch counters too
    def mutant(*args, **kwargs):
        return fn(*args, **kwargs) * 1.01 + 0.1
    return mutant


@pytest.mark.parametrize("module,table,name", [
    (qmm, "MATMULS", "q4_0"),  # the kernel path's matmul wrapper
    (att, None, "flash_attention"),  # and its flash and decode wrappers
    (att, None, "decode_attention"),
])
def test_verify_catches_a_perturbed_kernel_path(q4_0_path, monkeypatch, module, table, name):
    """A fault on the kernel side (here: the wrapper's output perturbed)
    shows as a MISMATCH, so the plain side really routes around the
    wrappers."""
    if table:
        monkeypatch.setitem(getattr(module, table), name, _perturbed(getattr(module, table)[name]))
    else:
        monkeypatch.setattr(module, name, _perturbed(getattr(module, name)))
    tcfg, model = load_params(GGUFReader(q4_0_path), device="cpu")
    res = verify_device_kernels(tcfg, model, PROMPT, n_decode=2, max_seq_len=64)
    assert not res["ok"] and res["max_abs"] > res["atol"]
    assert "MISMATCH" in format_report(res)


def test_plain_switch_is_off_after_an_exception(q4_0_path, monkeypatch):
    def broken(x, qt):
        assert qmm.forcing_plain() and att._FORCE_PLAIN and pat._FORCE_PLAIN
        raise RuntimeError("plain version failed")

    monkeypatch.setitem(qmm.PLAIN, "q4_0", broken)
    tcfg, model = load_params(GGUFReader(q4_0_path), device="cpu")
    with pytest.raises(RuntimeError, match="plain version failed"):
        verify_device_kernels(tcfg, model, PROMPT, n_decode=1, max_seq_len=64)
    assert not qmm.forcing_plain() and not att._FORCE_PLAIN and not pat._FORCE_PLAIN


def test_only_verify_sets_the_plain_switch():
    files = sorted((ROOT / "gemma_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    call = re.compile(r"^\s*[\w.]*\bset_force_plain\(", re.M)  # a call statement
    assert call.search("x = 1\n    qmm.set_force_plain(True)") and call.search("set_force_plain(1)")
    assert not call.search("def set_force_plain(flag):") and not call.search("`set_force_plain(x)`")
    callers = {f.relative_to(ROOT).as_posix() for f in files if call.search(f.read_text())}
    assert callers == {"gemma_tpu_torch/utils/verify.py"}
    assert not (qmm.forcing_plain() or att._FORCE_PLAIN or pat._FORCE_PLAIN)  # off by default


def test_cli_verify(q4_0_path, monkeypatch, capsys):
    argv = ["generate", str(q4_0_path), "--device", "cpu", "--tokens", "1,7,300",
            "--max-new-tokens", "3", "--no-eos", "--verify"]
    assert cli.main(argv) == 0
    assert "verification: OK" in capsys.readouterr().err
    monkeypatch.setitem(qmm.MATMULS, "q4_0", _perturbed(qmm.MATMULS["q4_0"]))
    for command in (argv, ["bench", str(q4_0_path), "--device", "cpu", "--max-new-tokens", "4",
                           "--max-seq-len", "64", "--verify"]):
        assert cli.main(command) == 3
        out = capsys.readouterr()
        assert "MISMATCH" in out.err and not out.out


# -- dequant mode ------------------------------------------------------------

def test_dequant_mode_matches_reference(q4_0_path):
    reader = GGUFReader(q4_0_path)
    jcfg, jparams = jax_load_params(reader, mode="dequant")
    tcfg, model = load_params(reader, device="cpu", mode="dequant")
    assert not any(isinstance(m, QTensor) for m in model.modules())
    assert {b.dtype for b in model.buffers() if b.dim() == 2} == {torch.bfloat16}
    for dtype, rel in (("float32", 1e-5), ("bfloat16", 5e-2)):
        jc, tc = (dataclasses.replace(c, activation_dtype=dtype) for c in (jcfg, tcfg))
        je = JaxEngine(jc, jparams, JaxEngineConfig(max_seq_len=64, kv_dtype=jnp.dtype(dtype),
                                                    donate_cache=False))
        te = Engine(tc, model, EngineConfig(max_seq_len=64, kv_dtype=getattr(torch, dtype)))
        ref = np.asarray(je.prefill([PROMPT])[0], np.float32)
        got = te.prefill([PROMPT])[0].numpy()
        assert np.abs(got - ref).max() <= rel * np.abs(ref).max(), dtype
        assert got.argmax(-1).tolist() == ref.argmax(-1).tolist()
        if dtype == "float32":
            assert te.generate([PROMPT], 12) == je.generate([PROMPT], 12)
    with pytest.raises(ValueError, match="mode must be one of"):
        load_params(reader, device="cpu", mode="bf16")


def test_cli_dequant_mode_matches_reference_cli(q4_0_path, capsys):
    common = ["--tokens", ",".join(map(str, PROMPT)), "--max-new-tokens", "8", "--no-eos",
              "--mode", "dequant"]
    assert cli.main(["generate", str(q4_0_path), "--device", "cpu", *common]) == 0
    ours = capsys.readouterr()
    args = jax_cli.build_parser().parse_args(["generate", str(q4_0_path), *common])
    assert args.fn(args) == 0
    assert ours.out == capsys.readouterr().out and ours.out.strip()
    assert "mode=dequant" in ours.err


# -- the CLI: bench, profile, quantize ----------------------------------------

def test_cli_bench_prints_the_reference_keys(q4_0_path, capsys):
    common = ["--max-new-tokens", "4", "--max-seq-len", "64"]
    assert cli.main(["bench", str(q4_0_path), "--device", "cpu", *common, "--batch", "2"]) == 0
    ours = json.loads(capsys.readouterr().out)
    args = jax_cli.build_parser().parse_args(["bench", str(q4_0_path), *common, "--batch", "2"])
    assert args.fn(args) == 0
    ref = json.loads(capsys.readouterr().out)
    assert set(ours) == set(ref) == {"metric", "value", "unit", "batch"}
    assert {k: ours[k] for k in ("metric", "unit", "batch")} == {k: ref[k] for k in
                                                                 ("metric", "unit", "batch")}
    assert ours["value"] > 0


def test_cli_generate_profile(q4_0_path, capsys):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the CPU's nominal peaks
        assert cli.main(["generate", str(q4_0_path), "--device", "cpu", "--tokens", "1,7,300",
                         "--max-new-tokens", "4", "--no-eos", "--profile",
                         "--profile-sync", "2"]) == 0
    err = capsys.readouterr().err
    for name in ("prefill.dispatch[B=1,T=3]", "decode.dispatch", "decode.steps[B=1]",
                 "tokens.decoded", "trace.matmul.plain.q4_0"):
        assert name in err, name
    assert profiling.sync_every() == 2


@pytest.mark.parametrize("qtype", ["q4_0", "q8_0", "q4_k", "q5_k", "q6_k", "q4_k_m", "q5_k_m",
                                   "f16"])
def test_cli_quantize_writes_the_reference_bytes(tmp_path_factory, qtype, capsys):
    d = tmp_path_factory.mktemp(f"quantize_{qtype}")
    src = make_gguf(d / "f32.gguf", KQUANT_CONFIG, weight_type="f32", seed=4)
    assert cli.main(["quantize", str(src), str(d / "ours.gguf"), "--type", qtype]) == 0
    args = jax_cli.build_parser().parse_args(["quantize", str(src), str(d / "ref.gguf"),
                                              "--type", qtype])
    assert args.fn(args) == 0
    assert (d / "ours.gguf").read_bytes() == (d / "ref.gguf").read_bytes()
    ours = GGUFReader(d / "ours.gguf")
    assert ours.metadata["general.file_type"] == cli.QUANTIZE_FTYPES[qtype]
    assert "quantized" in capsys.readouterr().err


def test_chip_smoke_quantize_digests_are_the_cpu_bytes(tmp_path):
    """chip_smoke.py phase 8 holds `quantize` on the card machine to the
    bytes it writes on the CPU: its digests are this run's."""
    spec = importlib.util.spec_from_file_location("chip_smoke_digests", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    f32 = make_gguf(tmp_path / "f32.gguf", TINY_KERNEL_CONFIG, seed=0, weight_type="f32")
    assert set(smoke.QUANTIZE_SHA256) == {"q4_0", "q8_0", "q4_k_m"}
    for qtype, digest in smoke.QUANTIZE_SHA256.items():
        out = tmp_path / f"{qtype}.gguf"
        assert cli.main(["quantize", str(f32), str(out), "--type", qtype]) == 0
        assert hashlib.sha256(out.read_bytes()).hexdigest() == digest, qtype
