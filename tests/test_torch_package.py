"""Package-level checks of gemma_tpu_torch: no jax and nothing of the JAX
package, the CLI, the loader's device, the kernel build, and chip_smoke.py's
refusal to run without a GPU."""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gemma_tpu_torch import cli
from gemma_tpu_torch.kernels import build
from gemma_tpu_torch.runtime import Engine, EngineConfig

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "gemma_tpu_torch"

_NO_JAX_RUN = r"""
import importlib, json, pkgutil, runpy, sys
sys.modules["jax"] = None  # any import of jax now fails
sys.modules["gemma_tpu"] = None  # and any import of the JAX package
import gemma_tpu_torch
for m in pkgutil.walk_packages(gemma_tpu_torch.__path__, "gemma_tpu_torch."):
    importlib.import_module(m.name)
from gemma_tpu_torch.testing import TINY_CONFIG, make_gguf
path = make_gguf(sys.argv[1], TINY_CONFIG, seed=1)  # q4_0
sys.argv = ["gemma_tpu_torch", "generate", str(path), "--device", "cpu", "--tokens", "1,7,300",
            "--max-new-tokens", "5", "--no-eos"]
try:
    runpy.run_module("gemma_tpu_torch", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
# the prefill worker, `python -m gemma_tpu_torch.runtime.kv_transfer`, in a
# thread, serving one prefill to a client of the port
import contextlib, io, re, socket, threading
from gemma_tpu_torch.runtime import kv_transfer
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]

def worker():
    sys.argv = ["kv_transfer", "--gguf", str(path), "--device", "cpu", "--port", str(port)]
    try:
        runpy.run_module("gemma_tpu_torch.runtime.kv_transfer", run_name="__main__")
    except SystemExit as e:
        assert not e.code, e.code

out = io.StringIO()
with contextlib.redirect_stdout(out):
    t = threading.Thread(target=worker)
    t.start()
    client = kv_transfer.RemotePrefillClient(("127.0.0.1", port), device="cpu")
    pre = client.prefill_standalone([1, 7, 300])
    client.close()
    t.join(120)
assert pre[4] == 3 and pre[1].shape[2] == 3, pre[1].shape
print(json.dumps({"jax": "jax" in sys.modules and sys.modules["jax"] is not None,
                  "gemma_tpu": any(m == "gemma_tpu" or m.startswith("gemma_tpu.")
                                   for m, mod in sys.modules.items() if mod is not None),
                  "ml_dtypes": "ml_dtypes" in sys.modules,
                  "worker": [re.sub(r"^PORT \d+$", "PORT", line)
                             for line in out.getvalue().splitlines()]}),
      file=sys.stderr)
"""


def test_runs_end_to_end_with_jax_blocked(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_RUN, str(tmp_path / "tiny.gguf")],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stderr.strip().splitlines()[-1]) == {
        "jax": False, "gemma_tpu": False, "ml_dtypes": False, "worker": ["PORT", "SERVED 1"]}
    assert "decode 5 tokens" in proc.stderr and "device cpu" in proc.stderr
    # the CLI prints what the library generates
    cfg, model, tok = cli.load(tmp_path / "tiny.gguf", "cpu")
    out = Engine(cfg, model, EngineConfig()).generate([[1, 7, 300]], 5)[0]
    assert proc.stdout == tok.decode(out) + "\n"


def test_sources_have_no_jax_sdpa_or_compile():
    """The port imports no jax and calls no finished attention kernel or
    compiler for the ported ops. Two benches time SDPA as the library's
    yardstick: `tools/bench_micro.py` beside the port's decode kernel (the
    reference's bench_micro times its non-Pallas attention) and
    `tools/bench_flash.py` beside its flash kernel: one call in each, and
    no module of the package imports either bench."""
    files = sorted(PKG.rglob("*.py")) + sorted((PKG / "csrc").glob("*.cu*"))
    assert len(files) > 10
    # every header, the tensor-core attention header and the emulation included
    assert {"attn_tc.cuh", "dq_gemv.cuh", "dq_tile.cuh", "dq_tile_tf32.cuh", "common.cuh",
            "tc_emulation.py", "probe_variants.py"} <= {f.name for f in files}
    jax_import = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)|import_module\(\s*['\"]jax", re.M)
    yardsticks = {PKG / "tools" / "bench_micro.py", PKG / "tools" / "bench_flash.py"}
    for f in files:
        text = f.read_text()
        assert not jax_import.search(text), f
        if f in yardsticks:
            assert text.count("scaled_dot_product_attention(") == 1, f
        else:
            assert "scaled_dot_product_attention" not in text, f
            assert not re.search(r"^\s*(from|import)\s.*\b(bench_micro|bench_flash)\b", text, re.M), f
        assert "torch.compile" not in text, f


def test_sources_import_nothing_of_the_jax_package():
    """No module of the port, and not chip_smoke.py, imports `gemma_tpu`
    (relative imports of the port's own modules aside)."""
    files = sorted(PKG.rglob("*.py")) + sorted((PKG / "csrc").glob("*.cu*")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20 and PKG / "csrc" / "attn_tc.cuh" in files
    pattern = re.compile(r"^\s*(import\s+gemma_tpu\b|from\s+gemma_tpu\b)"
                         r"|import_module\(\s*['\"]gemma_tpu\b", re.M)
    assert pattern.search("from gemma_tpu.gguf import GGUFReader")
    assert not pattern.search("from gemma_tpu_torch.gguf import GGUFReader")
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_sources_import_nothing_of_the_reference_tools():
    """No module of the port, and not chip_smoke.py, imports a module of the
    root tools/ directory or puts tools/ on sys.path: the port's benches are
    its own (`gemma_tpu_torch/tools/`)."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    names = sorted(p.stem for p in (ROOT / "tools").glob("*.py"))
    assert {"bench_qmm_variants", "bench_bn_sweep", "probe_int4"} <= set(names)
    imports = re.compile(rf"^\s*(import|from)\s+(tools|{'|'.join(names)})\b"
                         rf"|import_module\(\s*['\"](tools|{'|'.join(names)})\b", re.M)
    path_edit = re.compile(r"sys\.path\.(insert|append|extend)\([^)]*tools", re.S)
    assert imports.search("import bench_qmm_variants") and imports.search("from tools import x")
    assert not imports.search("from gemma_tpu_torch.tools import bench_qmm_variants")
    assert not imports.search("from . import _timing")
    assert path_edit.search('sys.path.insert(0, str(ROOT / "tools"))')
    for f in files:
        text = f.read_text()
        assert not imports.search(text), f
        assert not path_edit.search(text), f


_TOOLS_NO_JAX = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.modules["gemma_tpu"] = None
import gemma_tpu_torch.tools as t
names = [m.name for m in pkgutil.iter_modules(t.__path__)]
for n in names:
    importlib.import_module(f"gemma_tpu_torch.tools.{n}")
print(json.dumps({"tools": sorted(names), "reference_tools": sorted(
    m for m in sys.modules if m.startswith(("bench_", "probe_", "tools")))}))
"""


def test_tools_import_with_jax_and_the_jax_package_blocked(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _TOOLS_NO_JAX], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout) == {
        "tools": ["_launch", "_timing", "bench_bn_sweep", "bench_decode_attn", "bench_flash",
                  "bench_fmt_kernels", "bench_itl", "bench_longctx", "bench_micro",
                  "bench_prefill", "bench_q4k_variants", "bench_q6k_variants",
                  "bench_qmm_variants", "bench_scaling", "bench_scan", "bench_serving",
                  "bench_shapes", "bench_spec", "bench_step_parts", "parent_turn",
                  "probe_cache_cost", "probe_int4", "probe_spec_serving", "probe_variants",
                  "tc_emulation"],
        "reference_tools": []}


# the modules the serving path and the tools use, compared by their public
# surface with the JAX package's
SURFACE_MODULES = ("runtime.engine", "runtime.scheduler", "runtime.serving", "runtime.sampler",
                   "models", "models.gemma", "testing")
# what the port leaves out on purpose, each with its reason
SURFACE_GAPS = {
    # XLA program shapes and buffer donation
    "runtime.engine EngineConfig.__init__(prefill_bucket_min=)",
    "runtime.engine EngineConfig.__init__(donate_cache=)",
    "runtime.engine EngineConfig.__init__(decode_block=)",
    # the port samples from a torch.Generator, not a jax.random key
    "runtime.sampler sample(key=)",
    # the port's model is an nn.Module, and its tensor-parallel hook is `tp`
    "models.gemma forward(params=)",
    "models.gemma forward(tp_axis=)",
    "models.gemma decoder_layer(tp_axis=)",
}


def _surface_gaps() -> set[str]:
    """Every public function, class and method (and parameter name) defined
    in a SURFACE_MODULES module of the JAX package that the port's module
    of the same name lacks."""
    import importlib
    import inspect

    def names(f) -> list[str]:
        return [p for p in inspect.signature(f).parameters if p not in ("self", "cls")]

    gaps = set()
    for mod in SURFACE_MODULES:
        ref = importlib.import_module(f"gemma_tpu.{mod}")
        port = importlib.import_module(f"gemma_tpu_torch.{mod}")
        for name, obj in vars(ref).items():
            if (name.startswith("_") or getattr(obj, "__module__", None) != ref.__name__
                    or not (inspect.isfunction(obj) or inspect.isclass(obj))):
                continue
            if not hasattr(port, name):
                gaps.add(f"{mod} {name}")
                continue
            if inspect.isfunction(obj):
                members = [(name, obj, getattr(port, name))]
            else:
                members = []
                for attr, m in vars(obj).items():
                    if (attr.startswith("_") and attr != "__init__") or not (
                            inspect.isfunction(m) or isinstance(m, (property, staticmethod, classmethod))):
                        continue
                    if not hasattr(getattr(port, name), attr):
                        gaps.add(f"{mod} {name}.{attr}")
                    elif not isinstance(m, property):
                        f = m.__func__ if isinstance(m, (staticmethod, classmethod)) else m
                        members.append((f"{name}.{attr}", f, getattr(getattr(port, name), attr)))
            for label, f, g in members:
                gaps |= {f"{mod} {label}({p}=)" for p in names(f) if p not in names(g)}
    return gaps


def test_public_surface_matches_the_jax_package():
    """For the modules the serving path and the tools use, every public
    function, class and method of the JAX module, with each of its
    parameter names, exists in the port's module, except SURFACE_GAPS."""
    assert _surface_gaps() == SURFACE_GAPS


def test_load_params_defaults_to_the_card(monkeypatch, tmp_path):
    """Without a GPU, load_params with no device fails before it reads a
    tensor: it never loads onto the CPU. The CLI fails with its message."""
    from gemma_tpu_torch.gguf import GGUFReader
    from gemma_tpu_torch.models import load_params
    from gemma_tpu_torch.testing import TINY_CONFIG, make_gguf

    path = make_gguf(tmp_path / "t.gguf", TINY_CONFIG)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device") as err:
        load_params(GGUFReader(path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_params(object())  # fails before reading anything of the file
    with pytest.raises(SystemExit, match="error: " + re.escape(str(err.value))):
        cli.main(["generate", str(path)])
    cfg, model = load_params(GGUFReader(path), device="cpu")
    assert cfg.n_layers == TINY_CONFIG.n_layers and model.embed.device.type == "cpu"


def test_tp_engine_and_make_mesh_default_to_the_card(monkeypatch):
    """Without a GPU, make_mesh (any backend), make_multihost_mesh and a
    TPEngine with no mesh fail: they never place a rank on the CPU unless
    asked (device="cpu", which takes gloo)."""
    from gemma_tpu_torch.parallel import multihost
    from gemma_tpu_torch.parallel.shard_decode import TPEngine
    from gemma_tpu_torch.parallel.sharding import make_mesh
    from gemma_tpu_torch.testing import TINY_CONFIG, make_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_mesh, lambda: make_mesh(backend="gloo"), multihost.make_multihost_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    model = make_params(TINY_CONFIG, "q8_0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPEngine(TINY_CONFIG, model)
    eng = TPEngine(TINY_CONFIG, model, make_mesh(backend="gloo", device="cpu"))
    assert eng.device.type == "cpu" and eng.params.embed.device.type == "cpu"


def test_kernel_sources_note_what_they_replace():
    notes = [("q4_0_matmul.cu", "_q4_0_kernel"), ("decode_attention.cu", "_decode_kernel"),
             ("flash_attention.cu", "_flash_kernel"), ("q4_k_matmul.cu", "_q4_k_kernel"),
             ("q6_k_matmul.cu", "_q6_k_kernel"), ("q6_k_matmul.cu", "_q6_k_v4_kernel"),
             ("paged_attention.cu", "_paged_kernel"), ("q8_0_matmul.cu", "_q8_0_kernel"),
             ("dq_tile_tf32.cuh", "_q4_k_kernel"), ("dq_tile_tf32.cuh", "_q6_k_kernel"),
             ("decode_g1.cuh", "_decode_kernel"), ("decode_g1.cuh", "_paged_kernel")]
    notes += [("qmm_variants.cu", "kernel3"), ("qmm_variants.cu", "_kernel"),
              ("q4_0_matmul.cu", "_kernel"), ("q4_0_matmul.cu", "call"),
              ("q4_k_matmul.cu", "_kernel"), ("q6_k_matmul.cu", "_kernel")]
    for name, tpu_kernel in notes:
        text = (PKG / "csrc" / name).read_text()
        assert re.search(rf"Replaces .*`{tpu_kernel}`", text, re.S), name
        assert "What bounds it on the H100" in text or "bound by" in text, name
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.load()
    assert build._lib is None


def test_library_name_follows_the_sources():
    name = build.library_path().name
    assert re.fullmatch(r"libgemma_tpu_kernels_[0-9a-f]{16}\.so", name)
    assert build.library_path() == build.library_path()
    assert {p.name for p in build.sources()} >= {"q4_0_matmul.cu", "decode_attention.cu",
                                                 "flash_attention.cu", "q4_k_matmul.cu",
                                                 "q6_k_matmul.cu", "paged_attention.cu",
                                                 "q8_0_matmul.cu", "common.cuh", "attn_tc.cuh"}
    assert {"gt_q4_k_matmul", "gt_q6_k_matmul", "gt_paged_attention", "gt_q8_0_matmul",
            "gt_flash_attention_tc", "gt_decode_attention_tc"} <= set(build.SIGNATURES)


def test_c_entry_points_match_their_ctypes_signatures():
    """Every `extern "C"` entry of csrc/*.cu that `build.SIGNATURES` binds
    takes the arguments ctypes passes: a pointer for each `void*`, an int
    for each `int`, a float for each `float`, in order (a missing or extra
    argument would shift every later one on the card)."""
    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    entries = {}
    for src in sorted((PKG / "csrc").glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (gt_\w+)\(([^)]*)\)', src.read_text()):
            types = [re.sub(r"\s+", " ", p_.strip()).rsplit(" ", 1)[0].replace(" *", "*")
                     for p_ in params.split(",")]
            entries[name] = tuple(kinds[t] for t in types)
    for name, argtypes in build.SIGNATURES.items():
        assert entries[name] == argtypes, name
    assert {"gt_decode_attention_g1", "gt_paged_attention_g1"} <= set(build.SIGNATURES)


def test_build_library_raises_on_a_missing_entry(monkeypatch, tmp_path):
    """A library lacking an entry point it is asked to bind (every one of
    SIGNATURES by default, or those named) is a build error, not a gap."""
    import ctypes.util

    class Built(type(Path())):  # the C library, standing in for a build found on disk
        def exists(self):
            return True

    libc = ctypes.util.find_library("c")
    assert libc is not None
    monkeypatch.setattr(build, "library_path", lambda csrc=None, build_dir=None: Built(libc))
    with pytest.raises(build.KernelBuildError, match="no entry point gt_q4_0_matmul"):
        build.build_library()
    with pytest.raises(build.KernelBuildError, match="no entry point gt_decode_attention_tc"):
        build.build_library(tmp_path, tmp_path, ("gt_decode_attention_tc",))


def test_matmul_scratch_asks_once_a_library_and_shape(monkeypatch):
    """`build.matmul_scratch` asks the library's one query (bytes, and the
    tickets through its pointer) once a library and shape; `build.workspace`
    keeps one pair a stream, grown on demand, its tickets zeros."""
    asked = []

    class Lib:
        def gt_matmul_work_bytes(self, fmt, x_dtype, M, N, K, tickets):
            asked.append((fmt, x_dtype, M, N, K))
            tickets._obj.value = N // 64
            return 4 * M * N

    monkeypatch.setattr(build, "_scratch", {})
    lib, other = Lib(), Lib()
    for _ in range(3):
        assert build.matmul_scratch(lib, 2, 1, 1, 256, 2048) == (1024, 4)
    assert build.matmul_scratch(lib, 2, 1, 8, 256, 2048) == (8192, 4)
    assert build.matmul_scratch(other, 2, 1, 1, 256, 2048) == (1024, 4)
    assert asked == [(2, 1, 1, 256, 2048), (2, 1, 8, 256, 2048), (2, 1, 1, 256, 2048)]

    monkeypatch.setattr(build, "_workspaces", {})
    cpu = torch.device("cpu")
    work, tickets = build.workspace(cpu, 7, 10, 3)
    assert work.numel() == 10 and tickets.tolist() == [0, 0, 0]
    assert build.workspace(cpu, 7, 4, 2)[0] is work  # large enough: kept
    grown = build.workspace(cpu, 7, 4, 5)
    assert grown[0].numel() == 10 and grown[1].tolist() == [0] * 5
    assert build.workspace(cpu, 8, 1, 1)[0] is not grown[0]  # another stream, another pair


def test_cli_refuses_cuda_without_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["generate", str(tmp_path / "missing.gguf"), "--device", "cuda"])


def test_cli_inspect_json(tmp_path, capsys):
    from gemma_tpu_torch.testing import TINY_CONFIG, make_gguf

    path = make_gguf(tmp_path / "t.gguf", TINY_CONFIG)
    assert cli.main(["inspect", str(path), "--json"]) == 0
    meta = json.loads(capsys.readouterr().out)
    assert meta["architecture"] == "gemma"
    assert meta["tensors"]["blk.0.attn_q.weight"] == {"shape": [64, 64], "type": "Q4_0"}


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(alone, tmp_path):
    """chip_smoke.py exits non-zero and prints no result where there is no
    CUDA device (here), and where it stands without the repository."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_make_gguf_takes_type_names(tmp_path):
    """`make_gguf(weight_type="q4_0")` (chip_smoke's tiny checks) writes the
    same file as the GGMLType."""
    from gemma_tpu.gguf import GGMLType
    from gemma_tpu_torch.testing import TINY_CONFIG, make_gguf

    by_name = make_gguf(tmp_path / "a.gguf", TINY_CONFIG, weight_type="q4_0")
    by_type = make_gguf(tmp_path / "b.gguf", TINY_CONFIG, weight_type=GGMLType.Q4_0)
    assert by_name.read_bytes() == by_type.read_bytes()
