"""Command-line interface of the PyTorch/CUDA port.

    python -m gemma_tpu_torch generate model.gguf --prompt "..." [--stream]
    python -m gemma_tpu_torch generate model.gguf --tokens 1,7,300 --device cpu
    python -m gemma_tpu_torch generate model.gguf --prompt "..." --speculative [--spec-k 7]
    python -m gemma_tpu_torch serve    model.gguf --prompts-file p.txt [--paged] [--kv-quant]
    python -m gemma_tpu_torch serve    model.gguf --prompts-file p.txt --speculative
    python -m gemma_tpu_torch inspect  model.gguf [--json]
    python -m gemma_tpu_torch bench    model.gguf [--max-new-tokens 128] [--batch 1]
    python -m gemma_tpu_torch perplexity model.gguf --text-file corpus.txt [--window 512]
    python -m gemma_tpu_torch quantize model.gguf out.gguf --type q4_k_m

Counterpart of `gemma_tpu/cli.py`, every subcommand of its one process,
with the port's copies of its tokenizer, GGUF writer and ggml codecs.
`serve` reads one prompt per line and prints one JSON line per request on
stdout and the scheduler's stats on stderr, as the reference does.
`--speculative` (prompt-lookup speculative decoding,
`runtime/speculative.py`) needs greedy sampling, and for `serve` the dense
cache: otherwise it says so on stderr and decodes plainly, as the
reference does. `--mode dequant` loads every matrix as dense bf16.
`--verify` (generate, bench, serve) first runs `utils/verify.py` (the
kernels against their plain versions on the same device) and exits 3 on a
mismatch; `--profile` (generate) prints `utils/profiling.py`'s report on
stderr. `--device` defaults to `cuda`; without a GPU the command fails
rather than running on the CPU. `--device cpu` is the explicit way to run
the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _device(name: str):
    from .models.params import resolve_device

    try:
        return resolve_device(name)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None


def load(path, device, mode: str = "quantized"):
    """(config, model on `device`, tokenizer) of a GGUF checkpoint; `mode`
    as `load_params` takes it."""
    from .gguf.reader import GGUFReader
    from .models.params import load_params
    from .tokenizer.sentencepiece import Tokenizer

    reader = GGUFReader(path)
    cfg, params = load_params(reader, device, mode=mode)
    return cfg, params, Tokenizer.from_gguf(reader)


def _load(args):
    """`load` of args.model on args.device in args.mode, reported on stderr."""
    device = _device(args.device)
    t0 = time.perf_counter()
    cfg, params, tok = load(args.model, device, args.mode)
    print(f"loaded {args.model} in {time.perf_counter() - t0:.1f}s "
          f"({cfg.n_layers} layers, d_model={cfg.d_model}, vocab={cfg.vocab_size}, "
          f"device={device}, mode={args.mode})", file=sys.stderr)
    return cfg, params, tok


def _maybe_verify(args, cfg, params, prompt: list[int] | None = None) -> bool:
    """With --verify, the kernels against their plain versions for one
    prefill and 4 decode steps on the model's device; False on a mismatch."""
    if not args.verify:
        return True
    from .utils.verify import format_report, verify_device_kernels

    if prompt is None:
        prompt = [2 + (i % max(2, cfg.vocab_size - 2)) for i in range(64)]
    res = verify_device_kernels(
        cfg, params, prompt[:64], max_seq_len=args.max_seq_len, kv_quantized=args.kv_quant,
        paged=args.paged, page_size=args.page_size,
    )
    print(format_report(res), file=sys.stderr)
    return bool(res["ok"])


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _engine_config(args, max_batch: int):
    from .runtime import EngineConfig

    return EngineConfig(
        max_seq_len=args.max_seq_len, max_batch=max_batch, kv_quantized=args.kv_quant,
        paged=args.paged, page_size=args.page_size,
        prefill_chunk=getattr(args, "prefill_chunk", 0),
    )


def cmd_generate(args) -> int:
    from .runtime import Engine, SamplingParams
    from .utils import profiling

    if args.profile:
        profiling.enable(sync_every=max(0, args.profile_sync))
        profiling.autoset_peaks()
    cfg, params, tok = _load(args)
    if args.tokens:
        prompt = [int(t) for t in args.tokens.split(",")]
    else:
        text = args.prompt
        if args.chat:  # Gemma instruction-tuned turn format
            text = (f"<start_of_turn>user\n{text}<end_of_turn>\n"
                    "<start_of_turn>model\n")
        prompt = tok.encode(text)
    if len(prompt) >= args.max_seq_len:
        print(f"prompt ({len(prompt)} tokens) must be shorter than "
              f"--max-seq-len {args.max_seq_len}", file=sys.stderr)
        return 2
    if not _maybe_verify(args, cfg, params, prompt):
        return 3

    eng = Engine(cfg, params, _engine_config(args, max_batch=1))
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p)
    eos = tok.special.eos if args.eos else None
    budget = min(args.max_new_tokens, args.max_seq_len - len(prompt))

    def on_token(step: int, toks: list[int]) -> None:
        print(tok.decode([toks[0]]), end="", flush=True)

    # prefill is timed to first-token logits on the host (TTFT); decode is
    # the rest of the generation's wall time
    t0 = time.perf_counter()
    first_logits, cache = eng.prefill([prompt])
    _sync(eng.device)
    t_prefill = time.perf_counter() - t0
    t1 = time.perf_counter()
    if args.speculative and sampling.is_greedy:
        from .runtime import SpecDecoder

        out = SpecDecoder(eng, k=args.spec_k).generate(prompt, budget)
        if eos is not None and eos in out:
            out = out[: out.index(eos) + 1]
        for t in out if args.stream else ():
            on_token(0, [t])
    else:
        if args.speculative:
            print("--speculative requires greedy sampling; ignoring", file=sys.stderr)
        out = eng.generate_from(
            first_logits, cache, budget, sampling=sampling, eos_id=eos, seed=args.seed,
            on_token=on_token if args.stream else None,
        )[0]
    t_decode = time.perf_counter() - t1
    if args.stream:
        print()
    else:
        print(tok.decode(out))
    n = len(out)
    print(
        f"[prefill {len(prompt)} tokens in {t_prefill * 1e3:.1f} ms "
        f"({len(prompt) / max(t_prefill, 1e-9):.1f} tok/s); "
        f"decode {n} tokens in {t_decode:.2f}s ({n / max(t_decode, 1e-9):.2f} tok/s); "
        f"device {eng.device}]",
        file=sys.stderr,
    )
    if args.profile:
        print(profiling.report(), file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    """Decode throughput on a checkpoint: the marginal time of n more tokens,
    t(2n) - t(n) over `Engine.generate_fused`, which cancels the prefill and
    the fixed host cost. Prints the reference CLI's JSON line."""
    from .runtime import Engine

    cfg, params, tok = _load(args)
    if not _maybe_verify(args, cfg, params):
        return 3
    eng = Engine(cfg, params, _engine_config(args, max_batch=args.batch))
    n = args.max_new_tokens
    if args.prompt:
        prompt = tok.encode(args.prompt)
    else:
        # the default prompt leaves room for the 2n-token measurement run
        plen = max(1, min(64, args.max_seq_len - 2 * n - 1))
        prompt = list(range(2, 2 + plen))
    if len(prompt) + 2 * n > args.max_seq_len:
        raise SystemExit(f"prompt ({len(prompt)}) + 2*max_new_tokens ({2 * n}) exceeds "
                         f"--max-seq-len {args.max_seq_len}")
    prompts = [prompt] * args.batch
    eng.generate_fused(prompts, max_new_tokens=8)  # warm-up: first launches, allocator
    t0 = time.perf_counter()
    eng.generate_fused(prompts, max_new_tokens=n)
    t1 = time.perf_counter()
    eng.generate_fused(prompts, max_new_tokens=2 * n)
    t2 = time.perf_counter()
    dt = max((t2 - t1) - (t1 - t0), 1e-9)
    print(json.dumps({
        "metric": "decode_tokens_per_sec",
        "value": round(n * args.batch / dt, 2),
        "unit": "tokens/s",
        "batch": args.batch,
    }))
    return 0


def cmd_perplexity(args) -> int:
    from .utils.perplexity import evaluate

    cfg, params, tok = _load(args)
    if args.text_file:
        with open(args.text_file, encoding="utf-8") as f:
            text = f.read()
    else:
        text = sys.stdin.read()
    res = evaluate(params, cfg, tok.encode(text), ctx=args.window)
    print(json.dumps({"perplexity": res.ppl, "tokens": res.n_tokens}))
    return 0


# llama.cpp's LLAMA_FTYPE_* of each --type: the output advertises its own
# quant type, not the source's (downstream tooling reads general.file_type)
QUANTIZE_FTYPES = {"f16": 1, "q4_0": 2, "q8_0": 7, "q4_k": 14, "q4_k_m": 15, "q5_k": 16,
                   "q5_k_m": 17, "q6_k": 18}


def cmd_quantize(args) -> int:
    """Re-quantize a GGUF checkpoint with the port's ggml codecs and GGUF
    writer: the file the reference's `quantize` writes, byte for byte.

    2-D matrices quantize to --type, or to the mixed recipe (q4_k_m /
    q5_k_m: q4_k / q5_k with q6_k attn_v and embedding/head); 1-D norms and
    any matrix whose row length the block size does not divide stay f32."""
    import numpy as np

    from .gguf.constants import GGMLType
    from .gguf.reader import GGUFReader
    from .gguf.writer import GGUFWriter
    from .quant import numpy_ref

    t0 = time.time()
    reader = GGUFReader(args.model)
    w = GGUFWriter(args.out)
    ftype = QUANTIZE_FTYPES[args.type]
    for k, v in reader.metadata.items():
        w.add_kv(k, np.uint32(ftype) if k == "general.file_type" else v)
    if "general.file_type" not in reader.metadata:
        w.add_kv("general.file_type", np.uint32(ftype))

    name_to_type = {"q4_0": GGMLType.Q4_0, "q8_0": GGMLType.Q8_0, "q4_k": GGMLType.Q4_K,
                    "q5_k": GGMLType.Q5_K, "q6_k": GGMLType.Q6_K, "f16": GGMLType.F16}
    mixed = args.type in ("q4_k_m", "q5_k_m")
    base = ({"q4_k_m": GGMLType.Q4_K, "q5_k_m": GGMLType.Q5_K}[args.type] if mixed
            else name_to_type[args.type])
    block = {GGMLType.Q4_0: 32, GGMLType.Q8_0: 32, GGMLType.Q4_K: 256, GGMLType.Q5_K: 256,
             GGMLType.Q6_K: 256, GGMLType.F16: 1}

    n_q = 0
    for ti in reader:
        x = np.asarray(numpy_ref.dequantize(reader.tensor_raw(ti.name), ti.ggml_type, ti.shape),
                       np.float32)
        t = base
        if mixed and (ti.name in ("token_embd.weight", "output.weight")
                      or ti.name.endswith("attn_v.weight")):
            t = GGMLType.Q6_K
        if x.ndim != 2 or x.shape[-1] % block[t] != 0:
            w.add_tensor(ti.name, x, tuple(x.shape), GGMLType.F32)
            continue
        w.add_tensor(ti.name, numpy_ref.quantize(x, t), tuple(x.shape), t)
        n_q += 1
    w.write()
    print(f"quantized {n_q} matrices -> {args.out} ({args.type}) in {time.time() - t0:.1f}s",
          file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    """Offline-batch serving: prompts (one per line) through the
    continuous-batching scheduler; completions and stats as the reference
    prints them."""
    from .runtime import Engine, Request, SamplingParams, serve

    cfg, params, tok = _load(args)
    if not _maybe_verify(args, cfg, params):
        return 3
    eng = Engine(cfg, params, _engine_config(args, max_batch=args.batch))
    if args.prompts_file:
        with open(args.prompts_file, encoding="utf-8") as f:
            lines = f.read().splitlines()
    else:
        lines = sys.stdin.read().splitlines()
    lines = [ln for ln in lines if ln.strip()]
    eos = tok.special.eos if args.eos else None
    reqs = [Request(f"r{i}", tok.encode(ln), max_new_tokens=args.max_new_tokens, eos_id=eos)
            for i, ln in enumerate(lines)]
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p)
    speculative = args.speculative
    if speculative and (not sampling.is_greedy or args.paged):
        print("--speculative requires greedy sampling and the dense cache; ignoring",
              file=sys.stderr)
        speculative = False
    t0 = time.monotonic()
    sched = serve(eng, reqs, sampling=sampling, block=args.block, seed=args.seed,
                  speculative=speculative, spec_k=args.spec_k, spec_block=args.spec_block)
    wall = time.monotonic() - t0
    for r in sorted(sched.finished, key=lambda r: int(r.id[1:])):
        print(json.dumps({"id": r.id, "text": tok.decode(r.tokens), "tokens": len(r.tokens),
                          "ttft_s": round(r.ttft, 4) if r.ttft else None}))
    stats = sched.stats()
    stats["wall_s"] = round(wall, 2)
    print(json.dumps(stats), file=sys.stderr)
    return 0


def _jsonable(v):
    import numpy as np

    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, np.ndarray):
        v = v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, list):
        if len(v) > 64:
            v = v[:64] + ["... truncated"]
        return [_jsonable(x) for x in v]
    return v


def cmd_inspect(args) -> int:
    """Dump GGUF header KV pairs and tensor info."""
    from .gguf.reader import GGUFReader

    reader = GGUFReader(args.model)
    if args.json:
        print(json.dumps({
            "architecture": reader.architecture,
            "kv": {k: _jsonable(v) for k, v in reader.metadata.items()},
            "tensors": {t.name: {"shape": list(t.shape), "type": t.ggml_type.name}
                        for t in reader},
        }, indent=2))
        return 0
    print(f"architecture: {reader.architecture}")
    print(f"{len(reader.metadata)} KV pairs, {len(reader.tensors)} tensors")
    for k, v in reader.metadata.items():
        s = str(v)
        if len(s) > 80:
            s = f"{s[:77]}... ({len(v)} items)" if isinstance(v, list) else s[:77] + "..."
        print(f"  {k} = {s}")
    for t in reader:
        print(f"  {t.name}  {list(t.shape)}  {t.ggml_type.name}")
    return 0


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("model", help="path to a GGUF checkpoint")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain PyTorch path)")
    p.add_argument("--mode", choices=("quantized", "dequant"), default="quantized",
                   help="serve the block-quantized weights through the CUDA kernels (quantized) "
                   "or dequantize every matrix to dense bf16 at load (dequant)")


def _add_engine_flags(p: argparse.ArgumentParser) -> None:
    _add_common(p)
    p.add_argument("--max-seq-len", type=int, default=512, help="KV-cache capacity")
    p.add_argument("--kv-quant", action="store_true", help="int8-quantize the KV cache")
    p.add_argument("--paged", action="store_true", help="use the paged KV cache (page tables)")
    p.add_argument("--page-size", type=int, default=None,
                   help="paged KV page length (default 64)")
    p.add_argument("--verify", action="store_true",
                   help="before running, hold the CUDA kernels against their plain versions on "
                   "the device for one prefill + 4 decode steps; exit 3 on a mismatch")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="gemma_tpu_torch",
        description="quantized Gemma inference in PyTorch with hand-written CUDA kernels",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    g = sub.add_parser("generate", help="prefill + decode one prompt")
    _add_engine_flags(g)
    g.add_argument("--prompt", default="Hello", help="prompt text")
    g.add_argument("--tokens", default=None,
                   help="comma-separated prompt token ids (bypasses encode)")
    g.add_argument("--max-new-tokens", type=int, default=128)
    g.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    g.add_argument("--top-k", type=int, default=0)
    g.add_argument("--top-p", type=float, default=1.0)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--speculative", action="store_true",
                   help="prompt-lookup speculative decoding (greedy only): drafts k tokens from "
                   "the token history and verifies them in one forward; the greedy stream")
    g.add_argument("--spec-k", type=int, default=7, help="draft tokens a verify step")
    g.add_argument("--chat", action="store_true",
                   help="wrap the prompt in the Gemma instruction-tuned turn template")
    g.add_argument("--stream", action="store_true", help="print tokens as they decode")
    g.add_argument("--no-eos", dest="eos", action="store_false",
                   help="ignore EOS and generate max-new-tokens")
    g.add_argument("--profile", action="store_true",
                   help="print the span/counter/roofline report on stderr at exit")
    g.add_argument("--profile-sync", type=int, default=1, metavar="N",
                   help="with --profile: synchronize the device every Nth decode dispatch so "
                   "span times are device time, not queueing (0 disables)")
    g.set_defaults(fn=cmd_generate)

    s = sub.add_parser("serve", help="batch-serve prompts (one per line) through the "
                       "continuous-batching scheduler")
    _add_engine_flags(s)
    s.add_argument("--prompts-file", default=None,
                   help="file of prompts, one per line (default: stdin)")
    s.add_argument("--batch", type=int, default=8, help="decode slots (concurrent sequences)")
    s.add_argument("--max-new-tokens", type=int, default=128)
    s.add_argument("--block", type=int, default=8, help="decode steps per issued block")
    s.add_argument("--prefill-chunk", type=int, default=0,
                   help="chunk admission prefills to this many tokens")
    s.add_argument("--temperature", type=float, default=0.0)
    s.add_argument("--top-k", type=int, default=0)
    s.add_argument("--top-p", type=float, default=1.0)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--no-eos", dest="eos", action="store_false")
    s.add_argument("--speculative", action="store_true",
                   help="batched prompt-lookup speculation (greedy, dense cache): every slot "
                   "drafts and verifies spec-k tokens a tick, k = 1 while drafts miss")
    s.add_argument("--spec-k", type=int, default=7)
    s.add_argument("--spec-block", type=int, default=4, help="verify ticks a block")
    s.set_defaults(fn=cmd_serve)

    i = sub.add_parser("inspect", help="dump GGUF metadata and tensor info")
    i.add_argument("model")
    i.add_argument("--json", action="store_true")
    i.set_defaults(fn=cmd_inspect)

    b = sub.add_parser("bench", help="decode throughput on a checkpoint")
    _add_engine_flags(b)
    b.add_argument("--prompt", default=None)
    b.add_argument("--max-new-tokens", type=int, default=128)
    b.add_argument("--batch", type=int, default=1)
    b.set_defaults(fn=cmd_bench)

    p = sub.add_parser("perplexity", help="perplexity over a text corpus")
    _add_common(p)
    p.add_argument("--text-file", default=None, help="UTF-8 text file (default: stdin)")
    p.add_argument("--window", type=int, default=512)
    p.set_defaults(fn=cmd_perplexity)

    q = sub.add_parser("quantize", help="re-quantize a checkpoint")
    q.add_argument("model", help="source GGUF (any format)")
    q.add_argument("out", help="output GGUF path")
    q.add_argument("--type", default="q4_0", choices=tuple(QUANTIZE_FTYPES))
    q.set_defaults(fn=cmd_quantize)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
