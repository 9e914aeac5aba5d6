"""Command-line interface of the PyTorch/CUDA port.

    python -m gemma_tpu_torch generate model.gguf --prompt "..." [--stream]
    python -m gemma_tpu_torch generate model.gguf --tokens 1,7,300 --device cpu
    python -m gemma_tpu_torch generate model.gguf --prompt "..." --speculative [--spec-k 7]
    python -m gemma_tpu_torch serve    model.gguf --prompts-file p.txt [--paged] [--kv-quant]
    python -m gemma_tpu_torch serve    model.gguf --prompts-file p.txt --speculative
    python -m gemma_tpu_torch inspect  model.gguf [--json]

Counterpart of the `generate`, `serve` and `inspect` subcommands of
`gemma_tpu/cli.py`, with the port's copy of its tokenizer. `serve` reads
one prompt per line and prints one JSON line per request on stdout and the
scheduler's stats on stderr, as the reference does. `--speculative`
(prompt-lookup speculative decoding, `runtime/speculative.py`) needs greedy
sampling, and for `serve` the dense cache: otherwise it says so on stderr
and decodes plainly, as the reference does. `--device` defaults to `cuda`;
without a GPU the command fails rather than running on the CPU. `--device
cpu` is the explicit way to run the plain PyTorch path.
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


def load(path, device):
    """(config, model on `device`, tokenizer) of a GGUF checkpoint."""
    from .gguf.reader import GGUFReader
    from .models.params import load_params
    from .tokenizer.sentencepiece import Tokenizer

    reader = GGUFReader(path)
    cfg, params = load_params(reader, device)
    return cfg, params, Tokenizer.from_gguf(reader)


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

    device = _device(args.device)
    t0 = time.perf_counter()
    cfg, params, tok = load(args.model, device)
    print(f"loaded {args.model} in {time.perf_counter() - t0:.1f}s "
          f"({cfg.n_layers} layers, d_model={cfg.d_model}, vocab={cfg.vocab_size}, "
          f"device={device})", file=sys.stderr)
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
    return 0


def cmd_serve(args) -> int:
    """Offline-batch serving: prompts (one per line) through the
    continuous-batching scheduler; completions and stats as the reference
    prints them."""
    from .runtime import Engine, Request, SamplingParams, serve

    device = _device(args.device)
    cfg, params, tok = load(args.model, device)
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


def _add_engine_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("model", help="path to a GGUF checkpoint")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain PyTorch path)")
    p.add_argument("--max-seq-len", type=int, default=512, help="KV-cache capacity")
    p.add_argument("--kv-quant", action="store_true", help="int8-quantize the KV cache")
    p.add_argument("--paged", action="store_true", help="use the paged KV cache (page tables)")
    p.add_argument("--page-size", type=int, default=None,
                   help="paged KV page length (default 64)")


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
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
