"""On-device kernel verification: the CUDA kernels against their plain
versions, on the same card.

Counterpart of `gemma_tpu/utils/verify.py`. CPU tests hold each kernel's
plain version to the reference, and `chip_smoke.py` holds each kernel to
its plain version at fixed shapes; this check runs the whole model both
ways on the user's own checkpoint and card: one prefill and N greedy
decode steps through the kernels (recording the token stream), then the
same prefill and steps through the plain versions (replaying that stream,
so both sides see the same inputs), and reports the max |Δ| of the logits
at each step and whether every argmax agrees.

The plain side runs under `plain_versions()`, which sets the ops'
`set_force_plain` switches (`ops/quant_matmul.py`, `ops/attention.py`,
`ops/paged_attention.py`: the reference's `set_force_fallback`) and clears
them in a `finally`. Nothing else sets them. The kernels' launch counters
are read around each side: the plain side must launch no kernel, which is
how the check shows it really ran the plain versions.

Exposed as `--verify` on the CLI's generate, bench and serve.
"""
from __future__ import annotations

import contextlib
from typing import Any

import numpy as np
import torch

from ..ops import attention as att
from ..ops import paged_attention as pat
from ..ops import quant_matmul as qmm


def launch_counters() -> list[tuple[str, Any, str]]:
    """(name, wrapper, attribute) of every kernel launch counter of the
    main path's ops."""
    return [*((f"{fmt}_matmul", op, "launches") for fmt, op in qmm.MATMULS.items()),
            # the calls with f32 x at M > 8 (the TF32 tile)
            ("q4_0_matmul_tf32", qmm.q4_0_matmul, "tf32_launches"),
            ("q8_0_matmul_tf32", qmm.q8_0_matmul, "tf32_launches"),
            ("q4_k_matmul_tf32", qmm.q4_k_matmul, "tf32_launches"),
            ("q6_k_matmul_tf32", qmm.q6_k_matmul, "tf32_launches"),
            # the calls with f32 x at M <= 8 (the f32 GEMV)
            ("q4_0_matmul_gemv_f32", qmm.q4_0_matmul, "gemv_f32_launches"),
            ("q8_0_matmul_gemv_f32", qmm.q8_0_matmul, "gemv_f32_launches"),
            ("q4_k_matmul_gemv_f32", qmm.q4_k_matmul, "gemv_f32_launches"),
            ("q6_k_matmul_gemv_f32", qmm.q6_k_matmul, "gemv_f32_launches"),
            ("flash_attention", att.flash_attention, "launches"),
            # the calls of flash attention with f32 queries (the TF32 kernel)
            ("flash_attention_tf32", att.flash_attention, "tf32_launches"),
            ("decode_attention", att.decode_attention, "launches"),
            ("decode_attention_int8", att.decode_attention, "int8_launches"),
            # the calls of decode attention with f32 queries on TF32 tensor cores
            ("decode_attention_tf32", att.decode_attention, "tf32_launches"),
            # the calls of the two above that went through the tensor cores
            ("flash_attention_tc", att.flash_attention, "tc_launches"),
            ("decode_attention_tc", att.decode_attention, "tc_launches"),
            # the calls of decode attention at G = 1 (the core for one query row)
            ("decode_attention_g1", att.decode_attention, "g1_launches"),
            ("paged_attention", pat.paged_decode_attention, "launches"),
            ("paged_attention_int8", pat.paged_decode_attention, "int8_launches"),
            # the calls of the two above that went through the tensor cores
            ("paged_attention_tc", pat.paged_decode_attention, "tc_launches"),
            # and through the G = 1 core
            ("paged_attention_g1", pat.paged_decode_attention, "g1_launches")]


def read_launches() -> dict[str, int]:
    return {name: getattr(op, attr) for name, op, attr in launch_counters()}


@contextlib.contextmanager
def plain_versions():
    """Run the enclosed code through the ops' plain versions on every
    device; the switches are off again when it exits, by exception too."""
    mods = (qmm, att, pat)
    try:
        for m in mods:
            m.set_force_plain(True)
        yield
    finally:
        for m in mods:
            m.set_force_plain(False)


def verify_device_kernels(
    cfg,
    model,
    prompt: list[int],
    n_decode: int = 4,
    max_seq_len: int = 512,
    kv_quantized: bool = False,
    paged: bool = False,
    page_size: int | None = None,
    atol: float = 0.05,
    prefill_chunk: int = 0,
) -> dict[str, Any]:
    """Compare the kernel and plain-version forwards on `model`'s device.

    Returns {"ok", "max_abs", "steps" (per-step max |Δ| of the logits
    vector: the prefill's last row, then each decode step), "scale" (the
    largest |logit| of the kernel side), "argmax_agree", "stream" (the
    kernel side's greedy tokens), "n_decode", "atol", "kernel_launches",
    "plain_launches"}. ok: max |Δ| within atol,
    every argmax equal, and no kernel launched by the plain side. Both
    sides form the same products from the same weights and differ in the
    order of f32 sums; with bf16 activations a sum can also land on the
    other side of a bf16 rounding, and such flips grow with depth. The
    cache holds `cfg`'s activation dtype (bf16, or f32 for evaluation
    numerics; int8 with `kv_quantized`). Prompts longer than
    `prefill_chunk` (when set) prefill in chunks of that many tokens."""
    from ..runtime import Engine, EngineConfig

    ecfg = EngineConfig(max_seq_len=max_seq_len, max_batch=1, kv_dtype=cfg.act_dtype,
                        kv_quantized=kv_quantized, paged=paged, page_size=page_size,
                        prefill_chunk=prefill_chunk)

    def run(tokens: list[int] | None):
        """One prefill + n_decode steps. tokens=None: greedy (records the
        stream); else replay the given stream."""
        before = read_launches()
        eng = Engine(cfg, model, ecfg)
        logits, cache = eng.prefill([prompt])
        outs = [logits[0].float().cpu().numpy()]
        stream: list[int] = []
        for i in range(n_decode):
            t = int(np.argmax(outs[-1])) if tokens is None else tokens[i]
            stream.append(t)
            logits, cache = eng.decode_step(torch.tensor([t], device=eng.device), cache)
            outs.append(logits[0].float().cpu().numpy())
        after = read_launches()
        return outs, stream, {k: after[k] - before[k] for k in after}

    kernel_outs, stream, kernel_launches = run(None)
    with plain_versions():
        plain_outs, _, plain_launches = run(stream)

    steps = [float(np.abs(a - b).max()) for a, b in zip(kernel_outs, plain_outs)]
    argmax_agree = all(int(np.argmax(a)) == int(np.argmax(b))
                       for a, b in zip(kernel_outs, plain_outs))
    max_abs = max(steps)
    return {
        "ok": bool(max_abs <= atol and argmax_agree and not any(plain_launches.values())),
        "max_abs": max_abs,
        "steps": steps,
        "scale": max(float(np.abs(a).max()) for a in kernel_outs),
        "argmax_agree": argmax_agree,
        "stream": stream,
        "n_decode": n_decode,
        "atol": atol,
        "kernel_launches": kernel_launches,
        "plain_launches": plain_launches,
    }


def format_report(res: dict[str, Any]) -> str:
    launched = {k: n for k, n in res["kernel_launches"].items() if n}
    lines = [
        f"kernel-vs-plain on-device verification: {'OK' if res['ok'] else 'MISMATCH'}",
        f"  max |dlogit| over prefill + {res['n_decode']} decode steps: "
        f"{res['max_abs']:.3g} (atol {res['atol']:.3g}; logits up to {res['scale']:.3g})",
        f"  argmax agreement: {res['argmax_agree']}",
        "  per-step max |d|: " + ", ".join(f"{s:.3g}" for s in res["steps"]),
        f"  kernel launches: {launched or 'none (plain versions on the CPU)'}; "
        f"plain side: {sum(res['plain_launches'].values())}",
    ]
    return "\n".join(lines)
