"""The port's benches and probes, counterparts of the reference's `tools/`.

The decode-GEMV benches (`bench_qmm_variants`, `bench_bn_sweep`,
`probe_int4`, `bench_q4k_variants`, `bench_q6k_variants`):

    python -m gemma_tpu_torch.tools.<name> [shape] [--device cpu]

time each kernel with L2 cold (`_timing.py`). The serving and step benches
(`bench_serving`, `bench_itl`, `bench_longctx`, `bench_step_parts`,
`bench_micro`, `bench_scan`) take the reference tools' flags and print
their JSON keys on the last line, after the card's name and power limit
and a `launches {...}` line of the kernels the run launched:

    python -m gemma_tpu_torch.tools.bench_serving [--model gemma2b|gemma7b|tiny] [--device cpu]

The kernel-timing tools (`bench_decode_attn`, `bench_flash`,
`bench_fmt_kernels`, `bench_shapes`, `probe_cache_cost`) sweep the
attention kernels' launch shapes through their C entry points
(`_launch.py`), time the production matmul at the decode step's M = 8 by
format and shape, and a Gemma-7B step's cost by allocated cache:

    python -m gemma_tpu_torch.tools.bench_decode_attn [--heads 7b] [--device cpu --sizes 64:50]

Every bench runs on the card unless `--device cpu` asks for the plain
versions (with `--model tiny` for the serving and step benches, and tiny
sizes for the kernel-timing tools), whose times say nothing of the card. `bench_prefill` reads the marginal prefill
rate; `bench_spec` and `probe_spec_serving` time speculative decoding
against plain decode at batch 1 and over 8 serving slots; `bench_scaling`
times tensor parallelism. Instruments of the port's own kernels:
`probe_variants` builds patched copies of the kernels and times them side
by side on the card (constants, tile shapes, ablations), `tc_emulation`
emulates the tensor-core kernels lane by lane in numpy on the CPU, and
`parent_turn` times a parent tree against this one in turns.
"""
