"""The port's decode-GEMV benches, counterparts of the reference's
`tools/bench_qmm_variants.py`, `bench_bn_sweep.py`, `probe_int4.py`,
`bench_q4k_variants.py` and `bench_q6k_variants.py`:

    python -m gemma_tpu_torch.tools.<name> [shape] [--device cpu]

They run on the card unless `--device cpu` asks for the plain versions, and
time each kernel with L2 cold (`_timing.py`). Two more instruments serve the
port's own kernels: `probe_variants` builds patched copies of the kernels
and times them side by side on the card (constants, tile shapes,
ablations), and `tc_emulation` emulates the q4_0 and q8_0 tensor-core
kernels lane by lane in numpy on the CPU. `bench_spec` and
`probe_spec_serving`, counterparts of the reference's tools of the same
names, time speculative decoding against plain decode at batch 1 and over
8 serving slots.
"""
