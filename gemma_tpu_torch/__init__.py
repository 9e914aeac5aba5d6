"""gemma_tpu_torch — the PyTorch/CUDA port of gemma_tpu for NVIDIA Hopper.

The JAX package `gemma_tpu` is the reference this package is held against.
Module names mirror it (models/, quant/, ops/, runtime/, cli.py) so each
counterpart is easy to find. Plain tensor code is PyTorch; every Pallas
kernel on the served path is a hand-written CUDA C++ kernel for sm_90a under
`csrc/`, built at first use by `kernels/build.py`.

Device policy: the device of the tensor decides. A kernel wrapper given a
CPU tensor runs its plain PyTorch version; given a CUDA tensor it launches
the kernel or raises — there is no fallback on CUDA.

The package imports nothing of `gemma_tpu` and never imports jax: it keeps
its own copies of the reference's framework-free modules (`gguf/`,
`quant/numpy_ref.py`, `tokenizer/`), which tests/test_torch_gguf.py holds
equal to the originals.
"""

__version__ = "0.1.0"
