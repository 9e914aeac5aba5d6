"""Build and binding of the CUDA kernels under gemma_tpu_torch/csrc."""
