"""Ops on tensors: projections (`linear`, `quant_matmul`) and `attention`,
each kernel beside its plain PyTorch version. Import the submodules; this
package re-exports nothing, so no function shadows a submodule's name."""
