"""PyTorch/CUDA port of the CE-LoRA reproduction (the JAX package `repro` is
the reference).  Imports torch only; the CUDA kernels under
`kernels/*/csrc` are built with nvcc at first use."""
