"""Hand-written CUDA kernels (``csrc/``), their nvcc build, wrappers and
plain PyTorch versions."""
