"""Feature extractors: the plain PyTorch version and the CUDA kernels."""
