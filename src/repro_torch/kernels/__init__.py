"""Hand-written CUDA kernels (built with nvcc at first use) and their plain
PyTorch versions."""
