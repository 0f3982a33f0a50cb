"""Hand-written CUDA kernels of the port (sources in ``csrc/``), their
ctypes wrappers and plain PyTorch versions."""
