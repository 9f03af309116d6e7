"""Tensor ops of the port: functional layers, the fbank frontend, and the
hand-written CUDA kernels under `kernels/`."""
