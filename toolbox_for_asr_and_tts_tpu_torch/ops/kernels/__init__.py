"""Hand-written CUDA kernels for Hopper: the build step (`_build`), and one
module per kernel with its ctypes wrapper, plain PyTorch version and launch
counter."""
