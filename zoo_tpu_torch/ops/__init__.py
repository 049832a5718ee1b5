"""Tensor ops of the port: attention and the hand-written CUDA kernels."""
