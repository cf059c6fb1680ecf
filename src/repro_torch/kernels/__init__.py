"""Attention and selective-scan kernels: plain versions (ref), CUDA kernels
(cuda, csrc/) and the device dispatch (ops)."""
