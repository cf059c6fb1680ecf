"""Attention kernels: plain versions (ref), CUDA kernels (cuda, csrc/) and
the device dispatch (ops)."""
