"""Plain PyTorch references of the benchmark's models (no kernels, no
cache, no batching), in float32 or in a simulated fp8 for the control.
Nothing here imports the program or JAX."""
