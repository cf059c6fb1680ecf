"""PyTorch/CUDA port of the Andes serving stack.

Mirrors ``src/repro``'s layout (``configs``, ``core``, ``kernels``,
``models``, ``serving``, ``obs``, ``api``, ``server``, ``cluster``,
``workload``) so each module's counterpart is easy to find. The host
modules (configs, scheduler, QoE, pricing, latency model, observability,
the client API, the tolerance harness, the HTTP/SSE server, the
discrete-event simulator, the cluster layer and the workload generators)
are copies of the reference's
framework-free code; the model, cache, kernels and engine are rewritten
for PyTorch, with hand-written CUDA kernels for attention and the
selective scan (``kernels/csrc``). Entry points run on ``device="cuda"``
unless the caller asks for the CPU.
"""
