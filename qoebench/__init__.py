"""The benchmark of the PyTorch/CUDA port (``repro_torch``): wall-clock QoE,
TTFT and throughput of the Andes serving engine on one H100.

Run one cell once with ``python -m qoebench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the repository root; README.md says how
the harness finds configurations, traffic mixes and metrics by name.
"""
