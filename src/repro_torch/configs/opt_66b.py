"""OPT-66B — the paper's own evaluation model family. [arXiv:2205.01068]

Used by the faithful-reproduction benchmarks (latency-model calibration in
the simulator mirrors Table 3's 4xA100 deployment, mapped to TPU v5e chips).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="opt-66b",
    kind="dense",
    num_layers=64,
    d_model=9216,
    num_heads=72,
    num_kv_heads=72,
    d_ff=36864,
    vocab_size=50272,
    gated_mlp=False,
    source="arXiv:2205.01068",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="opt-66b-smoke",
        kind="dense",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        source="arXiv:2205.01068",
    )
