"""Zamba2 2.7B — Mamba-2 backbone + shared attention blocks. [arXiv:2411.15242]

54 Mamba2 layers with a shared (weight-tied) attention+MLP block applied
every 6 layers. MHA kv=32. ssm_state=64.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    kind="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, version=2, headdim=64),
    hybrid_attn_every=6,
    hybrid_shared_attn=True,
    source="arXiv:2411.15242",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        kind="hybrid",
        num_layers=4,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, version=2, headdim=64),
        hybrid_attn_every=2,
        hybrid_shared_attn=True,
        source="arXiv:2411.15242",
    )
