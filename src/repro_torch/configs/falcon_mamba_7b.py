"""Falcon-Mamba 7B — attention-free Mamba-1. [arXiv:2410.05355]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    kind="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, version=1),
    source="arXiv:2410.05355",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-smoke",
        kind="ssm",
        num_layers=2,
        d_model=256,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, version=1),
        source="arXiv:2410.05355",
    )
