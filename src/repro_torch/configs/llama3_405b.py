"""Llama-3 405B — dense GQA, 128k vocab. [arXiv:2407.21783]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    kind="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500000.0,
    source="arXiv:2407.21783",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b-smoke",
        kind="dense",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        rope_theta=500000.0,
        source="arXiv:2407.21783",
    )
