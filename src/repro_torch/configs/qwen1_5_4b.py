"""Qwen-1.5 4B — MHA with QKV bias. [hf:Qwen/Qwen1.5-0.5B family]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    kind="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b-smoke",
        kind="dense",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        qkv_bias=True,
        source="hf:Qwen/Qwen1.5-0.5B",
    )
