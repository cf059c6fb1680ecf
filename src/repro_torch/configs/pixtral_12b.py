"""Pixtral-12B — ViT frontend (stub) + Mistral-NeMo-style dense decoder.
[hf:mistralai/Pixtral-12B-2409]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    kind="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    rope_theta=1000000.0,
    frontend="vision",
    source="hf:mistralai/Pixtral-12B-2409",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-smoke",
        kind="vlm",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        frontend="vision",
        source="hf:mistralai/Pixtral-12B-2409",
    )
