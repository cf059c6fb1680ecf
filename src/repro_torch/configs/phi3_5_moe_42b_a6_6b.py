"""Phi-3.5-MoE 42B (A6.6B) — 16 experts top-2, GQA.
[hf:microsoft/Phi-3.5-MoE-instruct]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    kind="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    moe=MoEConfig(num_experts=16, num_shared_experts=0, top_k=2, d_expert=6400),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-smoke",
        kind="moe",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        moe=MoEConfig(num_experts=4, num_shared_experts=0, top_k=2, d_expert=128),
        source="hf:microsoft/Phi-3.5-MoE-instruct",
    )
