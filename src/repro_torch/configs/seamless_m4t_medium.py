"""SeamlessM4T-medium — enc-dec multimodal (audio) backbone. [arXiv:2308.11596]

12 encoder + 12 decoder layers, d_model=1024, 16 heads, d_ff=4096,
vocab 256206. Audio frontend (mel + conv) is a stub: ``input_specs`` feeds
precomputed frame embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    kind="audio",
    num_layers=12,
    num_encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio",
    source="arXiv:2308.11596",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke",
        kind="audio",
        num_layers=2,
        num_encoder_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        frontend="audio",
        source="arXiv:2308.11596",
    )
