"""IBM Granite-3.0 2B base — dense GQA. [hf:ibm-granite/granite-3.0-2b-base]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    kind="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b-smoke",
        kind="dense",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-2b-base",
    )
