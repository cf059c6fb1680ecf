from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    get_config,
    get_shape,
    get_smoke_config,
)

__all__ = [
    "ARCH_IDS",
    "INPUT_SHAPES",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "ShapeConfig",
    "get_config",
    "get_shape",
    "get_smoke_config",
]
