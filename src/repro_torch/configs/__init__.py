from repro_torch.configs.base import (
    MLAConfig,
    MoEConfig,
    ModelConfig,
    get_config,
    register,
)

__all__ = ["MLAConfig", "MoEConfig", "ModelConfig", "get_config", "register"]
