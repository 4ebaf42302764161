from .config import (
    PRESETS,
    Config,
    DataConfig,
    InferConfig,
    LossConfig,
    ModelConfig,
    TrainConfig,
)

__all__ = ["Config", "DataConfig", "InferConfig", "LossConfig",
           "ModelConfig", "PRESETS", "TrainConfig"]
