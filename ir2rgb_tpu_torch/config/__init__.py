from .config import (
    PRESETS,
    Config,
    DataConfig,
    InferConfig,
    LossConfig,
    ModelConfig,
    TrainConfig,
    config_from_args,
    load_config,
    parse_cli,
    save_config,
)

__all__ = ["Config", "DataConfig", "InferConfig", "LossConfig",
           "ModelConfig", "PRESETS", "TrainConfig", "config_from_args",
           "load_config", "parse_cli", "save_config"]
