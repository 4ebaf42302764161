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
from .compat import REFERENCE_FLAG_TABLE, from_reference_flags

__all__ = ["Config", "DataConfig", "InferConfig", "LossConfig",
           "ModelConfig", "PRESETS", "REFERENCE_FLAG_TABLE", "TrainConfig",
           "config_from_args", "from_reference_flags", "load_config",
           "parse_cli", "save_config"]
