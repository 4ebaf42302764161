from .config import PRESETS, Config, DataConfig, InferConfig, ModelConfig

__all__ = ["Config", "DataConfig", "InferConfig", "ModelConfig", "PRESETS"]
