from .model import GanModel, create_model, network_configs
from .trainer import Trainer

__all__ = ["GanModel", "Trainer", "create_model", "network_configs"]
