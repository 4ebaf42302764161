from .cycle import CycleGanModel, create_cycle_model
from .model import GanModel, create_model, network_configs
from .trainer import Trainer

__all__ = ["CycleGanModel", "GanModel", "Trainer", "create_cycle_model",
           "create_model", "network_configs"]
