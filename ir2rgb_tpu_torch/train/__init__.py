from .model import GanModel, create_model, network_configs

__all__ = ["GanModel", "create_model", "network_configs"]
