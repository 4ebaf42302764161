from .model import GanModel, create_model

__all__ = ["GanModel", "create_model"]
