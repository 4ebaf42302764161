from .from_jax import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    vgg_state_dict_from_jax,
)
from .manager import CheckpointManager, restore_train_state, save_train_state

__all__ = ["CheckpointManager", "discriminator_state_dict_from_jax",
           "generator_state_dict_from_jax", "restore_train_state",
           "save_train_state", "vgg_state_dict_from_jax"]
