from .from_jax import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    vgg_state_dict_from_jax,
)

__all__ = ["discriminator_state_dict_from_jax",
           "generator_state_dict_from_jax", "vgg_state_dict_from_jax"]
