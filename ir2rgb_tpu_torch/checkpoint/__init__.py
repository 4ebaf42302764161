from .from_jax import generator_state_dict_from_jax

__all__ = ["generator_state_dict_from_jax"]
