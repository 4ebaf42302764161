from .from_jax import (
    cycle_discriminators_from_jax,
    cycle_generators_from_jax,
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    vgg_state_dict_from_jax,
)
from .manager import CheckpointManager, restore_train_state, save_train_state
from .torch_import import (
    convert_vgg19_pth,
    import_discriminator,
    import_generator,
    load_state_dict,
)

__all__ = ["CheckpointManager", "convert_vgg19_pth",
           "cycle_discriminators_from_jax", "cycle_generators_from_jax",
           "discriminator_state_dict_from_jax",
           "generator_state_dict_from_jax", "import_discriminator",
           "import_generator", "load_state_dict", "restore_train_state",
           "save_train_state", "vgg_state_dict_from_jax"]
