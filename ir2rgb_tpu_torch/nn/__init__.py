from .discriminators import (
    DiscConfig,
    MultiscaleDiscriminator,
    NLayerDiscriminator,
    define_d,
)
from .encoders import (
    Encoder,
    EncoderConfig,
    define_e,
    hash_instance_ids,
    instance_collision_count,
    instance_edges,
    instance_feature_table,
    instance_wise_avg_pool,
)
from .generators import (
    Deconv,
    EnhancerDown,
    EnhancerUp,
    GenConfig,
    LocalEnhancer,
    ResizeConv,
    ResnetBlock,
    ResnetGenerator,
    ResnetStack,
    UnetBlock,
    UnetGenerator,
    define_g,
)
from .vgg import Vgg19, load_vgg19_npz

__all__ = ["Deconv", "DiscConfig", "Encoder", "EncoderConfig", "EnhancerDown",
           "EnhancerUp", "GenConfig", "LocalEnhancer",
           "MultiscaleDiscriminator", "NLayerDiscriminator", "ResizeConv",
           "ResnetBlock", "ResnetGenerator", "ResnetStack", "UnetBlock",
           "UnetGenerator", "Vgg19", "define_d", "define_e", "define_g",
           "hash_instance_ids", "instance_collision_count", "instance_edges",
           "instance_feature_table", "instance_wise_avg_pool",
           "load_vgg19_npz"]
