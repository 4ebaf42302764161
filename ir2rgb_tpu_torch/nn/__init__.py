from .discriminators import (
    DiscConfig,
    MultiscaleDiscriminator,
    NLayerDiscriminator,
    define_d,
)
from .encoders import instance_edges
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

__all__ = ["Deconv", "DiscConfig", "EnhancerDown", "EnhancerUp", "GenConfig",
           "LocalEnhancer", "MultiscaleDiscriminator", "NLayerDiscriminator",
           "ResizeConv", "ResnetBlock", "ResnetGenerator", "ResnetStack",
           "UnetBlock", "UnetGenerator", "Vgg19", "define_d", "define_g",
           "instance_edges", "load_vgg19_npz"]
