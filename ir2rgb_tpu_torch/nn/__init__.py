from .discriminators import (
    DiscConfig,
    MultiscaleDiscriminator,
    NLayerDiscriminator,
    define_d,
)
from .generators import (
    Deconv,
    EnhancerDown,
    EnhancerUp,
    GenConfig,
    LocalEnhancer,
    ResnetBlock,
    ResnetGenerator,
    ResnetStack,
)
from .vgg import Vgg19, load_vgg19_npz

__all__ = ["Deconv", "DiscConfig", "EnhancerDown", "EnhancerUp", "GenConfig",
           "LocalEnhancer", "MultiscaleDiscriminator", "NLayerDiscriminator",
           "ResnetBlock", "ResnetGenerator", "ResnetStack", "Vgg19",
           "define_d", "load_vgg19_npz"]
