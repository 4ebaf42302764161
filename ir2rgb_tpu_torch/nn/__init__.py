from .generators import (
    EnhancerDown,
    EnhancerUp,
    GenConfig,
    LocalEnhancer,
    ResnetBlock,
    ResnetGenerator,
    ResnetStack,
)

__all__ = ["EnhancerDown", "EnhancerUp", "GenConfig", "LocalEnhancer",
           "ResnetBlock", "ResnetGenerator", "ResnetStack"]
