from .gan import gan_loss_d_parts, gan_loss_g, gradient_penalty
from .reconstruction import (
    VGG_WEIGHTS,
    feature_matching_loss,
    l1_loss,
    vgg_loss,
)

__all__ = ["VGG_WEIGHTS", "feature_matching_loss", "gan_loss_d_parts",
           "gan_loss_g", "gradient_penalty", "l1_loss", "vgg_loss"]
