"""GAN losses over multiscale patch-logit pyramids — the port of
``ir2rgb_tpu/losses/gan.py``.

LSGAN (MSE against 1/0 targets, the default), vanilla (BCE with logits),
hinge and the WGAN critic values, each a mean over the patch-logit map,
summed over the scales of the discriminator's output (a list over scales,
each a list of taps with the logits last). All in fp32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ir2rgb_tpu_torch.nn.discriminators import DiscOut


def _per_scale(logits: torch.Tensor, target_is_real: bool, mode: str,
               for_discriminator: bool) -> torch.Tensor:
    x = logits.float()
    if mode == "lsgan":
        target = 1.0 if target_is_real else 0.0
        return ((x - target) ** 2).mean()
    if mode == "vanilla":
        target = 1.0 if target_is_real else 0.0
        # BCE with logits, the numerically stable form
        return (torch.clamp(x, min=0) - x * target
                + torch.log1p(torch.exp(-x.abs()))).mean()
    if mode == "hinge":
        if for_discriminator:
            if target_is_real:
                return F.relu(1.0 - x).mean()
            return F.relu(1.0 + x).mean()
        return -x.mean()  # generator side: -E[D(fake)]
    if mode == "wgangp":
        # the critic values; the gradient penalty is a separate term
        return -x.mean() if target_is_real else x.mean()
    raise ValueError(f"unknown gan mode: {mode}")


def gan_loss_g(disc_out_fake: DiscOut, mode: str = "lsgan") -> torch.Tensor:
    """Generator adversarial loss: push D(fake) toward 'real'."""
    return sum(_per_scale(scale[-1], True, mode, False)
               for scale in disc_out_fake)


def gan_loss_d_parts(disc_out_real: DiscOut, disc_out_fake: DiscOut,
                     mode: str = "lsgan"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(0.5 * loss(real -> 1), 0.5 * loss(fake -> 0)), reported apart
    as the reference's [D_real, D_fake]."""
    loss_real = sum(_per_scale(s[-1], True, mode, True)
                    for s in disc_out_real)
    loss_fake = sum(_per_scale(s[-1], False, mode, True)
                    for s in disc_out_fake)
    return 0.5 * loss_real, 0.5 * loss_fake


def gradient_penalty(*args, **kwargs):
    """WGAN-GP's penalty needs a second derivative through the B1
    backward kernel; not ported yet."""
    raise NotImplementedError("gan_mode='wgangp' (gradient_penalty) is not "
                              "ported yet")
