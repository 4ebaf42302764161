"""GAN losses over multiscale patch-logit pyramids — the port of
``ir2rgb_tpu/losses/gan.py``.

LSGAN (MSE against 1/0 targets, the default), vanilla (BCE with logits),
hinge and the WGAN critic values, each a mean over the patch-logit map,
summed over the scales of the discriminator's output (a list over scales,
each a list of taps with the logits last). All in fp32. WGAN-GP's
:func:`gradient_penalty` differentiates D's input gradient, so D's
parameters get a second derivative through every layer, kernel B1's
backward included.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

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


def draw_eps(n: int, generator: torch.Generator) -> torch.Tensor:
    """The penalty's per-sample mixing weights, (n, 1, 1, 1) fp32 uniform
    in [0, 1), drawn from ``generator`` on its device."""
    return torch.rand((n, 1, 1, 1), generator=generator,
                      device=generator.device)


def gradient_penalty(d_fn: Callable[[torch.Tensor], DiscOut],
                     pair_real: torch.Tensor, pair_fake: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     lambda_gp: float = 10.0,
                     eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """WGAN-GP's penalty (``ir2rgb_tpu/losses/gan.py:70-93``, the family's
    'mixed' mode): λ · mean((‖∇x̂ D(x̂)‖₂ − 1)²) at x̂ = ε·real + (1−ε)·fake,
    one ε a sample (``eps``, else drawn from ``generator``), in fp32.

    ``d_fn``: x -> D's multiscale output with D's parameters live. The
    inner gradient of the summed fp32 logits of every scale is taken with
    ``create_graph``, so the penalty's own gradient reaches D's
    parameters as a second derivative."""
    if eps is None:
        eps = draw_eps(pair_real.shape[0], generator)
    eps = eps.to(pair_real.device, torch.float32)
    xhat = (eps * pair_real.detach().float()
            + (1.0 - eps) * pair_fake.detach().float()).requires_grad_(True)
    critic = sum(s[-1].float().sum() for s in d_fn(xhat))
    (g,) = torch.autograd.grad(critic, xhat, create_graph=True)
    gnorm = torch.sqrt(g.reshape(g.shape[0], -1).square().sum(dim=1) + 1e-16)
    return lambda_gp * (gnorm - 1.0).square().mean()
