"""Reconstruction and perceptual losses — the port of
``ir2rgb_tpu/losses/reconstruction.py``.

- ``l1_loss``: mean |fake - real|;
- ``feature_matching_loss``: L1 between the discriminator's intermediate
  taps on fake and real, weight 4/(n_layers+1) per tap and 1/num_d per
  scale; the real taps are detached;
- ``vgg_loss``: sum_i w_i * L1(vgg(fake)_i, vgg(real)_i), with
  w = (1/32, 1/16, 1/8, 1/4, 1); the real pass records no graph.

All reductions in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

from ir2rgb_tpu_torch.nn.discriminators import DiscOut
from ir2rgb_tpu_torch.nn.vgg import Vgg19

VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def l1_loss(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    return (fake.float() - real.float()).abs().mean()


def feature_matching_loss(disc_out_fake: DiscOut, disc_out_real: DiscOut,
                          n_layers: int = 3) -> torch.Tensor:
    num_d = len(disc_out_fake)
    w = (4.0 / (n_layers + 1)) * (1.0 / num_d)
    loss = torch.zeros((), device=disc_out_fake[0][0].device)
    for fake_scale, real_scale in zip(disc_out_fake, disc_out_real):
        # every tap except the final logits map
        for ff, fr in zip(fake_scale[:-1], real_scale[:-1]):
            loss = loss + w * (ff.float() - fr.detach().float()).abs().mean()
    return loss


def vgg_loss(vgg: Vgg19, fake: torch.Tensor, real: torch.Tensor,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``dtype=torch.bfloat16`` runs the VGG trunk in bf16; the per-stage
    L1 reductions stay fp32."""
    feats_fake = vgg(fake, dtype)
    with torch.no_grad():
        feats_real = vgg(real, dtype)
    loss = torch.zeros((), device=fake.device)
    for w, ff, fr in zip(VGG_WEIGHTS, feats_fake, feats_real):
        loss = loss + w * (ff.float() - fr.float()).abs().mean()
    return loss
