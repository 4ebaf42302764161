"""Seeded weights, made on the device in a few large calls.

G's and D's convs take the reference ``weights_init``, N(0, 0.02) with
zero biases; the VGG19 takes He-normal N(0, 2 / (9 cin)) with zero biases
(no pretrained file is in the repository: the shapes and the work are the
pretrained network's). One normal draw from a ``torch.Generator`` on the
device fills every weight of a network; biases are one zero buffer. The
state dicts' keys are the reference's, which the program under test
shares.
"""

from __future__ import annotations

from typing import Dict

import torch

INIT_STD = 0.02


def _draw(net: torch.nn.Module, gen: torch.Generator, device,
          he: bool) -> Dict[str, torch.Tensor]:
    named = list(net.named_parameters())
    weights = [(k, p.shape) for k, p in named if k.endswith("weight")]
    biases = [(k, p.shape) for k, p in named if not k.endswith("weight")]
    flat = torch.randn(sum(s.numel() for _, s in weights), generator=gen,
                       device=device, dtype=torch.float32)
    zeros = torch.zeros(sum(s.numel() for _, s in biases), device=device,
                        dtype=torch.float32)
    sd, at = {}, 0
    for k, shape in weights:
        w = flat[at:at + shape.numel()].view(shape)
        w.mul_((2.0 / (9 * shape[1])) ** 0.5 if he else INIT_STD)
        sd[k] = w
        at += shape.numel()
    at = 0
    for k, shape in biases:
        sd[k] = zeros[at:at + shape.numel()].view(shape)
        at += shape.numel()
    return sd


def draw(nets: Dict[str, torch.nn.Module], seed: int, device
         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{net name: state dict} for the reference networks ``nets`` (their
    shapes only are read), from ``seed``: each network from its own
    generator, so adding a network changes no other's weights."""
    out = {}
    for i, (name, net) in enumerate(sorted(nets.items())):
        gen = torch.Generator(device=device).manual_seed(
            (seed * 7919 + i + 1) % (1 << 63))
        out[name] = _draw(net, gen, device, he=name == "vgg")
    return out
