"""PatchGAN discriminators on NHWC tensors — the port of
``ir2rgb_tpu/nn/discriminators.py``: ``NLayerDiscriminator`` (70x70
PatchGAN) and ``MultiscaleDiscriminator`` (``num_d`` PatchGANs over an
average-pooled image pyramid).

Layers: a 4x4 stride-2 conv + LeakyReLU(0.2); ``n_layers - 1`` stride-2
convs and one stride-1 conv, each + instance norm + LeakyReLU (kernel B1,
``leaky_relu``); a 4x4 stride-1 conv to one channel of patch logits. All
convs pad ``d_pad`` (2, the pix2pixHD convention). The input is cast to
the compute dtype, weights are cast at use, and the logits are cast to
fp32 (``discriminators.py:105``). The output is a list over scales, finest
first, of the taps ``[feat_0, ..., feat_n_layers, logits]``.

The modules keep the reference family's layout (``tests/torch_refs.py``):
``model{j}`` Sequentials in ``NLayerDiscriminator`` and
``scale{i}_layer{j}`` in ``MultiscaleDiscriminator``, so a reference
``state_dict`` loads directly. Trap: the reference runs the
full-resolution input through ``scale{num_d-1}`` (its ``forward`` walks
the scales in reverse), while the JAX package's ``scale0`` is the full
resolution; ``checkpoint/from_jax.py`` reverses the scales.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.nn as nn

from . import ops
from .generators import Slot

DiscOut = List[List[torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class DiscConfig:
    net_d: str = "n_layers"  # n_layers | multiscale
    input_nc: int = 6  # conditional GAN: cat(IR input, RGB output)
    ndf: int = 64
    n_layers: int = 3
    num_d: int = 2
    norm: str = "instance"
    get_interm_feat: bool = True
    d_pad: int = 2
    compute_dtype: torch.dtype = torch.float32


def _layer_plan(cfg: DiscConfig):
    """(cin, cout, stride, normed) of each 4x4 conv, head last."""
    plan = [(cfg.input_nc, cfg.ndf, 2, False)]
    nf = cfg.ndf
    for _ in range(1, cfg.n_layers):
        nf_prev, nf = nf, min(nf * 2, 512)
        plan.append((nf_prev, nf, 2, True))
    nf_prev, nf = nf, min(nf * 2, 512)
    plan.append((nf_prev, nf, 1, True))
    plan.append((nf, 1, 1, False))
    return plan


def _make_layers(cfg: DiscConfig) -> List[nn.Sequential]:
    layers = []
    plan = _layer_plan(cfg)
    for j, (cin, cout, stride, normed) in enumerate(plan):
        conv = nn.Conv2d(cin, cout, 4, stride=stride, padding=cfg.d_pad)
        if j == len(plan) - 1:
            layers.append(nn.Sequential(conv))
        elif normed:
            layers.append(nn.Sequential(conv, Slot(cfg.norm),
                                        Slot("leaky_relu")))
        else:
            layers.append(nn.Sequential(conv, Slot("leaky_relu")))
    return layers


def _check(cfg: DiscConfig) -> None:
    if cfg.norm != "instance":
        raise NotImplementedError(f"norm={cfg.norm!r} is not ported yet")
    if not cfg.get_interm_feat:
        raise NotImplementedError("get_interm_feat=False (the reference's "
                                  "flat `model` layout) is not ported yet")


def _apply_layers(layers, x: torch.Tensor, cfg: DiscConfig
                  ) -> List[torch.Tensor]:
    """[feat_0, ..., feat_n_layers, fp32 logits] of one PatchGAN."""
    h = x.to(cfg.compute_dtype)
    feats = []
    last = len(layers) - 1
    for j, seq in enumerate(layers):
        conv = seq[0]
        h = ops.conv(h, conv.weight, conv.bias, stride=conv.stride[0],
                     padding=cfg.d_pad)
        if j == last:
            h = h.float()
        elif len(seq) == 3:
            h = ops.norm_act(h, cfg.norm, "leaky_relu")
        else:
            h = ops.apply_act(h, "leaky_relu")
        feats.append(h)
    return feats


class NLayerDiscriminator(nn.Module):
    """70x70 PatchGAN (keys ``model{j}.0``). ``forward`` returns the
    uniform one-scale structure ``[[feat_0, ..., logits]]``."""

    def __init__(self, cfg: DiscConfig):
        super().__init__()
        _check(cfg)
        self.cfg = cfg
        for j, seq in enumerate(_make_layers(cfg)):
            setattr(self, f"model{j}", seq)

    def layers(self) -> List[nn.Sequential]:
        return [getattr(self, f"model{j}")
                for j in range(self.cfg.n_layers + 2)]

    def forward(self, x: torch.Tensor) -> DiscOut:
        return [_apply_layers(self.layers(), x, self.cfg)]


class MultiscaleDiscriminator(nn.Module):
    """``num_d`` PatchGANs over the input and its 3x3 stride-2 average-pool
    halvings (``count_include_pad=False``); keys ``scale{i}_layer{j}.0``.
    ``forward`` returns the scales finest first; the finest runs
    ``scale{num_d-1}``, as in the reference."""

    def __init__(self, cfg: DiscConfig):
        super().__init__()
        _check(cfg)
        self.cfg = cfg
        for i in range(cfg.num_d):
            for j, seq in enumerate(_make_layers(cfg)):
                setattr(self, f"scale{i}_layer{j}", seq)

    def layers(self, i: int) -> List[nn.Sequential]:
        return [getattr(self, f"scale{i}_layer{j}")
                for j in range(self.cfg.n_layers + 2)]

    def forward(self, x: torch.Tensor) -> DiscOut:
        cfg = self.cfg
        outs = []
        xi = x
        for i in range(cfg.num_d):
            outs.append(_apply_layers(self.layers(cfg.num_d - 1 - i), xi,
                                      cfg))
            if i != cfg.num_d - 1:
                xi = ops.avg_pool(xi, 3, 2, 1, count_include_pad=False)
        return outs


def define_d(cfg: DiscConfig) -> nn.Module:
    """The discriminator named by ``cfg.net_d``; its ``forward`` always
    yields the multiscale structure, so the losses are uniform."""
    if cfg.net_d == "n_layers":
        return NLayerDiscriminator(cfg)
    if cfg.net_d == "multiscale":
        return MultiscaleDiscriminator(cfg)
    if cfg.net_d == "pixel":
        raise NotImplementedError("net_d='pixel' is not ported yet")
    raise ValueError(f"unknown net_d: {cfg.net_d}")
