"""PatchGAN discriminators on NHWC tensors — the port of
``ir2rgb_tpu/nn/discriminators.py``: ``NLayerDiscriminator`` (70x70
PatchGAN), ``MultiscaleDiscriminator`` (``num_d`` PatchGANs over an
average-pooled image pyramid) and ``PixelDiscriminator`` (1x1 PatchGAN).

Layers: a 4x4 stride-2 conv + LeakyReLU(0.2); ``n_layers - 1`` stride-2
convs and one stride-1 conv, each + norm + LeakyReLU (instance norm in
kernel B1 with ``leaky_relu``; batch norm with batch statistics; or
none); a 4x4 stride-1 conv to one channel of patch logits. All convs pad
``d_pad`` (2, the pix2pixHD convention; a CycleGAN's 1, pix2pix's); the
normed convs carry a bias
unless a batch norm follows. The input is cast to the compute dtype,
weights are cast at use, and the logits are cast to fp32
(``discriminators.py:105``). The output is a list over scales, finest
first, of the taps ``[feat_0, ..., feat_n_layers, logits]``, or of
``[logits]`` alone when ``get_interm_feat`` is off.

The modules keep the reference family's layout (``tests/torch_refs.py``),
so a reference ``state_dict`` loads directly. With ``get_interm_feat``:
``model{j}`` Sequentials in ``NLayerDiscriminator`` and
``scale{i}_layer{j}`` in ``MultiscaleDiscriminator``; without it, one flat
Sequential, ``model`` and ``layer{i}``. Trap: the reference runs the
full-resolution input through scale ``num_d - 1`` (its ``forward`` walks
the scales in reverse), while the JAX package's ``scale0`` is the full
resolution; ``checkpoint/from_jax.py`` reverses the scales.

On a partitioned frame (``parallel/spatial.py``) the same forward runs on
this rank's rows: each 4x4 conv splits its output rows over the ranks,
so the layers' shards are uneven (a 4x4 stride-2 conv padded 2 gives
H/2 + 1 rows) and a rank may own none of a late layer; the pyramid's
pool and every tap keep their partition, which the losses read.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.nn as nn

from ir2rgb_tpu_torch.parallel import spatial
from . import ops
from .generators import Slot, norm_layer, use_bias

DiscOut = List[List[torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class DiscConfig:
    net_d: str = "n_layers"  # n_layers | multiscale | pixel
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
    """One Sequential a conv: (conv, leaky), (conv, norm, leaky) or the
    head (conv)."""
    layers = []
    plan = _layer_plan(cfg)
    for j, (cin, cout, stride, normed) in enumerate(plan):
        conv = nn.Conv2d(cin, cout, 4, stride=stride, padding=cfg.d_pad,
                         bias=use_bias(cfg.norm) if normed else True)
        if j == len(plan) - 1:
            layers.append(nn.Sequential(conv))
        elif normed:
            layers.append(nn.Sequential(conv, norm_layer(cfg.norm, cout),
                                        Slot("leaky_relu")))
        else:
            layers.append(nn.Sequential(conv, Slot("leaky_relu")))
    return layers


def _flat(layers: List[nn.Sequential]) -> nn.Sequential:
    """The reference's ``get_interm_feat=False`` layout: one Sequential."""
    return nn.Sequential(*(m for seq in layers for m in seq))


def _groups(flat: nn.Sequential) -> List[List[nn.Module]]:
    """A flat Sequential cut back into one list a conv."""
    groups: List[List[nn.Module]] = []
    for m in flat:
        if isinstance(m, nn.Conv2d):
            groups.append([])
        groups[-1].append(m)
    return groups


def _apply_layers(layers, x: torch.Tensor, cfg: DiscConfig
                  ) -> List[torch.Tensor]:
    """[feat_0, ..., feat_n_layers, fp32 logits] of one PatchGAN, or
    [logits] without ``get_interm_feat``. ``layers``: one sequence of
    modules a conv."""
    h = x.to(cfg.compute_dtype)
    feats = []
    last = len(layers) - 1
    for j, seq in enumerate(layers):
        conv = seq[0]
        h = ops.conv(h, conv.weight, conv.bias, stride=conv.stride[0],
                     padding=cfg.d_pad)
        if j == last:
            h = spatial.same_rows(h.float(), h)
        elif len(seq) == 3:
            h = ops.norm_act(h, cfg.norm, "leaky_relu",
                             bn=seq[1] if cfg.norm == "batch" else None)
        else:
            h = ops.apply_act(h, "leaky_relu")
        feats.append(h)
    return feats if cfg.get_interm_feat else feats[-1:]


class NLayerDiscriminator(nn.Module):
    """70x70 PatchGAN (keys ``model{j}.*``, or ``model.*`` without
    ``get_interm_feat``). ``forward`` returns the uniform one-scale
    structure ``[[feat_0, ..., logits]]`` (``[[logits]]``)."""

    def __init__(self, cfg: DiscConfig):
        super().__init__()
        self.cfg = cfg
        layers = _make_layers(cfg)
        if cfg.get_interm_feat:
            for j, seq in enumerate(layers):
                setattr(self, f"model{j}", seq)
        else:
            self.model = _flat(layers)

    def layers(self) -> List[nn.Sequential]:
        if not self.cfg.get_interm_feat:
            return _groups(self.model)
        return [getattr(self, f"model{j}")
                for j in range(self.cfg.n_layers + 2)]

    def forward(self, x: torch.Tensor) -> DiscOut:
        return [_apply_layers(self.layers(), x, self.cfg)]


class MultiscaleDiscriminator(nn.Module):
    """``num_d`` PatchGANs over the input and its 3x3 stride-2 average-pool
    halvings (``count_include_pad=False``); keys ``scale{i}_layer{j}.*``,
    or ``layer{i}.*`` without ``get_interm_feat``. ``forward`` returns the
    scales finest first; the finest runs scale ``num_d - 1``, as in the
    reference."""

    def __init__(self, cfg: DiscConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.num_d):
            layers = _make_layers(cfg)
            if cfg.get_interm_feat:
                for j, seq in enumerate(layers):
                    setattr(self, f"scale{i}_layer{j}", seq)
            else:
                setattr(self, f"layer{i}", _flat(layers))

    def layers(self, i: int) -> List[nn.Sequential]:
        if not self.cfg.get_interm_feat:
            return _groups(getattr(self, f"layer{i}"))
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


class PixelDiscriminator(nn.Module):
    """The family's ``--netD pixel`` (``discriminators.py:114-150``): a
    1x1 conv to ndf + LeakyReLU(0.2), a 1x1 conv to 2·ndf + norm +
    LeakyReLU, a 1x1 conv to one channel: per-pixel real/fake logits.
    The second conv and the head carry a bias unless the norm is batch,
    as the reference builds them (the head too, though no norm follows
    it). Keys ``net.{0,2,3,5}``, the reference's Sequential. ``forward``
    returns ``[[feat_0, feat_1, logits]]`` (``[[logits]]`` without
    ``get_interm_feat``)."""

    def __init__(self, cfg: DiscConfig):
        super().__init__()
        self.cfg = cfg
        bias = use_bias(cfg.norm)
        self.net = nn.Sequential(
            nn.Conv2d(cfg.input_nc, cfg.ndf, 1), Slot("leaky_relu"),
            nn.Conv2d(cfg.ndf, cfg.ndf * 2, 1, bias=bias),
            norm_layer(cfg.norm, cfg.ndf * 2), Slot("leaky_relu"),
            nn.Conv2d(cfg.ndf * 2, 1, 1, bias=bias))

    def forward(self, x: torch.Tensor) -> DiscOut:
        cfg, net = self.cfg, self.net
        h = ops.apply_act(ops.conv(x.to(cfg.compute_dtype), net[0].weight,
                                   net[0].bias), "leaky_relu")
        feats = [h]
        h = ops.norm_act(ops.conv(h, net[2].weight, net[2].bias), cfg.norm,
                         "leaky_relu",
                         bn=net[3] if cfg.norm == "batch" else None)
        feats.append(h)
        y = ops.conv(h, net[5].weight, net[5].bias)
        feats.append(spatial.same_rows(y.float(), y))
        return [feats if cfg.get_interm_feat else feats[-1:]]


def define_d(cfg: DiscConfig) -> nn.Module:
    """The discriminator named by ``cfg.net_d``; its ``forward`` always
    yields the multiscale structure, so the losses are uniform."""
    if cfg.net_d == "n_layers":
        return NLayerDiscriminator(cfg)
    if cfg.net_d == "multiscale":
        return MultiscaleDiscriminator(cfg)
    if cfg.net_d == "pixel":
        return PixelDiscriminator(cfg)
    raise ValueError(f"unknown net_d: {cfg.net_d}")
