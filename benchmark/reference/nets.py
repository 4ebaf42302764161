"""The plain reference of pix2pixHD's networks (Wang et al.,
arXiv:1711.11585; github.com/NVIDIA/pix2pixHD ``models/networks.py``), in
plain PyTorch on NCHW tensors.

- :class:`LocalEnhancer`: the coarse-to-fine generator, the headless
  global ResNet trunk at half resolution plus one enhancer branch, joined
  by an elementwise sum; a temporal model (vid2vid, arXiv:1808.06601,
  ``n_frames_G 2``) is the same network with the previous generated frame
  concatenated onto the input channels.
- :class:`MultiscaleDiscriminator`: ``num_D`` 70x70 PatchGANs over an
  average-pooled pyramid, returning every intermediate tap (for feature
  matching); the full-resolution input runs through scale ``num_D - 1``.
- :class:`Vgg19Features`: torchvision's VGG19 ``features`` through
  relu5_1, the five stage outputs of the perceptual loss.

State-dict keys are the reference family's, so one state dict loads into
both this reference and the program under test. Every conv and
transposed conv is a :class:`QConv2d` / :class:`QConvTranspose2d`: in
``"fp32"`` precision a plain conv, in ``"fp8"`` one whose input and
weight are rounded to float8 e4m3 (per-tensor scale): the control that
must fail the comparison.

Nothing here imports the program under test, JAX, or any kernel.
"""

from __future__ import annotations

import contextlib
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8 = torch.float8_e4m3fn


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one per-tensor scale (its amax at
    the format's largest finite value), back in x's dtype."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / torch.finfo(FP8).max
    return (x / scale).to(FP8).to(x.dtype) * scale


class QConv2d(nn.Conv2d):
    precision = "fp32"

    def forward(self, x):
        if self.precision == "fp8":
            return F.conv2d(fp8(x), fp8(self.weight), self.bias, self.stride,
                            self.padding)
        return super().forward(x)


class QConvTranspose2d(nn.ConvTranspose2d):
    precision = "fp32"

    def forward(self, x):
        if self.precision == "fp8":
            return F.conv_transpose2d(fp8(x), fp8(self.weight), self.bias,
                                      self.stride, self.padding,
                                      self.output_padding)
        return super().forward(x)


def set_precision(module: nn.Module, precision: str) -> nn.Module:
    """Every conv of ``module`` in ``precision`` ("fp32" or "fp8")."""
    if precision not in ("fp32", "fp8"):
        raise ValueError(f"unknown precision {precision!r}")
    for m in module.modules():
        if isinstance(m, (QConv2d, QConvTranspose2d)):
            m.precision = precision
    return module


@contextlib.contextmanager
def no_tf32():
    """fp32 convolutions and matmuls in full fp32 (a GPU otherwise rounds
    their inputs to TF32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _norm(c: int) -> nn.Module:
    return nn.InstanceNorm2d(c, affine=False, track_running_stats=False)


class ResnetBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), QConv2d(dim, dim, 3), _norm(dim),
            nn.ReLU(True), nn.ReflectionPad2d(1), QConv2d(dim, dim, 3),
            _norm(dim))

    def forward(self, x):
        return x + self.conv_block(x)


def _global_trunk(input_nc: int, ngf: int, n_downsampling: int,
                  n_blocks: int) -> nn.Sequential:
    """pix2pixHD's GlobalGenerator without its output layer."""
    model = [nn.ReflectionPad2d(3), QConv2d(input_nc, ngf, 7), _norm(ngf),
             nn.ReLU(True)]
    for i in range(n_downsampling):
        mult = 2 ** i
        model += [QConv2d(ngf * mult, ngf * mult * 2, 3, stride=2,
                          padding=1), _norm(ngf * mult * 2), nn.ReLU(True)]
    mult = 2 ** n_downsampling
    model += [ResnetBlock(ngf * mult) for _ in range(n_blocks)]
    for i in range(n_downsampling):
        mult = 2 ** (n_downsampling - i)
        model += [QConvTranspose2d(ngf * mult, ngf * mult // 2, 3, stride=2,
                                   padding=1, output_padding=1),
                  _norm(ngf * mult // 2), nn.ReLU(True)]
    return nn.Sequential(*model)


class LocalEnhancer(nn.Module):
    """pix2pixHD's LocalEnhancer with one enhancer (``--netG local``)."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 32,
                 n_downsample_global: int = 4, n_blocks_global: int = 9,
                 n_blocks_local: int = 3):
        super().__init__()
        self.model = _global_trunk(input_nc, ngf * 2, n_downsample_global,
                                   n_blocks_global)
        self.model1_1 = nn.Sequential(
            nn.ReflectionPad2d(3), QConv2d(input_nc, ngf, 7), _norm(ngf),
            nn.ReLU(True), QConv2d(ngf, ngf * 2, 3, stride=2, padding=1),
            _norm(ngf * 2), nn.ReLU(True))
        self.model1_2 = nn.Sequential(
            *[ResnetBlock(ngf * 2) for _ in range(n_blocks_local)],
            QConvTranspose2d(ngf * 2, ngf, 3, stride=2, padding=1,
                             output_padding=1),
            _norm(ngf), nn.ReLU(True), nn.ReflectionPad2d(3),
            QConv2d(ngf, output_nc, 7), nn.Tanh())
        self.downsample = nn.AvgPool2d(3, stride=2, padding=1,
                                       count_include_pad=False)

    def forward(self, x):
        coarse = self.model(self.downsample(x))
        return self.model1_2(self.model1_1(x) + coarse)


class MultiscaleDiscriminator(nn.Module):
    """pix2pixHD's MultiscaleDiscriminator with ``getIntermFeat``:
    ``forward`` returns, finest scale first, each scale's list of taps
    with the patch logits last."""

    def __init__(self, input_nc: int = 6, ndf: int = 64, n_layers: int = 3,
                 num_d: int = 3):
        super().__init__()
        self.num_d, self.n_layers = num_d, n_layers
        for i in range(num_d):
            for j, seq in enumerate(self._layers(input_nc, ndf, n_layers)):
                setattr(self, f"scale{i}_layer{j}", seq)
        self.downsample = nn.AvgPool2d(3, stride=2, padding=1,
                                       count_include_pad=False)

    @staticmethod
    def _layers(input_nc: int, ndf: int, n_layers: int) -> List[nn.Module]:
        pad = 2  # ceil((kw - 1) / 2), kw = 4
        seqs = [nn.Sequential(QConv2d(input_nc, ndf, 4, stride=2,
                                      padding=pad),
                              nn.LeakyReLU(0.2, True))]
        nf = ndf
        for _ in range(1, n_layers):
            nf_prev, nf = nf, min(nf * 2, 512)
            seqs.append(nn.Sequential(
                QConv2d(nf_prev, nf, 4, stride=2, padding=pad), _norm(nf),
                nn.LeakyReLU(0.2, True)))
        nf_prev, nf = nf, min(nf * 2, 512)
        seqs.append(nn.Sequential(
            QConv2d(nf_prev, nf, 4, stride=1, padding=pad), _norm(nf),
            nn.LeakyReLU(0.2, True)))
        seqs.append(nn.Sequential(QConv2d(nf, 1, 4, stride=1, padding=pad)))
        return seqs

    def forward(self, x) -> List[List[torch.Tensor]]:
        result = []
        for i in range(self.num_d):
            scale = self.num_d - 1 - i
            taps = [x]
            for j in range(self.n_layers + 2):
                taps.append(getattr(self, f"scale{scale}_layer{j}")(taps[-1]))
            result.append(taps[1:])
            if i != self.num_d - 1:
                x = self.downsample(x)
        return result


# torchvision vgg19.features: conv indices with (cin, cout); max pools at
# 4, 9, 18, 27; the five stages end at relu1_1, relu2_1, ..., relu5_1
VGG_CONVS = {0: (3, 64), 2: (64, 64), 5: (64, 128), 7: (128, 128),
             10: (128, 256), 12: (256, 256), 14: (256, 256), 16: (256, 256),
             19: (256, 512), 21: (512, 512), 23: (512, 512), 25: (512, 512),
             28: (512, 512)}
VGG_POOLS = (4, 9, 18, 27)
VGG_STAGE_ENDS = (1, 6, 11, 20, 29)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Vgg19Features(nn.Module):
    """VGG19's ``features[:30]``; ``forward`` takes images in [-1, 1],
    normalises them for ImageNet and returns the five stage outputs."""

    def __init__(self):
        super().__init__()
        layers = []
        for idx in range(VGG_STAGE_ENDS[-1] + 1):
            if idx in VGG_CONVS:
                layers.append(QConv2d(*VGG_CONVS[idx], 3, padding=1))
            elif idx in VGG_POOLS:
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers.append(nn.ReLU())
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(
            1, 3, 1, 1), persistent=False)

    def forward(self, x) -> List[torch.Tensor]:
        h = ((x + 1.0) * 0.5 - self.mean) / self.std
        out = []
        for idx, layer in enumerate(self.features):
            h = layer(h)
            if idx in VGG_STAGE_ENDS:
                out.append(h)
        return out
