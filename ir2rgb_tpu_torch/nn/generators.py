"""The generator zoo on NHWC tensors — the port of
``ir2rgb_tpu/nn/generators.py``:

- ``resnet_9blocks`` / ``resnet_6blocks``: c7s1-ngf, two stride-2 downs,
  residual blocks, two ups, c7s1-out + tanh (:class:`ResnetGenerator`);
- ``global``: the pix2pixHD coarse generator, the same stack with
  ``n_downsample_global`` downs and ``n_blocks_global`` blocks;
- ``local``: pix2pixHD coarse-to-fine, the headless global trunk plus one
  or two enhancer branches (:class:`LocalEnhancer`);
- ``unet_256`` / ``unet_128``: the 8- / 7-level U-Net with skip concats
  (:class:`UnetGenerator`).

:func:`define_g` builds the one a :class:`GenConfig` names. Norms are
instance (kernel B1), batch (batch statistics, ``ops.batch_norm``) or
none; conv biases follow the JAX package's rule, bias unless a batch norm
follows (``generators.py:58``). Ups are a transposed conv (run as the
subpixel conv + kernel B3's interleave, :class:`Deconv`) or, with
``upsample="resize_conv"``, a nearest x2 resize + zero-padded 3x3 conv
(:class:`ResizeConv`).

The modules keep the reference family's ``nn.Sequential`` layout, so their
``state_dict`` keys are those of ``tests/torch_refs.py`` (``model.*``,
``model1_1.*``, ``model1_2.*``, the U-Net's nested ``model.model.1...``)
and a reference ``.pth`` loads with ``load_state_dict``. Pads,
activations, dropout and instance norms carry no parameters; they hold
their Sequential index as :class:`Slot` placeholders, and each module's
``forward`` applies them explicitly, fused where the port has a kernel:
every instance norm with the activation after it (kernel B1), every
transposed conv's interleave (kernel B3) and, when serving, the ResNet
output tail's reflect-pad + 7x7 conv + tanh (kernel B2). With
``train=True`` that tail is the composed reflect-pad + conv + tanh, as the
JAX package computes it when training (``generators.py:204``): B2 has no
backward. A batch norm is an ``nn.BatchNorm2d`` for its keys (gamma, beta
and the running stats); ``forward`` never calls it, so no running stat
changes. Dropout (``use_dropout``) is a slot too: it drops (``ops.dropout``,
rate 0.5) only when ``forward`` is given ``train=True`` and a
``torch.Generator`` to draw from, where the JAX package drops
(``generators.py:92``, ``:751-767``): after the first norm of the ResNet
blocks of a ResNet generator or of the local enhancer's trunk (not of
its enhancer branches, which JAX gives no key), and after the up norm of
the U-Net's inner ``num_downs - 5`` middle levels. Serving never drops.

With ``remat`` (``generators.py:79-86``) every residual block of a train
forward (the ResNet generators', the trunk's and the enhancers') runs
under ``torch.utils.checkpoint``: its activations are recomputed in the
backward instead of kept. A block's dropout mask is drawn before the
checkpointed body and passed in, so the recompute applies the forward's
mask: checkpoint restores the global RNGs, not an explicit generator.

A frame whose rows lie on several ranks (``parallel/spatial.py``) runs
the same forward, served or trained: the ops of ``nn/ops.py`` exchange
what they read across ranks (differentiably), the divisibility check
reads the global H, and the served tail runs B2 on this rank's rows
extended by three halo rows each side (reflected at the global edge),
keeping the rows between; the training tail is the composed one, its
reflect pad through the halo. The U-Net is not partitioned (its
innermost levels have fewer rows than ranks, ROADMAP A16b).

The JAX package's TPU-layout rewrites (``nn/s2d_conv.py``,
``nn/s2d_space.py``) are exact rewrites of the same math and are not
ported; the port is held to the generator's output.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ir2rgb_tpu_torch import kernels
from ir2rgb_tpu_torch.parallel import spatial
from . import ops, quant


@dataclasses.dataclass(frozen=True)
class GenConfig:
    """Static generator hyperparameters."""

    net_g: str = "local"
    input_nc: int = 3
    output_nc: int = 3
    ngf: int = 64
    norm: str = "instance"
    upsample: str = "deconv"  # deconv | resize_conv
    use_dropout: bool = False
    n_downsample_global: int = 4
    n_blocks_global: int = 9
    n_blocks_local: int = 3
    n_local_enhancers: int = 1
    compute_dtype: torch.dtype = torch.float32
    # recompute each residual block in the backward (train forwards)
    remat: bool = False


class Slot(nn.Module):
    """A parameterless layer of the reference Sequential (a pad, an
    instance norm, an activation, dropout). It only keeps the indices of
    the layers after it; the owning module's ``forward`` applies what it
    names."""

    def __init__(self, what: str):
        super().__init__()
        self.what = what

    def extra_repr(self) -> str:
        return self.what

    def forward(self, x):
        raise RuntimeError(f"Slot({self.what}) is applied by its owner's "
                           "forward, not called")


def use_bias(norm: str) -> bool:
    """A conv bias is redundant right before an affine batch norm."""
    return norm != "batch"


def norm_layer(norm: str, c: int) -> nn.Module:
    """The reference's norm layer for ``c`` channels: a BatchNorm2d (its
    parameters and running stats are keys), else a slot."""
    if norm == "batch":
        return nn.BatchNorm2d(c)
    if norm in ("instance", "none"):
        return Slot(norm)
    raise ValueError(f"unknown norm: {norm}")


def _norm_act(layer: nn.Module, x: torch.Tensor, norm: str,
              act: str) -> torch.Tensor:
    return ops.norm_act(x, norm, act, bn=layer if norm == "batch" else None)


def _conv_norm_act(seq: nn.Sequential, i: int, x: torch.Tensor, norm: str,
                   act: str = "relu", stride: int = 1,
                   padding: int = 0) -> torch.Tensor:
    """``seq[i]`` (a conv), then the norm at ``seq[i + 1]`` and ``act``."""
    conv = seq[i]
    y = ops.conv(x, conv.weight, conv.bias, stride=stride, padding=padding)
    return _norm_act(seq[i + 1], y, norm, act)


def _tail(conv: nn.Conv2d, x: torch.Tensor, train: bool) -> torch.Tensor:
    """reflect-pad 3 + c7s1-out + tanh: fused in kernel B2 when serving;
    composed, with tanh in fp32, when training. Under the serving quant
    modes (``nn/quant.py``): ``int8_mixed`` leaves this 3-wide conv fp
    (B2 as in "none"); ``int8_w`` feeds B2 the dequantized weight, the
    same function as JAX's dequantized conv + bias + tanh; ``int8`` is an
    int8 product, another function than B2's, so it runs composed."""
    part = spatial.active()
    if part is not None and not train:
        # B2 on the rows and 3 halo rows each side; the kept rows read
        # real rows only, so they are this rank's rows of the frame's tail
        h = x.shape[1]
        y = kernels.tail_fused(part.halo(x, 3, 3, "reflect"),
                               conv.weight.permute(2, 3, 1, 0), conv.bias)
        return y[:, 3:3 + h]
    if not train:
        m = quant.mode_for(conv.in_channels, conv.out_channels)
        if m != "int8":
            w = conv.weight
            if m == "int8_w":
                w = quant.dequantized(w.to(x.dtype), source=(w, "conv"))
            return kernels.tail_fused(x, w.permute(2, 3, 1, 0), conv.bias)
    y = ops.conv(ops.reflect_pad(x, 3), conv.weight, conv.bias)
    return spatial.same_rows(torch.tanh(y.float()).to(x.dtype), y)


class Deconv(nn.ConvTranspose2d):
    """A stride-2 transposed conv (the ResNet generators' k3 p1 op1, the
    U-Net's k4 p1 op0), run as the subpixel conv + B3 depth-to-space
    (``ops.deconv``). Under ``torch.inference_mode`` the rearranged
    weight is kept, keyed on the weight tensor, its version counter and
    the compute dtype, so a serving frame does not rebuild it. While a
    program is exported (``infer/export.py``) the weight is a program
    input: the cache is neither read nor written, and the program
    rearranges the weight itself."""

    def __init__(self, cin: int, cout: int, k: int = 3, padding: int = 1,
                 output_padding: int = 1, bias: bool = True):
        super().__init__(cin, cout, k, stride=2, padding=padding,
                         output_padding=output_padding, bias=bias)
        self._wk = None  # (weight, its _version, dtype, rearranged weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, wk = self.weight, None
        pad, op = self.padding[0], self.output_padding[0]
        # an inference tensor has no version counter to key on
        if (torch.is_inference_mode_enabled() and not w.is_inference()
                and not torch.compiler.is_exporting()):
            kept = self._wk
            if (kept is None or kept[0] is not w or kept[1] != w._version
                    or kept[2] != x.dtype):
                kept = self._wk = (w, w._version, x.dtype,
                                   ops.subpixel_weight(w.to(x.dtype), pad))
            wk = kept[3]
        return ops.deconv(x, self.weight, self.bias, padding=pad,
                          output_padding=op, wk=wk)


class ResizeConv(nn.Conv2d):
    """The ``resize_conv`` upsampler (``generators.py:100-117``): nearest
    x2, then a 3x3 conv zero-padded by one."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__(cin, cout, 3, padding=1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.conv(ops.resize_nearest(x, 2), self.weight, self.bias,
                        padding=1)


def _upsampler(cin: int, cout: int, upsample: str, bias: bool) -> nn.Module:
    if upsample == "deconv":
        return Deconv(cin, cout, bias=bias)
    if upsample == "resize_conv":
        return ResizeConv(cin, cout, bias=bias)
    raise ValueError(f"unknown upsample: {upsample}")


class ResnetBlock(nn.Module):
    """ReflectionPad1 + 3x3 conv + norm + ReLU [+ dropout] +
    ReflectionPad1 + 3x3 conv + norm, additive skip (keys
    ``conv_block.1`` and ``conv_block.5``, or ``.6`` after a dropout
    slot)."""

    def __init__(self, dim: int, norm: str = "instance",
                 use_dropout: bool = False, remat: bool = False):
        super().__init__()
        self.norm, self.use_dropout, self.remat = norm, use_dropout, remat
        bias = use_bias(norm)
        layers = [Slot("reflect_pad 1"), nn.Conv2d(dim, dim, 3, bias=bias),
                  norm_layer(norm, dim), Slot("relu")]
        if use_dropout:
            layers.append(Slot("dropout 0.5"))
        self.convs = (1, len(layers) + 1)
        layers += [Slot("reflect_pad 1"), nn.Conv2d(dim, dim, 3, bias=bias),
                   norm_layer(norm, dim)]
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
        """``generator``: draw the dropout mask from it (a block built with
        ``use_dropout``); None: no dropout. ``train`` with ``remat``: the
        body is recomputed in the backward, on the mask drawn here."""
        drop = self.use_dropout and generator is not None
        if not (self.remat and train and torch.is_grad_enabled()):
            return self._body(x, generator if drop else None, None)
        mask = ops.dropout_mask(x.shape, 0.5, generator) if drop else None
        return checkpoint(self._body, x, None, mask, use_reentrant=False,
                          preserve_rng_state=False)

    def _body(self, x: torch.Tensor, generator: Optional[torch.Generator],
              mask: Optional[torch.Tensor]) -> torch.Tensor:
        cb, (c0, c1) = self.conv_block, self.convs
        h = _conv_norm_act(cb, c0, ops.reflect_pad(x, 1), self.norm, "relu")
        if generator is not None:
            h = ops.dropout(h, 0.5, generator)
        elif mask is not None:
            h = ops.apply_dropout(h, mask, 0.5)
        h = _conv_norm_act(cb, c1, ops.reflect_pad(h, 1), self.norm, "none")
        return x + h


class ResnetStack(nn.Sequential):
    """The reference ResnetGenerator's ``model`` Sequential: c7s1-ngf,
    stride-2 downs, residual blocks, ups and, with ``with_tail``, the
    c7s1-out + tanh head. Every conv is followed by its norm at the next
    index."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int,
                 n_blocks: int, n_downsampling: int, norm: str = "instance",
                 with_tail: bool = True, upsample: str = "deconv",
                 use_dropout: bool = False, remat: bool = False):
        bias = use_bias(norm)
        layers = [Slot("reflect_pad 3"), nn.Conv2d(input_nc, ngf, 7,
                                                   bias=bias),
                  norm_layer(norm, ngf), Slot("relu")]
        downs, blocks, ups = [], [], []
        mult = 1
        for _ in range(n_downsampling):
            downs.append(len(layers))
            layers += [nn.Conv2d(ngf * mult, ngf * mult * 2, 3, stride=2,
                                 padding=1, bias=bias),
                       norm_layer(norm, ngf * mult * 2), Slot("relu")]
            mult *= 2
        for _ in range(n_blocks):
            blocks.append(len(layers))
            layers.append(ResnetBlock(ngf * mult, norm, use_dropout, remat))
        for _ in range(n_downsampling):
            ups.append(len(layers))
            layers += [_upsampler(ngf * mult, ngf * mult // 2, upsample, bias),
                       norm_layer(norm, ngf * mult // 2), Slot("relu")]
            mult //= 2
        tail = None
        if with_tail:
            tail = len(layers) + 1
            layers += [Slot("reflect_pad 3"), nn.Conv2d(ngf, output_nc, 7),
                       Slot("tanh")]
        super().__init__(*layers)
        self.norm = norm
        self.head, self.downs, self.blocks, self.ups, self.tail = (
            1, downs, blocks, ups, tail)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: the blocks' dropout draws (with ``train``)."""
        norm = self.norm
        drop = generator if train else None
        h = _conv_norm_act(self, self.head, ops.reflect_pad(x, 3), norm)
        for i in self.downs:
            h = _conv_norm_act(self, i, h, norm, stride=2, padding=1)
        for i in self.blocks:
            h = self[i](h, drop, train)
        for i in self.ups:
            h = _norm_act(self[i + 1], self[i](h), norm, "relu")
        if self.tail is not None:
            h = _tail(self[self.tail], h, train)
        return h


def _check_divisible(x: torch.Tensor, downs: int, net: str) -> None:
    d = 1 << downs
    h, w = x.shape[1], x.shape[2]
    part = spatial.active()
    if part is not None:
        h = part.global_rows(h)
    if h % d or w % d:
        raise ValueError(
            f"net_g={net}: input {h}x{w} must be divisible by {d} "
            f"(2^{downs} stride-2 stages); resize/crop the frames or "
            f"lower n_downsample_global/n_local_enhancers")
    if part is not None and (h // d) % part.sp:
        # every stage's rows split evenly, so the ranks' residual adds
        # and concats line up
        raise ValueError(
            f"net_g={net}: global H {h} is not divisible by {d}·sp = "
            f"{d * part.sp}: each of the {downs} stride-2 stages needs "
            f"whole, even shards on the sp = {part.sp} ranks")


class ResnetGenerator(nn.Module):
    """ResNet generator (keys ``model.*``): ``resnet_9blocks`` /
    ``resnet_6blocks`` (2 downs) and ``global`` (``n_downsample_global``
    downs, ``n_blocks_global`` blocks). NHWC in, NHWC out, in
    ``compute_dtype`` when one is given. The local enhancer uses the
    headless stack as its global trunk."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 n_blocks: int = 9, n_downsampling: int = 2,
                 norm: str = "instance", with_tail: bool = True,
                 upsample: str = "deconv", use_dropout: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 net_g: str = "resnet", remat: bool = False):
        super().__init__()
        self.n_downsampling, self.net_g = n_downsampling, net_g
        self.compute_dtype = compute_dtype
        self.model = ResnetStack(input_nc, output_nc, ngf, n_blocks,
                                 n_downsampling, norm, with_tail, upsample,
                                 use_dropout, remat)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        _check_divisible(x, self.n_downsampling, self.net_g)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        return self.model(x, train, generator)


class EnhancerDown(nn.Sequential):
    """Enhancer branch entry ``model{n}_1``: c7s1-ngf_n + norm + ReLU, then
    a stride-2 3x3 conv to 2*ngf_n + norm + ReLU."""

    def __init__(self, input_nc: int, ngf_n: int, norm: str = "instance"):
        bias = use_bias(norm)
        super().__init__(
            Slot("reflect_pad 3"), nn.Conv2d(input_nc, ngf_n, 7, bias=bias),
            norm_layer(norm, ngf_n), Slot("relu"),
            nn.Conv2d(ngf_n, ngf_n * 2, 3, stride=2, padding=1, bias=bias),
            norm_layer(norm, ngf_n * 2), Slot("relu"))
        self.norm = norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv_norm_act(self, 1, ops.reflect_pad(x, 3), self.norm)
        return _conv_norm_act(self, 4, h, self.norm, stride=2, padding=1)


class EnhancerUp(nn.Sequential):
    """Enhancer branch exit ``model{n}_2``: residual blocks, an up + norm
    + ReLU and, on the last level, the tail."""

    def __init__(self, ngf_n: int, n_blocks: int, output_nc: int = 3,
                 norm: str = "instance", with_tail: bool = True,
                 upsample: str = "deconv", use_dropout: bool = False,
                 remat: bool = False):
        layers = [ResnetBlock(ngf_n * 2, norm, use_dropout, remat)
                  for _ in range(n_blocks)]
        layers += [_upsampler(ngf_n * 2, ngf_n, upsample, use_bias(norm)),
                   norm_layer(norm, ngf_n), Slot("relu")]
        if with_tail:
            layers += [Slot("reflect_pad 3"), nn.Conv2d(ngf_n, output_nc, 7),
                       Slot("tanh")]
        super().__init__(*layers)
        self.norm = norm
        self.n_blocks = n_blocks
        self.tail = n_blocks + 4 if with_tail else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.n_blocks):
            x = self[i](x, None, train)
        up = self.n_blocks
        h = _norm_act(self[up + 1], self[up](x), self.norm, "relu")
        if self.tail is not None:
            h = _tail(self[self.tail], h, train)
        return h


class LocalEnhancer(nn.Module):
    """pix2pixHD coarse-to-fine generator: the headless global trunk at
    1/2^n_local resolution (width ngf * 2^n_local) plus one enhancer
    branch per level, joined by elementwise sums. NHWC in, NHWC out, in
    ``cfg.compute_dtype``. The parameters may be in another dtype (fp32
    master weights when training); each op casts them at use.
    ``train=True`` picks the differentiable tail, as
    ``local_enhancer_apply(..., train=True)`` does, and with a
    ``generator`` the trunk's blocks drop out (the enhancer branches'
    never do: JAX hands them no key)."""

    def __init__(self, cfg: GenConfig):
        super().__init__()
        self.cfg = cfg
        n_local = cfg.n_local_enhancers
        self.model = ResnetStack(
            cfg.input_nc, cfg.output_nc, cfg.ngf * 2 ** n_local,
            cfg.n_blocks_global, cfg.n_downsample_global, cfg.norm,
            with_tail=False, upsample=cfg.upsample,
            use_dropout=cfg.use_dropout, remat=cfg.remat)
        for n in range(1, n_local + 1):
            ngf_n = cfg.ngf * 2 ** (n_local - n)
            setattr(self, f"model{n}_1",
                    EnhancerDown(cfg.input_nc, ngf_n, cfg.norm))
            setattr(self, f"model{n}_2",
                    EnhancerUp(ngf_n, cfg.n_blocks_local, cfg.output_nc,
                               cfg.norm, with_tail=n == n_local,
                               upsample=cfg.upsample,
                               use_dropout=cfg.use_dropout,
                               remat=cfg.remat))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        n_local = cfg.n_local_enhancers
        _check_divisible(x, n_local + cfg.n_downsample_global, cfg.net_g)
        x = x.to(cfg.compute_dtype)
        pyramid = [x]
        for _ in range(n_local):
            pyramid.append(ops.avg_pool(pyramid[-1], 3, 2, 1,
                                        count_include_pad=False))
        out = self.model(pyramid[-1], train, generator)
        for n in range(1, n_local + 1):
            down = getattr(self, f"model{n}_1")
            up = getattr(self, f"model{n}_2")
            out = up(down(pyramid[n_local - n]) + out, train)
        return out


class UnetBlock(nn.Module):
    """One level of the U-Net, the reference's UnetSkipConnectionBlock
    (keys ``model.{i}``), outermost to innermost:

    - outermost: down conv, submodule, ReLU, up (bias kept), tanh;
    - middle: LeakyReLU(0.2), down conv, norm, submodule, ReLU, up, norm
      [, dropout];
    - innermost: LeakyReLU(0.2), down conv, ReLU, up, norm.

    Downs are 4x4 stride-2 convs padded by one, ups k4 s2 p1 transposed
    convs. Norms take no activation (B1 with ``act="none"``): the skip is
    saved before the next level's LeakyReLU, and the ReLU of the way up
    acts on the concat. A level returns ``cat([x, up])`` but the
    outermost, which returns the image."""

    def __init__(self, outer_nc: int, inner_nc: int,
                 input_nc: Optional[int] = None,
                 submodule: Optional["UnetBlock"] = None,
                 outermost: bool = False, innermost: bool = False,
                 norm: str = "instance", use_dropout: bool = False):
        super().__init__()
        self.outermost, self.innermost, self.norm = outermost, innermost, norm
        self.use_dropout = use_dropout and not (outermost or innermost)
        bias = use_bias(norm)
        down = nn.Conv2d(outer_nc if input_nc is None else input_nc,
                         inner_nc, 4, stride=2, padding=1, bias=bias)
        if outermost:
            up = Deconv(inner_nc * 2, outer_nc, 4, 1, 0)
            layers = [down, submodule, Slot("relu"), up, Slot("tanh")]
        elif innermost:
            up = Deconv(inner_nc, outer_nc, 4, 1, 0, bias=bias)
            layers = [Slot("leaky_relu"), down, Slot("relu"), up,
                      norm_layer(norm, outer_nc)]
        else:
            up = Deconv(inner_nc * 2, outer_nc, 4, 1, 0, bias=bias)
            layers = [Slot("leaky_relu"), down, norm_layer(norm, inner_nc),
                      submodule, Slot("relu"), up, norm_layer(norm, outer_nc)]
            if use_dropout:
                layers.append(Slot("dropout 0.5"))
        self.model = nn.Sequential(*layers)
        # indices of the down conv, its norm, the submodule, the up, its norm
        self.down = 0 if outermost else 1
        self.down_norm = None if outermost or innermost else 2
        self.sub = None if innermost else self.down + (2 if self.down_norm
                                                       else 1)
        self.up = layers.index(up)
        self.up_norm = None if outermost else self.up + 1

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: the dropout draws of this level (built with
        ``use_dropout``) and the levels inside it; None: no dropout."""
        m = self.model
        d = x if self.outermost else ops.apply_act(x, "leaky_relu")
        conv = m[self.down]
        d = ops.conv(d, conv.weight, conv.bias, stride=2, padding=1)
        if self.down_norm is not None:
            d = _norm_act(m[self.down_norm], d, self.norm, "none")
        if self.sub is not None:
            d = m[self.sub](d, generator)
        u = m[self.up](ops.apply_act(d, "relu"))
        if self.outermost:
            return torch.tanh(u.float()).to(u.dtype)
        u = _norm_act(m[self.up_norm], u, self.norm, "none")
        if self.use_dropout and generator is not None:
            u = ops.dropout(u, 0.5, generator)
        return torch.cat([x, u], dim=-1)


class UnetGenerator(nn.Module):
    """``unet_256`` (8 levels) / ``unet_128`` (7): channels ngf, 2, 4, 8,
    8, ... x ngf from the outermost level in; the inner ``num_downs - 5``
    middle levels take dropout when ``use_dropout`` (when training with
    a generator: see the module docstring). NHWC in, NHWC out, in
    ``cfg.compute_dtype``."""

    def __init__(self, cfg: GenConfig):
        super().__init__()
        self.cfg = cfg
        self.num_downs = {"unet_256": 8, "unet_128": 7}[cfg.net_g]
        ngf, norm = cfg.ngf, cfg.norm
        block = UnetBlock(ngf * 8, ngf * 8, innermost=True, norm=norm)
        for _ in range(self.num_downs - 5):
            block = UnetBlock(ngf * 8, ngf * 8, submodule=block, norm=norm,
                              use_dropout=cfg.use_dropout)
        for mult in (4, 2, 1):
            block = UnetBlock(ngf * mult, ngf * mult * 2, submodule=block,
                              norm=norm)
        self.model = UnetBlock(cfg.output_nc, ngf, input_nc=cfg.input_nc,
                               submodule=block, outermost=True, norm=norm)

    def levels(self) -> Iterator[Tuple[str, UnetBlock]]:
        """(state_dict key prefix, block), outermost first."""
        prefix, block = "model", self.model
        while True:
            yield prefix, block
            if block.sub is None:
                return
            prefix = f"{prefix}.model.{block.sub}"
            block = block.model[block.sub]

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if spatial.active() is not None:
            raise NotImplementedError(
                f"net_g={self.cfg.net_g} on a spatially partitioned frame: "
                "its innermost levels have fewer rows than ranks "
                f"({spatial.A16B})")
        _check_divisible(x, self.num_downs, self.cfg.net_g)
        return self.model(x.to(self.cfg.compute_dtype),
                          generator if train else None)


def define_g(cfg: GenConfig) -> nn.Module:
    """The generator ``cfg.net_g`` names (``generators.py:775-790``)."""
    name = cfg.net_g
    resnet = dict(input_nc=cfg.input_nc, output_nc=cfg.output_nc,
                  ngf=cfg.ngf, norm=cfg.norm, upsample=cfg.upsample,
                  use_dropout=cfg.use_dropout,
                  compute_dtype=cfg.compute_dtype, net_g=name,
                  remat=cfg.remat)
    if name in ("resnet_9blocks", "resnet_6blocks"):
        return ResnetGenerator(n_blocks=9 if name.endswith("9blocks") else 6,
                               n_downsampling=2, **resnet)
    if name == "global":
        return ResnetGenerator(n_blocks=cfg.n_blocks_global,
                               n_downsampling=cfg.n_downsample_global,
                               **resnet)
    if name in ("unet_256", "unet_128"):
        return UnetGenerator(cfg)
    if name == "local":
        return LocalEnhancer(cfg)
    raise ValueError(f"unknown net_g: {name}")


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The reference ``weights_init``: conv/deconv weights ~ N(0, 0.02),
    biases 0, batch-norm gamma ~ N(1, 0.02) and beta 0 (its running stats
    reset), drawn on the CPU from ``generator`` and copied in place."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d,
                              nn.BatchNorm2d)):
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                w.normal_(0.0, ops.INIT_STD, generator=generator)
                if isinstance(m, nn.BatchNorm2d):
                    w += 1.0
                    m.reset_running_stats()  # to_empty left them unset
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
