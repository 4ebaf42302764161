"""pix2pixHD generators on NHWC tensors — the slice of
``ir2rgb_tpu/nn/generators.py`` that the serving path and the train step
run: the ResNet trunk (headless or with its c7s1 tail) and the
coarse-to-fine ``LocalEnhancer`` with one or two enhancers.

The modules keep the reference family's ``nn.Sequential`` layout, so their
``state_dict`` keys are those of ``tests/torch_refs.py`` (``model.*``,
``model1_1.*``, ``model1_2.*``) and a reference ``.pth`` loads with
``load_state_dict``. Pads, norms and activations carry no parameters; they
hold their Sequential index as :class:`Slot` placeholders, and each
module's ``forward`` applies them explicitly, fused where the port has a
kernel: every instance norm with the activation after it (kernel B1),
every transposed conv's interleave (kernel B3, :class:`Deconv`) and, when
serving, the output tail's reflect-pad + 7x7 conv + tanh (kernel B2).
With ``train=True`` the tail is the composed reflect-pad + conv + tanh, as
the JAX package computes it when training (``generators.py:204``): B2 has
no backward.

The JAX package's TPU-layout rewrites (``nn/s2d_conv.py``,
``nn/s2d_space.py``) are exact rewrites of the same math and are not
ported; the port is held to the generator's output.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ir2rgb_tpu_torch import kernels
from . import ops


@dataclasses.dataclass(frozen=True)
class GenConfig:
    """Static generator hyperparameters."""

    net_g: str = "local"
    input_nc: int = 3
    output_nc: int = 3
    ngf: int = 64
    norm: str = "instance"
    n_downsample_global: int = 4
    n_blocks_global: int = 9
    n_blocks_local: int = 3
    n_local_enhancers: int = 1
    compute_dtype: torch.dtype = torch.float32


class Slot(nn.Module):
    """A parameterless layer of the reference Sequential (a pad, a norm or
    an activation). It only keeps the indices of the layers after it; the
    owning module's ``forward`` applies what it names."""

    def __init__(self, what: str):
        super().__init__()
        self.what = what

    def extra_repr(self) -> str:
        return self.what

    def forward(self, x):
        raise RuntimeError(f"Slot({self.what}) is applied by its owner's "
                           "forward, not called")


def _check_norm(norm: str) -> None:
    if norm != "instance":
        raise NotImplementedError(f"norm={norm!r} is not ported yet")


def _conv_norm_act(conv: nn.Conv2d, x: torch.Tensor, norm: str,
                   act: str = "relu", stride: int = 1,
                   padding: int = 0) -> torch.Tensor:
    y = ops.conv(x, conv.weight, conv.bias, stride=stride, padding=padding)
    return ops.norm_act(y, norm, act)


def _tail(conv: nn.Conv2d, x: torch.Tensor, train: bool) -> torch.Tensor:
    """reflect-pad 3 + c7s1-out + tanh: fused in kernel B2 when serving;
    composed, with tanh in fp32, when training."""
    if not train:
        return kernels.tail_fused(x, conv.weight.permute(2, 3, 1, 0),
                                  conv.bias)
    y = ops.conv(ops.reflect_pad(x, 3), conv.weight, conv.bias)
    return torch.tanh(y.float()).to(x.dtype)


class Deconv(nn.ConvTranspose2d):
    """The generators' upsampler, ConvTranspose2d(k3, s2, p1,
    output_padding 1), run as the subpixel conv + B3 depth-to-space
    (``ops.deconv``). Under ``torch.inference_mode`` the rearranged
    weight is kept, keyed on the weight tensor, its version counter and
    the compute dtype, so a serving frame does not rebuild it."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, stride=2, padding=1,
                         output_padding=1)
        self._wk = None  # (weight, its _version, dtype, rearranged weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, wk = self.weight, None
        # an inference tensor has no version counter to key on
        if torch.is_inference_mode_enabled() and not w.is_inference():
            kept = self._wk
            if (kept is None or kept[0] is not w or kept[1] != w._version
                    or kept[2] != x.dtype):
                kept = self._wk = (w, w._version, x.dtype,
                                   ops.subpixel_weight(w.to(x.dtype)))
            wk = kept[3]
        return ops.deconv(x, self.weight, self.bias, wk=wk)


class ResnetBlock(nn.Module):
    """ReflectionPad1 + 3x3 conv + IN + ReLU + ReflectionPad1 + 3x3 conv +
    IN, additive skip (keys ``conv_block.1``, ``conv_block.5``)."""

    def __init__(self, dim: int, norm: str = "instance"):
        super().__init__()
        _check_norm(norm)
        self.norm = norm
        self.conv_block = nn.Sequential(
            Slot("reflect_pad 1"), nn.Conv2d(dim, dim, 3), Slot(norm),
            Slot("relu"), Slot("reflect_pad 1"), nn.Conv2d(dim, dim, 3),
            Slot(norm))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cb = self.conv_block
        h = _conv_norm_act(cb[1], ops.reflect_pad(x, 1), self.norm, "relu")
        h = _conv_norm_act(cb[5], ops.reflect_pad(h, 1), self.norm, "none")
        return x + h


class ResnetStack(nn.Sequential):
    """The reference ResnetGenerator's ``model`` Sequential: c7s1-ngf,
    stride-2 downs, residual blocks, transposed-conv ups and, with
    ``with_tail``, the c7s1-out + tanh head."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int,
                 n_blocks: int, n_downsampling: int, norm: str = "instance",
                 with_tail: bool = True):
        _check_norm(norm)
        layers = [Slot("reflect_pad 3"), nn.Conv2d(input_nc, ngf, 7),
                  Slot(norm), Slot("relu")]
        downs, blocks, ups = [], [], []
        mult = 1
        for _ in range(n_downsampling):
            downs.append(len(layers))
            layers += [nn.Conv2d(ngf * mult, ngf * mult * 2, 3, stride=2,
                                 padding=1), Slot(norm), Slot("relu")]
            mult *= 2
        for _ in range(n_blocks):
            blocks.append(len(layers))
            layers.append(ResnetBlock(ngf * mult, norm))
        for _ in range(n_downsampling):
            ups.append(len(layers))
            layers += [Deconv(ngf * mult, ngf * mult // 2), Slot(norm),
                       Slot("relu")]
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = _conv_norm_act(self[self.head], ops.reflect_pad(x, 3), self.norm)
        for i in self.downs:
            h = _conv_norm_act(self[i], h, self.norm, stride=2, padding=1)
        for i in self.blocks:
            h = self[i](h)
        for i in self.ups:
            h = ops.norm_act(self[i](h), self.norm, "relu")
        if self.tail is not None:
            h = _tail(self[self.tail], h, train)
        return h


class ResnetGenerator(nn.Module):
    """ResNet generator (keys ``model.*``). The local enhancer uses its
    headless ``model`` as the global trunk."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 n_blocks: int = 9, n_downsampling: int = 2,
                 norm: str = "instance", with_tail: bool = True):
        super().__init__()
        self.model = ResnetStack(input_nc, output_nc, ngf, n_blocks,
                                 n_downsampling, norm, with_tail)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.model(x, train)


class EnhancerDown(nn.Sequential):
    """Enhancer branch entry ``model{n}_1``: c7s1-ngf_n + IN + ReLU, then a
    stride-2 3x3 conv to 2*ngf_n + IN + ReLU."""

    def __init__(self, input_nc: int, ngf_n: int, norm: str = "instance"):
        _check_norm(norm)
        super().__init__(
            Slot("reflect_pad 3"), nn.Conv2d(input_nc, ngf_n, 7), Slot(norm),
            Slot("relu"), nn.Conv2d(ngf_n, ngf_n * 2, 3, stride=2, padding=1),
            Slot(norm), Slot("relu"))
        self.norm = norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv_norm_act(self[1], ops.reflect_pad(x, 3), self.norm)
        return _conv_norm_act(self[4], h, self.norm, stride=2, padding=1)


class EnhancerUp(nn.Sequential):
    """Enhancer branch exit ``model{n}_2``: residual blocks, a
    transposed-conv up + IN + ReLU and, on the last level, the tail."""

    def __init__(self, ngf_n: int, n_blocks: int, output_nc: int = 3,
                 norm: str = "instance", with_tail: bool = True):
        _check_norm(norm)
        layers = [ResnetBlock(ngf_n * 2, norm) for _ in range(n_blocks)]
        layers += [Deconv(ngf_n * 2, ngf_n), Slot(norm), Slot("relu")]
        if with_tail:
            layers += [Slot("reflect_pad 3"), nn.Conv2d(ngf_n, output_nc, 7),
                       Slot("tanh")]
        super().__init__(*layers)
        self.norm = norm
        self.n_blocks = n_blocks
        self.tail = n_blocks + 4 if with_tail else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.n_blocks):
            x = self[i](x)
        h = ops.norm_act(self[self.n_blocks](x), self.norm, "relu")
        if self.tail is not None:
            h = _tail(self[self.tail], h, train)
        return h


def _check_divisible(x: torch.Tensor, downs: int, net: str) -> None:
    d = 1 << downs
    h, w = x.shape[1], x.shape[2]
    if h % d or w % d:
        raise ValueError(
            f"net_g={net}: input {h}x{w} must be divisible by {d} "
            f"(2^{downs} stride-2 stages); resize/crop the frames or "
            f"lower n_downsample_global/n_local_enhancers")


class LocalEnhancer(nn.Module):
    """pix2pixHD coarse-to-fine generator: the headless global trunk at
    1/2^n_local resolution (width ngf * 2^n_local) plus one enhancer
    branch per level, joined by elementwise sums. NHWC in, NHWC out, in
    ``cfg.compute_dtype``. The parameters may be in another dtype (fp32
    master weights when training); each op casts them at use.
    ``train=True`` picks the differentiable tail, as
    ``local_enhancer_apply(..., train=True)`` does."""

    def __init__(self, cfg: GenConfig):
        super().__init__()
        _check_norm(cfg.norm)
        self.cfg = cfg
        n_local = cfg.n_local_enhancers
        self.model = ResnetStack(
            cfg.input_nc, cfg.output_nc, cfg.ngf * 2 ** n_local,
            cfg.n_blocks_global, cfg.n_downsample_global, cfg.norm,
            with_tail=False)
        for n in range(1, n_local + 1):
            ngf_n = cfg.ngf * 2 ** (n_local - n)
            setattr(self, f"model{n}_1",
                    EnhancerDown(cfg.input_nc, ngf_n, cfg.norm))
            setattr(self, f"model{n}_2",
                    EnhancerUp(ngf_n, cfg.n_blocks_local, cfg.output_nc,
                               cfg.norm, with_tail=n == n_local))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        cfg = self.cfg
        n_local = cfg.n_local_enhancers
        _check_divisible(x, n_local + cfg.n_downsample_global, cfg.net_g)
        x = x.to(cfg.compute_dtype)
        pyramid = [x]
        for _ in range(n_local):
            pyramid.append(ops.avg_pool(pyramid[-1], 3, 2, 1,
                                        count_include_pad=False))
        out = self.model(pyramid[-1])
        for n in range(1, n_local + 1):
            down = getattr(self, f"model{n}_1")
            up = getattr(self, f"model{n}_2")
            out = up(down(pyramid[n_local - n]) + out, train)
        return out


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The reference ``weights_init``: conv/deconv weights ~ N(0, 0.02),
    biases 0, drawn on the CPU from ``generator`` and copied in place."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                w.normal_(0.0, ops.INIT_STD, generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
