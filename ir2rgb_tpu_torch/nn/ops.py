"""Core NN ops on NHWC tensors — the port of ``ir2rgb_tpu/nn/ops.py`` (all
of it but the quantized conv of ``nn/quant.py``).

Every function takes and returns NHWC tensors, the JAX package's layout.
``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is a channels-last
NCHW view, which is what the PyTorch convolutions receive, and their
channels-last output permutes back to contiguous NHWC for free. Weights
keep PyTorch's layouts (Conv2d OIHW, ConvTranspose2d IOHW), so a module's
``state_dict`` is the reference family's.

Convolutions are plain ``F.conv2d``: the JAX package left them to XLA
outside any Pallas kernel. A stride-2 transposed conv whose geometry the
subpixel plan admits takes the JAX package's default ``subpixel``
lowering (``ops.py:193-292``): a dense conv to 4·cout phase channels,
then the depth-to-space of kernel B3 (``kernels.d2s_fn``), then the
bias. Instance norm goes to kernel B1 (``kernels.fused_instance_norm_act``).
Both kernels are differentiable. Batch norm, the pads, the resizes and
dropout are plain PyTorch, as the JAX package computes them outside any
Pallas kernel.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ir2rgb_tpu_torch.kernels import d2s_fn, fused_instance_norm_act
# eps 1e-5 (torch InstanceNorm2d's) and the activations live with B1
from ir2rgb_tpu_torch.kernels.instance_norm import (  # noqa: F401
    INSTANCE_NORM_EPS,
    apply_act,
)

INIT_STD = 0.02  # reference weights_init: N(0, 0.02)
BATCH_NORM_EPS = 1e-5


def apply_init_type(module: torch.nn.Module, init_type: str,
                    generator: torch.Generator) -> None:
    """Re-draw every conv and transposed-conv weight of ``module`` in place
    per the family's ``--init_type`` (normal | xavier | kaiming |
    orthogonal), as ``ir2rgb_tpu/nn/ops.py::apply_init_type`` does with
    its default gain 0.02. Biases and norm parameters stay. ``normal`` leaves the weights as
    they are (the reference ``weights_init`` already drew them).

    The fans are torch's, read off the weight as stored: dim 0 is "out",
    the rest "in". For a ConvTranspose2d (IOHW) that makes fan_in
    cout·k·k and the orthogonal rows cin, the fan swap the JAX package
    applies to its deconv kernels. The draws are the port's own (normal
    from ``generator`` on the CPU, copied in place): they follow the JAX
    package's distributions, not its bits."""
    if init_type == "normal":
        return
    if init_type not in ("xavier", "kaiming", "orthogonal"):
        raise ValueError(f"unknown init_type: {init_type}")
    with torch.no_grad():
        for m in module.modules():
            if not isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                continue
            shape = tuple(m.weight.shape)
            rows, fan_in = shape[0], int(np.prod(shape[1:]))
            fan_out = rows * int(np.prod(shape[2:]))
            if init_type == "orthogonal":
                a = torch.randn((max(rows, fan_in), min(rows, fan_in)),
                                generator=generator)
                q, r = torch.linalg.qr(a)
                q = q * torch.sign(torch.diagonal(r))
                w = (q if rows >= fan_in else q.T) * INIT_STD
            else:
                std = (INIT_STD * (2.0 / (fan_in + fan_out)) ** 0.5
                       if init_type == "xavier" else (2.0 / fan_in) ** 0.5)
                w = torch.randn(shape, generator=generator) * std
            m.weight.copy_(w.reshape(shape))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    # free when y is channels-last (what a channels-last input produces)
    return y.permute(0, 2, 3, 1).contiguous()


def conv(x: torch.Tensor, weight: torch.Tensor,
         bias: Optional[torch.Tensor] = None, stride: int = 1,
         padding: int = 0) -> torch.Tensor:
    """NHWC conv (cross-correlation) with an OIHW weight, computed in x's
    dtype."""
    b = None if bias is None else bias.to(x.dtype)
    return _nhwc(F.conv2d(_nchw(x), weight.to(x.dtype), b, stride=stride,
                          padding=padding))


def _subpixel_plan(k: int, pad: int):
    """Phase decomposition of a stride-2 transposed conv (the JAX
    package's ``_subpixel_plan``). Output position m = 2i+d (phase d) sums
    w[r]·x[i + (d+r-lo)/2] over the kernel rows r with (d+r-lo) even,
    lo = k-1-pad, where w is the forward-conv (flipped) kernel. Returns
    (per-phase (rows, offsets), kk, omin): the dense conv's window kk
    covers offsets omin .. omin+kk-1."""
    lo = k - 1 - pad
    phases, offs = [], []
    for d in (0, 1):
        rs = [r for r in range(k) if (d + r - lo) % 2 == 0]
        os_ = [(d + r - lo) // 2 for r in rs]
        phases.append((rs, os_))
        offs += os_
    omin, omax = min(offs), max(offs)
    return phases, omax - omin + 1, omin


@lru_cache(maxsize=None)
def _subpixel_index(ci: int, co: int, k: int, pad: int,
                    device: torch.device) -> torch.Tensor:
    """Gather index from the flattened IOHW ConvTranspose2d weight,
    followed by zeros, to the dense subpixel kernel laid out
    (4co, kk, kk, ci): channels-last OIHW, so that cuDNN writes
    channels-last output. Output channel (dh*2+dw)*co + o (the order B3's
    d2s reads, ``ops.py:229-233``). The JAX plan acts on the flipped
    forward-conv kernel wf[a, b, i, o] = w[i, o, k-1-a, k-1-b].

    Every weight tap lands in exactly one phase, and each empty slot
    reads a zero of its own, so the index is a permutation: the gather's
    backward adds into distinct addresses, with no atomic contention."""
    phases, kk, omin = _subpixel_plan(k, pad)
    idx = np.full((4 * co, kk, kk, ci), -1, np.int64)
    o = np.arange(co)[:, None]
    i = np.arange(ci)[None, :]
    for dh in (0, 1):
        rh, oh = phases[dh]
        for dw in (0, 1):
            rw, ow = phases[dw]
            p = dh * 2 + dw
            for a, oa in zip(rh, oh):
                for b, ob in zip(rw, ow):
                    idx[p * co:(p + 1) * co, oa - omin, ob - omin, :] = (
                        ((i * co + o) * k + (k - 1 - a)) * k + (k - 1 - b))
    empty = idx < 0
    idx[empty] = ci * co * k * k + np.arange(int(empty.sum()))
    with torch.inference_mode(False):  # see _reflect_index
        return torch.from_numpy(idx.reshape(-1)).to(device)


def subpixel_admits(k: int, pad: int, output_padding: int) -> bool:
    """Whether the subpixel plan computes this stride-2 transposed conv:
    it emits exactly twice the input and can only trim
    (``ops.py:263-264``)."""
    return output_padding in (0, 1) and k + output_padding - 2 * pad <= 2


def subpixel_weight(weight: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """IOHW ConvTranspose2d(k, s2, ``pad``) weight -> the dense
    (4·cout, cin, kk, kk) subpixel conv weight (channels-last), by one
    gather. Differentiable."""
    ci, co, k, _ = weight.shape
    idx = _subpixel_index(ci, co, k, pad, weight.device)
    kk = _subpixel_plan(k, pad)[1]
    flat = F.pad(weight.reshape(-1), (0, idx.numel() - weight.numel()))
    return flat.index_select(0, idx).view(4 * co, kk, kk, ci).permute(
        0, 3, 1, 2)


def deconv(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, padding: int = 1,
           output_padding: int = 1, lowering: str = "subpixel",
           wk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ConvTranspose2d with stride 2 and an IOHW weight, computed in x's
    dtype. The defaults (k3 p1 op1) are the ResNet generators' upsampler;
    the U-Net's is k4 p1 op0.

    ``lowering="subpixel"`` (the JAX default), for every geometry that
    :func:`subpixel_admits`: a dense kk x kk conv to 4·cout phase
    channels over x zero-padded as the plan needs, then B3's
    depth-to-space, trimmed per dimension to torch's output size, then
    the bias. ``wk`` is the already rearranged weight
    (:func:`subpixel_weight` of the weight in x's dtype), when the caller
    keeps one. ``lowering="dilated"``, and every geometry the plan does
    not admit (as in the JAX package): ``F.conv_transpose2d``."""
    b = None if bias is None else bias.to(x.dtype)
    k = weight.shape[2]
    if lowering not in ("subpixel", "dilated"):
        raise ValueError(f"unknown deconv lowering: {lowering!r}")
    if lowering == "dilated" or not subpixel_admits(k, padding,
                                                    output_padding):
        return _nhwc(F.conv_transpose2d(_nchw(x), weight.to(x.dtype), b,
                                        stride=2, padding=padding,
                                        output_padding=output_padding))
    if wk is None:
        wk = subpixel_weight(weight.to(x.dtype), padding)
    _, kk, omin = _subpixel_plan(k, padding)
    lo, hi = -omin, kk - 1 + omin
    y = _nhwc(F.conv2d(_nchw(F.pad(x, (0, 0, lo, hi, lo, hi))), wk))
    y = d2s_fn(y, weight.shape[1])
    _, h, w, _ = x.shape
    out_h = (h - 1) * 2 - 2 * padding + k + output_padding
    out_w = (w - 1) * 2 - 2 * padding + k + output_padding
    if out_h != 2 * h or out_w != 2 * w:
        y = y[:, :out_h, :out_w, :]
    return y if b is None else y + b


@lru_cache(maxsize=None)
def _reflect_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    # a normal tensor even when first asked for in inference mode, so that
    # a later training step may save it for backward
    with torch.inference_mode(False):
        i = torch.arange(-pad, n + pad, device="cpu").abs()
        return torch.where(i > n - 1, 2 * (n - 1) - i, i).to(device)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """torch ReflectionPad2d over H and W of NHWC ``x``; the result is
    contiguous NHWC."""
    _, h, w, _ = x.shape
    x = x.index_select(1, _reflect_index(h, pad, x.device))
    return x.index_select(2, _reflect_index(w, pad, x.device))


def avg_pool(x: torch.Tensor, window: int = 3, stride: int = 2, pad: int = 1,
             count_include_pad: bool = False) -> torch.Tensor:
    """torch AvgPool2d over NHWC ``x``, accumulated in fp32, result in x's
    dtype (the local enhancer's input pyramid, the discriminator's).

    It pools NCHW-contiguous memory: on a CUDA tensor in channels-last
    memory, ``F.avg_pool2d``'s backward returns a wrong gradient (PyTorch
    2.11 on an H100, (1,256,256,6) fp32: 105% relative error against the
    CPU, whatever count_include_pad; ``chip_smoke.py`` checks both
    layouts). The inputs are a few channels wide, so the two layout
    copies are small."""
    y = F.avg_pool2d(_nchw(x.float()).contiguous(), window, stride, pad,
                     count_include_pad=count_include_pad)
    return _nhwc(y).to(x.dtype)


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool over NHWC ``x`` (the VGG trunk's pools)."""
    return _nhwc(F.max_pool2d(_nchw(x), 2, 2))


def replicate_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """torch ReplicationPad2d (``jnp.pad`` mode "edge") over H and W of
    NHWC ``x``."""
    _, h, w, _ = x.shape
    x = x.index_select(1, _edge_index(h, pad, x.device))
    return x.index_select(2, _edge_index(w, pad, x.device))


@lru_cache(maxsize=None)
def _edge_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):  # see _reflect_index
        return torch.arange(-pad, n + pad).clamp(0, n - 1).to(device)


def resize_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of NHWC ``x`` by an integer factor (torch
    Upsample(mode="nearest")): each pixel repeated ``scale`` x ``scale``."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, scale, w, scale, c
                                            ).reshape(n, h * scale,
                                                      w * scale, c)


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = False
                    ) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to ``out_hw``, computed in fp32, the
    result in x's dtype. ``align_corners=False``: half-pixel centres, the
    triangle kernel widened when shrinking (``jax.image.resize``'s
    "linear", torch's ``antialias=True``); ``True``: the end pixels map
    to the end pixels, no widening."""
    y = F.interpolate(_nchw(x.float()).contiguous(), size=tuple(out_hw),
                      mode="bilinear", align_corners=align_corners,
                      antialias=not align_corners)
    return _nhwc(y).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator
            ) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 - ``rate``
    (a uniform draw from ``generator``, on its device) and scaled by
    1 / (1 - rate), the rest 0. Its bits are the port's own; the JAX
    package draws from its key."""
    return apply_dropout(x, dropout_mask(x.shape, rate, generator), rate)


def dropout_mask(shape, rate: float, generator: torch.Generator
                 ) -> torch.Tensor:
    """:func:`dropout`'s draw alone: the bool mask of kept elements, on
    ``generator``'s device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u < 1.0 - rate


def apply_dropout(x: torch.Tensor, mask: torch.Tensor, rate: float
                  ) -> torch.Tensor:
    """:func:`dropout` with its mask given."""
    keep = 1.0 - rate
    return torch.where(mask.to(x.device), x / keep, 0.0).to(x.dtype)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = BATCH_NORM_EPS,
               running_mean: Optional[torch.Tensor] = None,
               running_var: Optional[torch.Tensor] = None,
               use_running_stats: bool = False) -> torch.Tensor:
    """Batch norm over (N, H, W) of NHWC ``x``, fp32 statistics, then
    gamma (``weight``) and beta (``bias``); the result in x's dtype.

    Batch statistics by default, as the JAX package (``ops.py:351-371``)
    and the reference family at test time compute it; with
    ``use_running_stats`` (and running stats given) the stored ones,
    ``model.eval()``'s semantics. Written out, so that no running stat
    is ever updated."""
    x32 = x.float()
    if use_running_stats and running_mean is not None:
        mean, var = running_mean.float(), running_var.float()
    else:
        mean = x32.mean(dim=(0, 1, 2))
        var = (x32 - mean).square().mean(dim=(0, 1, 2))
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def norm_act(x: torch.Tensor, norm: str, act: str = "relu",
             negative_slope: float = 0.2,
             bn: Optional[torch.nn.BatchNorm2d] = None) -> torch.Tensor:
    """Norm followed by activation — the generator hot pattern. Instance
    norm (fp32 statistics, eps 1e-5) runs fused in kernel B1; batch norm
    (batch statistics, the affine ``bn``'s gamma and beta) and ``none``
    apply the activation after, in plain PyTorch."""
    if norm == "instance":
        return fused_instance_norm_act(x, act, negative_slope)
    if norm == "batch":
        x = batch_norm(x, bn.weight, bn.bias, bn.eps)
    elif norm != "none":
        raise ValueError(f"unknown norm: {norm}")
    return apply_act(x, act, negative_slope)
