"""Core NN ops on NHWC tensors — the slice of ``ir2rgb_tpu/nn/ops.py``
that the pix2pixHD serving path and its train step run.

Every function takes and returns NHWC tensors, the JAX package's layout.
``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is a channels-last
NCHW view, which is what the PyTorch convolutions receive, and their
channels-last output permutes back to contiguous NHWC for free. Weights
keep PyTorch's layouts (Conv2d OIHW, ConvTranspose2d IOHW), so a module's
``state_dict`` is the reference family's.

Convolutions are plain ``F.conv2d``: the JAX package left them to XLA
outside any Pallas kernel. The transposed conv takes the JAX package's
default ``subpixel`` lowering (``ops.py:193-288``): a dense conv to
4·cout phase channels, then the depth-to-space of kernel B3
(``kernels.d2s_fn``), then the bias. Instance norm goes to kernel B1
(``kernels.fused_instance_norm_act``). Both kernels are differentiable.
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


_UP_K, _UP_PAD = 3, 1  # the generators' upsampler: k3 s2 p1 output_padding 1


def subpixel_weight(weight: torch.Tensor) -> torch.Tensor:
    """IOHW ConvTranspose2d(k3 s2 p1 op1) weight -> the dense
    (4·cout, cin, 2, 2) subpixel conv weight (channels-last), by one
    gather. Differentiable."""
    ci, co, k, _ = weight.shape
    if k != _UP_K:
        raise NotImplementedError(f"subpixel deconv with k={k} (only the "
                                  "generators' k=3 is ported)")
    idx = _subpixel_index(ci, co, k, _UP_PAD, weight.device)
    kk = _subpixel_plan(k, _UP_PAD)[1]
    flat = F.pad(weight.reshape(-1), (0, idx.numel() - weight.numel()))
    return flat.index_select(0, idx).view(4 * co, kk, kk, ci).permute(
        0, 3, 1, 2)


def deconv(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, lowering: str = "subpixel",
           wk: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The generators' upsampler: ConvTranspose2d k3 s2 p1 output_padding 1
    (doubles H and W) with an IOHW weight, computed in x's dtype.

    ``lowering="subpixel"`` (the JAX default): a dense 2x2 conv to
    4·cout phase channels over x zero-padded by one row and column at the
    bottom and right, then B3's depth-to-space, then the bias. ``wk`` is
    the already rearranged weight (:func:`subpixel_weight` of the weight
    in x's dtype), when the caller keeps one. ``lowering="dilated"``:
    ``F.conv_transpose2d``, the JAX package's other branch."""
    b = None if bias is None else bias.to(x.dtype)
    if lowering == "dilated":
        return _nhwc(F.conv_transpose2d(_nchw(x), weight.to(x.dtype), b,
                                        stride=2, padding=1,
                                        output_padding=1))
    if lowering != "subpixel":
        raise ValueError(f"unknown deconv lowering: {lowering!r}")
    if wk is None:
        wk = subpixel_weight(weight.to(x.dtype))
    _, kk, omin = _subpixel_plan(_UP_K, _UP_PAD)
    lo, hi = -omin, kk - 1 + omin
    y = _nhwc(F.conv2d(_nchw(F.pad(x, (0, 0, lo, hi, lo, hi))), wk))
    y = d2s_fn(y, weight.shape[1])
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


def norm_act(x: torch.Tensor, norm: str, act: str = "relu",
             negative_slope: float = 0.2) -> torch.Tensor:
    """Norm followed by activation — the generator hot pattern. Instance
    norm (fp32 statistics, eps 1e-5) runs fused in kernel B1."""
    if norm == "instance":
        return fused_instance_norm_act(x, act, negative_slope)
    raise NotImplementedError(f"norm={norm!r} is not ported yet")
