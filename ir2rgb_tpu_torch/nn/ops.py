"""Core NN ops on NHWC tensors — the slice of ``ir2rgb_tpu/nn/ops.py``
that the pix2pixHD serving path runs.

Every function takes and returns NHWC tensors, the JAX package's layout.
``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is a channels-last
NCHW view, which is what the PyTorch convolutions receive, and their
channels-last output permutes back to contiguous NHWC for free. Weights
keep PyTorch's layouts (Conv2d OIHW, ConvTranspose2d IOHW), so a module's
``state_dict`` is the reference family's.

Convolutions are plain ``F.conv2d`` / ``F.conv_transpose2d``: the JAX
package left them to XLA outside any Pallas kernel. Instance norm goes to
kernel B1 (``kernels.fused_instance_norm_act``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import torch
import torch.nn.functional as F

from ir2rgb_tpu_torch.kernels import fused_instance_norm_act
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


def deconv(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The generators' upsampler: ConvTranspose2d k3 s2 p1 output_padding 1
    (doubles H and W) with an IOHW weight."""
    b = None if bias is None else bias.to(x.dtype)
    return _nhwc(F.conv_transpose2d(_nchw(x), weight.to(x.dtype), b,
                                    stride=2, padding=1, output_padding=1))


@lru_cache(maxsize=None)
def _reflect_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
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
    dtype (the local enhancer's input pyramid)."""
    y = F.avg_pool2d(_nchw(x.float()), window, stride, pad,
                     count_include_pad=count_include_pad)
    return _nhwc(y).to(x.dtype)


def norm_act(x: torch.Tensor, norm: str, act: str = "relu",
             negative_slope: float = 0.2) -> torch.Tensor:
    """Norm followed by activation — the generator hot pattern. Instance
    norm (fp32 statistics, eps 1e-5) runs fused in kernel B1."""
    if norm == "instance":
        return fused_instance_norm_act(x, act, negative_slope)
    raise NotImplementedError(f"norm={norm!r} is not ported yet")
