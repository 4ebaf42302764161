"""Fused instance norm + activation (kernel B1), forward only.

Port of ``ir2rgb_tpu/kernels/instance_norm.py::_instance_norm_act_pallas``.
The CUDA kernel is ``csrc/instance_norm.cu`` (its header says what bounds
it and how the design answers that); this module holds

- :func:`instance_norm_act_reference`: plain PyTorch, fp32 two-pass
  statistics, the CPU path and the yardstick the kernel is held to;
- :func:`instance_norm_act`: the wrapper. A CPU tensor takes the plain
  version; a CUDA tensor launches the kernel or raises;
- ``launches``: how many times the wrapper launched the kernel.

All take and return NHWC tensors. The kernel reads NHWC memory directly,
so ``x`` must be contiguous in that order (a channels-last NCHW tensor
permuted to NHWC is). The backward kernel comes with training; the CUDA
path refuses inputs that require a gradient instead of silently dropping
it.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch

from . import _build

INSTANCE_NORM_EPS = 1e-5
ACTS = {"none": 0, "relu": 1, "leaky_relu": 2, "tanh": 3}

launches = 0

_THREADS = 256       # block size of the stats/apply kernels
_MAX_CT = 32         # channel vectors per block (one warp's 16-byte loads)
_TARGET_BLOCKS = 528  # ~4 blocks per SM on a 132-SM H100


def apply_act(y: torch.Tensor, act: str,
              negative_slope: float = 0.2) -> torch.Tensor:
    if act == "relu":
        return torch.relu(y)
    if act == "leaky_relu":
        return torch.where(y >= 0, y, y * negative_slope)
    if act == "tanh":
        return torch.tanh(y)
    if act == "none":
        return y
    raise ValueError(f"unknown act: {act}")


def instance_norm_act_reference(x: torch.Tensor, act: str = "relu",
                                eps: float = INSTANCE_NORM_EPS,
                                negative_slope: float = 0.2
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """(N,H,W,C) -> (y in x.dtype, mean (N,C) fp32, rstd (N,C) fp32)."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2))
    var = (x32 - mean[:, None, None, :]).square().mean(dim=(1, 2))
    rstd = torch.rsqrt(var + eps)
    y = (x32 - mean[:, None, None, :]) * rstd[:, None, None, :]
    return apply_act(y, act, negative_slope).to(x.dtype), mean, rstd


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@lru_cache(maxsize=None)
def _plan(n: int, hw: int, c: int, vec: int):
    """Grid of the stats/apply kernels: (n_chunks, chunk, ct, n_ctiles).

    ``ct`` channel vectors of ``vec`` elements per block (a power of two,
    so the block's rows tree-merge), ``256 / ct`` pixel rows; pixel chunks
    sized so the grid holds about ``_TARGET_BLOCKS`` blocks."""
    cvecs = c // vec
    ct = 1
    while ct < min(cvecs, _MAX_CT):
        ct *= 2
    n_ctiles = _ceil_div(cvecs, ct)
    rows = _THREADS // ct
    want = max(1, _ceil_div(_TARGET_BLOCKS, n * n_ctiles))
    n_chunks = min(want, _ceil_div(hw, rows))
    chunk = _ceil_div(hw, n_chunks)
    return _ceil_div(hw, chunk), chunk, ct, n_ctiles


def instance_norm_act_cuda(x: torch.Tensor, act: str = "relu",
                           eps: float = INSTANCE_NORM_EPS,
                           negative_slope: float = 0.2):
    """Launch the CUDA kernel; raise on anything it does not take."""
    global launches
    if not x.is_cuda:
        raise ValueError("instance_norm_act_cuda needs a CUDA tensor")
    if x.dim() != 4:
        raise ValueError(f"expected NHWC (N,H,W,C), got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported dtype {x.dtype} (float32 or bfloat16)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC memory")
    if act not in ACTS:
        raise ValueError(f"unknown act: {act}")
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "the instance-norm kernel is forward-only; its backward comes "
            "with training")
    n, h, w, c = x.shape
    vec = 16 // x.element_size()
    if c % vec or x.data_ptr() % 16:
        raise ValueError(f"C={c} must be a multiple of {vec} and x 16-byte "
                         "aligned for the kernel's 16-byte loads")
    hw = h * w
    n_chunks, chunk, ct, n_ctiles = _plan(n, hw, c, vec)
    y = torch.empty_like(x)
    # one fp32 allocation: mean, rstd, then the (n, n_chunks, 2, c)
    # partial statistics
    buf = torch.empty(n * c * (2 + 2 * n_chunks), device=x.device,
                      dtype=torch.float32)
    mean, rstd = buf[:2 * n * c].view(2, n, c).unbind(0)
    part = buf[2 * n * c:]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _build.lib().ir2rgb_instance_norm_act(
        x.data_ptr(), part.data_ptr(), y.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), n, hw, c, n_chunks, chunk, ct, n_ctiles, ACTS[act],
        float(negative_slope), float(eps), int(x.dtype == torch.bfloat16),
        stream)
    _build.check(code, "instance_norm_act")
    launches += 1
    return y, mean, rstd


def instance_norm_act(x: torch.Tensor, act: str = "relu",
                      eps: float = INSTANCE_NORM_EPS,
                      negative_slope: float = 0.2):
    """Instance norm + activation over NHWC ``x``: (y, mean, rstd).

    CPU tensors take the plain version; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return instance_norm_act_reference(x, act, eps, negative_slope)
    return instance_norm_act_cuda(x, act, eps, negative_slope)
