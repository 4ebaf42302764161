"""Fused instance norm + activation (kernel B1), forward and backward.

Port of ``ir2rgb_tpu/kernels/instance_norm.py``: ``_instance_norm_act_pallas``
and the custom VJP around it (``_fused_fwd`` / ``_fused_bwd``). The CUDA
kernels are in ``csrc/instance_norm.cu`` (its header says what bounds them
and how the design answers that); this module holds

- :func:`instance_norm_act_reference` and
  :func:`instance_norm_act_backward_reference`: plain PyTorch, fp32
  arithmetic, the CPU path and the yardsticks the kernels are held to;
- :func:`instance_norm_act` and :func:`instance_norm_act_backward`: the
  wrappers. A CPU tensor takes the plain version; a CUDA tensor launches
  the kernel or raises;
- :class:`InstanceNormAct`: the ``torch.autograd.Function`` joining the
  two. Its forward saves ``(x, mean, rstd)`` as ``_fused_fwd`` does, and
  its backward is the backward wrapper;
- :func:`instance_norm_act_fn`: y only, differentiable; what the networks
  call;
- ``launches`` / ``bwd_launches``: how many times the wrappers launched
  the forward and the backward kernel.

All take and return NHWC tensors. The kernels read NHWC memory directly,
so ``x`` and the gradient must be contiguous in that order (a
channels-last NCHW tensor permuted to NHWC is).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch

from . import _build

INSTANCE_NORM_EPS = 1e-5
ACTS = {"none": 0, "relu": 1, "leaky_relu": 2, "tanh": 3}

launches = 0
bwd_launches = 0

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


def instance_norm_act_backward_reference(x: torch.Tensor, mean: torch.Tensor,
                                         rstd: torch.Tensor, g: torch.Tensor,
                                         act: str = "relu",
                                         negative_slope: float = 0.2
                                         ) -> torch.Tensor:
    """dx of instance norm + act, ``_fused_bwd``'s formula: with
    xh = (x - mean) * rstd and g' = g * act'(xh),
    dx = rstd * (g' - mean(g') - xh * mean(g' * xh)), in fp32, cast to
    x's dtype."""
    if act not in ACTS:
        raise ValueError(f"unknown act: {act}")
    mean = mean[:, None, None, :]
    rstd = rstd[:, None, None, :]
    xh = (x.float() - mean) * rstd
    g32 = g.float()
    if act == "relu":
        g32 = g32 * (xh > 0)
    elif act == "leaky_relu":
        g32 = torch.where(xh >= 0, g32, g32 * negative_slope)
    elif act == "tanh":
        t = torch.tanh(xh)
        g32 = g32 * (1.0 - t * t)
    gm = g32.mean(dim=(1, 2), keepdim=True)
    gx = (g32 * xh).mean(dim=(1, 2), keepdim=True)
    return (rstd * (g32 - gm - xh * gx)).to(x.dtype)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@lru_cache(maxsize=None)
def _plan(n: int, hw: int, c: int, vec: int):
    """Grid of the stats/apply kernels (both directions): (n_chunks,
    chunk, ct, n_ctiles).

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


def _check_nhwc(t: torch.Tensor, what: str) -> int:
    """Raise unless ``t`` is what the kernels read; return its vector
    width (elements per 16 bytes)."""
    if not t.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor")
    if t.dim() != 4:
        raise ValueError(f"expected NHWC (N,H,W,C), got shape {tuple(t.shape)}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported dtype {t.dtype} (float32 or bfloat16)")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous NHWC memory")
    vec = 16 // t.element_size()
    if t.shape[3] % vec or t.data_ptr() % 16:
        raise ValueError(f"C={t.shape[3]} must be a multiple of {vec} and the "
                         "tensor 16-byte aligned for the kernel's 16-byte "
                         "loads")
    return vec


def instance_norm_act_cuda(x: torch.Tensor, act: str = "relu",
                           eps: float = INSTANCE_NORM_EPS,
                           negative_slope: float = 0.2):
    """Launch the forward kernel; raise on anything it does not take."""
    global launches
    vec = _check_nhwc(x, "instance_norm_act_cuda")
    if act not in ACTS:
        raise ValueError(f"unknown act: {act}")
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("instance_norm_act_cuda does not record a graph; "
                         "call instance_norm_act_fn for a differentiable y")
    n, h, w, c = x.shape
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


def instance_norm_act_bwd_cuda(x: torch.Tensor, mean: torch.Tensor,
                               rstd: torch.Tensor, g: torch.Tensor,
                               act: str = "relu",
                               negative_slope: float = 0.2) -> torch.Tensor:
    """Launch the backward kernel; raise on anything it does not take."""
    global bwd_launches
    vec = _check_nhwc(x, "instance_norm_act_bwd_cuda")
    _check_nhwc(g, "instance_norm_act_bwd_cuda")
    if act not in ACTS:
        raise ValueError(f"unknown act: {act}")
    n, h, w, c = x.shape
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    for s in (mean, rstd):
        if (tuple(s.shape) != (n, c) or s.dtype != torch.float32
                or not s.is_contiguous() or s.device != x.device):
            raise ValueError("mean and rstd must be contiguous (N, C) fp32 "
                             "on x's device")
    hw = h * w
    n_chunks, chunk, ct, n_ctiles = _plan(n, hw, c, vec)
    dx = torch.empty_like(x)
    # one fp32 allocation: mean(g'), mean(g' * xh), then the
    # (n, n_chunks, 2, c) partial sums
    buf = torch.empty(n * c * (2 + 2 * n_chunks), device=x.device,
                      dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _build.lib().ir2rgb_instance_norm_act_bwd(
        x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        buf[2 * n * c:].data_ptr(), buf.data_ptr(), dx.data_ptr(), n, hw, c,
        n_chunks, chunk, ct, n_ctiles, ACTS[act], float(negative_slope),
        int(x.dtype == torch.bfloat16), stream)
    _build.check(code, "instance_norm_act_bwd")
    bwd_launches += 1
    return dx


def instance_norm_act(x: torch.Tensor, act: str = "relu",
                      eps: float = INSTANCE_NORM_EPS,
                      negative_slope: float = 0.2):
    """Instance norm + activation over NHWC ``x``: (y, mean, rstd).

    CPU tensors take the plain version; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return instance_norm_act_reference(x, act, eps, negative_slope)
    return instance_norm_act_cuda(x, act, eps, negative_slope)


def instance_norm_act_backward(x: torch.Tensor, mean: torch.Tensor,
                               rstd: torch.Tensor, g: torch.Tensor,
                               act: str = "relu",
                               negative_slope: float = 0.2) -> torch.Tensor:
    """dx of :func:`instance_norm_act` for the output gradient ``g``.

    CPU tensors take the plain version; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return instance_norm_act_backward_reference(x, mean, rstd, g, act,
                                                    negative_slope)
    return instance_norm_act_bwd_cuda(x, mean, rstd, g.contiguous(), act,
                                      negative_slope)


class InstanceNormAct(torch.autograd.Function):
    """y = act(instance_norm(x)) with the B1 kernels both ways."""

    @staticmethod
    def forward(ctx, x, act, eps, negative_slope):
        y, mean, rstd = instance_norm_act(x, act, eps, negative_slope)
        ctx.save_for_backward(x, mean, rstd)
        ctx.act, ctx.negative_slope = act, negative_slope
        return y

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd = ctx.saved_tensors
        dx = instance_norm_act_backward(x, mean, rstd, g, ctx.act,
                                        ctx.negative_slope)
        return dx, None, None, None


def instance_norm_act_fn(x: torch.Tensor, act: str = "relu",
                         eps: float = INSTANCE_NORM_EPS,
                         negative_slope: float = 0.2) -> torch.Tensor:
    """Differentiable y of instance norm + act. Without a graph to record
    (inference, or ``x`` needs no gradient) it calls the forward wrapper
    directly."""
    if torch.is_grad_enabled() and x.requires_grad:
        return InstanceNormAct.apply(x, act, eps, negative_slope)
    return instance_norm_act(x, act, eps, negative_slope)[0]
