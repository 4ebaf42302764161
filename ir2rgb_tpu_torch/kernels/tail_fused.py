"""Generator output tail (kernel B2): reflect-pad 3, 7x7 conv to 3 channels,
bias, tanh. Inference only.

Port of ``ir2rgb_tpu/kernels/tail_fused.py::tail_fused``. The TPU kernel
reads the space-to-depth activation and fuses the depth-to-space; the port
keeps activations in image space, so the kernel (``csrc/tail_fused.cu``,
whose header says what bounds it and how the design answers that)
computes the image-space function of ``ir2rgb_tpu/nn/generators.py:586-590``:

    y = tanh(conv7x7(reflect_pad3(x), w) + b)

with x (N,H,W,C), w (7,7,C,3) HWIO, b (3,), y (N,H,W,3) in x's dtype,
accumulated in fp32. The weights are rounded to x's dtype first, as the
JAX generator casts them to its compute dtype. This module holds

- :func:`tail_fused_reference`: plain PyTorch, the CPU path and yardstick;
- :func:`tail_fused`: the wrapper. A CPU tensor takes the plain version;
  a CUDA tensor launches the kernel or raises;
- ``launches``: how many times the wrapper launched the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

launches = 0

_K = 7
_TILE = 16
_WIN = _TILE + _K - 1  # output tile plus the 3-pixel halo on each side
_SMEM_LIMIT = 232448   # bytes of shared memory a Hopper block may use


def tail_fused_reference(x: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """(N,H,W,C), (7,7,C,3), (3,) -> tanh(conv(reflect_pad(x, 3)) + b)."""
    x32 = x.float().permute(0, 3, 1, 2)
    w32 = w.to(x.dtype).float().permute(3, 2, 0, 1)
    y = F.conv2d(F.pad(x32, (3, 3, 3, 3), mode="reflect"), w32, b.float())
    return torch.tanh(y).permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _smem_layout(c: int, vec: int):
    """(pix_stride, smem_bytes): a pixel's channels take ``c / vec``
    16-byte words, padded to an odd count so that neighbouring pixels
    fall in different shared-memory banks; the weights follow as one
    float4 per (tap, channel)."""
    words = c // vec
    pix_stride = words if words % 2 else words + 1
    return pix_stride, 16 * (_WIN * _WIN * pix_stride + _K * _K * c)


def tail_fused_cuda(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; raise on anything it does not take."""
    global launches
    if not (x.is_cuda and w.is_cuda and b.is_cuda):
        raise ValueError("tail_fused_cuda needs CUDA tensors")
    if x.dim() != 4:
        raise ValueError(f"expected NHWC (N,H,W,C), got shape {tuple(x.shape)}")
    n, h, wd, c = x.shape
    if tuple(w.shape) != (_K, _K, c, 3) or tuple(b.shape) != (3,):
        raise ValueError(f"expected w (7,7,{c},3) and b (3,), got "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported dtype {x.dtype} (float32 or bfloat16)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC memory")
    if h <= 3 or wd <= 3:
        raise ValueError(f"reflect padding 3 needs H, W > 3, got {h}x{wd}")
    vec = 16 // x.element_size()
    if c % vec or x.data_ptr() % 16:
        raise ValueError(f"C={c} must be a multiple of {vec} and x 16-byte "
                         "aligned for the kernel's 16-byte loads")
    pix_stride, smem = _smem_layout(c, vec)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"C={c} needs {smem} bytes of shared memory, more "
                         f"than a block has ({_SMEM_LIMIT})")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError("the tail kernel is inference-only")
    # one float4 (o0, o1, o2, 0) per (tap, channel)
    w4 = F.pad(w.to(x.dtype).float().reshape(_K * _K * c, 3), (0, 1))
    b32 = b.float().contiguous()
    y = torch.empty((n, h, wd, 3), device=x.device, dtype=x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _build.lib().ir2rgb_tail_fused(
        x.data_ptr(), w4.data_ptr(), b32.data_ptr(), y.data_ptr(), n, h, wd,
        c, pix_stride, smem, int(x.dtype == torch.bfloat16), stream)
    _build.check(code, "tail_fused")
    launches += 1
    return y


def tail_fused(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """The generator tail over NHWC ``x``. CPU tensors take the plain
    version; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return tail_fused_reference(x, w, b)
    return tail_fused_cuda(x, w, b)
