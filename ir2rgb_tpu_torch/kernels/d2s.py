"""2x depth-to-space and space-to-depth (kernel B3).

Port of ``ir2rgb_tpu/kernels/d2s.py``: ``d2s_pallas`` / ``s2d_pallas``
and the custom VJP that makes one the gradient of the other. The CUDA
kernel is ``csrc/d2s.cu`` (its header says what bounds it and how the
design answers that). With a phase tensor y (N, h, w, 4C) and an image
x (N, 2h, 2w, C):

    x[n, 2i+dh, 2j+dw, c] = y[n, i, j, (dh*2+dw)*C + c]

This is the interleave of the subpixel transposed conv
(``nn/ops.py::deconv``). ``torch.pixel_shuffle`` orders the channels
``c*4 + dh*2 + dw`` and is not this function. The module holds

- :func:`d2s_reference` / :func:`s2d_reference`: plain PyTorch, the CPU
  path and the yardstick the kernel is held to;
- the custom ops ``ir2rgb::d2s`` and ``ir2rgb::s2d``
  (``_build.define_op``): their CPU implementations are the plain versions,
  their CUDA implementations launch the kernel or raise, and their fake
  implementations give the outputs' shapes, so ``torch.export`` keeps
  each call as one node;
- :func:`d2s` / :func:`s2d`: the wrappers, which call the ops (their
  implementations directly, outside an export: ``_build.define_op``). A CPU
  tensor takes the plain version; a CUDA tensor launches the kernel or
  raises;
- :class:`D2S`: the ``torch.autograd.Function`` whose backward is
  :func:`s2d`, and :func:`d2s_fn`, what the networks call;
- ``launches``: per direction, how many times the ops' CUDA
  implementations launched the kernel.

The kernel takes any C. Where a pixel's C channels fill whole 16-byte
words (every shape of the main path) it copies words; otherwise it
copies single elements.
"""

from __future__ import annotations

import torch

from . import _build

launches = {"d2s": 0, "s2d": 0}


def d2s_reference(y: torch.Tensor, c: int) -> torch.Tensor:
    """(N, h, w, 4c) -> (N, 2h, 2w, c), channel (dh*2+dw)*c + ch."""
    n, h, w, _ = y.shape
    return (y.reshape(n, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(n, 2 * h, 2 * w, c))


def s2d_reference(x: torch.Tensor) -> torch.Tensor:
    """(N, 2h, 2w, c) -> (N, h, w, 4c): the inverse of d2s_reference."""
    n, h2, w2, c = x.shape
    return (x.reshape(n, h2 // 2, 2, w2 // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(n, h2 // 2, w2 // 2, 4 * c))


def _launch(src: torch.Tensor, out_shape, hs: int, ws: int, c: int,
            to_image: bool) -> torch.Tensor:
    name = "d2s" if to_image else "s2d"
    if not src.is_cuda:
        raise ValueError(f"{name}_cuda needs a CUDA tensor")
    if src.dim() != 4:
        raise ValueError(f"expected NHWC, got shape {tuple(src.shape)}")
    if not src.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous NHWC memory")
    esize = src.element_size()
    if esize not in (2, 4):
        raise TypeError(f"unsupported dtype {src.dtype} (2- or 4-byte "
                        "elements)")
    dst = torch.empty(out_shape, device=src.device, dtype=src.dtype)
    row = c * esize
    if row % 16 == 0 and src.data_ptr() % 16 == 0:
        unit, cw = 16, row // 16
    else:
        unit, cw = esize, c
    stream = torch.cuda.current_stream(src.device).cuda_stream
    code = _build.lib().ir2rgb_d2s(src.data_ptr(), dst.data_ptr(),
                                   src.shape[0], hs, ws, cw, unit,
                                   int(to_image), stream)
    _build.check(code, name)
    launches[name] += 1
    return dst


def d2s_cuda(y: torch.Tensor, c: int) -> torch.Tensor:
    """Launch the kernel, depth-to-space; raise on what it does not take."""
    n, hs, ws, c4 = y.shape
    if c4 != 4 * c:
        raise ValueError(f"expected 4*{c} channels, got {c4}")
    return _launch(y, (n, 2 * hs, 2 * ws, c), hs, ws, c, True)


def s2d_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel, space-to-depth; raise on what it does not take."""
    n, h2, w2, c = x.shape
    if h2 % 2 or w2 % 2:
        raise ValueError(f"H and W must be even, got {h2}x{w2}")
    return _launch(x, (n, h2 // 2, w2 // 2, 4 * c), h2 // 2, w2 // 2, c,
                   False)


def _fresh(out: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``out`` in memory of its own: an op's output may not alias its
    input, and the plain permutation is a view of it where the moved axes
    have size 1 (a 1x1 phase tensor)."""
    if out.untyped_storage().data_ptr() == src.untyped_storage().data_ptr():
        return out.clone(memory_format=torch.contiguous_format)
    return out


def _d2s_fake(y, c):
    n, hs, ws, _ = y.shape
    return y.new_empty((n, 2 * hs, 2 * ws, c))


def _s2d_fake(x):
    n, h2, w2, c = x.shape
    return x.new_empty((n, h2 // 2, w2 // 2, 4 * c))


_D2S = _build.define_op("d2s(Tensor y, int c) -> Tensor",
                        lambda y, c: _fresh(d2s_reference(y, c), y),
                        d2s_cuda, _d2s_fake)
_S2D = _build.define_op("s2d(Tensor x) -> Tensor",
                        lambda x: _fresh(s2d_reference(x), x), s2d_cuda,
                        _s2d_fake)


def d2s(y: torch.Tensor, c: int) -> torch.Tensor:
    """Depth-to-space of NHWC ``y``. CPU tensors take the plain version;
    CUDA tensors the kernel (the op ``ir2rgb::d2s``)."""
    _build.check_device(y, "d2s")
    return _D2S(y, c)


def s2d(x: torch.Tensor) -> torch.Tensor:
    """Space-to-depth of NHWC ``x``. CPU tensors take the plain version;
    CUDA tensors the kernel (the op ``ir2rgb::s2d``)."""
    _build.check_device(x, "s2d")
    return _S2D(x)


class D2S(torch.autograd.Function):
    """d2s forward, s2d backward (``d2s.py:128-136``)."""

    @staticmethod
    def forward(ctx, y, c):
        return d2s(y, c)

    @staticmethod
    def backward(ctx, g):
        return s2d(g.contiguous()), None


def d2s_fn(y: torch.Tensor, c: int) -> torch.Tensor:
    """Differentiable depth-to-space. Without a graph to record it calls
    the wrapper directly."""
    if torch.is_grad_enabled() and y.requires_grad:
        return D2S.apply(y, c)
    return d2s(y, c)
