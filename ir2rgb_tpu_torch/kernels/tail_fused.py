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
- the custom op ``ir2rgb::tail_fused`` (``_build.define_op``): its CPU
  implementation is the plain version, its CUDA implementation launches
  the kernel of its :func:`route` (packing the weights through
  :func:`packed`) or raises, and its fake implementation gives the
  output's shape, so ``torch.export`` keeps the call as one node;
- :func:`tail_fused`: the wrapper, which calls the op (its
  implementations directly, outside an export: ``_build.define_op``). A
  CPU tensor takes the plain version; a CUDA tensor launches the kernel
  or raises;
- :func:`pack_fragments`: the bf16 route's weights in the order its
  tensor-core fragments read them, and :func:`packed`, which keeps each
  weight's packing until the weight changes;
- ``launches``: how many times the op's CUDA implementation launched
  a kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from . import _build

launches = 0

_K = 7
_SMEM_LIMIT = 232448   # bytes of shared memory a Hopper block may use
_SM_SMEM = 233472      # bytes of shared memory of one SM
_BLOCK_RESERVED = 1024  # bytes the card keeps for each resident block

# fp32 route (CUDA cores): a 16x16 output tile and its 3-pixel halo
_TILE = 16
_WIN = _TILE + _K - 1

# bf16 route (tensor cores): a TH x 32 output tile, 7 warps (one per kw),
# kh taps in pairs (0,1) (2,3) (4,5) (6,-) as the 8 columns of one product
_TC_TW = 32
_TC_WIN_W = _TC_TW + _K - 1
_PAIRS = 4
_TC_ROWS = (16, 8)  # tile heights, the tallest whose two blocks fit an SM


def tail_fused_reference(x: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """(N,H,W,C), (7,7,C,3), (3,) -> tanh(conv(reflect_pad(x, 3)) + b)."""
    x32 = x.float().permute(0, 3, 1, 2)
    w32 = w.to(x.dtype).float().permute(3, 2, 0, 1)
    y = F.conv2d(F.pad(x32, (3, 3, 3, 3), mode="reflect"), w32, b.float())
    return torch.tanh(y).permute(0, 2, 3, 1).to(x.dtype).contiguous()


def route(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel that takes ``x``: ``"tensor_core"`` (bf16, C in 16, 32,
    64) or ``"cuda_core"`` (fp32). Raise on anything neither takes. Reads
    only shapes and dtypes, so it answers for tensors on any device."""
    if x.dim() != 4:
        raise ValueError(f"expected NHWC (N,H,W,C), got shape {tuple(x.shape)}")
    n, h, wd, c = x.shape
    if tuple(w.shape) != (_K, _K, c, 3) or tuple(b.shape) != (3,):
        raise ValueError(f"expected w (7,7,{c},3) and b (3,), got "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    if h <= 3 or wd <= 3:
        raise ValueError(f"reflect padding 3 needs H, W > 3, got {h}x{wd}")
    if x.dtype == torch.bfloat16:
        if c not in (16, 32, 64):
            raise ValueError(f"the bf16 tail kernel takes C in (16, 32, 64), "
                             f"got C={c}")
        return "tensor_core"
    if x.dtype == torch.float32:
        if c % 4:
            raise ValueError(f"the fp32 tail kernel needs C % 4 == 0, got {c}")
        if _smem_layout(c)[1] > _SMEM_LIMIT:
            raise ValueError(f"C={c} needs more shared memory than a block "
                             f"has ({_SMEM_LIMIT} bytes)")
        return "cuda_core"
    raise TypeError(f"unsupported dtype {x.dtype} (float32 or bfloat16)")


def _smem_layout(c: int):
    """fp32 route: (pix_stride, smem_bytes). A pixel's channels take
    ``c / 4`` 16-byte words, padded to an odd count so that neighbouring
    pixels fall in different shared-memory banks; the weights follow as
    one float4 per (tap, channel)."""
    words = c // 4
    pix_stride = words if words % 2 else words + 1
    return pix_stride, 16 * (_WIN * _WIN * pix_stride + _K * _K * c)


def tc_layout(c: int):
    """bf16 route: (tile rows, pixel stride in 16-byte words, smem bytes).
    A pixel's ``c / 8`` words are padded to an odd count, so the 8 rows of
    an ldmatrix phase (8 neighbouring pixels) hit distinct bank groups.
    The (rows + 6) x 38 window is followed by each warp's fp32 partials of
    the tile, 12 bytes a pixel. The tile takes 16 rows where two blocks
    fit one SM, else 8."""
    for th in _TC_ROWS:
        smem = tc_smem(c, th)
        if 2 * (smem + _BLOCK_RESERVED) <= _SM_SMEM:
            return th, c // 8 + 1, smem
    raise ValueError(f"no tile of the bf16 tail kernel fits C={c}")


def tc_smem(c: int, th: int) -> int:
    """Shared memory of a bf16-route block of ``th`` output rows."""
    return 16 * (th + _K - 1) * _TC_WIN_W * (c // 8 + 1) + \
        _K * th * _TC_TW * 12


def pack_fragments(w: torch.Tensor) -> torch.Tensor:
    """(7,7,C,3) HWIO -> (7 kw, 4 pairs, C/16 k-steps, 32 lanes, 4) bf16:
    the B fragments of ``mma.m16n8k16`` for each (kw, kh pair, k-step).
    Column n of pair p is output n % 4 of tap kh = 2p + n // 4 (zero for
    output 3 and for kh 7); lane l holds rows 2t, 2t+1, 2t+8, 2t+9 (t =
    l % 4, channels of the k-step) of column l // 4."""
    c = w.shape[2]
    wp = torch.zeros((2 * _PAIRS, _K, c, 4), dtype=torch.float32,
                     device=w.device)
    wp[:_K, :, :, :3] = w.float()
    # [pair][half][kw][c][o] -> [kw][pair][c][n = 4 * half + o]
    bm = wp.view(_PAIRS, 2, _K, c, 4).permute(2, 0, 3, 1, 4).reshape(
        _K, _PAIRS, c // 16, 16, 8)
    t = torch.arange(4, device=w.device)
    rows = torch.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], 1)  # [t][j]
    frag = bm[:, :, :, rows, :]              # [kw][p][ks][t][j][n]
    frag = frag.permute(0, 1, 2, 5, 3, 4)    # [kw][p][ks][n = g][t][j]
    return frag.reshape(_K, _PAIRS, c // 16, 32, 4).to(
        torch.bfloat16).contiguous()


def _pack(w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype):
    w, b = w.detach(), b.detach()  # no graph back to the kept weight
    with torch.inference_mode(False):
        if dtype == torch.bfloat16:
            wk = pack_fragments(w.to(dtype))
        else:  # one float4 (o0, o1, o2, 0) per (tap, channel)
            wk = F.pad(w.float().reshape(-1, 3), (0, 1)).contiguous()
        return wk, b.float().contiguous()


# weight's base tensor -> (its version, bias, bias version, dtype, packing)
_kept = WeakIdKeyDictionary()


def packed(w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype):
    """(packed weight, fp32 bias) for the route of ``dtype``, built once
    and kept, keyed on the weight's base tensor, its version counter, the
    bias and its version, and the dtype, so that a serving frame repacks
    nothing. Inference tensors have no version counter: theirs is packed
    on every call. Made outside inference mode, so that a later train step
    may use them."""
    base = w if w._base is None else w._base
    if base.is_inference() or b.is_inference():
        return _pack(w, b, dtype)
    kept = _kept.get(base)
    if (kept is None or kept[0] != w._version or kept[1] is not b
            or kept[2] != b._version or kept[3] != dtype):
        kept = (w._version, b, b._version, dtype, _pack(w, b, dtype))
        _kept[base] = kept
    return kept[4]


def tail_fused_cuda(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel of ``x``'s route; raise on anything it does not
    take."""
    global launches
    kind = route(x, w, b)
    if not (x.is_cuda and w.is_cuda and b.is_cuda):
        raise ValueError("tail_fused_cuda needs CUDA tensors")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous NHWC memory, 16-byte aligned")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError("the tail kernel is inference-only")
    n, h, wd, c = x.shape
    wk, b32 = packed(w, b, x.dtype)
    y = torch.empty((n, h, wd, 3), device=x.device, dtype=x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if kind == "tensor_core":
        th, _, smem = tc_layout(c)
        code = _build.lib().ir2rgb_tail_fused_tc(
            x.data_ptr(), wk.data_ptr(), b32.data_ptr(), y.data_ptr(), n, h,
            wd, c, th, smem, stream)
    else:
        pix_stride, smem = _smem_layout(c)
        code = _build.lib().ir2rgb_tail_fused(
            x.data_ptr(), wk.data_ptr(), b32.data_ptr(), y.data_ptr(), n, h,
            wd, c, pix_stride, smem, stream)
    _build.check(code, f"tail_fused ({kind})")
    launches += 1
    return y


_OP = _build.define_op(
    "tail_fused(Tensor x, Tensor w, Tensor b) -> Tensor",
    tail_fused_reference, tail_fused_cuda,
    lambda x, w, b: x.new_empty(tuple(x.shape[:3]) + (3,)))


def tail_fused(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """The generator tail over NHWC ``x``. CPU tensors take the plain
    version; CUDA tensors the kernel (the op ``ir2rgb::tail_fused``).
    Inference only: the op has no gradient. Off the CPU, what no route
    takes is refused here, before any launch (also while a program is
    exported for the card)."""
    if x.device.type != "cpu":
        route(x, w, b)
    _build.check_device(x, "tail_fused")
    return _OP(x, w, b)
