"""Core NN ops on NHWC tensors — the port of ``ir2rgb_tpu/nn/ops.py``.

Every function takes and returns NHWC tensors, the JAX package's layout.
``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is a channels-last
NCHW view, which is what the PyTorch convolutions receive, and their
channels-last output permutes back to contiguous NHWC for free. Weights
keep PyTorch's layouts (Conv2d OIHW, ConvTranspose2d IOHW), so a module's
``state_dict`` is the reference family's.

Convolutions are plain ``F.conv2d``: the JAX package left them to XLA
outside any Pallas kernel. Under a quantized serving mode
(``nn/quant.py``: ``quant.using``, set by ``GanModel.generate``) a conv
the mode quantizes computes through ``quant.conv`` instead, and its bias
is added after the rescale, as the JAX package adds it. A stride-2
transposed conv whose geometry the subpixel plan admits takes the JAX
package's default ``subpixel`` lowering (``ops.py:193-292``): a dense
conv to 4·cout phase channels, then the depth-to-space of kernel B3
(``kernels.d2s_fn``), then the bias. Instance norm goes to kernel B1
(``kernels.fused_instance_norm_act``). Both kernels are differentiable.
Batch norm, the pads, the resizes and dropout are plain PyTorch, as the
JAX package computes them outside any Pallas kernel. Inside a
data-parallel step (``parallel/mesh.py``: ``sharded``) a dropout mask is
drawn at the global batch's shape and sliced to the rank's rows, and
batch norm takes its statistics over the global batch.

While a frame is served or trained with its rows spread over several
ranks (``parallel/spatial.py``: ``spatial.active()``), each op computes
this rank's rows of the whole frame's result: a conv or a pool splits
its output's global rows over the ranks (``spatial.conv_windows``: the
discriminator's 4×4 convs give uneven shards, and a rank may own none),
takes the window of input rows those read (``Shards.window``, mapped by
its edge rule at the global image edge, whatever partition the input
has) and runs with its H padding 0; a transposed conv takes the window
its output rows read (the subpixel route's output twice its input's
partition, any other geometry's split by ``spatial.bounds``), a bilinear
resize the window its rows of the H weight read; a pad takes the rows
above and below its own (``Shards.halo``) and returns the extended rows,
which the next conv takes as they are. Each output is tagged with its
partition (``Shards.tag``). A rank with no output rows runs the op on k
zero rows and keeps none, so that every rank records the same graph and
makes the same exchanges. The
halos are differentiable: their backward is the exchange's transpose.
Instance norm runs B1 split (:class:`_SplitInstanceNormAct`): this
rank's statistics (``kernels.instance_norm_stats``), the ranks' merged
with a count a rank (``Shards.norm_stats``), then
``kernels.instance_norm_apply``; its backward the split backward's sums
(``instance_norm_bwd_stats``, one (2, N, C) buffer), added over the ranks
in rank order, then
``instance_norm_bwd_apply``, itself differentiable for WGAN-GP's
second derivative (:class:`_SplitInstanceNormActBackward`, as the halo's
transpose is). Batch norm takes the moments over every rank; a dropout
mask is this rank's rows of the global draw. A 2×2 max pool needs even
local rows. A quantized conv runs its mode on the window (``int8_w`` the
dequantized weight; ``int8`` the scale of the rows every rank owns,
merged over the mesh, ``quant.act_scale``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ir2rgb_tpu_torch.kernels import d2s_fn, fused_instance_norm_act
from ir2rgb_tpu_torch.kernels.instance_norm import (
    instance_norm_apply,
    instance_norm_bwd_apply,
    instance_norm_bwd_apply_reference,
    instance_norm_bwd_stats,
    instance_norm_bwd_stats_reference,
    instance_norm_stats,
)
from ir2rgb_tpu_torch.parallel import mesh as pmesh
from ir2rgb_tpu_torch.parallel import spatial
from . import quant
# eps 1e-5 (torch InstanceNorm2d's) and the activations live with B1
from ir2rgb_tpu_torch.kernels.instance_norm import INSTANCE_NORM_EPS
from ir2rgb_tpu_torch.kernels.instance_norm import apply_act as _apply_act

INIT_STD = 0.02  # reference weights_init: N(0, 0.02)
BATCH_NORM_EPS = 1e-5


def _kept_index(fn):
    """``fn`` (an index tensor from ints and a device) computed once per
    arguments and kept. While a program is exported (``infer/export.py``)
    a kept index is read, and enters the program as a constant (the
    exporter serves one frame first, which keeps every index the trace
    asks for), but none is kept: a tensor made there is a fake one of the
    trace, and the program computes it itself."""
    kept = {}

    def get(*args):
        out = kept.get(args)
        if out is None:
            out = fn(*args)
            if not torch.compiler.is_exporting():
                kept[args] = out
        return out
    get.__doc__ = fn.__doc__
    get.cache_clear = kept.clear
    return get


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


def apply_act(y: torch.Tensor, act: str,
              negative_slope: float = 0.2) -> torch.Tensor:
    """relu / leaky_relu / tanh / none of ``y`` (B1's activations), with
    ``y``'s partition on a partitioned frame."""
    return spatial.same_rows(_apply_act(y, act, negative_slope), y)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    # free when y is channels-last (what a channels-last input produces)
    return y.permute(0, 2, 3, 1).contiguous()


def conv(x: torch.Tensor, weight: torch.Tensor,
         bias: Optional[torch.Tensor] = None, stride: int = 1,
         padding: int = 0) -> torch.Tensor:
    """NHWC conv (cross-correlation) with an OIHW weight, computed in x's
    dtype (quantized as the serving mode says, ``nn/quant.py``)."""
    m = quant.mode_for(weight.shape[1], weight.shape[0])
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    part = spatial.active()
    if part is None:
        if m == "none":
            return _nhwc(F.conv2d(_nchw(x), w, b, stride=stride,
                                  padding=padding))
        y = quant.conv(x, w, m, stride, padding, source=(weight, "conv"))
        return y if b is None else y + b
    k = weight.shape[2]
    # int8's scale spans the rows every rank owns, before any window
    sx = quant.act_scale(part.own_rows(x)) if m == "int8" else None
    rows, out = _conv_rows(part, x, k, stride, padding)
    if m == "none":
        def op(t):
            return _nhwc(F.conv2d(_nchw(t), w, b, stride=stride,
                                  padding=(0, padding)))
    else:
        def op(t):
            y = quant.conv(t, w, m, stride, ((0, 0), (padding, padding)),
                           source=(weight, "conv"), scale=sx)
            return y if b is None else y + b
    return part.tag(_on_rows(rows, k, op), out)


def _conv_rows(part, x: torch.Tensor, k: int, stride: int, padding: int):
    """(the rows a k x k conv with zero padding ``padding`` reads for this
    rank's output rows, the global edge's zero rows included; the
    output's partition). The conv then pads W alone. Rows a pad extended
    (``Shards.mark``) are taken as they are, by a stride-1 conv without
    padding that they fit: its output keeps the pad's input's
    partition."""
    ext = part.extension(x)
    if ext is not None:
        if stride != 1 or padding or sum(ext) != k - 1:
            raise ValueError(f"conv k{k} s{stride} p{padding} on rows "
                             f"extended by {ext}: a pad feeds a stride-1 "
                             "conv that it fits")
        return x, part.bounds(x)
    out, wins = spatial.conv_windows(part.bounds(x), k, stride, padding)
    return part.window(x, wins, "zero"), out


def _on_rows(rows: torch.Tensor, k: int, op) -> torch.Tensor:
    """``op`` (a k-row window op with its H padding 0) of a window of
    ``rows``; a rank that owns no output rows has an empty window and
    runs ``op`` on k zero rows, keeping none of the result, so that its
    graph (the window's exchange, the op's weights) is every rank's."""
    if rows.shape[1] >= k:
        return op(rows)
    short = k - rows.shape[1]
    y = op(F.pad(rows, (0, 0, 0, 0, 0, short)))
    return y[:, :0]


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


@_kept_index
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
    not admit (as in the JAX package): ``F.conv_transpose2d``.

    Under a quantized serving mode each route quantizes the conv it runs
    (``nn/quant.py``): the subpixel route the rearranged weight (its
    4·cout outputs are what ``int8_mixed`` gates on and what the weight
    scales are per), the dilated route the flipped forward-conv weight
    over the zero-dilated input; the bias comes last, as in "none".

    On a partitioned frame each route computes this rank's output rows
    from the window of input rows they read (``Shards.window``, zeros
    past the global edge). The subpixel route's output is twice its
    input's partition where it emits exactly 2·H (a rank of no rows runs
    the conv on kk zero rows and keeps none), else the output's global
    rows split by ``spatial.bounds``, each rank's phase rows trimmed to
    its own. The dilated route splits its output so: k4 p1 op1 gives
    2·H + 1 rows, uneven shards by construction."""
    b = None if bias is None else bias.to(x.dtype)
    ci, co, k, _ = weight.shape
    if lowering not in ("subpixel", "dilated"):
        raise ValueError(f"unknown deconv lowering: {lowering!r}")
    part = spatial.active()
    if not (lowering == "subpixel"
            and subpixel_admits(k, padding, output_padding)):
        return _deconv_dilated(part, x, weight, b, padding, output_padding)
    if wk is None:
        wk = subpixel_weight(weight.to(x.dtype), padding)
    _, kk, omin = _subpixel_plan(k, padding)
    lo, hi = -omin, kk - 1 + omin
    m = quant.mode_for(ci, 4 * co)
    _, h, w, _ = x.shape
    out_w = (w - 1) * 2 - 2 * padding + k + output_padding
    if part is None:
        out_h = (h - 1) * 2 - 2 * padding + k + output_padding
        xp = F.pad(x, (0, 0, lo, hi, lo, hi))
        y = (_nhwc(F.conv2d(_nchw(xp), wk)) if m == "none" else quant.conv(
            xp, wk, m, source=(weight, ("subpixel", padding))))
        y = d2s_fn(y, co)
        if out_h != 2 * h or out_w != 2 * w:
            y = y[:, :out_h, :out_w, :]
        return y if b is None else y + b
    # int8's scale spans the rows every rank owns
    sx = quant.act_scale(part.own_rows(x)) if m == "int8" else None
    src = part.bounds(x)
    g = src[-1]
    out_h = (g - 1) * 2 - 2 * padding + k + output_padding
    out = (tuple(2 * r for r in src) if out_h == 2 * g
           else spatial.bounds(out_h, part.sp))
    # output rows [o0, o1) are phase rows [o0 // 2, ⌈o1 / 2⌉), which read
    # the input rows lo above and hi below them
    wins = []
    for q in range(part.sp):
        o0, o1 = out[q], out[q + 1]
        wins.append((o0 // 2 - lo, (o1 + 1) // 2 + hi) if o1 > o0
                    else (o0 // 2, o0 // 2))
    rows = part.window(x, wins, "zero")

    def op(t):
        t = F.pad(t, (0, 0, lo, hi))
        return (_nhwc(F.conv2d(_nchw(t), wk)) if m == "none" else quant.conv(
            t, wk, m, source=(weight, ("subpixel", padding)), scale=sx))
    y = d2s_fn(_on_rows(rows, kk, op), co)
    o0, o1 = out[part.rank], out[part.rank + 1]
    first = 2 * (o0 // 2)
    if o0 != first or o1 - o0 != y.shape[1] or out_w != 2 * w:
        y = y[:, o0 - first:o1 - first, :out_w, :]
    y = y if b is None else y + b
    return part.tag(y, out)


def _deconv_dilated(part, x: torch.Tensor, weight: torch.Tensor,
                    b: Optional[torch.Tensor], padding: int,
                    output_padding: int) -> torch.Tensor:
    """:func:`deconv`'s dilated route: ``F.conv_transpose2d`` (with the
    bias ``b``), or the quantized conv of the flipped weight over the
    zero-dilated input, then ``b``. On a partitioned frame the output's
    global rows split by ``spatial.bounds``; output row m = 2i + a -
    padding (tap a) reads input rows ⌈(m + padding - k + 1) / 2⌉ ..
    ⌊(m + padding) / 2⌋, so each rank runs the full transposed conv (H
    padding 0) of its window of those rows and keeps its own."""
    ci, co, k, _ = weight.shape
    m = quant.mode_for(ci, co)
    w = weight.to(x.dtype)
    lo = k - 1 - padding
    if m != "none":
        wf = w.permute(1, 0, 2, 3).flip(2, 3)
    if part is None:
        if m == "none":
            return _nhwc(F.conv_transpose2d(_nchw(x), w, b, stride=2,
                                            padding=padding,
                                            output_padding=output_padding))
        y = quant.conv(x, wf, m, 1, ((lo, lo + output_padding),) * 2,
                       lhs_dilation=2, source=(weight, "dilated"))
        return y if b is None else y + b
    sx = quant.act_scale(part.own_rows(x)) if m == "int8" else None
    g = part.bounds(x)[-1]
    out = spatial.bounds((g - 1) * 2 - 2 * padding + k + output_padding,
                         part.sp)
    wins = []
    for q in range(part.sp):
        o0, o1 = out[q], out[q + 1]
        i0 = -((k - 1 - o0 - padding) // 2)
        wins.append((i0, (o1 - 1 + padding) // 2 + 1) if o1 > o0
                    else (i0, i0))
    rows = part.window(x, wins, "zero")
    if m == "none":
        def op(t):
            return _nhwc(F.conv_transpose2d(
                _nchw(t), w, b, stride=2, padding=(0, padding),
                output_padding=(0, output_padding)))
    else:
        def op(t):
            y = quant.conv(t, wf, m, 1, ((k - 1, k - 1),
                                         (lo, lo + output_padding)),
                           lhs_dilation=2, source=(weight, "dilated"),
                           scale=sx)
            return y if b is None else y + b
    o0, o1 = out[part.rank], out[part.rank + 1]
    top = o0 - 2 * wins[part.rank][0] + padding
    y = _on_rows(rows, 1, op)[:, top:top + o1 - o0]
    return part.tag(y, out)


@_kept_index
def _reflect_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    # a normal tensor even when first asked for in inference mode, so that
    # a later training step may save it for backward
    with torch.inference_mode(False):
        i = torch.arange(-pad, n + pad, device="cpu").abs()
        return torch.where(i > n - 1, 2 * (n - 1) - i, i).to(device)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """torch ReflectionPad2d over H and W of NHWC ``x``; the result is
    contiguous NHWC. On a partitioned frame the H side comes from the
    halo, mirrored at the global edge."""
    return _pad(x, pad, "reflect", _reflect_index)


def _pad(x: torch.Tensor, pad: int, mode: str, index) -> torch.Tensor:
    _, h, w, _ = x.shape
    part = spatial.active()
    if part is None:
        x = x.index_select(1, index(h, pad, x.device))
        return x.index_select(2, index(w, pad, x.device))
    src = part.bounds(x)
    x = part.halo(x, pad, pad, mode).index_select(2, index(w, pad, x.device))
    return part.mark(x, pad, pad, src)


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
    part = spatial.active()
    if part is None:
        y = F.avg_pool2d(_nchw(x.float()).contiguous(), window, stride, pad,
                         count_include_pad=count_include_pad)
        return _nhwc(y).to(x.dtype)
    # this rank's output rows from its window's; where the global edge's
    # pad rows (zeros here) fall in a window, count_include_pad=False
    # divides by the real rows alone: the interior divisor stays whole
    src = part.bounds(x)
    g = src[-1]
    out, wins = spatial.conv_windows(src, window, stride, pad)
    x32 = x.float()
    ext = part.window(part.same_rows(x32, x), wins, "zero")
    y = _on_rows(ext, window, lambda t: _nhwc(F.avg_pool2d(
        _nchw(t).contiguous(), window, stride, (0, pad),
        count_include_pad=count_include_pad)))
    if not count_include_pad and y.shape[1]:
        first = wins[part.rank][0]  # global row of the window's first row
        real = [sum(0 <= first + stride * i + j < g for j in range(window))
                for i in range(y.shape[1])]
        if min(real) < window:
            y = y * torch.tensor([window / r for r in real],
                                 device=y.device)[:, None, None]
    return part.tag(y.to(x.dtype), out)


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool over NHWC ``x`` (the VGG trunk's pools). On a
    partitioned frame it is row-local: every rank's rows must start and
    end on even global rows."""
    part = spatial.active()
    y = _nhwc(F.max_pool2d(_nchw(x), 2, 2))
    if part is None:
        return y
    src = part.bounds(x)
    if any(r % 2 for r in src):
        raise ValueError(f"max_pool 2x2 at {tuple(x.shape)}: the rows "
                         f"{src} of sp = {part.sp} ranks must start and end "
                         "on even rows")
    return part.tag(y, tuple(r // 2 for r in src))


def replicate_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """torch ReplicationPad2d (``jnp.pad`` mode "edge") over H and W of
    NHWC ``x``; on a partitioned frame, as :func:`reflect_pad`."""
    return _pad(x, pad, "edge", _edge_index)


@_kept_index
def _edge_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):  # see _reflect_index
        return torch.arange(-pad, n + pad).clamp(0, n - 1).to(device)


def resize_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of NHWC ``x`` by an integer factor (torch
    Upsample(mode="nearest")): each pixel repeated ``scale`` x ``scale``."""
    n, h, w, c = x.shape
    y = x[:, :, None, :, None, :].expand(n, h, scale, w, scale, c
                                         ).reshape(n, h * scale, w * scale, c)
    part = spatial.active()
    if part is not None:
        part.tag(y, tuple(scale * r for r in part.bounds(x)))
    return y


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = False
                    ) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to ``out_hw``, computed in fp32, the
    result in x's dtype. ``align_corners=False``: half-pixel centres, the
    triangle kernel widened when shrinking (``jax.image.resize``'s
    "linear", torch's ``antialias=True``); ``True``: the end pixels map
    to the end pixels, no widening.

    On a partitioned frame the output's rows split by ``spatial.bounds``:
    each rank takes the window of source rows that its rows of the H
    weight (:func:`_resize_rows`) read, resizes W with ``F.interpolate``,
    then H by those weights."""
    part = spatial.active()
    if part is None:
        y = F.interpolate(_nchw(x.float()).contiguous(), size=tuple(out_hw),
                          mode="bilinear", align_corners=align_corners,
                          antialias=not align_corners)
        return _nhwc(y).to(x.dtype)
    g = part.bounds(x)[-1]
    out, wins = _resize_windows(g, out_hw[0], align_corners, part.sp)
    ext = part.window(part.same_rows(x.float(), x), wins, "edge")
    o0, o1 = out[part.rank], out[part.rank + 1]
    j0 = wins[part.rank][0]
    if ext.shape[1]:
        ext = _nhwc(F.interpolate(
            _nchw(ext).contiguous(), size=(ext.shape[1], out_hw[1]),
            mode="bilinear", align_corners=align_corners,
            antialias=not align_corners))
    else:  # no rows: still the window's graph, as every rank's
        ext = ext[:, :, :1].expand(-1, -1, out_hw[1], -1)
    wt = _resize_rows(g, out_hw[0], align_corners, x.device)[
        o0:o1, j0:j0 + ext.shape[1]]
    y = torch.einsum("oj,njwc->nowc", wt, ext)
    return part.tag(y.to(x.dtype), out)


@lru_cache(maxsize=None)
def _resize_weight(n_in: int, n_out: int, align_corners: bool
                   ) -> torch.Tensor:
    """(n_out, n_in) float64 weights of torch's bilinear resize along one
    axis (``antialias`` where not ``align_corners``, as
    :func:`resize_bilinear`): the resize of an identity, two columns wide
    (torch 2.x's antialiased resize of a one-column image is not the
    bilinear one)."""
    with torch.inference_mode(False):  # see _reflect_index
        eye = torch.eye(n_in, dtype=torch.float64).reshape(
            n_in, 1, n_in, 1).expand(n_in, 1, n_in, 2).contiguous()
        wt = F.interpolate(eye, size=(n_out, 2), mode="bilinear",
                           align_corners=align_corners,
                           antialias=not align_corners)
        return wt[..., 0].reshape(n_in, n_out).T.contiguous()


@_kept_index
def _resize_rows(n_in: int, n_out: int, align_corners: bool,
                 device: torch.device) -> torch.Tensor:
    """:func:`_resize_weight` in float32 on ``device``."""
    with torch.inference_mode(False):  # see _reflect_index
        return _resize_weight(n_in, n_out, align_corners).to(
            device, torch.float32)


@lru_cache(maxsize=None)
def _resize_windows(n_in: int, n_out: int, align_corners: bool, sp: int):
    """(the output partition, each rank's window of source rows: those
    its rows of :func:`_resize_weight` read; empty for no rows)."""
    wt = _resize_weight(n_in, n_out, align_corners)
    out = spatial.bounds(n_out, sp)
    wins = []
    for q in range(sp):
        cols = wt[out[q]:out[q + 1]].abs().sum(dim=0).nonzero()
        wins.append((int(cols[0]), int(cols[-1]) + 1) if cols.numel()
                    else (0, 0))
    return out, tuple(wins)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator
            ) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 - ``rate``
    (a uniform draw from ``generator``, on its device) and scaled by
    1 / (1 - rate), the rest 0. Its bits are the port's own; the JAX
    package draws from its key."""
    part = spatial.active()
    rows = None if part is None else part.bounds(x)
    return apply_dropout(x, dropout_mask(x.shape, rate, generator, rows),
                         rate)


def dropout_mask(shape, rate: float, generator: torch.Generator,
                 rows: Optional[tuple] = None) -> torch.Tensor:
    """:func:`dropout`'s draw alone: the bool mask of kept elements, on
    ``generator``'s device (in a data-parallel step, this rank's rows of
    the global batch's draw; on a partitioned frame, its image rows of
    the whole frame's draw too: ``rows`` the activation's partition,
    ``Shards.bounds``, by default an even split)."""
    shape = tuple(shape)
    part = spatial.active()
    if part is not None:
        if rows is None:
            rows = tuple(q * shape[1] for q in range(part.sp + 1))
        lo, hi = rows[part.rank], rows[part.rank + 1]
        shape = (shape[0], rows[-1]) + shape[2:]
    u = pmesh.draw(lambda n: torch.rand((n,) + shape[1:],
                                        generator=generator,
                                        device=generator.device), shape[0])
    if part is not None:
        u = u[:, lo:hi]
    return u < 1.0 - rate


def apply_dropout(x: torch.Tensor, mask: torch.Tensor, rate: float
                  ) -> torch.Tensor:
    """:func:`dropout` with its mask given; the result keeps ``x``'s
    partition on a partitioned frame."""
    keep = 1.0 - rate
    return spatial.same_rows(
        torch.where(mask.to(x.device), x / keep, 0.0).to(x.dtype), x)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = BATCH_NORM_EPS,
               running_mean: Optional[torch.Tensor] = None,
               running_var: Optional[torch.Tensor] = None,
               use_running_stats: bool = False) -> torch.Tensor:
    """Batch norm over (N, H, W) of NHWC ``x``, fp32 statistics, then
    gamma (``weight``) and beta (``bias``); the result in x's dtype.

    Batch statistics by default, as the JAX package (``ops.py:351-371``)
    and the reference family at test time compute it (over every rank's
    rows in a data-parallel step, ``pmesh.batch_moments``, as JAX's mean
    over a sharded batch); with ``use_running_stats`` (and running stats
    given) the stored ones, ``model.eval()``'s semantics. Written out, so
    that no running stat is ever updated."""
    x32 = x.float()
    dp = pmesh.active()
    if use_running_stats and running_mean is not None:
        mean, var = running_mean.float(), running_var.float()
    elif dp is not None:
        part = spatial.active()
        count = None if part is None else float(
            x.shape[0] * dp.dp * part.global_rows(x) * x.shape[2])
        mean, var = pmesh.batch_moments(x32, dp, count)
    else:
        mean = x32.mean(dim=(0, 1, 2))
        var = (x32 - mean).square().mean(dim=(0, 1, 2))
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def _split_forward(part, x: torch.Tensor, act: str, negative_slope: float):
    """(y, mean, rstd, pixels a channel over every rank) of the split B1:
    B1's statistics of this rank's rows (none on a rank without rows),
    the ranks' merged in rank order with a count a rank, then B1's
    apply."""
    n, h, w, c = x.shape
    counts = [r * w for r in part.counts(x)]
    if h * w:
        mean, m2 = instance_norm_stats(x)
    else:
        mean = m2 = x.new_zeros((n, c), dtype=torch.float32)
    mean, rstd = part.norm_stats(mean, m2, counts, INSTANCE_NORM_EPS)
    mean, rstd = mean.contiguous(), rstd.contiguous()
    y = (instance_norm_apply(x, mean, rstd, act, negative_slope) if h * w
         else torch.empty_like(x))
    return y, mean, rstd, sum(counts)


class _SplitInstanceNormAct(torch.autograd.Function):
    """The split B1 under autograd. Forward: :func:`_split_forward`,
    saving x and the merged (mean, rstd). Backward: the split backward
    (:class:`_SplitInstanceNormActBackward`), differentiable once more."""

    @staticmethod
    def forward(ctx, x, part, act, negative_slope):
        y, mean, rstd, count = _split_forward(part, x, act, negative_slope)
        ctx.save_for_backward(x, mean, rstd)
        ctx.part, ctx.act, ctx.slope, ctx.count = (part, act,
                                                   negative_slope, count)
        return y

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd = ctx.saved_tensors
        dx = _SplitInstanceNormActBackward.apply(
            x, g, mean, rstd, ctx.part, ctx.act, ctx.slope, ctx.count)
        return dx, None, None, None


class _SplitInstanceNormActBackward(torch.autograd.Function):
    """dx of the split B1 as a differentiable function of this rank's x
    and g (what WGAN-GP's second derivative runs through).

    Forward: this rank's sums of g' and g' * xh
    (``instance_norm_bwd_stats``; zeros on a rank without rows), the
    ranks' added in rank order (``Shards.sum_stats``: every rank the same
    bits), then ``instance_norm_bwd_apply`` with the frame's pixel count:
    together the JAX package's ``_fused_bwd`` over the whole frame.

    Backward: autograd of the plain split backward on copies of x and g,
    as ``kernels.instance_norm.InstanceNormActBackward`` does for the
    fused B1. Mean and rstd are recomputed from x over the whole frame
    (this rank's sums, then a differentiable sum over the ranks,
    ``Shards.sum_over_ranks``), and so are the sums s1 and s2; each takes
    the forward's value (``saved + (t - t.detach())``), so every
    activation kink decides as the kernels did, and its derivative. A
    rank without rows adds zeros and makes every exchange. This is
    PyTorch arithmetic: the JAX package computes the second derivative
    with XLA outside any Pallas kernel."""

    @staticmethod
    def forward(ctx, x, g, mean, rstd, part, act, negative_slope, count):
        n, h, w, c = x.shape
        # this rank's (2, N, C) sums, s1 then s2, as the op writes them
        sums = (instance_norm_bwd_stats(x, mean, rstd, g, act,
                                        negative_slope)
                if h * w else mean.new_zeros((2, n, c)))
        both = part.sum_stats(sums)
        ctx.save_for_backward(x, g, mean, rstd, both)
        ctx.part, ctx.act, ctx.slope, ctx.count = (part, act,
                                                   negative_slope, count)
        if not h * w:
            return torch.zeros_like(x)
        return instance_norm_bwd_apply(x, mean, rstd, g, both[0], both[1],
                                       count, act, negative_slope)

    @staticmethod
    def backward(ctx, gg):
        x, g, mean, rstd, both = ctx.saved_tensors
        part, count = ctx.part, ctx.count

        def pinned(saved, t):
            return saved + (t - t.detach())
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            gd = g.detach().requires_grad_(True)
            x32 = xd.float()
            m = part.sum_over_ranks(x32.sum(dim=(1, 2))) / count
            var = part.sum_over_ranks((x32 - m[:, None, None, :]).square()
                                      .sum(dim=(1, 2))) / count
            m = pinned(mean, m)
            r = pinned(rstd, torch.rsqrt(var + INSTANCE_NORM_EPS))
            s = pinned(both, part.sum_over_ranks(
                instance_norm_bwd_stats_reference(xd, m, r, gd, ctx.act,
                                                  ctx.slope)))
            dx = instance_norm_bwd_apply_reference(
                xd, m, r, gd, s[0], s[1], count, ctx.act, ctx.slope)
            d_x, d_g = torch.autograd.grad(dx, (xd, gd), gg)
        return d_x, d_g, None, None, None, None, None, None


def _split_instance_norm_act(part, x: torch.Tensor, act: str,
                             negative_slope: float) -> torch.Tensor:
    """Instance norm + act over the whole frame of which ``x`` holds this
    rank's rows (differentiable where a graph is recorded); the output
    keeps ``x``'s partition."""
    if torch.is_grad_enabled() and x.requires_grad:
        y = _SplitInstanceNormAct.apply(x, part, act, negative_slope)
    else:
        y = _split_forward(part, x, act, negative_slope)[0]
    return part.same_rows(y, x)


def norm_act(x: torch.Tensor, norm: str, act: str = "relu",
             negative_slope: float = 0.2,
             bn: Optional[torch.nn.BatchNorm2d] = None) -> torch.Tensor:
    """Norm followed by activation — the generator hot pattern. Instance
    norm (fp32 statistics, eps 1e-5) runs fused in kernel B1; batch norm
    (batch statistics, the affine ``bn``'s gamma and beta) and ``none``
    apply the activation after, in plain PyTorch."""
    if norm == "instance":
        part = spatial.active()
        if part is None:
            return fused_instance_norm_act(x, act, negative_slope)
        return _split_instance_norm_act(part, x, act, negative_slope)
    if norm == "batch":
        x = spatial.same_rows(batch_norm(x, bn.weight, bn.bias, bn.eps), x)
    elif norm != "none":
        raise ValueError(f"unknown norm: {norm}")
    return apply_act(x, act, negative_slope)
