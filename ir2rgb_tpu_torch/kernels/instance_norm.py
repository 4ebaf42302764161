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
  its backward is :class:`InstanceNormActBackward`: the backward wrapper,
  itself differentiable, so that B1 is differentiable twice (the gradient
  penalty of WGAN-GP differentiates D's input gradient). Its own
  derivative is that of the plain backward with mean and rstd taken as
  functions of x: the second derivative of
  :func:`instance_norm_act_reference`, as XLA differentiates the JAX
  package's reference twice;
- :func:`instance_norm_act_fn`: y only, differentiable; what the networks
  call;
- ``launches`` / ``bwd_launches``: how many times the wrappers launched
  the forward and the backward kernel;
- :func:`_plan` / :func:`plan_for`: the launch (channel group, cluster
  size, shared memory per block, route), sized by bytes and checked
  against the card.

All take and return NHWC tensors. The kernels read NHWC memory directly,
so ``x`` and the gradient must be contiguous in that order (a
channels-last NCHW tensor permuted to NHWC is).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Callable, NamedTuple, Tuple

import torch

from . import _build

INSTANCE_NORM_EPS = 1e-5
ACTS = {"none": 0, "relu": 1, "leaky_relu": 2, "tanh": 3}

launches = 0
bwd_launches = 0

_SMEM_OPTIN = 232_448   # shared memory one block may opt into on sm_90
_KS = (1, 2, 4, 8, 16)  # blocks per cluster; above 8 is non-portable
_PER = 4                # channels a thread loads per pixel (one word)
# blocks a plan grows toward (the H100 has 132 SMs); the backward's tile
# holds x and g, and more, smaller blocks pay (ir2rgb_tpu_torch/sweep_b1.py)
_TARGET_BLOCKS = {"fwd": 64, "bwd": 128, "l2": 64}


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


def _stats(x: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, rstd) of NHWC ``x`` over H and W in fp32, differentiable."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2))
    var = (x32 - mean[:, None, None, :]).square().mean(dim=(1, 2))
    return mean, torch.rsqrt(var + eps)


def instance_norm_act_reference(x: torch.Tensor, act: str = "relu",
                                eps: float = INSTANCE_NORM_EPS,
                                negative_slope: float = 0.2
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """(N,H,W,C) -> (y in x.dtype, mean (N,C) fp32, rstd (N,C) fp32)."""
    mean, rstd = _stats(x, eps)
    y = (x.float() - mean[:, None, None, :]) * rstd[:, None, None, :]
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


class Plan(NamedTuple):
    """One B1 launch (either direction), as ``csrc/instance_norm.cu``
    reads it: ``n * groups`` slabs, each one image's pixels of one group
    of ``channels`` channels (``cg`` words of 4 channels a pixel), one
    cluster of ``k`` blocks a slab, ``share`` pixels a block."""
    cg: int           # words of a group at one pixel
    channels: int     # channels per group (the group width)
    k: int            # blocks per cluster
    share: int        # pixels per block (the last may hold fewer)
    groups: int       # channel groups per image
    smem_bytes: int   # dynamic shared memory per block
    route: str        # "smem": x (and g) read once; "l2": re-read from L2


def _make_plan(hw: int, c: int, itemsize: int, bwd: bool, cg: int, k: int,
               route: str) -> Plan:
    """The launch with these choices. Its shared memory is laid out as the
    kernel's ``smem_need``: the tile (x, and g in the backward), the
    column sums' scratch (one row per warp: 8 on the tile route's 256
    threads, 16 on the L2 route's 512), two float2 per channel."""
    streams = 2 if bwd else 1
    share = _ceil_div(hw, k)
    tile = share * cg * _PER * itemsize * streams if route == "smem" else 0
    warps = 8 if route == "smem" else 16
    smem = tile + warps * cg * _PER * streams * 4 + cg * _PER * 16
    return Plan(cg, cg * _PER, k, share, c // (cg * _PER), smem, route)


def _choices(hw: int, c: int, itemsize: int):
    """The group widths (words a pixel, widest first, at most 64 bytes)
    and the cluster sizes (powers of two whose every block holds pixels)
    a launch may take."""
    cgs = [cg for cg in (16, 8, 4, 2, 1)
           if (c // _PER) % cg == 0 and cg * _PER * itemsize <= 64]
    ks = [k for k in _KS if (k - 1) * _ceil_div(hw, k) < hw]
    return cgs, ks


def _plan(n: int, hw: int, c: int, itemsize: int, bwd: bool,
          clusters: Callable[[Plan], int] = lambda p: 1 << 30) -> Plan:
    """The launch of B1 for an (n, hw, c) tensor of ``itemsize`` bytes,
    sized by bytes: groups of at most 64 bytes a pixel, K the smallest
    that fits, doubled while the grid is short of its target of blocks
    (``_TARGET_BLOCKS``) or K is 16.

    Tile route: of the groups of at least 32 bytes whose slab (x, and g
    in the backward) fits in the shared memory of K <= 16 blocks and that
    reach the target, the widest (forward) or the one with the smallest K
    (backward); where none reaches it, the one with the most blocks. L2
    route, where no such slab fits: the widest group that reaches the
    target, else the one with the most blocks.

    ``clusters(plan)`` is the card's count of such clusters it can hold at
    once. A plan whose clusters all fit at once (one wave) is taken before
    any that runs in waves: a second wave waits for the first's whole
    cluster. A plan the card cannot run (0) is never taken. Without a
    card, any runs."""
    word = _PER * itemsize
    cgs, ks = _choices(hw, c, itemsize)

    def blocks(p: Plan) -> int:
        return n * p.groups * p.k

    for one_wave in (True, False):
        def pick(cg: int, route: str, target: int):
            ok = [p for p in (_make_plan(hw, c, itemsize, bwd, cg, k, route)
                              for k in ks)
                  if p.smem_bytes <= _SMEM_OPTIN and 0 < clusters(p)
                  and (not one_wave or n * p.groups <= clusters(p))]
            return next((p for p in ok if blocks(p) >= target),
                        ok[-1] if ok else None)

        target = _TARGET_BLOCKS["bwd" if bwd else "fwd"]
        tile = [p for p in (pick(cg, "smem", target) for cg in cgs
                            if cg * word >= 32) if p is not None]
        reach = [p for p in tile if blocks(p) >= target]
        if reach:
            # the forward takes the widest group, the backward the smallest
            # cluster (then the widest group): sweep_b1.py measured each best
            return min(reach, key=lambda p: p.k) if bwd else reach[0]
        if tile:
            return max(tile, key=blocks)
        target = _TARGET_BLOCKS["l2"]
        l2 = [p for p in (pick(cg, "l2", target) for cg in cgs)
              if p is not None]
        reach = [p for p in l2 if blocks(p) >= target]
        if l2:
            return reach[0] if reach else max(l2, key=blocks)
    raise ValueError(f"no B1 launch for (n={n}, hw={hw}, c={c}) on this "
                     "card")


@lru_cache(maxsize=None)
def max_clusters(p: Plan, bwd: bool, is_bf16: bool) -> int:
    """How many clusters of plan ``p`` the card holds at once (0: it
    cannot run one), from ``cudaOccupancyMaxActiveClusters``."""
    out = ctypes.c_int()
    _build.check(_build.lib().ir2rgb_instance_norm_max_clusters(
        p.k, int(p.route == "smem"), p.smem_bytes, int(bwd), int(is_bf16),
        ctypes.byref(out)), "instance_norm max clusters")
    return out.value


@lru_cache(maxsize=None)
def _card_plan(n: int, hw: int, c: int, is_bf16: bool, bwd: bool) -> Plan:
    return _plan(n, hw, c, 2 if is_bf16 else 4, bwd,
                 lambda p: max_clusters(p, bwd, is_bf16))


def plan_for(x: torch.Tensor, bwd: bool = False) -> Plan:
    """The plan a CUDA NHWC ``x`` launches with (queries the card)."""
    n, h, w, c = x.shape
    return _card_plan(n, h * w, c, x.dtype == torch.bfloat16, bwd)


def _check_nhwc(t: torch.Tensor, what: str) -> None:
    """Raise unless ``t`` is what the kernels read."""
    if not t.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor")
    if t.dim() != 4:
        raise ValueError(f"expected NHWC (N,H,W,C), got shape {tuple(t.shape)}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported dtype {t.dtype} (float32 or bfloat16)")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous NHWC memory")
    word = _PER * t.element_size()
    if t.shape[3] % _PER or t.data_ptr() % word:
        raise ValueError(f"C={t.shape[3]} must be a multiple of {_PER} and the "
                         f"tensor {word}-byte aligned for the kernel's "
                         f"{word}-byte loads")


def instance_norm_act_cuda(x: torch.Tensor, act: str = "relu",
                           eps: float = INSTANCE_NORM_EPS,
                           negative_slope: float = 0.2, plan: Plan = None):
    """Launch the forward kernel; raise on anything it does not take.
    ``plan`` replaces :func:`plan_for`'s (``sweep_b1`` times each)."""
    global launches
    _check_nhwc(x, "instance_norm_act_cuda")
    if act not in ACTS:
        raise ValueError(f"unknown act: {act}")
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("instance_norm_act_cuda does not record a graph; "
                         "call instance_norm_act_fn for a differentiable y")
    n, h, w, c = x.shape
    p = plan or plan_for(x)
    y = torch.empty_like(x)
    mean, rstd = torch.empty((2, n, c), device=x.device,
                             dtype=torch.float32).unbind(0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _build.lib().ir2rgb_instance_norm_act(
        x.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n,
        h * w, c, p.k, p.share, p.cg, int(p.route == "smem"), p.smem_bytes,
        ACTS[act], float(negative_slope), float(eps),
        int(x.dtype == torch.bfloat16), stream)
    _build.check(code, "instance_norm_act")
    launches += 1
    return y, mean, rstd


def instance_norm_act_bwd_cuda(x: torch.Tensor, mean: torch.Tensor,
                               rstd: torch.Tensor, g: torch.Tensor,
                               act: str = "relu", negative_slope: float = 0.2,
                               plan: Plan = None) -> torch.Tensor:
    """Launch the backward kernel; raise on anything it does not take.
    ``plan`` replaces :func:`plan_for`'s."""
    global bwd_launches
    _check_nhwc(x, "instance_norm_act_bwd_cuda")
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
    p = plan or plan_for(x, bwd=True)
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _build.lib().ir2rgb_instance_norm_act_bwd(
        x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        dx.data_ptr(), n, h * w, c, p.k, p.share, p.cg,
        int(p.route == "smem"), p.smem_bytes, ACTS[act],
        float(negative_slope), int(x.dtype == torch.bfloat16), stream)
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

    CPU tensors take the plain version; CUDA tensors the kernel. A ``g``
    the kernel cannot read (a view: a slice of a concat's gradient, or
    contiguous memory at an offset that breaks its word loads) is copied
    once to fresh contiguous memory."""
    if x.device.type == "cpu":
        return instance_norm_act_backward_reference(x, mean, rstd, g, act,
                                                    negative_slope)
    if not g.is_contiguous() or g.data_ptr() % (_PER * g.element_size()):
        g = g.clone(memory_format=torch.contiguous_format)
    return instance_norm_act_bwd_cuda(x, mean, rstd, g, act, negative_slope)


class InstanceNormActBackward(torch.autograd.Function):
    """dx = the B1 backward of (x, g) as a differentiable function of both
    (what the gradient penalty's second derivative runs through).

    Its forward is :func:`instance_norm_act_backward`: the backward kernel
    on the card, the plain version on the CPU. Its backward returns
    d(dx)/dx and d(dx)/dg for the incoming cotangent, from autograd of the
    plain backward on copies of x and g, with mean and rstd recomputed
    from x: their values are the saved ones (``saved + (m - m.detach())``),
    so every activation kink decides as the kernel did, and their
    derivatives are those of the statistics. This is PyTorch arithmetic:
    the JAX package computes this second derivative with XLA outside any
    Pallas kernel."""

    @staticmethod
    def forward(ctx, x, g, mean, rstd, act, negative_slope, eps):
        ctx.save_for_backward(x, g, mean, rstd)
        ctx.act, ctx.negative_slope, ctx.eps = act, negative_slope, eps
        return instance_norm_act_backward(x, mean, rstd, g, act,
                                          negative_slope)

    @staticmethod
    def backward(ctx, gg):
        x, g, mean, rstd = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            gd = g.detach().requires_grad_(True)
            m, r = _stats(xd, ctx.eps)
            dx = instance_norm_act_backward_reference(
                xd, mean + (m - m.detach()), rstd + (r - r.detach()), gd,
                ctx.act, ctx.negative_slope)
            d_x, d_g = torch.autograd.grad(dx, (xd, gd), gg)
        return d_x, d_g, None, None, None, None, None


class InstanceNormAct(torch.autograd.Function):
    """y = act(instance_norm(x)) with the B1 kernels both ways; its
    backward is differentiable (:class:`InstanceNormActBackward`)."""

    @staticmethod
    def forward(ctx, x, act, eps, negative_slope):
        y, mean, rstd = instance_norm_act(x, act, eps, negative_slope)
        ctx.save_for_backward(x, mean, rstd)
        ctx.act, ctx.negative_slope, ctx.eps = act, negative_slope, eps
        return y

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd = ctx.saved_tensors
        dx = InstanceNormActBackward.apply(x, g, mean, rstd, ctx.act,
                                           ctx.negative_slope, ctx.eps)
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
