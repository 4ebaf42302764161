"""Fused instance norm + activation (kernel B1), forward and backward.

Port of ``ir2rgb_tpu/kernels/instance_norm.py``: ``_instance_norm_act_pallas``
and the custom VJP around it (``_fused_fwd`` / ``_fused_bwd``). The CUDA
kernels are in ``csrc/instance_norm.cu`` (its header says what bounds them
and how the design answers that); this module holds

- :func:`instance_norm_act_reference` and
  :func:`instance_norm_act_backward_reference`: plain PyTorch, fp32
  arithmetic, the CPU path and the yardsticks the kernels are held to;
- the custom ops ``ir2rgb::instance_norm_act`` and
  ``ir2rgb::instance_norm_act_bwd`` (``_build.define_op``): their CPU
  implementations are the plain versions, their CUDA implementations
  launch the kernels or raise, and their fake implementations give the
  outputs' shapes, so ``torch.export`` keeps each call as one node of
  the exported program (``infer/export.py``);
- :func:`instance_norm_act` and :func:`instance_norm_act_backward`: the
  wrappers, which call the ops (their implementations directly, outside
  an export: ``_build.define_op``). A CPU tensor takes the plain version; a
  CUDA tensor launches the kernel or raises;
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
- the split forward, for a frame whose rows lie on several ranks
  (``parallel/spatial.py`` merges the ranks' statistics between the
  two): :func:`instance_norm_stats` (the ops ``ir2rgb::instance_norm_stats``:
  each (n, c)'s mean and M2, the sum of squared deviations, over the rows
  in hand; a kernel of its own with two reduction levels, planned by
  :func:`_stats_plan`) and :func:`instance_norm_apply`
  (``ir2rgb::instance_norm_apply``: act((x - mean) * rstd) for given
  (N, C) statistics, one elementwise pass), with their plain versions
  :func:`instance_norm_stats_reference` and
  :func:`instance_norm_apply_reference`, and
  :func:`instance_norm_stats_chunked_reference`, the statistics kernel's
  chunks and merge order in plain PyTorch (for the tests). Neither
  records a graph: the split B1's autograd Function (``nn/ops.py``)
  calls them;
- the split backward, its counterpart under autograd:
  :func:`instance_norm_bwd_stats` (``ir2rgb::instance_norm_bwd_stats``:
  each (n, c)'s sums of g' and g' * xh over the rows in hand, for the
  merged statistics, in one (2, N, C) buffer; its own plan,
  :func:`_bwd_stats_plan`) and :func:`instance_norm_bwd_apply`
  (``ir2rgb::instance_norm_bwd_apply``: dx from the sums over every rank,
  one pass of a 16-byte lane a thread, :func:`_bwd_apply_plan`), with
  their plain versions :func:`instance_norm_bwd_stats_reference` and
  :func:`instance_norm_bwd_apply_reference`, and
  :func:`instance_norm_bwd_stats_chunked_reference`, the sums kernel's
  chunks and order in plain PyTorch (for the tests); the ranks add their
  sums in rank order between the two, and together they are
  ``_fused_bwd``;
- ``launches`` / ``bwd_launches`` / ``stats_launches`` /
  ``apply_launches`` / ``bwd_stats_launches`` / ``bwd_apply_launches``:
  how many times the ops' CUDA implementations launched each kernel;
- :func:`_plan` / :func:`plan_for`: the launch (channel group, cluster
  size, shared memory per block, route), sized by bytes and checked
  against the card; :func:`_stats_plan` / :func:`stats_plan_for`: the
  statistics kernel's (channel group, chunks a slab, pixels a chunk);
  :func:`_bwd_stats_plan` / :func:`bwd_stats_plan_for`: the split
  backward's sums (route, chunks a slab, cluster size).

All take and return NHWC tensors. The kernels read NHWC memory directly,
so ``x`` and the gradient must be contiguous in that order (a
channels-last NCHW tensor permuted to NHWC is).
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache
from typing import Callable, NamedTuple, Tuple

import torch

from . import _build

INSTANCE_NORM_EPS = 1e-5
ACTS = {"none": 0, "relu": 1, "leaky_relu": 2, "tanh": 3}

launches = 0
bwd_launches = 0
stats_launches = 0
apply_launches = 0
bwd_stats_launches = 0
bwd_apply_launches = 0

_SMEM_OPTIN = 232_448   # shared memory one block may opt into on sm_90
_KS = (1, 2, 4, 8, 16)  # blocks per cluster; above 8 is non-portable
_PER = 4                # channels a thread loads per pixel (one word)
# blocks a plan grows toward (the H100 has 132 SMs); the backward's tile
# holds x and g, and more, smaller blocks pay (ir2rgb_tpu_torch/sweep_b1.py)
_TARGET_BLOCKS = {"fwd": 64, "bwd": 128, "l2": 64}
# the statistics kernel (ir2rgb_tpu_torch/sweep_b1.py --stats): threads a
# block; loads a thread keeps in flight (kStatsBatch); partials a thread of
# a slab's last block merges a round (kMerge); the largest slab, in values
# (pixels x channels), that one block takes alone (one level)
_STATS_THREADS = 256
_STATS_BATCH = 8
_STATS_MERGE = 16
_STATS_ONE_LEVEL = 32768
# the split backward's sums kernel (ir2rgb_tpu_torch/sweep_b1.py
# --bwd-stats): the largest cluster (the card's non-portable 16), the
# blocks a launch of the cluster route aims at, and the most partials a
# slab the tickets route's last block adds without clusters
_BWD_CLUSTER_MAX = 16
_BWD_CLUSTER_BLOCKS = 64
_BWD_MERGE_MAX = 64


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


def instance_norm_stats_reference(x: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N,H,W,C) -> (mean (N,C), m2 (N,C)), fp32: the mean over H and W,
    then the sum of squared deviations about it (two passes, as
    :func:`_stats`)."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2))
    m2 = (x32 - mean[:, None, None, :]).square().sum(dim=(1, 2))
    return mean, m2


def instance_norm_stats_chunked_reference(x: torch.Tensor, plan: "StatsPlan"
                                          ) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(mean, m2) as the statistics kernel reduces under ``plan``, in
    plain fp32 PyTorch: each chunk's (mean, M2) of x less the image's
    first pixel (the shift; a two-pass here, where the kernel merges its
    threads' two-pass batches: another order), then the slab's mean from
    the chunks' count x mean and its M2 from each chunk's M2 moved to that
    mean (Chan's formula for many parts), each a plain sum in the last
    block's order: each of ``256 / channels`` threads of a channel adds a
    run of consecutive chunks in order, and the runs are added in order.
    The shift is added back to the mean. The tests hold the plan's chunks
    and this merge to float64 and to JAX with it."""
    n, h, w, c = x.shape
    x32 = x.float().reshape(n, h * w, c)
    shift = x32[:, 0]
    x32 = x32 - shift[:, None]
    parts = []
    for k in range(plan.chunks):
        xs = x32[:, k * plan.chunk:(k + 1) * plan.chunk]
        mu = xs.mean(dim=1)
        parts.append((xs.shape[1], mu,
                      (xs - mu[:, None]).square().sum(dim=1)))
    runs = _STATS_THREADS // plan.channels
    length = _ceil_div(plan.chunks, runs)

    def in_order(term):
        total = torch.zeros_like(shift)
        for r in range(runs):
            acc = torch.zeros_like(shift)
            for part in parts[r * length:(r + 1) * length]:
                acc = acc + term(*part)
            total = total + acc
        return total

    mean = in_order(lambda k, mu, m2: k * mu) / float(h * w)
    m2 = in_order(lambda k, mu, m2: m2 + k * (mu - mean).square())
    return shift + mean, m2


def instance_norm_apply_reference(x: torch.Tensor, mean: torch.Tensor,
                                  rstd: torch.Tensor, act: str = "relu",
                                  negative_slope: float = 0.2
                                  ) -> torch.Tensor:
    """act((x - mean) * rstd) in fp32 with (N, C) statistics, in x's
    dtype: :func:`instance_norm_act_reference`'s y for given statistics."""
    y = (x.float() - mean[:, None, None, :]) * rstd[:, None, None, :]
    return apply_act(y, act, negative_slope).to(x.dtype)


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


def _act_grad(g32: torch.Tensor, xh: torch.Tensor, act: str,
              negative_slope: float) -> torch.Tensor:
    """g * act'(xh) in fp32, as ``_fused_bwd`` folds it."""
    if act == "relu":
        return g32 * (xh > 0)
    if act == "leaky_relu":
        return torch.where(xh >= 0, g32, g32 * negative_slope)
    if act == "tanh":
        t = torch.tanh(xh)
        return g32 * (1.0 - t * t)
    return g32


def _bwd_terms(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
               g: torch.Tensor, act: str, negative_slope: float
               ) -> torch.Tensor:
    """(2, N, H, W, C) fp32: g' and g' * xh, with xh = (x - mean) * rstd
    and g' = g * act'(xh)."""
    if act not in ACTS:
        raise ValueError(f"unknown act: {act}")
    xh = (x.float() - mean[:, None, None, :]) * rstd[:, None, None, :]
    gp = _act_grad(g.float(), xh, act, negative_slope)
    return torch.stack([gp, gp * xh])


def instance_norm_bwd_stats_reference(x: torch.Tensor, mean: torch.Tensor,
                                      rstd: torch.Tensor, g: torch.Tensor,
                                      act: str = "relu",
                                      negative_slope: float = 0.2
                                      ) -> torch.Tensor:
    """(2, N, C) fp32: s1 and s2, the sums over H and W of g' and of
    g' * xh, with xh = (x - mean) * rstd for given (merged) statistics and
    g' = g * act'(xh). The split backward's first half."""
    return _bwd_terms(x, mean, rstd, g, act, negative_slope).sum(dim=(2, 3))


def instance_norm_bwd_stats_chunked_reference(x: torch.Tensor,
                                              mean: torch.Tensor,
                                              rstd: torch.Tensor,
                                              g: torch.Tensor,
                                              plan: "BwdStatsPlan",
                                              act: str = "relu",
                                              negative_slope: float = 0.2
                                              ) -> torch.Tensor:
    """(2, N, C): the sums as the sums kernel adds them under ``plan``, in
    plain fp32 PyTorch: each chunk's sums (a plain sum here, where the
    kernel adds its threads' and warps' in another order), the chunks of
    a cluster added in rank order, then the clusters' partials of a slab
    in cluster order (the tickets route's last cluster). The tests hold
    the plan's chunks and this order to float64 and to JAX with it."""
    n, h, w, c = x.shape
    terms = _bwd_terms(x, mean, rstd, g, act, negative_slope).reshape(
        2, n, h * w, c)
    parts = [terms[:, :, k * plan.chunk:(k + 1) * plan.chunk].sum(dim=2)
             for k in range(plan.chunks)]
    total = torch.zeros_like(parts[0])
    for cl in range(plan.chunks // plan.k):
        acc = torch.zeros_like(total)
        for part in parts[cl * plan.k:(cl + 1) * plan.k]:
            acc = acc + part
        total = total + acc
    return total


def instance_norm_bwd_apply_reference(x: torch.Tensor, mean: torch.Tensor,
                                      rstd: torch.Tensor, g: torch.Tensor,
                                      s1: torch.Tensor, s2: torch.Tensor,
                                      count: float, act: str = "relu",
                                      negative_slope: float = 0.2
                                      ) -> torch.Tensor:
    """dx = rstd * (g' - s1 / count - xh * s2 / count) in fp32, cast to
    x's dtype: the split backward's second half, with (s1, s2) the sums
    over every rank and ``count`` a channel's pixels over every rank, as
    JAX's ``_fused_bwd`` writes it."""
    if act not in ACTS:
        raise ValueError(f"unknown act: {act}")
    mean, rstd = mean[:, None, None, :], rstd[:, None, None, :]
    xh = (x.float() - mean) * rstd
    gp = _act_grad(g.float(), xh, act, negative_slope)
    gm = (s1 / count)[:, None, None, :]
    gx = (s2 / count)[:, None, None, :]
    return (rstd * (gp - gm - xh * gx)).to(x.dtype)


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


class StatsPlan(NamedTuple):
    """One launch of the statistics kernel (``in_stats_kernel``), as
    ``csrc/instance_norm.cu`` reads it: ``n * groups`` slabs, each one
    image's pixels of one group of ``channels`` channels (``cg`` words a
    pixel), cut into ``chunks`` chunks of ``chunk`` pixels (the last may
    hold fewer), one block a chunk. One chunk a slab is one level; with
    more, the last block of a slab to finish merges its chunks."""
    cg: int           # words of a group at one pixel
    channels: int     # channels per group
    groups: int       # channel groups per image
    chunks: int       # chunks (blocks) per slab
    chunk: int        # pixels per chunk
    smem_bytes: int   # dynamic shared memory per block


def _stats_lane(channels: int, itemsize: int) -> int:
    """Channels of a pixel's group one thread of the statistics kernel
    loads at once: 16 bytes (8 bf16 or 4 fp32), or 8 bytes for a bf16
    group of 4 channels."""
    return 8 if itemsize == 2 and channels > 4 else 4


def _stats_rows(channels: int, itemsize: int) -> int:
    """Pixels the statistics kernel's 256 threads read side by side."""
    return _STATS_THREADS // (channels // _stats_lane(channels, itemsize))


def _check_stats_aligned(ptr: int, p: "StatsPlan", itemsize: int) -> None:
    """Raise unless ``ptr`` is aligned to the statistics kernel's loads
    under ``p``: 16 bytes, where ``_check_nhwc`` asks 8 of bf16."""
    load = _stats_lane(p.channels, itemsize) * itemsize
    if ptr % load:
        raise ValueError(f"instance_norm_stats_cuda: a group of "
                         f"{p.channels} channels is read {load} bytes a "
                         f"load; the tensor must be {load}-byte aligned")


def _make_stats_plan(hw: int, c: int, itemsize: int, cg: int,
                     chunk: int) -> StatsPlan:
    """The statistics launch with chunks of ``chunk`` pixels (at most the
    image's). Shared memory as the kernel's ``stats_smem_need``: a float
    for each of 8 warps and channel of the group, a float a thread."""
    chunk = min(chunk, hw)
    channels = cg * _PER
    smem = (8 * channels + _STATS_THREADS) * 4
    return StatsPlan(cg, channels, c // channels, _ceil_div(hw, chunk),
                     chunk, smem)


def _stats_plan(n: int, hw: int, c: int, itemsize: int, sms: int = 132,
                resident: int = 2) -> StatsPlan:
    """The statistics launch for an (n, hw, c) tensor of ``itemsize``
    bytes on a card of ``sms`` SMs that each hold ``resident`` of its
    blocks at once. The widest group of at most 64 bytes a pixel
    (``_choices``). A slab of at most ``_STATS_ONE_LEVEL`` values, or a
    launch of at least a wave of slabs, takes one chunk a slab: one
    level. Otherwise as many chunks a slab as keep the grid to one wave
    (a block streams its chunk, and one past the wave would start only as
    the first ended), each thread of the last block to one round of
    ``_STATS_MERGE`` partials, and every thread to at least one round of
    ``_STATS_BATCH`` loads."""
    cg = _choices(hw, c, itemsize)[0][0]
    channels = cg * _PER
    slabs = n * (c // channels)
    rows = _stats_rows(channels, itemsize)
    per = min(sms * resident // slabs,
              _STATS_MERGE * (_STATS_THREADS // channels),
              hw // (_STATS_BATCH * rows))
    if hw * channels <= _STATS_ONE_LEVEL or per < 2:
        return _make_stats_plan(hw, c, itemsize, cg, hw)
    return _make_stats_plan(hw, c, itemsize, cg, _ceil_div(hw, per))


@lru_cache(maxsize=None)
def stats_resident(cg: int, smem_bytes: int, is_bf16: bool) -> int:
    """How many statistics blocks of this group and shared memory one SM
    holds at once, from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    out = ctypes.c_int()
    _build.check(_build.lib().ir2rgb_instance_norm_stats_occupancy(
        cg, smem_bytes, int(is_bf16), ctypes.byref(out)),
        "instance_norm_stats occupancy")
    return out.value


@lru_cache(maxsize=None)
def _card_stats_plan(n: int, hw: int, c: int, itemsize: int,
                     index: int) -> StatsPlan:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    one = _stats_plan(n, hw, c, itemsize, sms, 1)
    return _stats_plan(n, hw, c, itemsize, sms, stats_resident(
        one.cg, one.smem_bytes, itemsize == 2))


def stats_plan_for(x: torch.Tensor) -> StatsPlan:
    """The statistics plan a CUDA NHWC ``x`` launches with (queries the
    card)."""
    n, h, w, c = x.shape
    return _card_stats_plan(n, h * w, c, x.element_size(), x.device.index)


class BwdStatsPlan(NamedTuple):
    """One launch of the split backward's sums kernel
    (``in_bwd_stats_kernel``), as ``csrc/instance_norm.cu`` reads it:
    ``n * groups`` slabs, each one image's pixels of one group of
    ``channels`` channels (``cg`` words a pixel), cut into ``chunks``
    chunks of ``chunk`` pixels (the last may hold fewer), one block a
    chunk; clusters of ``k`` consecutive chunks, ``chunks // k`` clusters
    a slab. ``route``: "one" (one chunk a slab), "cluster" (one cluster a
    slab) or "tickets" (several clusters a slab, their partials merged by
    the last to draw a ticket)."""
    cg: int           # words of a group at one pixel
    channels: int     # channels per group
    groups: int       # channel groups per image
    chunks: int       # chunks (blocks) per slab
    chunk: int        # pixels per chunk
    k: int            # blocks per cluster (1: no cluster)
    route: str        # "one", "cluster" or "tickets"


def _make_bwd_stats_plan(hw: int, c: int, itemsize: int, cg: int,
                         chunks: int, k: int) -> BwdStatsPlan:
    """The sums launch with ``chunks`` chunks a slab in clusters of
    ``k``; raises unless every chunk holds a pixel."""
    chunk = _ceil_div(hw, chunks)
    if chunks % k or (chunks - 1) * chunk >= hw:
        raise ValueError(f"no sums launch of {chunks} chunks in clusters "
                         f"of {k} over {hw} pixels")
    route = "one" if chunks == 1 else "cluster" if chunks == k else "tickets"
    return BwdStatsPlan(cg, cg * _PER, c // (cg * _PER), chunks, chunk, k,
                        route)


def _bwd_stats_plan(n: int, hw: int, c: int, itemsize: int, sms: int = 132,
                    resident: int = 2,
                    clusters: Callable[[int], int] = None) -> BwdStatsPlan:
    """The sums launch for an (n, hw, c) tensor of ``itemsize`` bytes on
    a card of ``sms`` SMs that each hold ``resident`` of its blocks, where
    ``clusters(k)`` is how many clusters of k blocks the card holds at once
    (without it, ``sms * resident // k``; 0: it cannot run one). The rules
    are ``sweep_b1.py --bwd-stats``'s readings at the path's shapes.

    The widest group of at most 64 bytes a pixel (``_choices``); ``per``,
    the chunks a slab that give every thread one round of ``_STATS_BATCH``
    loads of x and of g.
    - One level where ``per`` is 1.
    - One cluster a slab of k = max(per, ⌈``_BWD_CLUSTER_BLOCKS`` /
      slabs⌉) chunks, where k is at most ``_BWD_CLUSTER_MAX``, the launch
      at most ``2 * _BWD_CLUSTER_BLOCKS`` blocks and the card holds a
      cluster a slab at once: more, shorter chunks end sooner, and the
      cluster merge costs the same.
    - Else tickets: one block an SM over the slabs (``sms // slabs``
      chunks a slab, no cluster), which keeps the blocks of a bandwidth-
      bound launch even over the SMs; where that is more than
      ``_BWD_MERGE_MAX`` partials a slab for the last block to add,
      clusters of ``_BWD_CLUSTER_MAX`` (or the largest the card holds a
      slab of), as many a slab as the card holds at once."""
    if clusters is None:
        clusters = lambda k: sms * resident // k  # noqa: E731
    cg = _choices(hw, c, itemsize)[0][0]
    channels = cg * _PER
    slabs = n * (c // channels)
    per = _ceil_div(hw, _STATS_BATCH * _stats_rows(channels, itemsize))
    if per == 1:
        return _make_bwd_stats_plan(hw, c, itemsize, cg, 1, 1)
    k = max(per, _ceil_div(_BWD_CLUSTER_BLOCKS, slabs))
    if (k <= _BWD_CLUSTER_MAX and slabs * k <= 2 * _BWD_CLUSTER_BLOCKS
            and clusters(k) >= slabs):
        return _make_bwd_stats_plan(hw, c, itemsize, cg, k, k)
    m = max(2, sms // slabs)
    if m <= _BWD_MERGE_MAX:
        k = 1
    else:
        k = next((k for k in (_BWD_CLUSTER_MAX, 8, 4, 2)
                  if clusters(k) >= slabs), 1)
        m = max(1, clusters(k) // slabs) if k > 1 else _BWD_MERGE_MAX
    while m > 1 and (k * m - 1) * _ceil_div(hw, k * m) >= hw:
        m -= 1
    return _make_bwd_stats_plan(hw, c, itemsize, cg, k * m, k)


@lru_cache(maxsize=None)
def bwd_stats_resident(cg: int, act: str, is_bf16: bool) -> int:
    """How many blocks of the split backward's sums kernel of this group
    and activation one SM holds at once."""
    out = ctypes.c_int()
    _build.check(_build.lib().ir2rgb_instance_norm_bwd_stats_occupancy(
        cg, ACTS[act], int(is_bf16), ctypes.byref(out)),
        "instance_norm_bwd_stats occupancy")
    return out.value


@lru_cache(maxsize=None)
def bwd_stats_clusters(k: int, cg: int, act: str, is_bf16: bool) -> int:
    """How many clusters of k blocks of the sums kernel the card holds at
    once (0: it cannot run one), from ``cudaOccupancyMaxActiveClusters``."""
    out = ctypes.c_int()
    _build.check(_build.lib().ir2rgb_instance_norm_bwd_stats_max_clusters(
        k, cg, ACTS[act], int(is_bf16), ctypes.byref(out)),
        "instance_norm_bwd_stats max clusters")
    return out.value


@lru_cache(maxsize=None)
def _card_bwd_stats_plan(n: int, hw: int, c: int, itemsize: int, act: str,
                         index: int) -> BwdStatsPlan:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    cg = _choices(hw, c, itemsize)[0][0]
    bf16 = itemsize == 2
    return _bwd_stats_plan(
        n, hw, c, itemsize, sms, bwd_stats_resident(cg, act, bf16),
        lambda k: bwd_stats_clusters(k, cg, act, bf16))


def bwd_stats_plan_for(x: torch.Tensor, act: str = "relu") -> BwdStatsPlan:
    """The plan the split backward's sums launch with for a CUDA NHWC
    ``x`` (queries the card)."""
    n, h, w, c = x.shape
    return _card_bwd_stats_plan(n, h * w, c, x.element_size(), act,
                                x.device.index)


class BwdApplyPlan(NamedTuple):
    """One launch of the split backward's apply kernel
    (``in_bwd_apply_kernel``): a thread a lane of ``lane`` channels of one
    image, a block ``rows`` pixels side by side of ``lb`` lanes (256
    threads), a grid of ``blocks`` blocks along the pixels for each image
    and group of ``lb`` lanes."""
    lane: int         # channels one load reads (8 bf16 or 4; 4 fp32)
    lb: int           # lanes a block
    rows: int         # pixels a block reads side by side
    blocks: int       # blocks along the pixels


def _bwd_apply_plan(n: int, hw: int, c: int, itemsize: int, sms: int = 132,
                    resident: int = 2) -> BwdApplyPlan:
    """The apply launch for an (n, hw, c) tensor: 16-byte lanes (8 bf16
    channels where C allows, else 4; 4 fp32), a block of up to 256 lanes
    and as many pixels side by side as fill 256 threads, and blocks along
    the pixels up to one wave of the ``sms * resident`` the card holds
    over the images and lane groups, never more than a pixel row a
    thread."""
    lane = 8 if itemsize == 2 and c % 8 == 0 else 4
    cv = c // lane
    lb = min(cv, 256)
    rows = 256 // lb
    lgroups = _ceil_div(cv, lb)
    blocks = max(1, min(_ceil_div(hw, rows),
                        sms * resident // (n * lgroups)))
    return BwdApplyPlan(lane, lb, rows, blocks)


@lru_cache(maxsize=None)
def bwd_apply_resident(c: int, act: str, is_bf16: bool) -> int:
    """How many blocks of the apply kernel one SM holds at once."""
    out = ctypes.c_int()
    _build.check(_build.lib().ir2rgb_instance_norm_bwd_apply_occupancy(
        c, ACTS[act], int(is_bf16), ctypes.byref(out)),
        "instance_norm_bwd_apply occupancy")
    return out.value


@lru_cache(maxsize=None)
def _card_bwd_apply_plan(n: int, hw: int, c: int, itemsize: int, act: str,
                         index: int) -> BwdApplyPlan:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return _bwd_apply_plan(n, hw, c, itemsize, sms,
                           bwd_apply_resident(c, act, itemsize == 2))


# The statistics kernel's ticket counters: per device, an arena of
# _TICKET_SLOTS slots of _TICKETS_PER_SLOT counters, zeroed once; one slot
# a stream
_TICKET_SLOTS, _TICKETS_PER_SLOT = 128, 4096
_tickets = {}
_tickets_lock = threading.Lock()


def _stream_tickets(device: torch.device, slabs: int) -> torch.Tensor:
    """The counters a launch of ``slabs`` slabs on ``device``'s current
    stream draws its tickets from: that stream's slot of the device's
    arena. The arena is zeroed when first used, which cannot be inside a
    CUDA graph capture, and the kernel leaves every counter it draws at
    zero. Launches on two streams never share a counter; a CUDA graph
    keeps the slot of the stream it was captured on."""
    if slabs > _TICKETS_PER_SLOT:
        raise ValueError(f"instance_norm_stats: {slabs} slabs a launch, at "
                         f"most {_TICKETS_PER_SLOT}")
    stream = torch.cuda.current_stream(device).cuda_stream
    with _tickets_lock:
        if device.index not in _tickets:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "instance_norm_stats: the first launch on a device "
                    "zeroes the kernel's counters; make it before capturing "
                    "a CUDA graph")
            arena = torch.zeros((_TICKET_SLOTS, _TICKETS_PER_SLOT),
                                dtype=torch.int32, device=device)
            torch.cuda.synchronize(device)  # zero before any stream draws
            _tickets[device.index] = (arena, {})
        arena, slots = _tickets[device.index]
        if stream not in slots:
            if len(slots) == _TICKET_SLOTS:
                raise RuntimeError(f"instance_norm_stats: launches on more "
                                   f"than {_TICKET_SLOTS} streams")
            slots[stream] = len(slots)
        return arena[slots[stream]]


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
    # two allocations: the op's outputs may not alias one another
    mean = torch.empty((n, c), device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
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


def instance_norm_stats_cuda(x: torch.Tensor, plan: StatsPlan = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the statistics kernel; raise on anything it does not take.
    ``plan`` replaces :func:`stats_plan_for`'s (``sweep_b1 --stats``
    times each)."""
    global stats_launches
    _check_nhwc(x, "instance_norm_stats_cuda")
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("instance_norm_stats_cuda records no graph; a "
                         "partitioned train step runs it inside the split "
                         "B1's autograd Function (nn/ops.py)")
    n, h, w, c = x.shape
    p = plan or stats_plan_for(x)
    _check_stats_aligned(x.data_ptr(), p, x.element_size())
    mean = torch.empty((n, c), device=x.device, dtype=torch.float32)
    m2 = torch.empty_like(mean)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part = tickets = None  # one level: neither
    if p.chunks > 1:
        part = torch.empty(n * c * p.chunks * 2, device=x.device,
                           dtype=torch.float32)
        tickets = _stream_tickets(x.device, n * p.groups)
    code = _build.lib().ir2rgb_instance_norm_stats(
        x.data_ptr(), mean.data_ptr(), m2.data_ptr(),
        part.data_ptr() if part is not None else 0,
        tickets.data_ptr() if tickets is not None else 0, n, h * w, c,
        p.cg, p.chunks, p.chunk, p.smem_bytes,
        int(x.dtype == torch.bfloat16), stream)
    _build.check(code, "instance_norm_stats")
    stats_launches += 1
    return mean, m2


def instance_norm_apply_cuda(x: torch.Tensor, mean: torch.Tensor,
                             rstd: torch.Tensor, act: str = "relu",
                             negative_slope: float = 0.2) -> torch.Tensor:
    """Launch the apply kernel; raise on anything it does not take."""
    global apply_launches
    _check_nhwc(x, "instance_norm_apply_cuda")
    if act not in ACTS:
        raise ValueError(f"unknown act: {act}")
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("instance_norm_apply_cuda records no graph; a "
                         "partitioned train step runs it inside the split "
                         "B1's autograd Function (nn/ops.py)")
    n, h, w, c = x.shape
    for s in (mean, rstd):
        if (tuple(s.shape) != (n, c) or s.dtype != torch.float32
                or not s.is_contiguous() or s.device != x.device
                or s.data_ptr() % 16):
            raise ValueError("mean and rstd must be contiguous (N, C) fp32 "
                             "on x's device, 16-byte aligned")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _build.lib().ir2rgb_instance_norm_apply(
        x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), y.data_ptr(), n,
        h * w, c, ACTS[act], float(negative_slope),
        int(x.dtype == torch.bfloat16), stream)
    _build.check(code, "instance_norm_apply")
    apply_launches += 1
    return y


def _readable(g: torch.Tensor, align: int) -> torch.Tensor:
    """``g`` as a kernel reads it: a view (a slice of a concat's gradient)
    or memory at an offset that breaks the kernel's ``align``-byte loads
    is copied once to fresh contiguous memory."""
    if not g.is_contiguous() or g.data_ptr() % align:
        return g.clone(memory_format=torch.contiguous_format)
    return g


def _check_split_bwd(x, g, stats, what):
    _check_nhwc(x, what)
    _check_nhwc(g, what)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    n, _, _, c = x.shape
    for s in stats:
        if (tuple(s.shape) != (n, c) or s.dtype != torch.float32
                or not s.is_contiguous() or s.device != x.device
                or s.data_ptr() % 16):
            raise ValueError(f"{what}: the (N, C) statistics and sums must "
                             "be contiguous fp32 on x's device, 16-byte "
                             "aligned")


def instance_norm_bwd_stats_cuda(x: torch.Tensor, mean: torch.Tensor,
                                 rstd: torch.Tensor, g: torch.Tensor,
                                 act: str = "relu",
                                 negative_slope: float = 0.2,
                                 plan: BwdStatsPlan = None) -> torch.Tensor:
    """Launch the split backward's sums kernel; raise on anything it does
    not take. Returns one (2, N, C) buffer, s1 then s2. ``plan``
    replaces :func:`bwd_stats_plan_for`'s (``sweep_b1 --bwd-stats``
    times each)."""
    global bwd_stats_launches
    if act not in ACTS:
        raise ValueError(f"unknown act: {act}")
    g = _readable(g, 16)
    _check_split_bwd(x, g, (mean, rstd), "instance_norm_bwd_stats_cuda")
    n, h, w, c = x.shape
    p = plan or bwd_stats_plan_for(x, act)
    for t in (x, g):
        _check_stats_aligned(t.data_ptr(), p, x.element_size())
    sums = torch.empty((2, n, c), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part = tickets = None  # one cluster a slab: neither
    if p.route == "tickets":
        part = torch.empty(n * c * 2 * (p.chunks // p.k), device=x.device,
                           dtype=torch.float32)
        tickets = _stream_tickets(x.device, n * p.groups)
    code = _build.lib().ir2rgb_instance_norm_bwd_stats(
        x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        sums.data_ptr(), part.data_ptr() if part is not None else 0,
        tickets.data_ptr() if tickets is not None else 0, n, h * w, c,
        p.cg, p.chunks, p.chunk, p.k, ACTS[act], float(negative_slope),
        int(x.dtype == torch.bfloat16), stream)
    _build.check(code, "instance_norm_bwd_stats")
    bwd_stats_launches += 1
    return sums


def instance_norm_bwd_apply_cuda(x: torch.Tensor, mean: torch.Tensor,
                                 rstd: torch.Tensor, g: torch.Tensor,
                                 s1: torch.Tensor, s2: torch.Tensor,
                                 count: float, act: str = "relu",
                                 negative_slope: float = 0.2
                                 ) -> torch.Tensor:
    """Launch the split backward's apply kernel; raise on anything it
    does not take."""
    global bwd_apply_launches
    if act not in ACTS:
        raise ValueError(f"unknown act: {act}")
    if not count > 0:
        raise ValueError(f"count must be positive, got {count}")
    n, h, w, c = x.shape
    p = _card_bwd_apply_plan(n, h * w, c, x.element_size(), act,
                             x.device.index)
    load = p.lane * x.element_size()
    g = _readable(g, load)
    _check_split_bwd(x, g, (mean, rstd, s1, s2),
                     "instance_norm_bwd_apply_cuda")
    if x.data_ptr() % load:
        raise ValueError(f"instance_norm_bwd_apply_cuda: x is read {load} "
                         f"bytes a load; it must be {load}-byte aligned")
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _build.lib().ir2rgb_instance_norm_bwd_apply(
        x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        s1.data_ptr(), s2.data_ptr(), dx.data_ptr(), n, h * w, c, p.lb,
        p.blocks, 1.0 / count, ACTS[act], float(negative_slope),
        int(x.dtype == torch.bfloat16), stream)
    _build.check(code, "instance_norm_bwd_apply")
    bwd_apply_launches += 1
    return dx


def _backward_cuda(x, mean, rstd, g, act, negative_slope):
    """The backward op's CUDA implementation: a ``g`` the kernel cannot
    read is copied once (``_readable``, its word loads)."""
    g = _readable(g, _PER * g.element_size())
    return instance_norm_act_bwd_cuda(x, mean, rstd, g, act, negative_slope)


def _forward_fake(x, act, eps, negative_slope):
    n, _, _, c = x.shape
    stats = x.new_empty((n, c), dtype=torch.float32)
    return torch.empty_like(x), stats, torch.empty_like(stats)


_OPS = _build.define_op(
    "instance_norm_act(Tensor x, str act, float eps, float negative_slope)"
    " -> (Tensor, Tensor, Tensor)",
    instance_norm_act_reference, instance_norm_act_cuda, _forward_fake)
_BWD_OPS = _build.define_op(
    "instance_norm_act_bwd(Tensor x, Tensor mean, Tensor rstd, Tensor g, "
    "str act, float negative_slope) -> Tensor",
    instance_norm_act_backward_reference, _backward_cuda,
    lambda x, mean, rstd, g, act, negative_slope: torch.empty_like(x))


def _stats_fake(x):
    n, _, _, c = x.shape
    mean = x.new_empty((n, c), dtype=torch.float32)
    return mean, torch.empty_like(mean)


_STATS_OPS = _build.define_op(
    "instance_norm_stats(Tensor x) -> (Tensor, Tensor)",
    instance_norm_stats_reference, instance_norm_stats_cuda, _stats_fake)
_APPLY_OPS = _build.define_op(
    "instance_norm_apply(Tensor x, Tensor mean, Tensor rstd, str act, "
    "float negative_slope) -> Tensor",
    instance_norm_apply_reference, instance_norm_apply_cuda,
    lambda x, mean, rstd, act, negative_slope: torch.empty_like(x))


_BWD_STATS_OPS = _build.define_op(
    "instance_norm_bwd_stats(Tensor x, Tensor mean, Tensor rstd, Tensor g, "
    "str act, float negative_slope) -> Tensor",
    instance_norm_bwd_stats_reference, instance_norm_bwd_stats_cuda,
    lambda x, mean, rstd, g, act, negative_slope: mean.new_empty(
        (2,) + tuple(mean.shape)))
_BWD_APPLY_OPS = _build.define_op(
    "instance_norm_bwd_apply(Tensor x, Tensor mean, Tensor rstd, Tensor g, "
    "Tensor s1, Tensor s2, float count, str act, float negative_slope) "
    "-> Tensor",
    instance_norm_bwd_apply_reference, instance_norm_bwd_apply_cuda,
    lambda x, mean, rstd, g, s1, s2, count, act, negative_slope:
    torch.empty_like(x))


def instance_norm_bwd_stats(x: torch.Tensor, mean: torch.Tensor,
                            rstd: torch.Tensor, g: torch.Tensor,
                            act: str = "relu", negative_slope: float = 0.2
                            ) -> torch.Tensor:
    """The split backward's per-(n, c) sums of g' and g' * xh over NHWC
    ``x``'s H and W, in one fp32 (2, N, C) buffer (s1, then s2). CPU
    tensors take the plain version; CUDA tensors the kernel
    (``ir2rgb::instance_norm_bwd_stats``)."""
    _build.check_device(x, "instance_norm_bwd_stats")
    return _BWD_STATS_OPS(x, mean, rstd, g, act, float(negative_slope))


def instance_norm_bwd_apply(x: torch.Tensor, mean: torch.Tensor,
                            rstd: torch.Tensor, g: torch.Tensor,
                            s1: torch.Tensor, s2: torch.Tensor,
                            count: float, act: str = "relu",
                            negative_slope: float = 0.2) -> torch.Tensor:
    """dx of the split B1 from the sums over every rank (``s1``, ``s2``)
    and a channel's pixels over every rank (``count``). CPU tensors take
    the plain version; CUDA tensors the kernel
    (``ir2rgb::instance_norm_bwd_apply``)."""
    _build.check_device(x, "instance_norm_bwd_apply")
    return _BWD_APPLY_OPS(x, mean, rstd, g, s1, s2, float(count), act,
                          float(negative_slope))


def instance_norm_stats(x: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """(mean, m2) of NHWC ``x`` over its H and W, fp32 (N, C). CPU tensors
    take the plain version; CUDA tensors the kernel (the op
    ``ir2rgb::instance_norm_stats``)."""
    _build.check_device(x, "instance_norm_stats")
    return _STATS_OPS(x)


def instance_norm_apply(x: torch.Tensor, mean: torch.Tensor,
                        rstd: torch.Tensor, act: str = "relu",
                        negative_slope: float = 0.2) -> torch.Tensor:
    """act((x - mean) * rstd) over NHWC ``x`` with (N, C) fp32 statistics.
    CPU tensors take the plain version; CUDA tensors the kernel (the op
    ``ir2rgb::instance_norm_apply``)."""
    _build.check_device(x, "instance_norm_apply")
    return _APPLY_OPS(x, mean, rstd, act, float(negative_slope))


def instance_norm_act(x: torch.Tensor, act: str = "relu",
                      eps: float = INSTANCE_NORM_EPS,
                      negative_slope: float = 0.2):
    """Instance norm + activation over NHWC ``x``: (y, mean, rstd).

    CPU tensors take the plain version; CUDA tensors the kernel (the op
    ``ir2rgb::instance_norm_act``)."""
    _build.check_device(x, "instance_norm_act")
    return _OPS(x, act, float(eps), float(negative_slope))


def instance_norm_act_backward(x: torch.Tensor, mean: torch.Tensor,
                               rstd: torch.Tensor, g: torch.Tensor,
                               act: str = "relu",
                               negative_slope: float = 0.2) -> torch.Tensor:
    """dx of :func:`instance_norm_act` for the output gradient ``g``.

    CPU tensors take the plain version; CUDA tensors the kernel (the op
    ``ir2rgb::instance_norm_act_bwd``), a ``g`` it cannot read copied
    once to fresh contiguous memory first."""
    _build.check_device(x, "instance_norm_act_backward")
    return _BWD_OPS(x, mean, rstd, g, act, float(negative_slope))


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
