"""Spatial partitioning of a frame: the rows of every activation split
over the ``sp`` ranks of a dp×sp mesh (``mesh.dp_sp_mesh``), served or
trained.

JAX shards H over a ``spatial`` mesh axis and XLA's SPMD partitioner
writes the rest: each conv's reads across shards become halo exchanges,
instance norm's H, W reductions all-reduces, and autograd their
transposes. PyTorch has no partitioner, so the ops of ``nn/ops.py`` do it
themselves while a frame or a train step runs under :func:`serving`
(the model code is unchanged). This module holds

- :class:`Shards`, the partition as one rank sees it (``sp``, ``rank``),
  :func:`active` / :func:`partitioned`, the context the ops read, and
  :func:`serving`, which enters it (for a served frame or a train step)
  with the data-parallel context (``mesh.sharded``: the step's draws at the
  global shape, batch norm's moments over every rank);
- the partition of a tensor's global rows (:func:`bounds`: ``⌊q·R/sp⌋``,
  the frame's ``h`` rows a rank wherever ``sp`` divides R). An op's
  output rows are split so (:func:`conv_windows`), and each op reads
  the input rows its output rows need, whatever partition the previous
  op produced (``Shards.tag`` / ``Shards.bounds``): the discriminator's
  4×4 convs give uneven shards, and a rank may own none of a layer;
- the halo: :meth:`Shards.window` gives this rank's window of global
  rows. Each index is first mapped by the op's edge rule at the
  *global* image edge only (zero, reflect or edge), then taken from the
  rank that owns it, so a reflect pad wider than a shard reads the right
  rows. The plan (:func:`halo_plan`) comes from shapes alone, so every
  rank makes the same collectives in the same order;
- the exchange: every rank writes the rows it owns that any other rank
  needs into a zero byte buffer at agreed offsets, and one all-reduce
  (sum) of it (``mesh.all_reduce_bytes``, as ``mesh.gather``) serves the
  whole halo, exact for any dtype on gloo and NCCL alike (gloo has no
  ``all_gather`` of CUDA tensors). Under autograd the halo is a
  ``torch.autograd.Function`` whose backward is the exchange's exact
  transpose: each rank writes the gradients of the rows it received at
  its offset of a zero buffer, one all-reduce, and each rank adds the
  entries of the rows it owns into its gradient. That transpose is a
  ``Function`` too, whose backward is the halo again, so a second
  derivative (WGAN-GP's penalty) runs through it;
- instance norm over the whole frame: each rank's (mean, M2) of its rows
  (kernel B1's statistics), exchanged the same way and merged in rank
  order with Chan's formula and a count a rank (:func:`merge_stats`),
  so that every rank holds the same bits; the backward's per-rank sums
  added in rank order (:meth:`Shards.sum_stats`), differentiably where
  a second derivative needs it (:meth:`Shards.sum_over_ranks`);
- :func:`local_block` / :func:`gather_block`: a whole frame's block of
  this rank (batch rows over ``dp``, image rows over ``sp``) and the
  whole frame back from every rank's block.

It imports torch only.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from functools import lru_cache
from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import mesh as pmesh

A16B = "ROADMAP A16b"
MODES = ("zero", "reflect", "edge")


def bounds(rows: int, sp: int) -> Tuple[int, ...]:
    """The partition of ``rows`` global rows over ``sp`` ranks: rank q
    owns rows ``[b[q], b[q + 1])``, ``b[q] = ⌊q·rows/sp⌋``. It is
    ``h`` rows a rank wherever ``sp`` divides ``rows``; otherwise the
    shares differ by one row, and a rank may own none."""
    return tuple(q * rows // sp for q in range(sp + 1))


def conv_windows(src: Tuple[int, ...], k: int, stride: int, pad: int
                 ) -> Tuple[Tuple[int, ...], Tuple[Tuple[int, int], ...]]:
    """(the output partition, each rank's window of input rows) of a
    k-row window op with ``stride`` and ``pad`` rows of padding each side
    over input rows partitioned as ``src``: the output's global rows
    split by :func:`bounds`, and rank q's window the global input rows
    ``[o·stride - pad, (o' - 1)·stride - pad + k)`` its output rows
    ``[o, o')`` read (empty where it owns no output row)."""
    sp = len(src) - 1
    out = bounds((src[-1] + 2 * pad - k) // stride + 1, sp)
    wins = []
    for q in range(sp):
        o0, o1 = out[q], out[q + 1]
        lo = o0 * stride - pad
        wins.append((lo, (o1 - 1) * stride - pad + k) if o1 > o0
                    else (lo, lo))
    return out, tuple(wins)


def _source(p: int, n: int, mode: str) -> Optional[int]:
    """Global row ``p`` of an ``n``-row image, mapped by the edge rule:
    None (a zero row) outside it in "zero" mode, the mirror row in
    "reflect" (torch's ReflectionPad, the edge row not repeated), the
    nearest row in "edge"."""
    if 0 <= p < n:
        return p
    if mode == "zero":
        return None
    if mode == "edge":
        return min(max(p, 0), n - 1)
    q = -p if p < 0 else 2 * (n - 1) - p
    if not 0 <= q < n:
        raise ValueError(f"reflect pad reaches row {p} of {n}: it must be "
                         "less than the image's height")
    return q


def _owner(r: int, src: Tuple[int, ...]) -> int:
    return bisect.bisect_right(src, r) - 1


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """The rows an op reads on every rank: the input partition ``src``
    (``sp + 1`` bounds), each rank's window ``windows[q]`` of global
    rows, ``mode`` at the global edge.

    - ``sources[q]``: the global source row (None: zero) of each row of
      rank q's window;
    - ``foreign[q]``: the distinct rows rank q reads from other ranks, in
      order; they sit in the exchange buffer at ``offset[q]``;
    - ``total``: the buffer's rows (0: no exchange)."""
    src: Tuple[int, ...]
    windows: Tuple[Tuple[int, int], ...]
    mode: str
    sources: Tuple[Tuple[Optional[int], ...], ...]
    foreign: Tuple[Tuple[int, ...], ...]
    offset: Tuple[int, ...]
    total: int


@lru_cache(maxsize=None)
def halo_plan(src: Tuple[int, ...], windows: Tuple[Tuple[int, int], ...],
              mode: str) -> HaloPlan:
    """The plan of windows ``windows`` over rows partitioned as ``src``;
    from shapes alone, so every rank builds the same one."""
    if mode not in MODES:
        raise ValueError(f"unknown halo mode: {mode!r}")
    n = src[-1]
    sources, foreign, offset, total = [], [], [], 0
    for q, (lo, hi) in enumerate(windows):
        rows = tuple(_source(p, n, mode) for p in range(lo, hi))
        far = tuple(sorted({r for r in rows
                            if r is not None and _owner(r, src) != q}))
        sources.append(rows)
        foreign.append(far)
        offset.append(total)
        total += len(far)
    return HaloPlan(src, windows, mode, tuple(sources), tuple(foreign),
                    tuple(offset), total)


class _Indices(NamedTuple):
    """One rank's view of a plan, on a device: its window is
    ``[side rows [:ntop], x[:, m0:m1], side rows [ntop:]]``, the side rows
    picked (``pick``) from [x's rows ``own``, the received rows, a zero
    row]; ``dst`` / ``rows``: the buffer rows this rank writes and the
    local rows it writes there."""
    own: torch.Tensor
    pick: torch.Tensor
    ntop: int
    m0: int
    m1: int
    dst: torch.Tensor
    rows: torch.Tensor


class _Halo(torch.autograd.Function):
    """This rank's window of rows (:meth:`Shards.window`); its backward is
    the exchange's exact transpose (:class:`_HaloTranspose`)."""

    @staticmethod
    def forward(ctx, x, shards, plan):
        ix = shards._indices(plan, x.device)
        recv = shards.exchange(x, plan)
        zero = x.new_zeros((x.shape[0], 1) + tuple(x.shape[2:]))
        side = torch.cat([x.index_select(1, ix.own), recv, zero],
                         dim=1).index_select(1, ix.pick)
        ctx.shards, ctx.plan, ctx.h = shards, plan, x.shape[1]
        return torch.cat([side[:, :ix.ntop], x[:, ix.m0:ix.m1],
                          side[:, ix.ntop:]], dim=1)

    @staticmethod
    def backward(ctx, g):
        return _HaloTranspose.apply(g, ctx.shards, ctx.plan, ctx.h), \
            None, None


class _HaloTranspose(torch.autograd.Function):
    """The halo's transpose: the gradient of a window ``g`` -> the
    gradient of this rank's ``h`` rows. The window's own rows go back in
    place, its side rows are added into the rows this rank owns or, for
    the rows it received, sent back to their owners
    (:meth:`Shards.exchange_back`). Both maps are linear, so its backward
    is the halo of the cotangent with the same plan: every rank records
    the same node and makes the same exchanges in a second derivative,
    a rank of no rows included."""

    @staticmethod
    def forward(ctx, g, shards, plan, h):
        ix = shards._indices(plan, g.device)
        mid = ix.m1 - ix.m0
        n_own, n_recv = ix.own.numel(), len(plan.foreign[shards.rank])
        side = torch.cat([g[:, :ix.ntop], g[:, ix.ntop + mid:]], dim=1)
        pool = g.new_zeros((g.shape[0], n_own + n_recv + 1)
                           + tuple(g.shape[2:]))
        pool.index_add_(1, ix.pick, side)
        gx = g.new_zeros((g.shape[0], h) + tuple(g.shape[2:]))
        gx[:, ix.m0:ix.m1] = g[:, ix.ntop:ix.ntop + mid]
        gx.index_add_(1, ix.own, pool[:, :n_own])
        if plan.total:
            gx += shards.exchange_back(pool[:, n_own:n_own + n_recv], plan,
                                       h)
        ctx.shards, ctx.plan = shards, plan
        return gx

    @staticmethod
    def backward(ctx, gg):
        return _Halo.apply(gg, ctx.shards, ctx.plan), None, None, None


class _SumOverRanks(torch.autograd.Function):
    """The sum over the ``sp`` ranks of ``t`` (:meth:`Shards.sum_stats`:
    added in rank order, the same bits on every rank). The sum is its own
    transpose: its backward sums the cotangents over the ranks the same
    way, differentiable again."""

    @staticmethod
    def forward(ctx, t, shards):
        ctx.shards = shards
        return shards.sum_stats(t)

    @staticmethod
    def backward(ctx, g):
        return _SumOverRanks.apply(g.contiguous(), ctx.shards), None


class Shards:
    """This rank's place in the partition: ``sp`` ranks, this one
    ``rank``, and how halo rows and statistics travel: over ``group``
    (the mesh's ``sp`` subgroup) through ``device``.

    A tensor's rows are a partition of its global rows: the frame's
    ``h`` rows a rank, or whatever the op that made it produced
    (:meth:`tag`; a k×k conv's output splits by :func:`bounds`, so the
    discriminator's layers have uneven shards and some ranks none).
    :meth:`bounds` reads it back. An op that pads its input for the next
    conv (``reflect_pad``, ``replicate_pad``) returns the extended rows;
    :meth:`mark` records that, so the conv takes them as they are
    (:meth:`extension`)."""

    def __init__(self, sp: int, rank: int, group: Any = None,
                 device: Optional[torch.device] = None):
        if not 0 <= rank < sp:
            raise ValueError(f"rank {rank} outside sp = {sp}")
        self.sp, self.rank = sp, rank
        self.group = group
        self.device = torch.device("cpu") if device is None else device
        self._extended = WeakIdKeyDictionary()
        self._bounds = WeakIdKeyDictionary()
        self._index = {}

    @classmethod
    def of(cls, mesh: "pmesh.DataParallelMesh") -> "Shards":
        return cls(mesh.sp, mesh.sp_rank, mesh.sp_group, mesh.device)

    # -- geometry ------------------------------------------------------

    def bounds(self, x: torch.Tensor) -> Tuple[int, ...]:
        """The partition of ``x``'s rows: its tag, else the frame's even
        split (``x.shape[1]`` rows on every rank)."""
        got = self._bounds.get(x)
        return got if got is not None else tuple(
            q * x.shape[1] for q in range(self.sp + 1))

    def tag(self, x: torch.Tensor, b: Tuple[int, ...]) -> torch.Tensor:
        """Record that ``x``'s rows are partitioned as ``b``; returns x."""
        if b[self.rank + 1] - b[self.rank] != x.shape[1]:
            raise ValueError(f"{x.shape[1]} rows on rank {self.rank} of the "
                             f"partition {b}")
        self._bounds[x] = b
        return x

    def same_rows(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``y``, a row-wise function of ``x``, tagged as ``x``."""
        got = self._bounds.get(x)
        if got is not None and y is not x:
            self._bounds[y] = got
        return y

    def global_rows(self, h) -> int:
        """The global H of a tensor (its partition), or of ``h`` local
        rows of an even split."""
        if isinstance(h, torch.Tensor):
            return self.bounds(h)[-1]
        return h * self.sp

    def counts(self, x: torch.Tensor) -> Tuple[int, ...]:
        """Every rank's rows of ``x``'s partition."""
        b = self.bounds(x)
        return tuple(b[q + 1] - b[q] for q in range(self.sp))

    def mark(self, x: torch.Tensor, top: int, bottom: int,
             src: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
        """Record that ``x`` holds this rank's rows of a tensor partitioned
        as ``src`` (default: evenly) with ``top`` / ``bottom`` extra rows."""
        self._extended[x] = (top, bottom)
        if src is not None:
            self._bounds[x] = src
        return x

    def extension(self, x: torch.Tensor) -> Optional[Tuple[int, int]]:
        return self._extended.get(x)

    # -- the halo ------------------------------------------------------

    def window(self, x: torch.Tensor, windows, mode: str) -> torch.Tensor:
        """``x`` (N, h, W, C), this rank's rows of a tensor partitioned as
        :meth:`bounds` says, as the rows of its window ``windows[rank]``
        (every rank's windows are given: the plan is one for all): the
        global rows in it, mapped at the global edge by ``mode`` ("zero",
        "reflect", "edge"), taken from this rank, the exchange or zeros.
        Differentiable (:class:`_Halo`)."""
        plan = halo_plan(self.bounds(x), tuple(windows), mode)
        return _Halo.apply(x, self, plan)

    def halo(self, x: torch.Tensor, top: int, bottom: int,
             mode: str) -> torch.Tensor:
        """``x`` extended by ``top`` rows above and ``bottom`` below."""
        if top == 0 and bottom == 0:
            return x
        b = self.bounds(x)
        return self.window(x, tuple((b[q] - top, b[q + 1] + bottom)
                                    for q in range(self.sp)), mode)

    def _indices(self, plan: HaloPlan, device: torch.device) -> _Indices:
        """Kept per (plan, device)."""
        key = (plan, device)
        got = self._index.get(key)
        if got is not None:
            return got
        q, b = self.rank, plan.src
        lo, hi = plan.windows[q]
        src = plan.sources[q]
        # the window's run of this rank's own rows, as they are
        a, z = max(lo, b[q]), min(hi, b[q + 1])
        if a >= z:
            a = z = max(min(lo, b[q + 1]), b[q])
        ntop = a - lo if a < z else len(src)
        side = src[:ntop] + src[ntop + z - a:]
        own = sorted({r for r in side if r is not None and b[q] <= r < b[q + 1]})
        far = plan.foreign[q]

        def at(r):
            if r is None:
                return len(own) + len(far)
            if b[q] <= r < b[q + 1]:
                return own.index(r)
            return len(own) + far.index(r)
        dst, rows = [], []
        for k in range(self.sp):
            for j, r in enumerate(plan.foreign[k]):
                if b[q] <= r < b[q + 1]:
                    dst.append(plan.offset[k] + j)
                    rows.append(r - b[q])
        with torch.inference_mode(False):
            t = [torch.tensor(v, dtype=torch.long, device=device)
                 for v in ([r - b[q] for r in own], [at(r) for r in side],
                           dst, rows)]
        got = self._index[key] = _Indices(t[0], t[1], ntop, a - b[q],
                                          z - b[q], t[2], t[3])
        return got

    def _reduce(self, buf: torch.Tensor) -> torch.Tensor:
        """The sum over the ``sp`` ranks of ``buf``, each of whose bytes
        one rank writes and the others leave zero."""
        return pmesh.all_reduce_bytes(buf, self.group, self.device)

    def exchange(self, x: torch.Tensor, plan: HaloPlan) -> torch.Tensor:
        """(N, len(plan.foreign[rank]), W, C): the rows this rank reads
        from the others, by one all-reduce of a zero buffer into which
        every rank writes the rows it owns that another rank reads."""
        if plan.total == 0:
            return x[:, :0]
        ix = self._indices(plan, x.device)
        buf = x.new_zeros((x.shape[0], plan.total) + tuple(x.shape[2:]))
        if ix.dst.numel():
            buf.index_copy_(1, ix.dst, x.index_select(1, ix.rows))
        buf = self._reduce(buf)
        lo = plan.offset[self.rank]
        return buf[:, lo:lo + len(plan.foreign[self.rank])]

    def exchange_back(self, g: torch.Tensor, plan: HaloPlan,
                      h: int) -> torch.Tensor:
        """The transpose of :meth:`exchange`: ``g``, the gradient of the
        rows this rank received, written at its offset of a zero buffer;
        one all-reduce; each rank adds the entries of the rows it owns into
        an (N, h, W, C) gradient of its own rows."""
        ix = self._indices(plan, g.device)
        buf = g.new_zeros((g.shape[0], plan.total) + tuple(g.shape[2:]))
        lo = plan.offset[self.rank]
        buf[:, lo:lo + g.shape[1]] = g
        buf = self._reduce(buf)
        out = g.new_zeros((g.shape[0], h) + tuple(g.shape[2:]))
        if ix.dst.numel():
            out.index_add_(1, ix.rows, buf.index_select(1, ix.dst))
        return out

    # -- instance norm over the whole frame ----------------------------

    def gather_stats(self, t: torch.Tensor) -> torch.Tensor:
        """(sp,) + t.shape: every rank's ``t`` (the same shape on each) in
        rank order."""
        out = t.new_zeros((self.sp,) + tuple(t.shape))
        out[self.rank] = t
        return self._reduce(out)

    def norm_stats(self, mean: torch.Tensor, m2: torch.Tensor, count,
                   eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """The whole frame's (mean, rstd) from this rank's (mean, M2) over
        its ``count`` pixels a channel (an int: the same on every rank;
        else every rank's, in rank order): every rank's gathered and
        merged in rank order (:func:`merge_stats`)."""
        both = self.gather_stats(torch.stack([mean, m2]))
        return merge_stats(both[:, 0], both[:, 1], count, eps)

    def sum_stats(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``t`` (the split backward's sums),
        gathered and added in rank order, so that every rank holds the
        same bits."""
        every = self.gather_stats(t)
        total = every[0]
        for r in range(1, self.sp):
            total = total + every[r]
        return total

    def sum_over_ranks(self, t: torch.Tensor) -> torch.Tensor:
        """:meth:`sum_stats` as a differentiable function of every rank's
        ``t`` (a second derivative's statistics, WGAN-GP's per-sample
        norm): its backward sums the cotangents over the ranks. Every rank
        must call it, in the same order."""
        return _SumOverRanks.apply(t, self)


def merge_stats(means: torch.Tensor, m2s: torch.Tensor, count,
                eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, rstd) over every shard from (sp, N, C) fp32 per-shard means
    and M2s of ``count`` pixels each (an int, or one a shard): Chan's
    pairwise merge in rank order (the B1 kernel's cluster merge,
    ``csrc/instance_norm.cu``), a shard of no pixels skipped, then
    rstd = rsqrt(M2 / total + eps). Plain PyTorch; the same inputs give
    the same bits on every rank."""
    counts = ([count] * means.shape[0] if isinstance(count, int)
              else list(count))
    live = [r for r in range(means.shape[0]) if counts[r] > 0]
    cnt = float(counts[live[0]])
    mean, m2 = means[live[0]], m2s[live[0]]
    for r in live[1:]:
        nb = float(counts[r])
        tot = cnt + nb
        wb = nb / tot
        d = means[r] - mean
        mean = mean + d * wb
        m2 = m2 + m2s[r] + d * d * cnt * wb
        cnt = tot
    return mean, torch.rsqrt(m2 / cnt + eps)


# ---------------------------------------------------------------------------
# The context the ops read
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Shards] = None


def active() -> Optional[Shards]:
    """The partition of the running frame, else None."""
    return _ACTIVE


def same_rows(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y`` (a row-wise function of ``x``) with ``x``'s partition, on a
    partitioned frame; else ``y``."""
    part = active()
    return y if part is None else part.same_rows(y, x)


@contextlib.contextmanager
def partitioned(shards: Optional[Shards]):
    """Inside: the ops of ``nn/ops.py`` act on ``shards``' rows (no-op
    for None)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = shards
    try:
        yield
    finally:
        _ACTIVE = prev


@contextlib.contextmanager
def serving(mesh: Optional["pmesh.DataParallelMesh"],
            shards: Optional[Shards] = None):
    """A served frame (or tick), or a train step's passes, on ``mesh``:
    the data-parallel context (``mesh.sharded``: batch norm's moments
    over every rank; a step's draws at the global batch's shape, the
    ``sp`` ranks of a data row taking the same rows) and, with ``sp >
    1``, the ops (and a step's losses and pool) on this rank's rows
    (``shards``, default ``Shards.of(mesh)``)."""
    if mesh is None:
        yield
        return
    if shards is None and mesh.sp > 1:
        shards = Shards.of(mesh)
    with pmesh.sharded(mesh), partitioned(shards):
        yield


# ---------------------------------------------------------------------------
# A whole frame's blocks
# ---------------------------------------------------------------------------

def local_block(x: torch.Tensor, mesh: "pmesh.DataParallelMesh"
                ) -> torch.Tensor:
    """This rank's block of the global ``x`` (a view): its rows of dim 0
    over ``dp`` (:func:`mesh.local_rows`), its image rows over ``sp``
    (:func:`mesh.image_rows`)."""
    rows = pmesh.local_rows(x.shape[0], mesh.dp, mesh.dp_rank)
    return pmesh.image_rows(x[int(rows[0]):int(rows[-1]) + 1], mesh)


def gather_block(x: torch.Tensor, mesh: "pmesh.DataParallelMesh"
                 ) -> torch.Tensor:
    """The global tensor from every rank's block ``x`` (this rank's,
    :func:`local_block`'s layout), on every rank: one all-reduce over the
    whole group of a zero buffer holding this rank's block."""
    if mesh.world == 1:
        return x
    shape = list(x.shape)
    shape[0] *= mesh.dp
    d = pmesh.image_dim(x, mesh)
    if d is not None:
        shape[d] *= mesh.sp
    out = x.new_zeros(shape)
    local_block(out, mesh).copy_(x)
    return pmesh.all_reduce_bytes(out, mesh.group, mesh.device)


__all__ = ["A16B", "HaloPlan", "Shards", "active", "bounds",
           "conv_windows", "gather_block", "halo_plan", "local_block",
           "merge_stats", "partitioned", "same_rows", "serving"]
