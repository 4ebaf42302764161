"""Spatial partitioning of a served frame: the rows of every activation
split evenly over the ``sp`` ranks of a dp×sp mesh (``mesh.dp_sp_mesh``).

JAX shards H over a ``spatial`` mesh axis and XLA's SPMD partitioner
writes the rest: each conv's reads across shards become halo exchanges,
instance norm's H, W reductions all-reduces. PyTorch has no partitioner,
so the ops of ``nn/ops.py`` do it themselves while a frame runs under
:func:`serving` (the model code is unchanged). This module holds

- :class:`Shards`, the partition as one rank sees it (``sp``, ``rank``),
  :func:`active` / :func:`partitioned`, the context the ops read, and
  :func:`serving`, which enters it with the data-parallel context
  (``mesh.sharded``: batch norm's moments over every rank);
- the halo: :meth:`Shards.halo` extends this rank's rows with the rows
  above and below that an op reads, by global row index. Each index is
  first mapped by the op's edge rule at the *global* image edge only
  (zero, reflect or edge), then taken from the rank that owns it, so a
  reflect pad wider than a shard (shards of one row) reads the right
  rows. The plan (:func:`halo_plan`) comes from shapes alone, so every
  rank makes the same collectives in the same order;
- the exchange: every rank writes the rows it owns that any other rank
  needs into a zero byte buffer at agreed offsets, and one all-reduce
  (sum) of it (``mesh.all_reduce_bytes``, as ``mesh.gather``) serves the
  whole halo, exact for any dtype on gloo and NCCL alike (gloo has no
  ``all_gather`` of CUDA tensors);
- instance norm over the whole frame: each rank's (mean, M2) of its rows
  (kernel B1's statistics), exchanged the same way and merged in rank
  order with Chan's formula (:func:`merge_stats`), so that every rank
  holds the same bits;
- :func:`local_block` / :func:`gather_block`: a whole frame's block of
  this rank (batch rows over ``dp``, image rows over ``sp``) and the
  whole frame back from every rank's block.

It imports torch only. Serving only: a halo or a split norm under
autograd raises (the backward is ROADMAP A16b).
"""

from __future__ import annotations

import contextlib
import dataclasses
from functools import lru_cache
from typing import Any, Optional, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import mesh as pmesh

A16B = "ROADMAP A16b"
MODES = ("zero", "reflect", "edge")


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


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """The halo of one op for every rank: ``h`` rows a rank, ``top`` /
    ``bottom`` extra rows, ``mode`` at the global edge.

    - ``sources[q]``: the global source row (None: zero) of each of rank
      q's ``h + top + bottom`` rows;
    - ``foreign[q]``: the distinct rows rank q reads from other ranks, in
      order; they sit in the exchange buffer at ``offset[q]``;
    - ``total``: the buffer's rows (0: no exchange)."""
    h: int
    sp: int
    top: int
    bottom: int
    mode: str
    sources: Tuple[Tuple[Optional[int], ...], ...]
    foreign: Tuple[Tuple[int, ...], ...]
    offset: Tuple[int, ...]
    total: int


@lru_cache(maxsize=None)
def halo_plan(h: int, sp: int, top: int, bottom: int, mode: str) -> HaloPlan:
    if mode not in MODES:
        raise ValueError(f"unknown halo mode: {mode!r}")
    n = h * sp
    sources, foreign, offset, total = [], [], [], 0
    for q in range(sp):
        src = tuple(_source(p, n, mode)
                    for p in range(q * h - top, (q + 1) * h + bottom))
        far = tuple(sorted({r for r in src
                            if r is not None and r // h != q}))
        sources.append(src)
        foreign.append(far)
        offset.append(total)
        total += len(far)
    return HaloPlan(h, sp, top, bottom, mode, tuple(sources), tuple(foreign),
                    tuple(offset), total)


class Shards:
    """This rank's place in the partition: ``sp`` ranks, this one
    ``rank`` (its rows are ``rank * h ... (rank + 1) * h - 1`` of a tensor
    of ``h`` local rows), and how halo rows and statistics travel: over
    ``group`` (the mesh's ``sp`` subgroup) through ``device``.

    An op that pads its input for the next conv (``reflect_pad``,
    ``replicate_pad``) returns the extended rows; :meth:`mark` records
    that, so the conv takes them as they are (:meth:`extension`)."""

    def __init__(self, sp: int, rank: int, group: Any = None,
                 device: Optional[torch.device] = None):
        if not 0 <= rank < sp:
            raise ValueError(f"rank {rank} outside sp = {sp}")
        self.sp, self.rank = sp, rank
        self.group = group
        self.device = torch.device("cpu") if device is None else device
        self._extended = WeakIdKeyDictionary()
        self._index = {}

    @classmethod
    def of(cls, mesh: "pmesh.DataParallelMesh") -> "Shards":
        return cls(mesh.sp, mesh.sp_rank, mesh.sp_group, mesh.device)

    # -- geometry ------------------------------------------------------

    def global_rows(self, h: int) -> int:
        """The global H of a tensor of ``h`` local rows."""
        return h * self.sp

    def check_rows(self, h: int, k: int, stride: int, pad: int,
                   what: str) -> None:
        """Raise ``ValueError`` unless a k-row window op (``what``) with
        ``stride`` and ``pad`` rows of padding splits over the ranks: the
        global H divisible by ``stride * sp`` (every rank's rows whole and
        its first row on the stride), and H / stride rows out."""
        g = self.global_rows(h)
        if h % stride:
            raise ValueError(
                f"{what}: global H {g} is not divisible by {stride}·sp = "
                f"{stride * self.sp}: a stride-{stride} layer needs whole, "
                f"aligned rows on each of the sp = {self.sp} ranks")
        if (g + 2 * pad - k) // stride + 1 != g // stride:
            raise ValueError(f"{what}: {g} global rows do not give "
                             f"{g // stride} rows to split over sp = "
                             f"{self.sp}")

    def mark(self, x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
        self._extended[x] = (top, bottom)
        return x

    def extension(self, x: torch.Tensor) -> Optional[Tuple[int, int]]:
        return self._extended.get(x)

    # -- the halo ------------------------------------------------------

    def halo(self, x: torch.Tensor, top: int, bottom: int,
             mode: str) -> torch.Tensor:
        """``x`` (N, h, W, C), this rank's rows, extended by ``top`` rows
        above and ``bottom`` below: the global rows the op reads, mapped
        at the global edge by ``mode`` ("zero", "reflect", "edge")."""
        if torch.is_grad_enabled() and x.requires_grad:
            raise NotImplementedError(
                "a halo exchange under autograd: spatially partitioned "
                f"training is not ported ({A16B})")
        if top == 0 and bottom == 0:
            return x
        # the halo rows come from x itself, the exchange, or zeros
        plan = halo_plan(x.shape[1], self.sp, top, bottom, mode)
        own, pick, _, _ = self._indices(plan, x.device)
        recv = self.exchange(x, plan)
        zero = x.new_zeros((x.shape[0], 1) + tuple(x.shape[2:]))
        pool = torch.cat([x.index_select(1, own), recv, zero], dim=1)
        halo = pool.index_select(1, pick)
        return torch.cat([halo[:, :plan.top], x, halo[:, plan.top:]], dim=1)

    def _indices(self, plan: HaloPlan, device: torch.device):
        """Kept per (plan, device): (this rank's own rows its halo reads,
        each halo row's place in [those, the received rows, a zero row],
        the buffer rows this rank writes, the local rows it writes
        there)."""
        key = (plan, device)
        got = self._index.get(key)
        if got is None:
            h, q = plan.h, self.rank
            src = plan.sources[q]
            halo = src[:plan.top] + src[plan.top + h:]
            own = sorted({r for r in halo if r is not None and r // h == q})
            far = plan.foreign[q]

            def at(r):
                if r is None:
                    return len(own) + len(far)
                if r // h == q:
                    return own.index(r)
                return len(own) + far.index(r)
            dst, src_rows = [], []
            for k in range(plan.sp):
                for j, r in enumerate(plan.foreign[k]):
                    if r // h == q:
                        dst.append(plan.offset[k] + j)
                        src_rows.append(r - q * h)
            with torch.inference_mode(False):
                got = tuple(torch.tensor(v, dtype=torch.long, device=device)
                            for v in ([r - q * h for r in own],
                                      [at(r) for r in halo], dst, src_rows))
            self._index[key] = got
        return got

    def exchange(self, x: torch.Tensor, plan: HaloPlan) -> torch.Tensor:
        """(N, len(plan.foreign[rank]), W, C): the rows this rank reads
        from the others, by one all-reduce of a zero buffer into which
        every rank writes the rows it owns that another rank reads."""
        if plan.total == 0:
            return x[:, :0]
        _, _, dst, src = self._indices(plan, x.device)
        buf = x.new_zeros((x.shape[0], plan.total) + tuple(x.shape[2:]))
        if dst.numel():
            buf.index_copy_(1, dst, x.index_select(1, src))
        buf = pmesh.all_reduce_bytes(buf, self.group, self.device)
        lo = plan.offset[self.rank]
        return buf[:, lo:lo + len(plan.foreign[self.rank])]

    # -- instance norm over the whole frame ----------------------------

    def gather_stats(self, t: torch.Tensor) -> torch.Tensor:
        """(sp,) + t.shape: every rank's ``t`` (the same shape on each) in
        rank order."""
        out = t.new_zeros((self.sp,) + tuple(t.shape))
        out[self.rank] = t
        return pmesh.all_reduce_bytes(out, self.group, self.device)

    def norm_stats(self, mean: torch.Tensor, m2: torch.Tensor, count: int,
                   eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """The whole frame's (mean, rstd) from this rank's (mean, M2) over
        its ``count`` pixels a channel: every rank's gathered and merged
        in rank order (:func:`merge_stats`)."""
        both = self.gather_stats(torch.stack([mean, m2]))
        return merge_stats(both[:, 0], both[:, 1], count, eps)


def merge_stats(means: torch.Tensor, m2s: torch.Tensor, count: int,
                eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, rstd) over every shard from (sp, N, C) fp32 per-shard means
    and M2s of ``count`` pixels each: Chan's pairwise merge in rank order
    (the B1 kernel's cluster merge, ``csrc/instance_norm.cu``), then
    rstd = rsqrt(M2 / total + eps). Plain PyTorch; the same inputs give
    the same bits on every rank."""
    cnt = float(count)
    mean, m2 = means[0], m2s[0]
    for r in range(1, means.shape[0]):
        tot = cnt + count
        wb = count / tot
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
    """A served frame (or tick) on ``mesh``: batch norm's moments over
    every rank (``mesh.sharded``) and, with ``sp > 1``, the ops on this
    rank's rows (``shards``, default ``Shards.of(mesh)``)."""
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


__all__ = ["A16B", "HaloPlan", "Shards", "active", "gather_block",
           "halo_plan", "local_block", "merge_stats", "partitioned",
           "serving"]
