"""The image pool of D's fakes — the port of
``ir2rgb_tpu/train/image_pool.py`` (``init_pool``, ``query_pool``).

A history of ``pool_size`` generated frames that, once full, swaps the
current fake for a stored one with probability 0.5 per batch item before
D's own update sees it (the reference's ``util/image_pool.py``). The pool
is a (buffer, count) pair of tensors on the model's device, so a query
reads nothing back to the host. The buffer is updated in place (a query
writes at most one row an item, and a copy of the whole pool a query
would cost ``pool_size`` frames of traffic); the count is replaced.

The decisions (swap or not, which slot) come from a ``torch.Generator``:
the port's own bits, not the JAX package's. :func:`query_pool` also takes
them as arguments, so a test can hand it the decisions ``jax.random``
draws and hold the outputs and the state to ``query_pool``'s.

In a data-parallel step (``parallel/mesh.py``: ``sharded``) the pool
works over the global batch, as JAX's replicated pool state does: every
rank gathers the fakes of all ranks, queries its replica of the pool with
them and the same draws (so the replicas stay equal), and keeps its own
rows of the output. On a dp×sp mesh the fakes are blocks (batch rows over
``dp``, image rows over ``sp``): every rank gathers the whole frames
(``spatial.gather_block``), so each replica holds whole frames, equal to
the one-process pool's, and keeps its block of the output.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ir2rgb_tpu_torch.parallel import mesh as pmesh
from ir2rgb_tpu_torch.parallel import spatial


class PoolState(NamedTuple):
    buffer: torch.Tensor  # (pool_size, H, W, C)
    count: torch.Tensor   # () int64: rows filled so far


def init_pool(pool_size: int, frame_shape: Tuple[int, ...],
              dtype: torch.dtype = torch.float32,
              device: Optional[torch.device] = None) -> PoolState:
    """An empty pool of ``pool_size`` frames of ``frame_shape`` (H, W, C)."""
    if pool_size <= 0:
        raise ValueError(f"pool_size must be > 0, got {pool_size}")
    return PoolState(
        buffer=torch.zeros((pool_size,) + tuple(frame_shape), dtype=dtype,
                           device=device),
        count=torch.zeros((), dtype=torch.int64, device=device))


def draw_decisions(n: int, pool_size: int, generator: torch.Generator
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(swap, idx) for ``n`` batch items, on the generator's device: a fair
    coin each and a slot uniform in [0, pool_size)."""
    dev = generator.device
    swap = torch.rand((n,), generator=generator, device=dev) < 0.5
    idx = torch.randint(0, pool_size, (n,), generator=generator, device=dev)
    return swap, idx


def query_pool(pool: PoolState, fakes: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               swap: Optional[torch.Tensor] = None,
               idx: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, PoolState]:
    """The frames D sees for ``fakes`` (B, H, W, C), and the pool after
    them. Per batch item, in order:

    - pool not full: store the fake in the next row, emit it;
    - pool full: if ``swap``, emit the row ``idx`` and store the fake
      there; else emit the fake and leave the pool.

    ``swap`` (B,) bool and ``idx`` (B,) int are drawn from ``generator``
    when not given. ``fakes`` should carry no graph (the pool keeps
    them). In a data-parallel step ``fakes`` are this rank's rows: the
    query runs on the global batch and returns this rank's rows."""
    dp = pmesh.active()
    if dp is not None and dp.sp > 1:
        out, pool = _query(pool, spatial.gather_block(fakes, dp), generator,
                           swap, idx)
        return spatial.local_block(out, dp).contiguous(), pool
    if dp is not None:
        n = fakes.shape[0]
        out, pool = _query(pool, pmesh.gather(fakes, dp), generator, swap,
                           idx)
        return out[dp.rank * n:(dp.rank + 1) * n], pool
    return _query(pool, fakes, generator, swap, idx)


def _query(pool: PoolState, fakes: torch.Tensor,
           generator: Optional[torch.Generator],
           swap: Optional[torch.Tensor], idx: Optional[torch.Tensor]
           ) -> Tuple[torch.Tensor, PoolState]:
    buffer, count = pool
    size = buffer.shape[0]
    if tuple(fakes.shape[1:]) != tuple(buffer.shape[1:]):
        raise ValueError(f"fakes of frame shape {tuple(fakes.shape[1:])} do "
                         f"not fit a pool of {tuple(buffer.shape[1:])}")
    if swap is None or idx is None:
        swap, idx = draw_decisions(fakes.shape[0], size, generator)
    swap = swap.to(buffer.device, torch.bool)
    idx = idx.to(buffer.device, torch.int64)
    outs = []
    for i in range(fakes.shape[0]):
        fake = fakes[i].to(buffer.dtype)
        not_full = count < size
        stored = buffer.index_select(0, idx[i:i + 1])[0]
        outs.append(torch.where(~not_full & swap[i], stored, fake))
        write = torch.where(not_full, count, idx[i]).view(1)
        row = torch.where(not_full | swap[i], fake,
                          buffer.index_select(0, write)[0])
        buffer.index_copy_(0, write, row[None])
        count = (count + not_full.long()).clamp(max=size)
    return torch.stack(outs), PoolState(buffer, count)
