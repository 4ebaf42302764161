"""The data-parallel mesh of the port — the counterpart of
``ir2rgb_tpu/parallel/mesh.py`` on ``torch.distributed``.

JAX trains data-parallel by sharding the batch on a 1-D ``data`` mesh and
replicating the state; XLA inserts the gradient all-reduce. PyTorch has
no SPMD partitioner, so the same step is written out here, one process a
card (``multihost.initialize`` brings the group up; ``torchrun`` launches
it):

- :class:`DataParallelMesh` is the group as one rank sees it: ``world``,
  ``rank``, ``local_rank``, the rank's ``device`` and the process group
  (None for one process without a group, world 1).
- :func:`shard_batch` is this rank's rows of a global batch, dim 0 split
  for every leaf. It is also where ``batch_sharding``'s rule lives: a
  sharding has no tensor type to return in PyTorch. With ``accum = K``
  the rows are this rank's slice of **each** of the K micro-batches the
  step cuts the global batch into, micro-batch by micro-batch, so that
  micro-batch k holds the same rows as JAX's (``model.py:471-475``).
- :func:`replicate` broadcasts rank 0's whole train state (every network,
  both Adams, the pool, the EMA shadows, the random generator, the step)
  and attaches the mesh to the model, whose ``train_step`` then takes
  data-parallel steps: one averaging all-reduce of the gradients after
  the backward passes (:func:`all_reduce_grads`) and one of the metrics
  (:func:`all_reduce_metrics`).
- :func:`sharded` is the context the step runs in. Every random draw of
  the step (dropout masks, the pool's decisions, WGAN-GP's mixing
  weights, the loader's crops and flips) is made at the global batch's
  shape on every rank and sliced to the rank's rows (:func:`draw`), so
  the ranks' generators stay in step and a DP step draws what the
  one-process step of the global batch draws. The pool queries the
  gathered global fakes (:func:`gather`) and batch norm takes global
  statistics (:func:`batch_moments`) inside it.
- :func:`gather` is the one gather: an all-reduce of a zero buffer into
  which each rank writes its own rows, as bytes, so it is exact on every
  backend (gloo has no ``all_gather`` of CUDA tensors).

:func:`dp_sp_mesh` keeps JAX's argument checks and, for ``sp > 1``,
lays the group out as JAX's ``devices.reshape(dp, sp)``: rank ``r`` is
``(dp_rank, sp_rank) = divmod(r, sp)``, with a ``dp`` subgroup (the ranks
of one spatial column) and an ``sp`` subgroup (the ranks of one data
row). Such a mesh serves and trains: a frame's rows spread over the
``sp`` ranks (``parallel/spatial.py``: the halo exchanges and the
instance-norm merge that XLA's partitioner writes in JAX, and their
transposes), batch rows and slots over the ``dp`` ranks. On it a step's
draws are made at ``dp`` times the rows in hand and every ``sp`` rank of
a data row takes the same rows (:func:`draw`); the ``sp`` ranks' losses
and gradients are partial sums of their data row's, so the gradient and
metric all-reduces sum over every rank and divide by ``dp``
(:func:`all_reduce_grads`, :func:`all_reduce_metrics`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

LAUNCH = ("torchrun --standalone --nproc_per_node {n} -m "
          "ir2rgb_tpu_torch.cli.train ... --train.num_devices {n}")


@dataclasses.dataclass(frozen=True)
class DataParallelMesh:
    """The group as one rank sees it; with ``sp > 1`` a dp×sp mesh
    (:func:`dp_sp_mesh`): ``world = dp * sp`` ranks, ``dp_group`` the
    ranks of this rank's spatial column (None when ``dp == 1``),
    ``sp_group`` those of its data row. With ``sp == 1`` every rank is its
    own data row and ``dp_group`` is ``group``."""
    world: int
    rank: int
    local_rank: int
    device: torch.device
    group: Optional[Any] = None  # a torch.distributed ProcessGroup
    sp: int = 1
    dp_group: Optional[Any] = None
    sp_group: Optional[Any] = None

    def __post_init__(self):
        if self.sp == 1 and self.dp_group is None:
            object.__setattr__(self, "dp_group", self.group)

    @property
    def dp(self) -> int:
        return self.world // self.sp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.sp

    @property
    def sp_rank(self) -> int:
        return self.rank % self.sp

    def barrier(self) -> None:
        """Wait for every rank (a one-element all-reduce, read back, so it
        is a barrier on the host under NCCL too)."""
        if self.group is not None:
            t = torch.zeros(1, device=self.device)
            dist.all_reduce(t, group=self.group)
            t.item()


def _group_device(group_backend: str) -> torch.device:
    if group_backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def data_parallel_mesh(num_devices: int = 0,
                       device: Optional[torch.device] = None
                       ) -> DataParallelMesh:
    """The mesh of the initialized ``torch.distributed`` group, or world
    1 without one. ``num_devices`` 0 means the group's world size; any
    other value must equal it (``ValueError``). Without a group, 0 means
    every visible card (JAX's meaning): more than one raises, naming the
    ``torchrun`` command, as does ``num_devices > 1``; one process never
    quietly trains on one of several cards. ``device``: the rank's
    device (default: ``cuda:LOCAL_RANK`` under NCCL, the CPU under gloo;
    without a group the card if there is one)."""
    if num_devices < 0:
        raise ValueError(f"num_devices must be >= 0, got {num_devices}")
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if num_devices and num_devices != world:
            raise ValueError(
                f"num_devices={num_devices} but the process group has "
                f"{world} rank(s): launch one process a card, "
                + LAUNCH.format(n=num_devices))
        dev = torch.device(device) if device is not None else \
            _group_device(dist.get_backend())
        local = int(os.environ.get("LOCAL_RANK", dev.index or 0))
        return DataParallelMesh(world, rank, local, dev, dist.group.WORLD)
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    visible = torch.cuda.device_count() if dev.type == "cuda" else 1
    n = num_devices or visible
    if n > 1:
        asked = (f"num_devices={num_devices}" if num_devices
                 else f"every visible card ({n})")
        raise ValueError(
            f"{asked} but no process group is initialized: the port "
            "trains one process a card; launch " + LAUNCH.format(n=n))
    return DataParallelMesh(1, 0, 0, dev, None)


SP_LAUNCH = ("launch {n} processes, one a card (torchrun --standalone "
             "--nproc_per_node {n} <serving script>), and build the mesh "
             "on each")


def dp_sp_mesh(dp: int = 0, sp: int = 1,
               devices: Optional[Sequence[Any]] = None,
               device: Optional[torch.device] = None) -> DataParallelMesh:
    """JAX's ``dp_sp_mesh`` argument checks (``mesh.py:50-75``) over
    ``devices`` (default: one a rank of the group, else the visible
    cards), then the mesh: for ``sp == 1`` the data-parallel mesh; for
    ``sp > 1`` the initialized group laid out as ``(dp, sp)`` in JAX's
    order (``ValueError`` unless there is a group of ``dp * sp`` ranks).
    Every rank must call it, in the same order: it makes the ``dp`` and
    ``sp`` subgroups with ``dist.new_group``. ``device``: the rank's
    device (as :func:`data_parallel_mesh`'s)."""
    if devices is None:
        n_dev = (dist.get_world_size() if dist.is_available()
                 and dist.is_initialized() else max(
                     torch.cuda.device_count(), 1))
    else:
        n_dev = len(devices)
    if sp < 1:
        raise ValueError(f"sp must be >= 1, got {sp}")
    if dp < 0:
        raise ValueError(f"dp must be >= 0 (0 = all devices / sp), "
                         f"got {dp}")
    if not dp:
        dp = n_dev // sp
        if dp == 0:
            raise ValueError(
                f"sp = {sp} exceeds {n_dev} visible devices "
                f"(dp would be 0)")
    n = dp * sp
    if n > n_dev:
        raise ValueError(f"dp*sp = {dp}*{sp} = {n} exceeds "
                         f"{n_dev} visible devices")
    if sp == 1:
        return data_parallel_mesh(dp, device)
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"dp*sp = {dp}*{sp} = {n} ranks but no process "
                         "group is initialized: " + SP_LAUNCH.format(n=n))
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"dp*sp = {dp}*{sp} = {n} but the process group "
                         f"has {world} rank(s): " + SP_LAUNCH.format(n=n))
    base = data_parallel_mesh(0, device)
    # every rank makes every subgroup, in the same order
    rows = [list(range(d * sp, (d + 1) * sp)) for d in range(dp)]
    cols = [list(range(k, n, sp)) for k in range(sp)]

    def mine(groups):
        if len(groups[0]) == 1:
            return None
        if len(groups[0]) == world:
            return base.group
        made = [dist.new_group(g) for g in groups]
        return next(h for g, h in zip(groups, made) if base.rank in g)
    sp_group, dp_group = mine(rows), mine(cols)
    return dataclasses.replace(base, sp=sp, dp_group=dp_group,
                               sp_group=sp_group)


# ---------------------------------------------------------------------------
# Rows of a global batch
# ---------------------------------------------------------------------------

def local_rows(n: int, world: int, rank: int, accum: int = 1
               ) -> torch.Tensor:
    """The indices of rank ``rank``'s rows in a global batch of ``n``
    rows: its slice of each of the ``accum`` contiguous micro-batches, in
    micro-batch order. Raises ``ValueError`` unless ``world × accum``
    divides ``n``."""
    if accum < 1 or n % (world * accum):
        raise ValueError(
            f"a global batch of {n} rows does not divide into {world} "
            f"rank(s) x {accum} micro-batch(es)")
    micro, per = n // accum, n // (world * accum)
    return torch.cat([torch.arange(k * micro + rank * per,
                                   k * micro + (rank + 1) * per)
                      for k in range(accum)])


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def image_dim(x: torch.Tensor, mesh: DataParallelMesh) -> Optional[int]:
    """The dim of ``x`` split over the ``sp`` ranks (JAX's
    ``batch_sharding`` rule, ``mesh.py:78-95``): H (dim 1) of a rank-4
    leaf, dim 2 of a rank-5 one (time stays whole); None for any other
    leaf, and for every leaf with ``sp == 1``."""
    if mesh.sp == 1 or x.dim() not in (4, 5):
        return None
    return 1 if x.dim() == 4 else 2


def image_rows(x: torch.Tensor, mesh: DataParallelMesh) -> torch.Tensor:
    """This rank's image rows of a leaf (a view): :func:`image_dim` split
    evenly over the ``sp`` ranks, a leaf it does not split as it is.
    ``ValueError`` unless ``sp`` divides H."""
    d = image_dim(x, mesh)
    if d is None:
        return x
    if x.shape[d] % mesh.sp:
        raise ValueError(f"{x.shape[d]} image rows do not split evenly over "
                         f"sp = {mesh.sp} ranks")
    h = x.shape[d] // mesh.sp
    return x.narrow(d, mesh.sp_rank * h, h)


def shard_batch(batch: Any, mesh: DataParallelMesh, accum: int = 1) -> Any:
    """This rank's rows of the global ``batch`` (a tensor, numpy array,
    or dict / list / tuple of them), on the rank's device. Dim 0 is split
    over the ``dp`` ranks for every leaf: frames (B, H, W, C), windows
    (B, T, H, W, C), instance maps (B, H, W), labels (B,); on a dp×sp
    mesh the image leaves' rows too (:func:`image_rows`). With
    ``accum = K`` the rows are the rank's slice of each of the K
    micro-batches (:func:`local_rows`); ``ValueError`` unless ``dp × K``
    divides the batch."""
    def take(x):
        x = torch.as_tensor(x)
        rows = local_rows(x.shape[0], mesh.dp, mesh.dp_rank, accum)
        x = image_rows(x.index_select(0, rows.to(x.device)), mesh)
        return x.contiguous().to(mesh.device)
    return _tree_map(take, batch)


# ---------------------------------------------------------------------------
# The step's context: draws at the global shape, the gather, batch norm
# ---------------------------------------------------------------------------

_ACTIVE: Optional[tuple] = None  # (mesh, accum) of the running step


@contextlib.contextmanager
def sharded(mesh: Optional[DataParallelMesh], accum: int = 1):
    """Inside: the random draws, the pool and batch norm act over the
    global batch of ``mesh`` (no-op for None or world 1). ``accum``: the
    rows in hand are laid out as :func:`shard_batch`'s with that many
    micro-batches (the loader's transforms); the step itself runs each
    micro-batch with 1. A module global, not a context variable: the
    autograd engine's threads read it too (a remat recompute)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = (mesh, accum) if mesh is not None and mesh.world > 1 else None
    try:
        yield
    finally:
        _ACTIVE = prev


def active() -> Optional[DataParallelMesh]:
    """The mesh of the running DP step (world > 1), else None."""
    return None if _ACTIVE is None else _ACTIVE[0]


def draw(fn: Callable[[int], Any], n: int) -> Any:
    """``fn(n)`` where ``fn(m)`` draws ``m`` rows (a tensor, or a tuple of
    tensors, with the rows on dim 0). Inside a DP step: ``fn`` at the
    global row count (``n`` times ``dp``), then this rank's rows of it:
    its data row's, the same on each of the row's ``sp`` ranks."""
    if _ACTIVE is None:
        return fn(n)
    mesh, accum = _ACTIVE
    rows = local_rows(n * mesh.dp, mesh.dp, mesh.dp_rank, accum)
    out = fn(n * mesh.dp)

    def take(x):
        return x.index_select(0, rows.to(x.device))
    if isinstance(out, tuple):
        taken = [take(x) for x in out]
        return type(out)(*taken) if hasattr(out, "_fields") else tuple(taken)
    return take(out)


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def all_reduce_bytes(t: torch.Tensor, group: Any,
                     device: torch.device) -> torch.Tensor:
    """The sum over the ranks of ``group`` of ``t``'s bytes (through
    ``device``), each byte written by one rank and zero on the others, so
    the sum is that rank's byte: exact for any dtype on any backend. A
    tensor of ``t``'s dtype and shape on ``t``'s device."""
    buf = _bytes(t).to(device)
    dist.all_reduce(buf, group=group)
    return buf.to(t.device).view(t.dtype).reshape(t.shape)


def gather(x: torch.Tensor, mesh: DataParallelMesh) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) stacked on dim 0 in
    rank order: an all-reduce of a zero buffer into which each rank
    writes its own rows (:func:`all_reduce_bytes`). No graph."""
    n = x.shape[0]
    out = torch.zeros((mesh.world * n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[mesh.rank * n:(mesh.rank + 1) * n] = x.detach()
    return all_reduce_bytes(out, mesh.group, mesh.device)


class _AllReduceSum(torch.autograd.Function):
    """y = the sum over ranks of x; its backward sums the gradient over
    ranks the same way (differentiable again, for a second
    derivative)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g.contiguous(), ctx.group), None


def batch_moments(x32: torch.Tensor, mesh: DataParallelMesh,
                  count: Optional[float] = None):
    """The (C,) mean and biased variance over (N, H, W) of NHWC fp32
    ``x32`` across every rank's rows (on a dp×sp mesh the group spans
    both axes: the batch's rows and the image's), in ``ops.batch_norm``'s
    two passes:
    the summed sum and count give the mean, then the summed squared
    deviations about it the variance. ``count``: the pixels over every
    rank (default: every rank's as many as this one's). Differentiable:
    the backward sums the statistics' gradients over ranks."""
    dims = (0, 1, 2)
    if count is None:
        count = float(x32.shape[0] * x32.shape[1] * x32.shape[2]
                      * mesh.world)
    mean = _AllReduceSum.apply(x32.sum(dim=dims), mesh.group) / count
    var = _AllReduceSum.apply((x32 - mean).square().sum(dim=dims),
                              mesh.group) / count
    return mean, var


# ---------------------------------------------------------------------------
# The step's collectives and the replicated state
# ---------------------------------------------------------------------------

def all_reduce_grads(nets: Iterable[torch.nn.Module],
                     mesh: DataParallelMesh) -> int:
    """Average every ``.grad`` of each network over the data-parallel
    replicas: one flat buffer a network and dtype, one all-reduce (sum)
    over every rank each, divided by ``dp`` (on a dp×sp mesh the ``sp``
    ranks of a data row hold partial sums of its gradient). Parameters
    without a gradient (the same on every rank: every rank records the
    same graph) are left. Returns the bytes reduced."""
    moved = 0
    for net in nets:
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for p in net.parameters():
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=mesh.group)
            flat.div_(mesh.dp)
            moved += flat.numel() * flat.element_size()
            i = 0
            for g in grads:
                g.copy_(flat[i:i + g.numel()].view_as(g))
                i += g.numel()
    return moved


# counts summed over the batch's images, not means
SUMMED_METRICS = ("inst_collisions",)


def all_reduce_metrics(metrics: Dict[str, torch.Tensor],
                       mesh: DataParallelMesh) -> Dict[str, torch.Tensor]:
    """The global batch's metrics from each rank's: one all-reduce of the
    stacked 0-dim values over every rank, the means divided by ``dp``
    (the ``sp`` ranks' are partial sums of their data row's) and the
    counts (``SUMMED_METRICS``) left summed."""
    names = sorted(metrics)
    flat = torch.stack([metrics[k].float() for k in names])
    dist.all_reduce(flat, group=mesh.group)
    return {k: v if k in SUMMED_METRICS else v / mesh.dp
            for k, v in zip(names, flat)}


def _leaves(tree: Any, out: list) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif isinstance(tree, torch.Tensor) or (
            isinstance(tree, (int, float)) and not isinstance(tree, bool)):
        out.append(tree)


def _rebuild(tree: Any, it) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    if isinstance(tree, torch.Tensor) or (
            isinstance(tree, (int, float)) and not isinstance(tree, bool)):
        return next(it)
    return tree


def broadcast_state(state: Any, mesh: DataParallelMesh) -> Any:
    """Rank 0's ``state`` (a nested dict / list of tensors and numbers,
    the same structure on every rank) on every rank: one broadcast of
    every tensor's bytes and one of the numbers. Rank 0 gets its own
    ``state`` back. Rank 0 is the mesh's: the first rank of its group,
    whatever its rank in the world."""
    leaves: list = []
    _leaves(state, leaves)
    tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
    numbers = [x for x in leaves if not isinstance(x, torch.Tensor)]
    sizes = [_bytes(t).numel() for t in tensors]
    shape = torch.tensor([len(tensors), sum(sizes), len(numbers)],
                         dtype=torch.int64, device=mesh.device)
    ref = shape.clone()
    dist.broadcast(ref, group=mesh.group, group_src=0)
    if not torch.equal(ref, shape):
        raise RuntimeError(
            f"replicate: rank {mesh.rank}'s train state has (tensors, "
            f"bytes, numbers) {shape.tolist()}, rank 0's {ref.tolist()}: "
            "the ranks built different models")
    buf = torch.cat([_bytes(t).to(mesh.device) for t in tensors]) \
        if tensors else torch.zeros(0, dtype=torch.uint8, device=mesh.device)
    nums = torch.tensor([float(x) for x in numbers], dtype=torch.float64,
                        device=mesh.device)
    dist.broadcast(buf, group=mesh.group, group_src=0)
    dist.broadcast(nums, group=mesh.group, group_src=0)
    if mesh.rank == 0:
        return state
    out, i = [], 0
    for t, size in zip(tensors, sizes):
        # a copy of the slice starts at offset 0: any dtype may view it
        out.append(buf[i:i + size].to(t.device, copy=True).view(t.dtype)
                   .reshape(t.shape))
        i += size
    got_t, got_n = iter(out), iter(nums.tolist())
    return _rebuild(state, iter([next(got_t) if isinstance(x, torch.Tensor)
                                 else type(x)(next(got_n)) for x in leaves]))


def replicate(model, mesh: DataParallelMesh):
    """Make every rank's ``model`` rank 0's: its whole train state
    (``model.state_dict()``: every network's parameters and buffers, both
    optimizers' state, the pool, the EMA shadows, ``model.generator``'s
    state and ``step``) broadcast from rank 0 and loaded, then attach the
    mesh (``model.mesh``), so ``model.train_step`` steps data-parallel.
    Without a group it only attaches the mesh. Returns the model."""
    if mesh.group is not None:
        state = broadcast_state(model.state_dict(), mesh)
        if mesh.rank != 0:
            model.load_state_dict(state)
    model.mesh = mesh
    return model


__all__ = ["DataParallelMesh", "active", "all_reduce_bytes",
           "all_reduce_grads", "all_reduce_metrics", "batch_moments",
           "broadcast_state", "data_parallel_mesh", "dp_sp_mesh", "draw",
           "gather", "image_dim", "image_rows", "local_rows", "replicate",
           "shard_batch", "sharded"]
