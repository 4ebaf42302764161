"""Multi-process data parallelism — the counterpart of
``ir2rgb_tpu/parallel/multihost.py`` on ``torch.distributed``.

JAX runs one process a host and meshes over every process's chips; the
port runs one process a card (NCCL can put only one rank on a card),
launched by ``torchrun``, on one host or several:

    torchrun --standalone --nproc_per_node N -m ir2rgb_tpu_torch.cli.train \\
        --preset pix2pixhd_512 --train.num_devices N ...

Usage (the same program in every process):

    from ir2rgb_tpu_torch.parallel import multihost
    multihost.initialize()               # reads torchrun's environment
    mesh = data_parallel_mesh()          # spans every rank
    replicate(model, mesh)
    batch = multihost.global_batch(local_batch, mesh)
    metrics = model.train_step(batch)    # a DP step of the global batch

Each process feeds only its own rows of the global batch (the loader
decodes only those, ``data/loader.py``), so no process materializes the
global batch; :func:`global_batch` moves them to the rank's device and
checks that every rank feeds the same count.
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import Any, Optional

import torch
import torch.distributed as dist

from .mesh import DataParallelMesh, _tree_map, image_rows

# torchrun's environment (MASTER_ADDR / MASTER_PORT: the rendezvous)
ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
DEFAULT_TIMEOUT_S = 300.0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               require: bool = False, backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Bring up the process group (``torch.distributed.init_process_group``)
    unless it is up already.

    The configuration is the explicit ``coordinator_address`` ("host:port"
    of rank 0's store), ``num_processes`` and ``process_id``, all three,
    or else torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``; ``LOCAL_RANK``). JAX's semantics
    (``multihost.py:36-75``): with nothing configured and not
    ``require``, it warns and stays single-process; with explicit
    arguments, any of torchrun's variables, or ``require=True``, a
    missing piece or a failed initialization raises. Nothing is caught.

    ``backend``: NCCL when CUDA is available, else gloo; "gloo" on a
    CUDA machine runs CUDA tensors through the host (two ranks on one
    card, which NCCL refuses). Under NCCL the rank's device is
    ``cuda:LOCAL_RANK`` (0 when unset), made current. ``timeout_s``
    bounds every collective: a rank that dies or hangs fails the others
    within it."""
    if dist.is_initialized():
        return
    explicit = (coordinator_address, num_processes, process_id)
    env = {k: os.environ[k] for k in ENV if k in os.environ}
    if any(x is not None for x in explicit):
        if any(x is None for x in explicit):
            raise ValueError(
                "multihost.initialize: pass coordinator_address, "
                "num_processes and process_id together (got "
                f"{explicit})")
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    elif env:
        missing = [k for k in ENV if k not in env]
        if missing:
            raise ValueError(
                f"multihost.initialize: torchrun's environment is "
                f"incomplete (missing {missing}); launch with torchrun")
        init_method = "env://"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    elif require:
        raise RuntimeError(
            "multihost.initialize(require=True): no cluster is configured "
            "(no torchrun environment, no coordinator_address); launch "
            "with torchrun --nproc_per_node N -m ir2rgb_tpu_torch.cli.train "
            "... or pass the coordinator, process count and id")
    else:
        warnings.warn("multihost.initialize: no cluster configured; "
                      "continuing single-process")
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def global_batch(local_batch: Any, mesh: DataParallelMesh,
                 check: bool = True, whole_images: bool = False) -> Any:
    """This rank's rows of the global batch (tensors or numpy arrays, or
    dicts / lists / tuples of them; every leaf with the same rows) on the
    rank's device, pinned and copied without blocking from host memory
    to a card. ``local_batch`` is this rank's data row's rows (on a
    dp×sp mesh every rank of a data row feeds the same); on a dp×sp mesh
    its image leaves are then cut to this rank's image rows
    (``mesh.image_rows``, JAX's layout: ``tests/test_parallel.py:192-213``)
    unless ``whole_images`` (a caller that crops first and cuts after).
    ``check``: all-reduce the row count (its max and its negated min in
    one call) and raise ``ValueError`` on every rank if the ranks feed
    different counts (the global batch would not be the one asked for).
    The check waits for the device: a loader whose batches all have one
    shape checks its first."""
    def put(x):
        t = torch.as_tensor(x)
        if not whole_images:
            t = image_rows(t, mesh).contiguous()
        if t.device.type == "cpu" and mesh.device.type == "cuda":
            return t.pin_memory().to(mesh.device, non_blocking=True)
        return t.to(mesh.device)
    out = _tree_map(put, local_batch)
    if check and mesh.group is not None:
        rows = []
        _tree_map(lambda t: rows.append(t.shape[0]), out)
        if len(set(rows)) > 1:
            raise ValueError(f"global_batch: leaves of {rows} rows on rank "
                             f"{mesh.rank}")
        n = rows[0] if rows else 0
        t = torch.tensor([n, -n], dtype=torch.int64, device=mesh.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
        hi, lo = t.tolist()
        if hi != -lo:
            raise ValueError(
                f"global_batch: the ranks feed {-lo} to {hi} rows; every "
                "rank must feed the same count")
    return out
