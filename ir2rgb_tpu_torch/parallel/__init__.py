from . import multihost
from .mesh import (
    DataParallelMesh,
    data_parallel_mesh,
    dp_sp_mesh,
    replicate,
    shard_batch,
)

__all__ = [
    "DataParallelMesh",
    "multihost",
    "data_parallel_mesh",
    "dp_sp_mesh",
    "replicate",
    "shard_batch",
]
