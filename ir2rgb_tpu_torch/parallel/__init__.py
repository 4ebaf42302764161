from . import multihost, spatial
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
    "spatial",
    "data_parallel_mesh",
    "dp_sp_mesh",
    "replicate",
    "shard_batch",
]
