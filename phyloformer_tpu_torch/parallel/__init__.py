from .mesh import (
    DATA_AXIS,
    PAIR_AXIS,
    Mesh,
    batch_slice,
    host_local_slice,
    init_distributed,
    local_mesh,
    make_mesh,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "PAIR_AXIS",
    "Mesh",
    "batch_slice",
    "host_local_slice",
    "init_distributed",
    "local_mesh",
    "make_mesh",
    "shard_batch",
]
