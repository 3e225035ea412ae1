from .sharding import (
    AXIS,
    init_distributed,
    make_mesh,
    replicated_sharding,
    shard_vector,
    state_shardings,
    vector_sharding,
)

__all__ = [
    "AXIS",
    "init_distributed",
    "make_mesh",
    "replicated_sharding",
    "shard_vector",
    "state_shardings",
    "vector_sharding",
]
