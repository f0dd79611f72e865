from simplenerf_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    initialize_distributed,
    make_mesh,
    process_local_rows,
    replicate,
    shard_ray_batch,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "replicate",
    "shard_ray_batch",
    "process_local_rows",
    "initialize_distributed",
    "all_reduce_sum",
]
