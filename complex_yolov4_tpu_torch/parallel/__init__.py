"""Data parallelism: one process per device over torch.distributed."""

from .mesh import (
    barrier,
    destroy,
    device_prefetch,
    initialize_distributed,
    is_distributed,
    local_shard_info,
    make_mesh_for_batch,
    wrap_ddp,
)

__all__ = [
    "barrier",
    "destroy",
    "device_prefetch",
    "initialize_distributed",
    "is_distributed",
    "local_shard_info",
    "make_mesh_for_batch",
    "wrap_ddp",
]
