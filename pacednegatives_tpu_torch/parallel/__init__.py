"""Ranks, meshes and collectives over torch.distributed (the port of
parallel/)."""

from pacednegatives_tpu_torch.parallel.mesh import (
    MeshConfig,
    create_mesh,
    batch_sharding,
    replicated,
    param_shardings,
    shard_batch,
)

__all__ = [
    "MeshConfig",
    "create_mesh",
    "batch_sharding",
    "replicated",
    "param_shardings",
    "shard_batch",
]
