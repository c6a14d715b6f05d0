"""Meshes of ranks (training over ``torch.distributed``) and of devices
(serving in one process): counterpart of ``this_and_that_vdm_tpu/parallel``."""

from .mesh import (
    BlockRows,
    Mesh,
    ShardedParams,
    distributed_init,
    global_batch,
    host_replicated,
    is_main_process,
    make_mesh,
    make_serving_mesh,
    mesh_devices,
    replicate,
    replicate_to_mesh,
    shard_batch,
    shard_frozen,
    shard_leading,
    shard_module,
    shard_params,
    shard_state,
)

__all__ = [
    "BlockRows",
    "Mesh",
    "ShardedParams",
    "distributed_init",
    "global_batch",
    "host_replicated",
    "is_main_process",
    "make_mesh",
    "make_serving_mesh",
    "mesh_devices",
    "replicate",
    "replicate_to_mesh",
    "shard_batch",
    "shard_frozen",
    "shard_leading",
    "shard_module",
    "shard_params",
    "shard_state",
]
