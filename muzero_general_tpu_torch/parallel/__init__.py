"""Device-mesh parallelism on torch.distributed: sharding rules and sharded
train and self-play steps (port of parallel/)."""

from muzero_general_tpu_torch.parallel.mesh import (
    batch_sharding,
    create_mesh,
    make_sharded_fused_train_steps,
    make_sharded_train_step,
    mesh_from_config,
    param_sharding,
    replicated,
    shard_batch,
    shard_stacked_batches,
    shard_train_state,
    stacked_batch_sharding,
)

__all__ = [
    "create_mesh",
    "batch_sharding",
    "replicated",
    "param_sharding",
    "make_sharded_train_step",
    "make_sharded_fused_train_steps",
    "mesh_from_config",
    "shard_batch",
    "shard_stacked_batches",
    "shard_train_state",
    "stacked_batch_sharding",
]
