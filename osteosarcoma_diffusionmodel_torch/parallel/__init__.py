"""Multi-device layer on torch.distributed: the (data, model) mesh, the
global batch's numerics over the data group, tensor parallelism over the
model group, and the multi-device dry run (:mod:`.dryrun`)."""

from .batch import BatchShard, RowBlock, attached, gather_rows, pad_to_multiple
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_group,
    axis_rank,
    axis_size,
    batch_sharding,
    data_shard,
    denoiser_param_sharding,
    group_devices,
    initialize_distributed,
    is_writer,
    make_mesh,
    parallelize_denoiser,
    replicated,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "BatchShard",
    "RowBlock",
    "attached",
    "axis_group",
    "axis_rank",
    "axis_size",
    "batch_sharding",
    "data_shard",
    "denoiser_param_sharding",
    "gather_rows",
    "group_devices",
    "initialize_distributed",
    "is_writer",
    "make_mesh",
    "pad_to_multiple",
    "parallelize_denoiser",
    "replicated",
    "shard_batch",
]
