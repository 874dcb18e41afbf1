"""Parallelism (``inpaintnet_tpu/parallel``): the ("data", "model") mesh
over local devices or a ``torch.distributed`` world, batch and parameter
placement (``shard_params`` splits the gate matrices over "model"), and
the multi-device dry run (``python -m inpaintnet_tpu_torch.parallel.dryrun``)."""
from inpaintnet_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedLeaf,
    batch_sharding,
    gather_params,
    local_batch_size,
    make_global_batch,
    make_mesh,
    pad_rows_to_divisible,
    replicate,
    replicated,
    shard_batch,
    shard_params,
)
