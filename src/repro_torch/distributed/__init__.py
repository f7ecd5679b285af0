"""Distribution: the sharding rules over a mesh's axis sizes, and the active
mesh whose process groups the models' tensor-parallel paths use."""

from repro_torch.distributed.sharding import (  # noqa: F401
    PartitionSpec,
    batch_partition,
    cache_partition,
    param_partition,
    partition_state,
    serve_pool_partition,
)
