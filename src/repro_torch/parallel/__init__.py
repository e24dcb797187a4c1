"""Sharding rules as ``DeviceMesh`` placements."""
from .sharding import (  # noqa: F401
    AbstractMesh,
    NamedSharding,
    PartitionSpec,
    batch_shardings,
    cache_shardings,
    constrain_batch,
    device_put,
    fsdp_axes,
    gather_fsdp,
    maybe_shard_seq,
    param_spec,
    params_shardings,
)
