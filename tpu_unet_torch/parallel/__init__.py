"""Data, spatial and tensor parallelism over ``torch.distributed`` process
groups (counterpart of ``tpu_unet/parallel``): the ('data', 'space',
'model') mesh (``mesh.py``), the halo exchanges of H-sharded activations
(``spatial.py``), FSDP2 (``fsdp.py``) and channel slices (``tensor.py``)."""

from tpu_unet_torch.parallel.collectives import (
    all_gather_host_values,
    broadcast_from_host0,
    local_rows,
    psum_scalar,
)
from tpu_unet_torch.parallel.fsdp import (
    leaf_partition_spec,
    per_device_state_bytes,
    shard_state,
    sharded_fraction,
)
from tpu_unet_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SPACE_AXIS,
    launch,
    make_mesh,
    maybe_initialize,
    replicate,
    shard_batch,
    synced_timestamp,
)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "SPACE_AXIS", "launch", "make_mesh", "maybe_initialize",
    "replicate", "shard_batch", "synced_timestamp",
    "all_gather_host_values", "broadcast_from_host0", "local_rows", "psum_scalar",
    "leaf_partition_spec", "per_device_state_bytes", "shard_state", "sharded_fraction",
]
