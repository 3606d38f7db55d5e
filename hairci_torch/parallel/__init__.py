"""Data and model parallelism on ``torch.distributed`` (port of
``hairci/parallel``): the ``(data, model)`` mesh and the collectives."""

from hairci_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    create_mesh,
    batch_sharding,
    replicated_sharding,
    model_sharding,
    shard_batch,
    local_mesh_size,
)
