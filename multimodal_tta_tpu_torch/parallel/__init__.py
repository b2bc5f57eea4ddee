"""Multi-GPU layers of the port (the data, space and model axes;
``multimodal_tta_tpu/parallel``).

The pipeline schedule (``pipeline_apply``, ``pipeline_value_and_grad``,
``make_pipeline_train_step``, ``stack_layer_params``,
``vit_forward_pipelined``) waits for its item (ROADMAP.md, 12b-iii)."""

from .distributed import is_primary_host, maybe_initialize_distributed
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SPACE_AXIS,
    STAGE_AXIS,
    Mesh,
    batch_sharding,
    data_axis_size,
    make_mesh,
    mesh_from_config,
    pad_batch_to_multiple,
    replicated,
    select_devices,
    shard_batch,
    zero1_optimizer,
)

__all__ = [
    "is_primary_host",
    "maybe_initialize_distributed",
    "DATA_AXIS",
    "MODEL_AXIS",
    "SPACE_AXIS",
    "STAGE_AXIS",
    "Mesh",
    "batch_sharding",
    "data_axis_size",
    "make_mesh",
    "mesh_from_config",
    "pad_batch_to_multiple",
    "replicated",
    "select_devices",
    "shard_batch",
    "zero1_optimizer",
]
