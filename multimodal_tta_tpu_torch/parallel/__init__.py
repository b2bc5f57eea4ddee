"""Multi-GPU layers of the port (the data, space, model, expert and stage
axes; ``multimodal_tta_tpu/parallel``)."""

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
from .pipeline import (
    make_pipeline_train_step,
    pipeline_apply,
    pipeline_value_and_grad,
    stack_layer_params,
    vit_forward_pipelined,
)

__all__ = [
    "is_primary_host",
    "maybe_initialize_distributed",
    "DATA_AXIS",
    "MODEL_AXIS",
    "SPACE_AXIS",
    "STAGE_AXIS",
    "pipeline_apply",
    "pipeline_value_and_grad",
    "make_pipeline_train_step",
    "stack_layer_params",
    "vit_forward_pipelined",
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
