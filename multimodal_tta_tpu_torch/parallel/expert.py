"""The expert axis over ranks (the counterpart of the reference's
``expert_state_sharding`` and of the expert half of
``train_state_sharding``, ``multimodal_tta_tpu/parallel/mesh.py:212-288``).

The reference pins a MoE block's ``[E, ...]`` tensors to the mesh
``expert`` axis and XLA shards the experts' parameters, their moments and
the expert FFNs over it. Here each rank of an expert group
(``Mesh.expert_group``: the ranks of one data index) holds ``E / ep``
experts of every MoE block: ``shard_experts`` cuts the block's ``wi``,
``bi``, ``wo`` and ``bo`` on dim 0 after a whole build from the seed,
whenever ``E`` divides by the axis. Every other tensor, the router
included, stays whole, as the reference's rule keeps it. ``models/moe.py``
runs the router, the dispatch and the load balance whole on the rank's rows
and the three einsums for its own experts, then sums its share of the
combine over the expert group (Megatron's "g", ``parallel/tensor.py``).

The reference keys its rule on the param path (a leaf under a module named
``moe``), so the flagship UNet3D's ``moe_bottleneck`` keeps whole params
there while XLA still computes its experts sharded; the port cuts every
``MoEMlp`` whose ``expert_axis`` is the mesh axis: the same numbers, fewer
bytes a rank.

A checkpoint and the converter see the whole tree through
``parallel/tensor.py`` (``whole_tensors`` gathers each expert share over
the expert group, ``local_tensors`` cuts it), so a checkpoint moves between
an expert axis and one process.
"""

from __future__ import annotations

from torch import nn

from .tensor import axis_of, local_tensors, whole_tensors

EXPERT_AXIS = "expert"


def shard_experts(model: nn.Module, mesh) -> int:
    """Cut every MoE block of ``model`` over the expert axis of ``mesh`` to
    this rank's ``E / ep`` experts; returns how many blocks were cut (0
    without an expert axis). A block whose expert count does not divide by
    the axis stays whole, as in the reference."""
    axis = axis_of(mesh, EXPERT_AXIS)
    if axis is None:
        return 0
    mods = [m for m in model.modules()
            if getattr(m, "expert_axis", None) == EXPERT_AXIS and m.num_experts % axis.size == 0]
    for m in mods:
        m.shard(axis)
    return len(mods)


__all__ = ["EXPERT_AXIS", "local_tensors", "shard_experts", "whole_tensors"]
