"""The data axis over ranks (the port of ``multimodal_tta_tpu/parallel/mesh.py``).

The reference is one SPMD program over a ``jax.sharding.Mesh``: the batch
is sharded over the ``data`` axis and XLA inserts the collectives. Here
each rank is one process with one device, and a ``Mesh`` holds the axis
sizes, this process's rank and device, and the process group. The code
that runs the model calls the mesh's collectives itself, so that a run over
``w`` ranks computes what one process computes on the global batch:

  * ``training.batch_size`` is the GLOBAL batch; it is padded to a multiple
    of ``w`` (``pad_batch_to_multiple``) and rank ``r`` holds rows
    ``[r*B/w, (r+1)*B/w)`` (``shard_batch``, ``Mesh.rows``);
  * a mean over the batch is each rank's masked sum over the GLOBAL count,
    and the gradients are SUMMED over ranks (``Mesh.sum_flat``);
  * a batch statistic (BatchNorm, the MoE load balance) pools its sums over
    the ranks before it is used (``Mesh.sum_with_grad``);
  * per-sample metrics are gathered (``Mesh.gather_rows``).

``zero1_optimizer`` is the ``zero1`` half of the reference's
``train_state_sharding``: ``torch.distributed.optim.ZeroRedundancyOptimizer``
over the port's optimizer, each rank keeping the state of a partition of
whole tensors (the reference shards each moment's largest divisible dim:
the same numbers, other bytes per rank).

The space axis (``space > 1``): ``data x space`` ranks, rank ``r`` at
``(d, s) = divmod(r, space)``. Rank ``(d, s)`` holds the rows
``rows(n)`` of data rank ``d`` and the depth planes ``slab(D)``, ``[s*D/space,
(s+1)*D/space)`` (``batch_sharding``). The space group (the ranks of one
``d``) carries the conv halos, the norm statistics and the per-sample sums
(``parallel/space.py``, the counterpart of ``constrain_activations``); the
world carries the gradients; the data group (the ranks of one ``s``)
gathers the rows of a per-sample result (``gather_rows``).

The model, expert and stage axes (``model``, ``expert``, ``stage`` > 1)
follow the reference's axis order ``data, space, model, expert, stage``:
rank ``r`` sits at ``(d, s, m, e, t)``, the stage index varying fastest.
The group of an axis is the ranks that share every other index
(``model_group``, ``expert_group``, ``stage_group``; ``data_group``, the
ranks of one model, expert and stage index). A rank's rows are its data
rank's (the reference's ``batch_sharding`` is ``P(data)``), so the ranks of
a model, expert or stage group hold the same rows:

  * the model group holds one replica of a transformer, each rank its share
    of the heads and MLP features (``parallel/tensor.py``, Megatron-style);
  * the expert group holds one replica of a MoE model, each rank ``E/ep``
    experts of every MoE block (``parallel/expert.py``, ``models/moe.py``);
  * the stage group runs the layer groups of a pipelined trunk
    (``parallel/pipeline.py``); every other path computes its data rank's
    step whole on each stage rank, as the reference's jit does with a stage
    axis its program does not name.

``sum``, ``sum_flat``, ``sum_with_grad`` and ZeRO-1 run over the data
group (over a space axis too: the data x space group), ``gather_rows``
over the data group.

A tensor whole over a model or expert axis (every param that
``parallel/tensor.py:sharded_params`` does not list, and a sharded one over
the other of the two axes) is one value on every rank of that axis's
group in the reference, by construction. Here each rank computes its own
gradient of it, and kernels that sum in a free order (cuDNN's default
algorithms) round the ranks' gradients apart. So ``sum_flat``, given each
tensor's axis (``shards``: a step's gradients), averages
each such gradient over the group after its sum over data x space, in one
flat ``all_reduce`` a group (``_replica_mean``): every rank then steps the
same gradient, and the ranks' whole params, optimizer state included, stay
bit for bit equal.

A space axis beside a model, expert or stage axis: the space group is the
ranks that share ``(d, m, e, t)``, and the gradients and a batch's
statistics sum over the data x space group, the ranks that share
``(m, e, t)`` (``Mesh.group``). ``local`` and ``gather`` cut and gather the
rows and the slab as without the other axis. A pipeline
(``parallel/pipeline.py``) takes its data rank's rows whole on each space
rank: in the reference the space ranks of a pipeline are replicas
(``x_spec = P(None, data)``), and it sums its gradients over the data group
alone, so they count once. ``axis_groups`` lists every axis's groups from
the sizes alone.

What has no counterpart: ``ambient_axes``, ``constrain`` and
``constrain_activations`` pin XLA layouts inside one program; here
``parallel/space.py``, ``parallel/tensor.py`` and ``parallel/expert.py``
write the collectives they imply.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import DeviceLike, resolve_device
from ..utils.config import get_config
from ..utils.logger import get_logger
from .distributed import local_rank, local_world_size
from .space import all_gather_cat

DATA_AXIS = "data"
SPACE_AXIS = "space"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"
EXPERT_AXIS = "expert"

AXES = (DATA_AXIS, SPACE_AXIS, MODEL_AXIS, EXPERT_AXIS, STAGE_AXIS)  # the reference's order, stage last


def axis_groups(sizes: Sequence[int], *axes: str) -> List[List[int]]:
    """The groups over ``axes`` of a mesh of ``sizes`` (in ``AXES``' order,
    the last varying fastest): each the ranks that share every other index,
    in rank order; the groups in the order of their first rank."""
    sizes = [int(n) for n in sizes]
    free = [AXES.index(a) for a in axes]
    groups: Dict[tuple, List[int]] = {}
    for r in range(int(np.prod(sizes))):
        idx, rest = [], r
        for n in reversed(sizes):
            idx.append(rest % n)
            rest //= n
        idx.reverse()
        groups.setdefault(tuple(i for a, i in enumerate(idx) if a not in free), []).append(r)
    return list(groups.values())


class Mesh:
    """The data, space, model, expert and stage axes over their product of
    ranks: this process's world ``rank``, its ``device`` and the process
    ``group`` of its sums (None: the default group, or one process). With
    one rank every collective is the identity."""

    space = 1  # the space axis (class default: a mesh of the data axis alone)
    model = 1  # the model axis
    expert = 1  # the expert axis
    stage = 1  # the stage axis
    space_group = None  # the ranks that share every index but the space index (None: the world, or no space axis)
    data_group = None  # the ranks that share every index but the data index (None: the world, or no data axis)
    model_group = None  # the ranks that share every index but the model index
    expert_group = None  # the ranks that share every index but the expert index
    stage_group = None  # the ranks that share every index but the stage index

    def __init__(self, device: torch.device, data: int = 1, rank: int = 0, group=None, space: int = 1,
                 model: int = 1, expert: int = 1, stage: int = 1):
        self.device = device
        self.data, self.space, self.model = int(data), int(space), int(model)
        self.expert, self.stage = int(expert), int(stage)
        self.rank = int(rank)
        self.group = group
        if not 0 <= self.rank < self.size:
            raise ValueError(f"[mesh] rank {self.rank} outside a mesh of "
                             f"{'x'.join(str(n) for n in self.sizes.values())}")
        if self.size > 1 and not dist.is_initialized():
            raise RuntimeError("[mesh] a data axis over several ranks needs a process group")
        if self.size > 1 and self.space * self.data < self.size:
            # every rank creates every group, in one order (torch.distributed's rule)
            for axis in (MODEL_AXIS, EXPERT_AXIS, STAGE_AXIS, DATA_AXIS):
                if axis == DATA_AXIS or self.sizes[axis] > 1:
                    setattr(self, f"{axis}_group", self._new_groups(axis))
            self._replicas = {(a,): getattr(self, f"{a}_group") for a in (MODEL_AXIS, EXPERT_AXIS)
                              if self.sizes[a] > 1}
            if len(self._replicas) == 2:
                self._replicas[(MODEL_AXIS, EXPERT_AXIS)] = self._new_groups(MODEL_AXIS, EXPERT_AXIS)
            self.group = self.data_group  # the sums run over the data group
            if self.space > 1:  # ... and its space group: over data x space
                self.space_group = self._new_groups(SPACE_AXIS)
                self.group = self._new_groups(DATA_AXIS, SPACE_AXIS)
        elif self.space > 1 and self.data > 1:
            self.space_group = self._new_groups(SPACE_AXIS)
            self.data_group = self._new_groups(DATA_AXIS)

    def _new_groups(self, *axes: str):
        """Create the group over ``axes`` for every value of the other
        indices (all ranks, one order: ``axis_groups``); returns this rank's."""
        mine = None
        for members in axis_groups(list(self.sizes.values()), *axes):
            g = dist.new_group(members)
            if self.rank in members:
                mine = g
        return mine

    @property
    def sizes(self) -> Dict[str, int]:
        """Every axis's size, in the reference's order."""
        return dict(zip(AXES, (self.data, self.space, self.model, self.expert, self.stage)))

    @property
    def shape(self) -> Dict[str, int]:
        """The axes the reference's mesh materializes: data and space, and
        each of model, expert and stage above 1."""
        return {a: n for a, n in self.sizes.items() if a in (DATA_AXIS, SPACE_AXIS) or n > 1}

    @property
    def size(self) -> int:
        return self.data * self.space * self.model * self.expert * self.stage

    @property
    def parallel(self) -> bool:
        """More than one rank."""
        return self.size > 1

    def _index(self, axis: str) -> int:
        sizes = list(self.sizes.values())
        i = AXES.index(axis)
        return (self.rank // int(np.prod(sizes[i + 1:]))) % sizes[i]

    @property
    def data_rank(self) -> int:
        return self._index(DATA_AXIS)

    @property
    def space_rank(self) -> int:
        return self._index(SPACE_AXIS)

    @property
    def model_rank(self) -> int:
        return self._index(MODEL_AXIS)

    @property
    def expert_rank(self) -> int:
        return self._index(EXPERT_AXIS)

    @property
    def stage_rank(self) -> int:
        return self._index(STAGE_AXIS)

    @property
    def replica_lead(self) -> bool:
        """The first rank of the ranks that hold this rank's rows (space,
        model, expert and stage index 0; a space group gathers its depth
        slabs): the one that writes them."""
        return self.space_rank == self.model_rank == self.expert_rank == self.stage_rank == 0

    def global_rank(self, **index: int) -> int:
        """The world rank of this rank with the given axes' indices changed
        (``global_rank(stage=s + 1)``: the next stage's)."""
        sizes = list(self.sizes.values())
        idx = [index.get(a, self._index(a)) for a in AXES]
        r = 0
        for i, n in zip(idx, sizes):
            r = r * n + i
        return r

    @property
    def sums(self) -> bool:
        """The sums run over more than one rank (the data and space axes)."""
        return self.data * self.space > 1

    def rows(self, n: int) -> slice:
        """This rank's rows of a padded global batch of ``n``."""
        if n % self.data:
            raise ValueError(f"[mesh] a global batch of {n} does not split over a data axis of {self.data}")
        b = n // self.data
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    def slab(self, depth: int) -> slice:
        """This rank's depth planes of a volume of ``depth`` planes."""
        if depth % self.space:
            raise ValueError(f"[mesh] a depth of {depth} does not split over a space axis of {self.space}")
        k = depth // self.space
        return slice(self.space_rank * k, (self.space_rank + 1) * k)

    def local(self, x):
        """This rank's rows and depth slab of a global batch ``x`` [B, D, ...]
        (a tensor or numpy array; its own rows without a space axis)."""
        x = x[self.rows(x.shape[0])]
        return x[:, self.slab(x.shape[1])] if self.space > 1 else x

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch of a per-voxel result ``t`` [b, d, ...] that
        ``local`` cut: the depth gathered over the space group, then the
        rows over the data group (``t`` itself on one rank)."""
        if self.space > 1:
            t = all_gather_cat(t, 1, self.space, self.space_group)
        return self.gather_rows(t)

    # -- collectives (the identity on one rank) -----------------------------
    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks (beside a model, expert or stage axis:
        over the data x space group), in place (no gradient)."""
        if self.sums:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks as a new tensor without a gradient
        (``t`` itself on one rank)."""
        return self.sum(t.detach().clone()) if self.sums else t

    def sum_flat(self, tensors: Sequence[torch.Tensor],
                 shards: Optional[Sequence[Optional[str]]] = None) -> List[torch.Tensor]:
        """``tensors`` (one dtype) summed over the ranks in one
        ``all_reduce`` of a flat buffer (themselves on one rank); with
        ``shards`` (the axis each tensor is cut over, None for a whole one: a
        step's gradients) then averaged over the model and expert axes each
        is whole over (``_replica_mean``)."""
        tensors = list(tensors)
        if self.sums:
            flat = self.sum(torch.cat([t.reshape(-1) for t in tensors]))
            tensors = [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]
        return tensors if shards is None else self._replica_mean(tensors, shards)

    def _replica_mean(self, tensors: Sequence[torch.Tensor], shards: Sequence[Optional[str]]) -> List[torch.Tensor]:
        """Each tensor averaged over the model and expert axes (above 1)
        that it is not cut over (``shards``, as in ``sum_flat``): one flat
        ``all_reduce`` for each set of such axes, so that every rank of the
        group holds the same bits (themselves without those axes)."""
        tensors = list(tensors)
        groups: Dict[tuple, List[int]] = {}
        for i, cut in enumerate(shards):
            axes = tuple(a for a in (MODEL_AXIS, EXPERT_AXIS) if self.sizes[a] > 1 and a != cut)
            if axes:
                groups.setdefault(axes, []).append(i)
        for axes, idx in groups.items():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self._replicas[axes])
            flat.div_(float(np.prod([self.sizes[a] for a in axes])))
            for i, f in zip(idx, flat.split([tensors[i].numel() for i in idx])):
                tensors[i] = f.view_as(tensors[i])
        return tensors

    def sum_with_grad(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, differentiable: the gradient of each
        rank's ``t`` is the sum of the ranks' upstream gradients."""
        if not self.sums:
            return t
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's ``t`` (equal shapes), concatenated on dim 0 in
        rank order: the global batch of a per-row tensor. The data group
        gathers: the ranks of its other axes hold the same rows."""
        if self.data == 1:
            return t
        return all_gather_cat(t, 0, self.data, self.data_group if self.data_group is not None else self.group)

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Rank 0's values into ``tensors`` on every rank of the world (a
        whole model, before a model or expert axis cuts each rank's share)."""
        if self.parallel:
            with torch.no_grad():
                for t in tensors:
                    dist.broadcast(t, src=0)

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.sizes.items())
        return f"Mesh({axes}, rank={self.rank}, device={self.device})"


def data_axis_size(mesh: Optional[Mesh]) -> int:
    """Batch-dim divisibility requirement (the data axis extent; 1 without
    a mesh)."""
    return 1 if mesh is None else int(mesh.data)


def select_devices(training_cfg=None, device: DeviceLike = "cuda") -> List[torch.device]:
    """The device of each rank on this host, by local rank.

    ``training.devices`` as a list of indices gives local rank ``r`` the
    card ``devices[r]`` (``[0, 0]`` puts two ranks on card 0); ``auto``
    (also ``all``/``tpu``/``cpu``/``""``) gives ``cuda:r``, with the
    reference-compat ``training.gpu_ids`` (ignored when it is the default
    ``[0]`` singleton) as the list instead. Ranks never share a card unless
    the list says so: more ranks than cards raises. A CPU run gives ``cpu``
    to every rank, and one process without a list keeps ``device``."""
    dev = resolve_device(device)
    n_local = local_world_size()
    if dev.type == "cpu":
        return [dev] * n_local
    n_cards = torch.cuda.device_count()
    devices = get_config(training_cfg, "devices", "auto") if training_cfg is not None else "auto"
    if isinstance(devices, (list, tuple)):
        idxs = [int(i) for i in devices]
    elif isinstance(devices, str) and devices.lower() in ("auto", "all", "tpu", "cpu", ""):
        if n_local == 1 and not dist.is_initialized():
            return [dev]
        gpu_ids = get_config(training_cfg, "gpu_ids", None) if training_cfg is not None else None
        idxs = list(range(n_local))
        if isinstance(gpu_ids, (list, tuple)) and len(gpu_ids) > 1:
            ids = [int(i) for i in gpu_ids if 0 <= int(i) < n_cards]
            if ids:
                idxs = ids
    else:
        raise ValueError(f"Unrecognized training.devices: {devices!r}")
    if len(idxs) < n_local:
        raise ValueError(
            f"[mesh] {n_local} ranks on this host but {len(idxs)} device(s) selected ({idxs}); "
            f"ranks share a card only when training.devices lists it for each of them")
    bad = [i for i in idxs if not 0 <= i < n_cards]
    if bad:
        raise ValueError(f"[mesh] device indices {bad} out of range: this host has {n_cards} card(s)")
    return [torch.device("cuda", i) for i in idxs[:n_local]]


def axis_sizes(n: int, *, data: int = -1, space: int = 1, model: int = 1, stage: int = 1,
               expert: int = 1) -> int:
    """The data axis of a mesh over ``n`` ranks (``data=-1``: every rank
    the other axes leave), with the reference's checks and messages."""
    space, model, stage, expert = (max(1, int(a)) for a in (space, model, stage, expert))
    per_data = space * model * stage * expert
    if n % per_data != 0:
        raise ValueError(
            f"device count {n} not divisible by space*model*expert*stage="
            f"{space}*{model}*{expert}*{stage}"
        )
    if data == -1:
        data = n // per_data
    if data * per_data != n:
        raise ValueError(
            f"mesh {data}x{space}x{model}x{expert}x{stage} != {n} devices"
        )
    return int(data)


def make_mesh(
    devices: Optional[Sequence[torch.device]] = None,
    *,
    data: int = -1,
    space: int = 1,
    model: int = 1,
    stage: int = 1,
    expert: int = 1,
) -> Mesh:
    """The mesh of this process over the default process group (one rank
    without one), on this rank's device of ``devices`` (by local rank;
    default: ``select_devices()``). ``data=-1`` takes every rank that
    the other axes leave. The reference's size checks and messages."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    data = axis_sizes(n, data=data, space=space, model=model, stage=stage, expert=expert)
    devices = list(devices) if devices is not None else select_devices()
    device = devices[local_rank()] if len(devices) > 1 else devices[0]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(device, data=data, rank=rank, group=None, space=max(1, int(space)), model=max(1, int(model)),
                expert=max(1, int(expert)), stage=max(1, int(stage)))


def mesh_from_config(config, device: DeviceLike = "cuda") -> Mesh:
    """``make_mesh`` from ``training.devices`` / ``training.gpu_ids`` and
    ``training.mesh.*``."""
    tcfg = get_config(config, "training", None)
    devs = select_devices(tcfg, device)
    mcfg = get_config(tcfg, "mesh", None) if tcfg is not None else None

    def axis(name: str, default: int) -> int:
        return int(get_config(mcfg, name, default)) if mcfg is not None else default

    mesh = make_mesh(devs, data=axis("data", -1), space=axis("space", 1), model=axis("model", 1),
                     stage=axis("stage", 1), expert=axis("expert", 1))
    get_logger().info(f"Device mesh: {mesh.shape} over {mesh.size} rank(s); this is rank {mesh.rank} "
                      f"on {mesh.device}")
    return mesh


@dataclass(frozen=True)
class Layout:
    """Where a tensor lives over the ranks: its rows split over the data
    axis and, over a space axis, its depth (dim 1) over the space axis
    (``batch_sharding``), or whole on every rank (``replicated``)."""

    mesh: Mesh
    rows: bool

    def place(self, x) -> torch.Tensor:
        """``x`` (numpy or a tensor) as this rank holds it, on its device."""
        t = torch.as_tensor(x)
        if self.rows:
            t = self.mesh.local(t) if t.dim() >= 4 else t[self.mesh.rows(t.shape[0])]
        return t.to(self.mesh.device)


def batch_sharding(mesh: Mesh) -> Layout:
    """The batch's rows over the data axis and, when the mesh has a space
    axis, the depth of a volume ([B, D, H, W, ...]) over the space axis."""
    return Layout(mesh, True)


def replicated(mesh: Mesh) -> Layout:
    return Layout(mesh, False)


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's contiguous rows of every array leaf, on its device;
    non-arrays pass through."""
    sh = batch_sharding(mesh)
    out = {}
    for k, v in batch.items():
        is_array = (isinstance(v, np.ndarray) and v.ndim >= 1 and v.dtype != object) or (
            isinstance(v, torch.Tensor) and v.dim() >= 1)
        out[k] = sh.place(v) if is_array else v
    return out


def pad_batch_to_multiple(
    batch: Dict[str, Any], multiple: int, array_keys: Sequence[str] = ("image", "label")
) -> (Dict[str, Any], int):
    """Zero-pad the batch dim up to a multiple of the mesh data size.

    Returns (padded batch, original size). Used on eval/TTA streams where the
    tail batch isn't divisible by the device count; metric accumulation masks
    the padding out via the returned original size.
    """
    sizes = [np.asarray(batch[k]).shape[0] for k in array_keys if k in batch]
    if not sizes:
        return batch, 0
    n = sizes[0]
    if n % multiple == 0:
        return batch, n
    pad_to = ((n + multiple - 1) // multiple) * multiple
    out = dict(batch)
    for k in array_keys:
        if k in batch:
            v = np.asarray(batch[k])
            pad_width = [(0, pad_to - n)] + [(0, 0)] * (v.ndim - 1)
            out[k] = np.pad(v, pad_width)
    return out, n


def zero1_optimizer(optimizer_class, groups, mesh: Mesh, **defaults):
    """``optimizer_class(groups, **defaults)`` whose state is partitioned
    over the data axis (ZeRO stage 1): ``ZeroRedundancyOptimizer``. Each
    rank steps its partition and broadcasts the updated params, so the
    params stay equal on every rank and the arithmetic is the plain
    optimizer's."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return ZeroRedundancyOptimizer(groups, optimizer_class, process_group=mesh.group, **defaults)


__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "SPACE_AXIS",
    "STAGE_AXIS",
    "EXPERT_AXIS",
    "AXES",
    "Mesh",
    "Layout",
    "axis_groups",
    "axis_sizes",
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
