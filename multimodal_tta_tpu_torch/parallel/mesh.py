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

The model axis (``model > 1``): ``data x model`` ranks in the reference's
axis order, rank ``r`` at ``(d, m) = divmod(r, model)``. The model group
(the ranks of one ``d``) holds one replica of the model, each rank its
share of the transformer's heads and MLP features (``parallel/tensor.py``,
Megatron-style, the counterpart of ``tp_axis``); the data group (the ranks
of one ``m``) carries the gradients, the batch sums and the rows of a
per-sample result: ``sum``, ``sum_flat``, ``sum_with_grad`` and
``gather_rows`` run over it, and a model rank's rows are its data rank's.

What has no counterpart: ``ambient_axes``, ``constrain`` and
``constrain_activations`` pin XLA layouts inside one program; here
``parallel/space.py`` and ``parallel/tensor.py`` write the collectives they
imply. The ``expert`` and ``stage`` axes are not ported yet (ROADMAP.md
items 12b-ii part 3 and 12b-iii), nor a space axis beside a model axis
(item 12b-v, with the sequence axis): a mesh that asks for one raises.
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

# the ROADMAP item that ports each axis
_UNPORTED_AXES = {EXPERT_AXIS: "12b-ii part 3", STAGE_AXIS: "12b-iii"}


class Mesh:
    """The data, space and model axes over ``data * space * model`` ranks:
    this process's world ``rank``, its ``device`` and the process ``group``
    of its sums (None: the default group, or one process). With one rank
    every collective is the identity."""

    space = 1  # the space axis (class default: a mesh of the data axis alone)
    model = 1  # the model axis
    space_group = None  # the ranks of this rank's data index (None: the world, or no space axis)
    data_group = None  # the ranks of this rank's space / model index (None: the world, or no data axis)
    model_group = None  # the ranks of this rank's data index over a model axis

    def __init__(self, device: torch.device, data: int = 1, rank: int = 0, group=None, space: int = 1,
                 model: int = 1):
        self.device = device
        self.data = int(data)
        self.space = int(space)
        self.model = int(model)
        self.rank = int(rank)
        self.group = group
        if not 0 <= self.rank < self.size:
            raise ValueError(f"[mesh] rank {self.rank} outside a mesh of {self.data}x{self.space}x{self.model}")
        if self.space > 1 and self.model > 1:
            raise NotImplementedError(
                f"[mesh] a space axis ({SPACE_AXIS}={self.space}) beside a model axis ({MODEL_AXIS}="
                f"{self.model}) is not ported yet (ROADMAP.md, item 12b-v: the transformers over the "
                "space axis)")
        if self.size > 1 and not dist.is_initialized():
            raise RuntimeError("[mesh] a data axis over several ranks needs a process group")
        if self.model > 1:
            # every rank creates every group, in one order (torch.distributed's rule)
            for d in range(self.data):
                g = dist.new_group([d * self.model + m for m in range(self.model)])
                if d == self.data_rank:
                    self.model_group = g
            for m in range(self.model):
                g = dist.new_group([d * self.model + m for d in range(self.data)])
                if m == self.model_rank:
                    self.data_group = g
            self.group = self.data_group  # the sums run over the data group
        if self.space > 1 and self.data > 1:
            # every rank creates every group, in one order (torch.distributed's rule)
            for d in range(self.data):
                g = dist.new_group([d * self.space + s for s in range(self.space)])
                if d == self.data_rank:
                    self.space_group = g
            for s in range(self.space):
                g = dist.new_group([d * self.space + s for d in range(self.data)])
                if s == self.space_rank:
                    self.data_group = g

    @property
    def shape(self) -> Dict[str, int]:
        out = {DATA_AXIS: self.data, SPACE_AXIS: self.space}
        if self.model > 1:
            out[MODEL_AXIS] = self.model
        return out

    @property
    def size(self) -> int:
        return self.data * self.space * self.model

    @property
    def parallel(self) -> bool:
        """More than one rank."""
        return self.size > 1

    @property
    def data_rank(self) -> int:
        return self.rank // (self.space * self.model)

    @property
    def space_rank(self) -> int:
        return (self.rank // self.model) % self.space

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

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
        """``t`` summed over the ranks (over a model axis: its data group),
        in place (no gradient)."""
        if self.sums:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks as a new tensor without a gradient
        (``t`` itself on one rank)."""
        return self.sum(t.detach().clone()) if self.sums else t

    def sum_flat(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``tensors`` (one dtype) summed over the ranks in one
        ``all_reduce`` of a flat buffer (themselves on one rank)."""
        if not self.sums:
            return list(tensors)
        flat = self.sum(torch.cat([t.reshape(-1) for t in tensors]))
        return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]

    def sum_with_grad(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, differentiable: the gradient of each
        rank's ``t`` is the sum of the ranks' upstream gradients."""
        if not self.sums:
            return t
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's ``t`` (equal shapes), concatenated on dim 0 in
        rank order: the global batch of a per-row tensor. Over a space axis
        the data group gathers: its space ranks hold the same rows."""
        if self.data == 1:
            return t
        return all_gather_cat(t, 0, self.data, self.data_group if self.data_group is not None else self.group)

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Rank 0's values into ``tensors`` on every rank of the world (a
        whole model, before a model axis cuts each rank's share)."""
        if self.parallel:
            with torch.no_grad():
                for t in tensors:
                    dist.broadcast(t, src=0)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, space={self.space}, model={self.model}, rank={self.rank}, "
                f"device={self.device})")


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
    the other axes leave), with the reference's checks and messages; an
    expert or stage axis above 1 raises ``NotImplementedError``, naming its
    ROADMAP item."""
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
    for axis, size in ((EXPERT_AXIS, expert), (STAGE_AXIS, stage)):
        if size > 1:
            raise NotImplementedError(
                f"[mesh] the {axis} axis ({axis}={size}) is not ported yet "
                f"(ROADMAP.md, item {_UNPORTED_AXES[axis]}); the data, space and model axes run over ranks")
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
    ``space`` and ``model`` leave. The reference's size checks and
    messages; an expert or stage axis above 1 raises
    ``NotImplementedError``, and so does a space axis beside a model
    axis."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    data = axis_sizes(n, data=data, space=space, model=model, stage=stage, expert=expert)
    devices = list(devices) if devices is not None else select_devices()
    device = devices[local_rank()] if len(devices) > 1 else devices[0]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(device, data=data, rank=rank, group=None, space=max(1, int(space)), model=max(1, int(model)))


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
    "Mesh",
    "Layout",
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
