"""The model axis over ranks: Megatron-style tensor parallelism (the
counterpart of the reference's ``tp_axis``, ``multimodal_tta_tpu/models/vit.py``),
and the pieces every axis that cuts a tensor shares (``ShardAxis``, the two
collectives, ``narrow_param``, the whole / local trees; the expert axis of
``parallel/expert.py`` uses them over its own group).

The reference names the mesh axis and XLA shards the heads of
``SelfAttention`` and the MLP features of ``EncoderBlock`` over it. Here
each rank of a model group (``Mesh.model_group``, the ranks of one data
index) holds its share of those weights, and the modules call the two
collectives of Megatron-LM themselves:

  * ``copy_to`` ("f"): the identity forward; the backward sums the
    input's gradient over the model group, since each rank's heads or
    features saw the whole input;
  * ``reduce_from`` ("g"): the forward sums the row-parallel
    products over the model group; the backward is the identity.

A sharded pair is column-parallel then row-parallel: q/k/v take the rows
(output features) of this rank's heads, the out projection the matching
columns, and its bias is added once after the sum; the MLP's ``Dense_0``
takes a block of hidden features (rows and bias), ``Dense_1`` the matching
columns. One ``all_reduce`` a forward for each, one a backward. Everything
else (LayerNorms, embeddings, MoE blocks, the head, UNETR's conv decoder)
stays whole on every rank. Each rank computes its own gradient of those,
which kernels that sum in a free order round apart, so the step averages
them over the model group (``Mesh.sum_flat`` with ``shard_axes``) and the
ranks' whole params stay one value, as in the reference.

The model is built whole from its seed on every rank and ``shard_model``
cuts each rank's share, so the ranks together hold the weights one process
holds. A checkpoint holds the whole tree: ``whole_state_dict`` gathers the
shares and ``local_tensors`` cuts a whole tree to this rank's share, so a
checkpoint of a run over a model (or expert) axis loads into one process
and the reverse. Each module that holds a share records it in ``shards``
(``{param: (dim, axis)}``), which ``sharded_params`` reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

MODEL_AXIS = "model"


@dataclass(frozen=True)
class ShardAxis:
    """This rank's place on an axis that cuts tensors (the model axis, the
    expert axis): its ``size``, ``rank``, the ``group`` of the ranks that
    hold the other shares, and the axis ``name``."""

    size: int
    rank: int
    group: Any = None
    name: str = MODEL_AXIS

    def block(self, n: int, what: str) -> slice:
        """This rank's block of ``n`` heads, features or experts."""
        if n % self.size:
            raise ValueError(f"[tensor] {what}={n} does not split over a {self.name} axis of {self.size}")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def axis_of(mesh, name: str = MODEL_AXIS) -> Optional[ShardAxis]:
    """The ``name`` axis of ``mesh`` (None without one, or of size 1)."""
    if mesh is None or getattr(mesh, name, 1) <= 1:
        return None
    return ShardAxis(getattr(mesh, name), getattr(mesh, f"{name}_rank"), getattr(mesh, f"{name}_group"), name)


def check_tp_axis(tp_axis: Optional[str]) -> Optional[str]:
    """``tp_axis`` is None or the model axis (the only one that shards
    heads and MLP features)."""
    if tp_axis and tp_axis != MODEL_AXIS:
        raise ValueError(f"tp_axis={tp_axis!r}: heads and MLP features shard over the {MODEL_AXIS!r} axis")
    return tp_axis or None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.axis.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        x = x.contiguous().clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=axis.group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, axis: Optional[ShardAxis]) -> torch.Tensor:
    """Megatron's "f": ``x`` as it is; its gradient summed over the axis's group."""
    return x if axis is None else _Copy.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Optional[ShardAxis]) -> torch.Tensor:
    """Megatron's "g": ``x`` summed over the axis's group; its gradient as it is."""
    return x if axis is None else _Reduce.apply(x, axis)


def narrow_param(module: nn.Module, name: str, dim: int, block: slice, axis: ShardAxis) -> None:
    """Replace ``module``'s param ``name`` (dotted, under ``module``) by its
    ``block`` along ``dim`` over ``axis``, and record the cut in
    ``module.shards``."""
    owner_name, _, pname = name.rpartition(".")
    owner = module.get_submodule(owner_name) if owner_name else module
    p = getattr(owner, pname)
    piece = p.detach().narrow(dim, block.start, block.stop - block.start).clone()
    setattr(owner, pname, nn.Parameter(piece, requires_grad=p.requires_grad))
    module.shards = dict(getattr(module, "shards", {}), **{name: (dim, axis)})


def shard_model(model: nn.Module, mesh) -> int:
    """Cut each ``tp_axis`` module of ``model`` (``SelfAttention`` and a dense
    ``EncoderBlock``) to this rank's share over the model axis of ``mesh``;
    returns how many modules were cut (0 without a model axis). A model
    axis over a model without such a module raises."""
    axis = axis_of(mesh)
    if axis is None:
        return 0
    mods = [m for m in model.modules() if getattr(m, "tp_axis", None) and hasattr(m, "shard")]
    if not mods:
        raise ValueError(f"[tensor] a model axis of {axis.size} needs a model built with tp_axis={MODEL_AXIS!r} "
                         f"(model.tp_axis; the transformers' heads and MLP features shard over it), "
                         f"not {type(model).__name__}")
    for m in mods:
        m.shard(axis)
    return len(mods)


def sharded_params(model: nn.Module) -> Dict[str, Tuple[int, ShardAxis]]:
    """``{param name: (dim, axis)}`` of every param ``model`` holds a share of
    (over the model or the expert axis)."""
    out = {}
    for mname, m in model.named_modules():
        for name, cut in getattr(m, "shards", {}).items():
            out[f"{mname}.{name}" if mname else name] = cut
    return out


def shard_axes(model: nn.Module, names) -> List[Optional[str]]:
    """The axis each param of ``names`` is cut over (``sharded_params``),
    None for a whole one: ``Mesh.sum_flat``'s ``shards``."""
    cut = sharded_params(model)
    return [cut[n][1].name if n in cut else None for n in names]


def gather_share(t: torch.Tensor, dim: int, axis: ShardAxis) -> torch.Tensor:
    """Every share of a tensor over ``axis`` concatenated along ``dim``."""
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    return torch.cat(parts, dim=dim)


def cut_share(t: torch.Tensor, dim: int, axis: ShardAxis) -> torch.Tensor:
    """This rank's share along ``dim`` of a whole tensor."""
    s = axis.block(t.shape[dim], "a sharded dim")
    return t.narrow(dim, s.start, s.stop - s.start)


def whole_tensors(model: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``tensors`` by param name (a state dict, an EMA shadow) with every
    sharded param's share gathered over its group (every rank of the group
    takes part); the others as they are."""
    shards = sharded_params(model)
    return {k: gather_share(v, *shards[k]) if k in shards else v for k, v in tensors.items()}


def local_tensors(model: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of ``whole_tensors``: each sharded param's whole tensor
    cut to this rank's share."""
    shards = sharded_params(model)
    return {k: cut_share(v, *shards[k]).clone() if k in shards else v for k, v in tensors.items()}


def whole_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded param whole."""
    return whole_tensors(model, model.state_dict())


def _param_index(model: nn.Module, optimizer) -> Dict[int, Tuple[str, torch.Tensor]]:
    """``{index in the optimizer's state dict: (param name, param)}``."""
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return {i: (names[id(p)], p) for i, p in enumerate(params)}


def update_rule(optimizer):
    """The update rule under ``MultiSteps`` and ZeRO-1's wrapper."""
    optimizer = getattr(optimizer, "optimizer", optimizer)
    return getattr(optimizer, "optim", optimizer)


def optimizer_state(model: nn.Module, optimizer, sd: Optional[dict], cut: bool) -> Optional[dict]:
    """An optimizer state dict with the moments of each sharded param
    gathered whole (``cut=False``; every rank of its group takes part) or
    cut to this rank's share (``cut=True``); the others, and the scalars, as
    they are. A moment is cut where its param is, unless the update rule
    says otherwise (``state_cut``: Adafactor's factored statistics in the
    flax layout). ``MultiSteps``' state dict (``inner``) takes its update
    rule's this way and its accumulator (a tensor a param, in the param's
    layout) as the params. Without a sharded param: ``sd``."""
    shards = sharded_params(model)
    if not shards or sd is None:
        return sd
    index = _param_index(model, optimizer)
    if "inner" in sd:
        acc = sd.get("acc")
        if acc is not None:
            acc = [_share(a, *shards[index[i][0]], cut) if index[i][0] in shards else a for i, a in enumerate(acc)]
        return dict(sd, inner=optimizer_state(model, optimizer.optimizer, sd["inner"], cut), acc=acc)
    state_cut = getattr(update_rule(optimizer), "state_cut", None)
    state = {}
    for i, entry in sd["state"].items():
        name, p = index.get(int(i), (None, None))
        if name not in shards:
            state[i] = entry
            continue
        dim, axis = shards[name]
        state[i] = {}
        for k, v in entry.items():
            d = state_cut(p, k) if state_cut is not None else dim
            if isinstance(v, torch.Tensor) and d is not None and v.dim() > d:
                v = _share(v, d, axis, cut)
            state[i][k] = v
    return dict(sd, state=state)


def _share(t: torch.Tensor, dim: int, axis: ShardAxis, cut: bool) -> torch.Tensor:
    return cut_share(t, dim, axis).clone() if cut else gather_share(t, dim, axis)


__all__ = [
    "MODEL_AXIS",
    "ShardAxis",
    "axis_of",
    "check_tp_axis",
    "copy_to",
    "cut_share",
    "gather_share",
    "local_tensors",
    "narrow_param",
    "optimizer_state",
    "reduce_from",
    "shard_axes",
    "shard_model",
    "sharded_params",
    "update_rule",
    "whole_state_dict",
    "whole_tensors",
]
