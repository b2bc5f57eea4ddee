"""Carry flax model weights across to the port's models.

``from_flax(params)`` takes the flax ``params`` tree as a nested dict of
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) and returns a
``state_dict`` for the port model's ``load_state_dict``: every model of
``models/`` keeps flax's module names. ``from_flax(params, model)`` returns
the share of a ViT or UNETR cut over a model axis (its rank's heads and MLP
features). ``unet3d_from_flax`` is the same
function. ``variables_from_flax({"params": ..., "batch_stats": ...})``
adds a BatchNorm model's running statistics (flax's ``mean``/``var``
leaves) as the buffers of the same names. It imports no JAX.

  * conv ``kernel`` ``[kd, kh, kw, in, out]`` -> ``weight`` ``[out, in, kd, kh, kw]``,
    and 2D ``[kh, kw, in, out]`` -> ``[out, in, kh, kw]``; a grouped or
    depthwise conv (flax ``feature_group_count``) stores ``in / groups``
    input features in both layouts, so it takes the same transpose
  * dense ``kernel`` ``[in, out]`` -> ``weight`` ``[out, in]`` (``nn.Linear``)
  * transposed conv (the ``up`` module of ``TransposedConvUp``, and the
    2D ``dec{i}`` of ``vae_delta_mog``): flax's ``nn.ConvTranspose`` with
    ``transpose_kernel=False`` correlates the dilated input with the kernel
    as stored, while ``conv_transpose3d`` / ``2d`` scatters it, so the
    kernel is flipped spatially and laid out as ``[in, out, kd, kh, kw]``
    (``[in, out, kh, kw]``)
  * attention (flax ``DenseGeneral``, an ``nn.Linear`` here): the q/k/v
    ``kernel`` ``[H, heads, hd]`` -> ``weight`` ``[heads*hd, H]`` and its
    ``bias`` ``[heads, hd]`` -> ``[heads*hd]``; the ``out`` ``kernel``
    ``[heads, hd, H]`` -> ``weight`` ``[H, heads*hd]``
  * every other ``bias`` as is; norm ``scale``/``bias`` by name; the
    transformers' ``pos_embed`` ``[1, N, H]`` and ``rel_pos_bias``
    ``[(2w-1)^3, heads]`` as they are
  * MoE (``models/moe.py``): the ``router`` is a dense layer; the experts'
    ``wi`` ``[E, H, F]``, ``bi`` ``[E, F]``, ``wo`` ``[E, F, H]`` and ``bo``
    ``[E, H]`` keep their layout; ``moe_ln``, the MoE block's ``LayerNorm_1``
    and UNet3D's ``ds_head{i}`` convs take the rules above

``flax_path(name)`` goes the other way for a name: the reference's
'/'-joined param path of a torch parameter, ``flax_layouts(model)`` for a
layout: how each parameter reads as the flax leaf it came from, and
``to_flax(state_dict, model)`` for a whole state dict: the ``params`` tree
(and a BatchNorm model's ``batch_stats``) in the reference's layout, each
leaf in its own dtype, so that ``from_flax`` of it gives the state dict back
bit for bit (``core/checkpoint.py`` writes the reference's msgpack
checkpoints through it).
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..parallel.tensor import local_tensors, sharded_params

_TRANSPOSED = "up"  # module name of TransposedConvUp's nn.ConvTranspose
_TRANSPOSED_2D = re.compile(r"dec\d+")  # vae_delta_mog's decoder nn.ConvTranspose (a 2D kernel)
_ATTN_OUT = "out"  # module name of an attention's out projection (DenseGeneral over heads, hd)


def _leaves(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def flax_path(name: str) -> str:
    """The reference's '/'-joined param path of a torch parameter name
    (``enc0.unit0.conv.weight`` -> ``enc0/unit0/conv/kernel``), which
    ``update_path_regex`` and the no-decay rules are matched against."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


def from_flax(params: Mapping[str, Any], model: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """The port state dict of a flax ``params`` tree; given a ``model``
    cut over a model axis (``parallel/tensor.py:shard_model``), the share
    that model holds: each sharded kernel's block of heads or MLP features
    on its model rank."""
    sd = _from_flax(params)
    return sd if model is None else local_tensors(model, sd)


def _from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params):
        a = leaf.float().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf, dtype=np.float32)
        mod, name = path[:-1], path[-1]
        if name == "bias" and a.ndim == 2:  # q/k/v DenseGeneral [heads, hd]
            a = a.reshape(-1)
        elif name == "kernel":
            if a.ndim == 3:  # DenseGeneral: q/k/v [H, heads, hd], out [heads, hd, H]
                a = a.reshape(-1, a.shape[-1]) if mod[-1] == _ATTN_OUT else a.reshape(a.shape[0], -1)
            if a.ndim == 2:
                sd[".".join(mod + ("weight",))] = torch.from_numpy(a.T.copy())
                continue
            if a.ndim == 4 and _TRANSPOSED_2D.fullmatch(mod[-1]):
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
            elif a.ndim == 4:  # 2D conv [kh, kw, in / groups, out]
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim != 5:
                raise ValueError(f"{'/'.join(path)}: expected a 2D or 3D conv, a dense or an attention "
                                 f"kernel, got {a.shape}")
            elif mod[-1] == _TRANSPOSED:
                a = a[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
            else:
                a = a.transpose(4, 3, 0, 1, 2)
            name = "weight"
        sd[".".join(mod + (name,))] = torch.from_numpy(a.copy())  # C-contiguous, writable
    return sd


unet3d_from_flax = from_flax

_ATTENTION_INPUTS = ("query", "key", "value")


def flax_layouts(model: nn.Module) -> Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """``{param name: (perm, shape)}``: ``p.permute(perm).reshape(shape)``
    is the parameter in the layout of its flax leaf, up to the spatial flip
    of a transposed conv (``from_flax`` the other way): a conv kernel
    ``[kd, kh, kw, in, out]``, a dense kernel ``[in, out]``, an attention's
    q/k/v kernel ``[H, heads, hd]`` and bias ``[heads, hd]``, its out kernel
    ``[heads, hd, H]``. Optimizers that treat axes apart (Adafactor's
    factored moments) read a parameter through it."""
    out = {}
    for mname, m in model.named_modules():
        heads = getattr(m, "heads", None)
        for cname, c in m.named_children():
            prefix = f"{mname}.{cname}" if mname else cname
            w = getattr(c, "weight", None)
            if isinstance(c, nn.Linear):  # from the weight: a share cut over a model axis keeps its features
                n_out, n_in = w.shape
            if isinstance(c, nn.Linear) and heads and cname in _ATTENTION_INPUTS:
                out[prefix + ".weight"] = ((1, 0), (n_in, heads, n_out // heads))
                if c.bias is not None:
                    out[prefix + ".bias"] = ((0,), (heads, n_out // heads))
            elif isinstance(c, nn.Linear) and heads and cname == _ATTN_OUT:
                out[prefix + ".weight"] = ((1, 0), (heads, n_in // heads, n_out))
            elif isinstance(c, nn.Linear):
                out[prefix + ".weight"] = ((1, 0), (n_in, n_out))
            elif isinstance(c, (nn.Conv2d, nn.Conv3d)):
                perm = tuple(range(2, w.dim())) + (1, 0)
                out[prefix + ".weight"] = (perm, tuple(w.shape[i] for i in perm))
            elif isinstance(c, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
                perm = tuple(range(2, w.dim())) + (0, 1)
                out[prefix + ".weight"] = (perm, tuple(w.shape[i] for i in perm))
    for name, p in model.named_parameters():
        out.setdefault(name, (tuple(range(p.dim())), tuple(p.shape)))
    return {name: out[name] for name, _ in model.named_parameters()}


def flax_cut_dim(perm: Tuple[int, ...], torch_shape, flax_shape, dim: int) -> int:
    """The axis of a parameter's flax layout (``flax_layouts``: permuted by
    ``perm``, then reshaped to ``flax_shape``) that holds its torch dim
    ``dim``: the first flax axis of the group that dim reshapes into (a cut
    of q/k/v's rows is a cut of their heads)."""
    permuted = [torch_shape[i] for i in perm]
    before = math.prod(permuted[:perm.index(dim)])
    for k in range(len(flax_shape)):
        if math.prod(flax_shape[:k]) == before:
            return k
    raise ValueError(f"[convert] no axis of the flax layout {tuple(flax_shape)} holds dim {dim} of {tuple(torch_shape)}")


def transposed_kernels(model: nn.Module) -> set:
    """The names of ``model``'s transposed-conv kernels: their flax leaf is
    their ``flax_layouts`` view flipped in space."""
    return {f"{n}.weight" for n, m in model.named_modules() if isinstance(m, (nn.ConvTranspose2d, nn.ConvTranspose3d))}


def flax_leaf_of(model: nn.Module) -> Callable[[str, torch.Tensor], torch.Tensor]:
    """``leaf(name, t)``: the tensor ``t``, laid out as parameter ``name``
    of ``model`` (or a moment of it), in the layout of its flax leaf
    (``flax_layouts``; a transposed conv's kernel flipped back), in its own
    dtype and contiguous. ``t`` is whole: a param cut over a model or expert
    axis takes the whole size on its cut axis."""
    layouts = flax_layouts(model)
    shards = sharded_params(model)
    params = dict(model.named_parameters())
    transposed = transposed_kernels(model)

    def leaf(name: str, t: torch.Tensor) -> torch.Tensor:
        perm, shape = layouts[name]
        if name in shards:
            shape = list(shape)
            shape[flax_cut_dim(perm, params[name].shape, layouts[name][1], shards[name][0])] = -1
        out = t.permute(perm).reshape(shape)
        if name in transposed:  # from_flax flips it on the way in
            out = out.flip(tuple(range(t.dim() - 2)))
        return out.contiguous()

    return leaf


def nest(flat: Mapping[str, Any], sep: str) -> Dict[str, Any]:
    """``{"a.b.c": v}`` -> ``{"a": {"b": {"c": v}}}`` (split on ``sep``)."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        *mods, name = key.split(sep)
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = v
    return out


def to_flax(state_dict: Mapping[str, torch.Tensor], model: nn.Module) -> Dict[str, Any]:
    """``{"params": ..., "batch_stats": ...}``: the reference's variables of
    a whole state dict of ``model`` (``tp.whole_state_dict``), the inverse of
    ``variables_from_flax``: the params through ``flax_leaf_of``, the
    buffers (a BatchNorm's ``mean`` / ``var``; ``{}`` without one) as they
    are. Leaves are tensors in their own dtype, on their own device."""
    leaf = flax_leaf_of(model)
    names = {n for n, _ in model.named_parameters()}
    params = {flax_path(n): leaf(n, t) for n, t in state_dict.items() if n in names}
    stats = {n: t.contiguous() for n, t in state_dict.items() if n not in names}
    return {"params": nest(params, "/"), "batch_stats": nest(stats, ".")}


def variables_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``from_flax`` of ``variables["params"]`` plus the ``batch_stats``
    collection's leaves (``.../mean``, ``.../var``) as buffers by name."""
    sd = from_flax(variables["params"])
    for path, leaf in _leaves(variables.get("batch_stats") or {}):
        sd[".".join(path)] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    return sd


def _present(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """``tree`` without its None leaves (a JAX adapter's trainable subtree
    holds None at every frozen param)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            v = _present(v)
            if v:
                out[k] = v
        elif v is not None:
            out[k] = v
    return out


def serving_state_from_flax(names, params, batch_stats, opt_state, carry=()) -> list:
    """The port's flat serving state (the leaf ``names`` that
    ``TentAdapter.serving_export_spec`` gives) from the state tuple of the
    JAX adapter's ``serving_export_spec``, as numpy: ``params``,
    ``batch_stats`` (None without BatchNorm), the optax state (a chain's
    tuple of states: ``TraceState.trace`` gives the momentum buffers,
    ``ScaleByAdamState`` ``mu``, ``nu`` and ``count``) and the method's
    carry (SAR's ``em`` scalar; CoTTA's teacher subtree)."""
    sd = variables_from_flax({"params": params, "batch_stats": batch_stats or {}})
    for part in opt_state:
        fields = getattr(part, "_fields", ())  # an optax state is a NamedTuple
        for field, prefix in (("trace", "momentum"), ("mu", "mu"), ("nu", "nu")):
            if field in fields:
                sd.update({f"opt:{prefix}:{k}": v for k, v in from_flax(_present(getattr(part, field))).items()})
        if "count" in fields:
            sd["opt:count"] = torch.tensor(float(np.asarray(part.count)), dtype=torch.float32)
    for c in carry:
        if isinstance(c, Mapping):
            sd.update({f"teacher:{k}": v for k, v in from_flax(_present(c)).items()})
        else:
            sd["em"] = torch.tensor(float(np.asarray(c)), dtype=torch.float32)
    out = []
    for n in names:
        key = n.split(":", 1)[1] if n.startswith(("param:", "stat:")) else n
        if key not in sd:
            raise KeyError(f"serving_state_from_flax: no JAX leaf for {n}")
        out.append(sd[key])
    return out
