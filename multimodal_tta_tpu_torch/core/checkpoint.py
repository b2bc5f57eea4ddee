"""Checkpoint serialization (the port of ``multimodal_tta_tpu/core/checkpoint.py``).

An extension-less ``path`` is written in one of three formats, each with the
reference's JSON sidecar ``path.json`` (epoch, best metrics, scheduler
state, ``_format``):

  * ``msgpack`` (the default, the reference's and the stock configs'):
    ``path.msgpack`` holds what the reference's ``save_checkpoint`` writes
    (``flax.serialization.to_bytes`` of ``{step, params, batch_stats,
    opt_state[, ema_params]}``), byte for byte: the params, BatchNorm
    statistics and EMA shadow in flax's layout (``models/convert.py:to_flax``)
    and the optimizer's state as the reference's optax chain
    (``core/optim.py:optax_state``), through the port's own codec
    (``core/flax_msgpack.py``; no flax, no msgpack package). So a checkpoint
    of the JAX package resumes, adapts and serves here, and one of the port
    resumes there. The sidecar also keeps the exact learning rate, which the
    file holds as float32 (``_learning_rate``; a run of the port resumes
    with it bit for bit).
  * ``torch``: ``path.pt``, ``torch.save`` of the model's and the
    optimizer's state dicts, the step and, when the run tracks it, the EMA
    shadow.
  * ``orbax`` (``training.checkpoint_format: orbax``, alias ``sharded``):
    ``path.orbax/``, the reference's multi-host format
    (``save_checkpoint_sharded``: orbax's ``StandardCheckpointer``, an OCDBT
    database of zarr v2 arrays), through ``core/orbax_format.py`` (no orbax,
    tensorstore or zstd package). It is written into ``path.orbax.tmp`` and
    renamed, an earlier ``path.orbax`` replaced: it is moved to
    ``path.orbax.old`` first and removed once the new one stands, and a
    save cut between the two renames leaves it there, where
    ``checkpoint_file`` finds it (``orbax_format.commit``). Over ranks each rank writes
    only its own chunks into ``ocdbt.process_<rank>/`` (``_orbax_leaves``):
    rank 0 the leaves replicated over the data and space axes; over a model
    or expert axis each rank of the first replica its cut of each sharded
    param, EMA shadow and moment, as one chunk of the leaf in flax's layout;
    under ZeRO-1 each rank the moments of its own partition (rank 0 those
    of a param the optimizer does not hold). After a barrier rank 0 writes
    the top-level tree and the sidecar. Two cases
    gather the whole tree to rank 0 instead (ROADMAP.md §3): Adafactor over
    a model or expert axis (its factored statistics are no block of the
    cut), and ZeRO-1 beside such an axis. Every rank reads the whole tree
    and cuts its share, as for msgpack. The reference's
    ``load_checkpoint_sharded`` needs the file's tree and the template's to
    match: toggling EMA between an orbax save and its resume
    raises ``ValueError`` there, and here.

The first two are written to a ``.tmp`` file first and renamed with
``os.replace``, so an interrupted save never leaves a torn checkpoint (orbax:
above). In every format the sidecar is written after the rename, as in the
reference: a save cut between the two leaves the new checkpoint beside the
earlier sidecar. ``load_checkpoint`` reads whichever is there; with more than
one, the sidecar's ``_format`` decides (without one, the newest), as the
reference decides between msgpack and orbax, and says so.

``load_params_only`` reads a model's params and buffers alone (the
frozen teacher of ``core/distill.py``), with no optimizer template, from
msgpack or torch (an orbax checkpoint alone raises, as in the reference).

Over ranks (msgpack, torch) rank 0 writes, as in the reference, and the
other ranks wait at a barrier. Under ZeRO-1 (``training.zero1``) the
optimizer's state is first consolidated to rank 0, so the file holds the plain optimizer's state:
a checkpoint of a run over ranks resumes in one process and the reverse
(``ZeroRedundancyOptimizer.load_state_dict`` takes its partition). Every
rank reads the file to resume. Over a model or expert axis
(``parallel/tensor.py``) the file holds the whole tree too: the ranks of a
model group gather each sharded param, its EMA shadow and its optimizer
moments, and a rank that loads cuts its share, so a checkpoint moves between
any model axis and one process.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.convert import flax_cut_dim, flax_layouts, flax_path, from_flax, to_flax, variables_from_flax
from ..parallel import tensor as tp
from ..parallel.distributed import barrier, is_primary_host
from ..utils.logger import get_logger
from . import flax_msgpack, orbax_format
from .optim import Adafactor, MultiSteps, load_optax_state, optax_state
from .train_state import TrainState, shadow_module


FORMATS = {"msgpack": ".msgpack", "torch": ".pt", "orbax": ".orbax"}


def _zero1_of(optimizer):
    """The ``ZeroRedundancyOptimizer`` of ``optimizer`` (itself, or inside
    ``MultiSteps``), or None."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    inner = getattr(optimizer, "optimizer", optimizer)
    return inner if isinstance(inner, ZeroRedundancyOptimizer) else None


def _whole_state(state: TrainState):
    """``(params and buffers, EMA shadow, optimizer state dict)``, whole;
    under ZeRO-1 every rank takes part in the consolidation and only rank
    0's are complete (None elsewhere)."""
    model = tp.whole_state_dict(state.model)
    ema = None if state.ema_params is None else tp.whole_tensors(state.model, state.ema_params)
    zero = _zero1_of(state.optimizer)
    if zero is not None:
        # each data group consolidates to its first rank: over a model axis
        # those ranks form one model group and gather its moments together
        zero.consolidate_state_dict(to=0)
        if zero.rank != 0:
            return None
    optimizer = tp.optimizer_state(state.model, state.optimizer, state.optimizer.state_dict(), cut=False)
    if not is_primary_host():
        return None
    return model, ema, optimizer


def _torch_payload(state: TrainState, sd, ema, optimizer) -> Dict[str, Any]:
    payload = {"step": int(state.step), "model": sd, "optimizer": optimizer}
    # the EMA shadow rides along only when the run tracks it
    if ema is not None:
        payload["ema_params"] = ema
    return payload


def _msgpack_payload(state: TrainState, sd, ema, opt_sd) -> Dict[str, Any]:
    """The reference's payload (``_state_payload`` there), as flax lays it
    out; the EMA shadow only when the run tracks it, as there."""
    variables = to_flax(sd, state.model)
    params = {n: sd[n] for n, _ in state.model.named_parameters()}
    payload = {"step": np.asarray(state.step, np.int32), "params": variables["params"],
               "batch_stats": variables["batch_stats"],
               "opt_state": optax_state(state.optimizer, state.model, step=int(state.step), state_dict=opt_sd,
                                        params=params)}
    if ema is not None:
        payload["ema_params"] = to_flax(ema, state.model)["params"]
    return payload


def _rank_world() -> Tuple[int, int]:
    if torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


def _zero1_partition(optimizer, zero) -> dict:
    """The optimizer state dict of this rank's ZeRO-1 partition, indexed as
    the whole optimizer's (the other params hold no state); under
    ``MultiSteps`` with its counters and accumulator."""
    params = [p for g in zero.param_groups for p in g["params"]]
    local = zero.optim.state
    sd = {"state": {i: local[p] for i, p in enumerate(params) if local.get(p)}, "param_groups": []}
    if isinstance(optimizer, MultiSteps):
        sd = {"inner": sd, "mini_step": optimizer.mini_step, "gradient_step": optimizer.gradient_step,
              "acc": optimizer.acc}
    return sd


def _zero1_writes(zero, params: Dict[str, torch.nn.Parameter]) -> Dict[str, bool]:
    """Per param name, whether this rank writes its optimizer state under
    ZeRO-1: the rank whose partition holds it (``zero.optim``, the local
    optimizer, holds this rank's), and rank 0 for a param the optimizer
    does not hold (a frozen one: its moments are the same on every rank).
    Only the data group of rank 0 writes."""
    held = {id(p) for g in zero.param_groups for p in g["params"]}
    mine = {id(p) for g in zero.optim.param_groups for p in g["params"]}
    rank = torch.distributed.get_rank()
    if 0 not in torch.distributed.get_process_group_ranks(zero.process_group):
        return {n: False for n in params}
    return {n: id(p) in mine if id(p) in held else rank == 0 for n, p in params.items()}


def _param_of(keys: List[str], by_path: Dict[Tuple[str, ...], str]) -> Optional[str]:
    """The param whose flax path ends the leaf path ``keys`` (a param, its
    EMA shadow or one of its moments), or None."""
    for i in range(1, len(keys)):
        name = by_path.get(tuple(keys[i:]))
        if name is not None:
            return name
    return None


def _orbax_leaves(state: TrainState) -> List[orbax_format.Leaf]:
    """The orbax leaves of ``state`` with the chunks this rank writes (every
    rank calls it; see the module docstring for who writes what)."""
    rank, world = _rank_world()
    model, optimizer = state.model, state.optimizer
    shards = tp.sharded_params(model)
    zero = _zero1_of(optimizer)
    if world == 1 or (shards and (zero is not None or isinstance(tp.update_rule(optimizer), Adafactor))):
        whole = _whole_state(state)  # gathered to rank 0
        return [] if whole is None else orbax_format.whole_leaves(_msgpack_payload(state, *whole))
    opt_sd = _zero1_partition(optimizer, zero) if zero is not None else optimizer.state_dict()
    payload = _msgpack_payload(state, model.state_dict(), state.ema_params, opt_sd)
    params = dict(model.named_parameters())
    by_path = {tuple(flax_path(n).split("/")): n for n in params}
    layouts = flax_layouts(model)
    zero_writes = _zero1_writes(zero, params) if zero is not None else {}
    leaves = []
    for keys, v in orbax_format.flatten(payload):
        if isinstance(v, str):
            leaves.append(orbax_format.Leaf(keys, empty=v))
            continue
        t = orbax_format.as_tensor(v)
        path = [k for k, _ in keys]
        name = _param_of(path, by_path) if path[0] in ("params", "ema_params", "opt_state") else None
        whole_shape, index, write = tuple(t.shape), (0,) * t.dim(), rank == 0
        if name in shards:
            dim, axis = shards[name]
            perm, fshape = layouts[name]
            if tuple(t.shape) == tuple(fshape):  # laid out as the param's share
                k = flax_cut_dim(perm, params[name].shape, fshape, dim)
                whole_shape = tuple(s * axis.size if i == k else s for i, s in enumerate(t.shape))
                index = tuple(axis.rank if i == k else 0 for i in range(t.dim()))
                write = 0 in torch.distributed.get_process_group_ranks(axis.group)
        elif zero is not None and name is not None and path[0] == "opt_state":
            write = zero_writes[name]
        leaves.append(orbax_format.Leaf(keys, whole_shape, t.dtype, tuple(t.shape), {index: t} if write else {}))
    return leaves


def _save_orbax(path: str, state: TrainState, meta: Dict[str, Any]) -> None:
    """Write ``path.orbax/`` (every rank its own chunks) and the sidecar."""
    directory = path + FORMATS["orbax"]
    tmp = directory + ".tmp"
    rank, world = _rank_world()
    if rank == 0:
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    barrier()
    init = time.time_ns()
    leaves = _orbax_leaves(state)
    orbax_format.write_process(tmp, leaves, rank, write_zarray=rank == 0)
    barrier()
    if rank == 0:
        orbax_format.finalize(tmp, leaves, world, init)
        orbax_format.commit(tmp, directory)
        _write_sidecar(path, meta)
    barrier()


def save_checkpoint(path: str, state: TrainState, extra: Dict[str, Any] = None, *, fmt: str = "msgpack") -> None:
    """path is extension-less; writes ``path.msgpack`` (``fmt="torch"``:
    ``path.pt``; ``fmt="orbax"``: ``path.orbax/``) + ``path.json``
    atomically (rank 0 over ranks, or every rank its own chunks for orbax;
    every rank calls it and returns once the files exist)."""
    if fmt not in FORMATS:
        raise ValueError(f"[checkpoint] unknown checkpoint format: {fmt}")
    if fmt == "orbax":
        meta = dict(extra or {}, _format=fmt, _learning_rate=float(state.optimizer.param_groups[0]["lr"]))
        _save_orbax(path, state, meta)
        return
    whole = _whole_state(state)
    if whole is not None:
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        tmp = path + FORMATS[fmt] + ".tmp"
        meta = dict(extra or {}, _format=fmt)
        if fmt == "msgpack":
            flax_msgpack.dump(_msgpack_payload(state, *whole), tmp)
            meta["_learning_rate"] = float(state.optimizer.param_groups[0]["lr"])
        else:
            torch.save(_torch_payload(state, *whole), tmp)
        os.replace(tmp, path + FORMATS[fmt])
        _write_sidecar(path, meta)
    barrier()


def _json_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, (np.ndarray, torch.Tensor)):
        return o.tolist()
    return str(o)


def checkpoint_file(path: str, formats=tuple(FORMATS)) -> Tuple[str, str]:
    """``(file, format)`` of the checkpoint at the extension-less ``path``
    (among ``formats``). When more than one format is there (a run switched
    ``checkpoint_format`` without cleaning its save dir), the sidecar's
    ``_format`` decides, else the newest file, with the reference's
    warning; none at all raises. An orbax checkpoint that a save cut
    between ``orbax_format.commit``'s renames left in ``path.orbax.old``
    counts as ``path.orbax``."""
    found = {f: path + FORMATS[f] for f in formats if os.path.exists(path + FORMATS[f])}
    if "orbax" in formats and "orbax" not in found and os.path.isdir(orbax_format.old_of(path + FORMATS["orbax"])):
        found["orbax"] = orbax_format.old_of(path + FORMATS["orbax"])  # a save cut between commit's renames
    fmt = next(iter(found), None)
    if len(found) > 1:
        declared = _read_sidecar(path).get("_format")
        fmt = declared if declared in found else max(found, key=lambda f: os.path.getmtime(found[f]))
        get_logger().warning(
            f"[checkpoint] both {' and '.join(found.values())} exist; restoring the {fmt} payload "
            f"({'sidecar-declared' if declared in found else 'newer mtime'})")
    if fmt is None:
        raise FileNotFoundError(f"[checkpoint] no checkpoint at {path} "
                                f"({', '.join(FORMATS[f] for f in formats)})")
    return found[fmt], fmt


def _read_payload(path: str, formats=tuple(FORMATS)) -> Tuple[Dict[str, Any], str]:
    file, fmt = checkpoint_file(path, formats)
    if fmt == "torch":
        # read to the host: the state dicts' loaders put each tensor where
        # the live one lives (Adam's step counts stay on the host, as in a
        # fresh run)
        return torch.load(file, map_location="cpu", weights_only=True), fmt
    if fmt == "orbax":
        return orbax_format.load(file), fmt
    return flax_msgpack.load(file), fmt


def _flax_state_dict(raw: Dict[str, Any], key: str = "params") -> Dict[str, torch.Tensor]:
    """The whole state dict of a msgpack payload's ``key`` tree and its
    ``batch_stats``."""
    return variables_from_flax({"params": raw[key], "batch_stats": raw.get("batch_stats") or {}})


def load_checkpoint(path: str, template_state: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore ``path`` (either format) into ``template_state``'s model and
    optimizer (in place, on their device); returns ``(state,
    extra_metadata)`` with the restored step and EMA shadow. EMA presence
    may differ between the checkpoint and the resuming run
    (``training.ema`` toggled between runs): a shadow in the checkpoint is
    restored either way; resuming with EMA from a checkpoint without one
    starts the shadow at the restored params. An orbax checkpoint raises
    ``ValueError`` instead, as the reference's ``load_checkpoint_sharded``
    does: its restore needs the file's tree and the template's to match."""
    raw, fmt = _read_payload(path)
    if fmt == "orbax" and ("ema_params" in raw) != (template_state.ema_params is not None):
        raise ValueError(
            f"[checkpoint] {path}.orbax {'holds' if 'ema_params' in raw else 'has no'} ema_params and this run "
            f"{'does not track' if 'ema_params' in raw else 'tracks'} EMA: the orbax format restores onto a "
            "matching tree only (the reference's load_checkpoint_sharded raises too); use the msgpack format "
            "to toggle training.ema between runs")
    meta = _read_sidecar(path)
    exact_lr = meta.pop("_learning_rate", None)
    model, optimizer = template_state.model, template_state.optimizer
    device = next(model.parameters()).device
    if fmt == "torch":
        sd, opt, ema = raw["model"], raw["optimizer"], raw.get("ema_params")
    else:  # msgpack and orbax: the reference's payload
        sd = _flax_state_dict(raw)
        opt = load_optax_state(optimizer, model, raw["opt_state"], learning_rate=exact_lr)
        ema = from_flax(raw["ema_params"]) if "ema_params" in raw else None
    model.load_state_dict(tp.local_tensors(model, sd))
    optimizer.load_state_dict(tp.optimizer_state(model, optimizer, opt, cut=True))
    if ema is not None:
        ema = {k: v.to(device) for k, v in tp.local_tensors(model, ema).items()}
    elif template_state.ema_params is not None:
        get_logger().info(
            "[checkpoint] no ema_params in checkpoint; warm-starting the EMA "
            "shadow from the restored params"
        )
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = dataclasses.replace(template_state, step=int(raw["step"]), ema_params=ema)
    return state, meta


def load_params_only(path: str, model: nn.Module, *, use_ema: bool = False) -> nn.Module:
    """Load ONLY the params and buffers of the checkpoint ``path`` (either
    format) into ``model`` (in place; returned): no optimizer template is
    needed, so the loading run's optimizer may differ from the saving run's
    (the frozen teacher of ``core/distill.py``). ``use_ema=True`` takes the
    EMA shadow as the params and raises when the checkpoint has none. An
    orbax checkpoint alone raises ``ValueError``, as in the reference."""
    if os.path.isdir(path + FORMATS["orbax"]) and not any(
            os.path.exists(path + FORMATS[f]) for f in ("msgpack", "torch")):
        raise ValueError(
            f"[checkpoint] {path} is orbax-format; params-only loading needs "
            "the msgpack format — load it with the original training config "
            "and re-save via save_checkpoint()"
        )
    raw, fmt = _read_payload(path, ("msgpack", "torch"))
    if use_ema and "ema_params" not in raw:
        raise ValueError(
            f"[checkpoint] use_ema requested but {path} carries no "
            "ema_params — the teacher was trained without training.ema"
        )
    if fmt == "msgpack":
        sd = _flax_state_dict(raw, "ema_params" if use_ema else "params")
    else:
        sd = dict(raw["model"])
        if use_ema:
            sd.update(raw["ema_params"])
    model.load_state_dict(tp.local_tensors(model, sd))
    return model


def resolve_serving_params(state: TrainState, use_ema: bool) -> TrainState:
    """Swap the EMA shadow in as the serving/adaptation params
    (``training.use_ema_params``): a state whose model is a copy carrying the
    shadow; ``state`` is left as it is. Hard-fails when requested on a
    checkpoint without a shadow — silently serving the raw params when EMA
    metrics selected the checkpoint would be the silent config-ignore
    failure mode."""
    if not use_ema:
        return state
    if state.ema_params is None:
        raise ValueError(
            "[checkpoint] training.use_ema_params=true but the checkpoint "
            "carries no ema_params — train with training.ema.enabled=true"
        )
    return dataclasses.replace(state, model=shadow_module(state.model, state.ema_params))


def _read_sidecar(path: str) -> Dict[str, Any]:
    meta_path = path + ".json"
    if os.path.exists(meta_path):
        with open(meta_path, "r", encoding="utf-8") as f:
            return json.load(f)
    return {}


def _write_sidecar(path: str, extra: Dict[str, Any]) -> None:
    meta = dict(extra or {})
    tmp = path + ".json.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f, default=_json_default)
    os.replace(tmp, path + ".json")
