"""Checkpoint serialization (the port of ``multimodal_tta_tpu/core/checkpoint.py``).

An extension-less ``path`` is written in one of two formats, each with the
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

Both are written to a ``.tmp`` file first and renamed with ``os.replace``,
so an interrupted save never leaves a torn checkpoint. ``load_checkpoint``
reads whichever is there; with both, the sidecar's ``_format`` decides
(without one, the newer file), as the reference decides between msgpack and
orbax, and says so.

``load_params_only`` reads a model's params and buffers alone (the
frozen teacher of ``core/distill.py``), with no optimizer template.

Over ranks rank 0 writes, as in the reference, and the other ranks wait at
a barrier. Under ZeRO-1 (``training.zero1``) the optimizer's state is first
consolidated to rank 0, so the file holds the plain optimizer's state:
a checkpoint of a run over ranks resumes in one process and the reverse
(``ZeroRedundancyOptimizer.load_state_dict`` takes its partition). Every
rank reads the file to resume. Over a model or expert axis
(``parallel/tensor.py``) the file holds the whole tree too: the ranks of a
model group gather each sharded param, its EMA shadow and its optimizer
moments, and a rank that loads cuts its share, so a checkpoint moves between
any model axis and one process.

The reference's sharded orbax format is not ported (ROADMAP.md, item 13):
loading such a checkpoint raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..models.convert import from_flax, to_flax, variables_from_flax
from ..parallel import tensor as tp
from ..parallel.distributed import barrier, is_primary_host
from ..utils.logger import get_logger
from . import flax_msgpack
from .optim import load_optax_state, optax_state
from .train_state import TrainState, shadow_module


FORMATS = {"msgpack": ".msgpack", "torch": ".pt"}


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


def save_checkpoint(path: str, state: TrainState, extra: Dict[str, Any] = None, *, fmt: str = "msgpack") -> None:
    """path is extension-less; writes ``path.msgpack`` (``fmt="torch"``:
    ``path.pt``) + ``path.json`` atomically (rank 0 over ranks; every rank
    calls it and returns once the files exist)."""
    if fmt not in FORMATS:
        raise ValueError(f"[checkpoint] unknown checkpoint format: {fmt}")
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


def checkpoint_file(path: str) -> Tuple[str, str]:
    """``(file, format)`` of the checkpoint at the extension-less ``path``.
    When more than one format is there (a run switched
    ``checkpoint_format`` without cleaning its save dir), the sidecar's
    ``_format`` decides, else the newest file, with the reference's
    warning; an orbax one raises (not ported), as does none at all."""
    found = {f: path + ext for f, ext in dict(FORMATS, orbax=".orbax").items() if os.path.exists(path + ext)}
    fmt = next(iter(found), None)
    if len(found) > 1:
        declared = _read_sidecar(path).get("_format")
        fmt = declared if declared in found else max(found, key=lambda f: os.path.getmtime(found[f]))
        get_logger().warning(
            f"[checkpoint] both {' and '.join(found.values())} exist; restoring the {fmt} payload "
            f"({'sidecar-declared' if declared in found else 'newer mtime'})")
    if fmt == "orbax":
        raise NotImplementedError(
            f"[checkpoint] {path}.orbax is in the reference's sharded orbax format, which the port does not "
            "read (ROADMAP.md, item 13)")
    if fmt is None:
        raise FileNotFoundError(f"[checkpoint] no checkpoint at {path} (.msgpack or .pt)")
    return found[fmt], fmt


def _read_payload(path: str) -> Tuple[Dict[str, Any], str]:
    file, fmt = checkpoint_file(path)
    if fmt == "torch":
        # read to the host: the state dicts' loaders put each tensor where
        # the live one lives (Adam's step counts stay on the host, as in a
        # fresh run)
        return torch.load(file, map_location="cpu", weights_only=True), fmt
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
    starts the shadow at the restored params."""
    raw, fmt = _read_payload(path)
    meta = _read_sidecar(path)
    exact_lr = meta.pop("_learning_rate", None)
    model, optimizer = template_state.model, template_state.optimizer
    device = next(model.parameters()).device
    if fmt == "torch":
        sd, opt, ema = raw["model"], raw["optimizer"], raw.get("ema_params")
    else:
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
    EMA shadow as the params and raises when the checkpoint has none."""
    raw, fmt = _read_payload(path)
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
