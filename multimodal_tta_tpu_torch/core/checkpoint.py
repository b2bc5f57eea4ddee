"""Checkpoint serialization (the port of ``multimodal_tta_tpu/core/checkpoint.py``).

One format: an extension-less ``path`` is written as ``path.pt``
(``torch.save`` of the model's and the optimizer's state dicts, the step
and, when the run tracks it, the EMA shadow) plus the reference's JSON
sidecar ``path.json`` (epoch, best metrics, scheduler state; ``_format:
"torch"``). Both are written to a ``.tmp`` file first and renamed with
``os.replace``, so an interrupted save never leaves a torn checkpoint.

``load_params_only`` reads a model's params and buffers alone (the
frozen teacher of ``core/distill.py``), with no optimizer template.

Over ranks rank 0 writes, as in the reference, and the other ranks wait at
a barrier. Under ZeRO-1 (``training.zero1``) the optimizer's state is first
consolidated to rank 0, so the file holds the plain optimizer's state dict:
a checkpoint of a run over ranks resumes in one process and the reverse
(``ZeroRedundancyOptimizer.load_state_dict`` takes its partition). Every
rank reads the file to resume. Over a model axis (``parallel/tensor.py``)
the file holds the whole tree too: the ranks of a model group gather each
sharded param, its EMA shadow and its optimizer moments, and a rank that
loads cuts its share, so a checkpoint moves between any model axis and one
process.

The reference's msgpack and orbax formats are not ported yet (ROADMAP.md,
item 13: flax's msgpack first, through a reader of the port's own, then
orbax): loading such a checkpoint raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..parallel import tensor as tp
from ..parallel.distributed import barrier, is_primary_host
from ..utils.logger import get_logger
from .train_state import TrainState, shadow_module


def _zero1_of(optimizer):
    """The ``ZeroRedundancyOptimizer`` of ``optimizer`` (itself, or inside
    ``MultiSteps``), or None."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    inner = getattr(optimizer, "optimizer", optimizer)
    return inner if isinstance(inner, ZeroRedundancyOptimizer) else None


def _state_payload(state: TrainState) -> Dict[str, Any]:
    """What the file holds; under ZeRO-1 every rank takes part in the
    consolidation and only rank 0's payload is complete."""
    model = tp.whole_state_dict(state.model)
    ema = None if state.ema_params is None else tp.whole_tensors(state.model, state.ema_params)
    zero = _zero1_of(state.optimizer)
    if zero is not None:
        # each data group consolidates to its first rank: over a model axis
        # those ranks form one model group and gather its moments together
        zero.consolidate_state_dict(to=0)
        if zero.rank != 0:
            return {}
    optimizer = tp.optimizer_state(state.model, state.optimizer, state.optimizer.state_dict(), cut=False)
    if not is_primary_host():
        return {}
    payload = {"step": int(state.step), "model": model, "optimizer": optimizer}
    # the EMA shadow rides along only when the run tracks it
    if ema is not None:
        payload["ema_params"] = ema
    return payload


def save_checkpoint(path: str, state: TrainState, extra: Dict[str, Any] = None) -> None:
    """path is extension-less; writes path.pt + path.json atomically (rank 0
    over ranks; every rank calls it and returns once the files exist)."""
    payload = _state_payload(state)
    if is_primary_host():
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        tmp = path + ".pt.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path + ".pt")
        _write_sidecar(path, dict(extra or {}, _format="torch"))
    barrier()


def _json_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, (np.ndarray, torch.Tensor)):
        return o.tolist()
    return str(o)


def _pt_file(path: str) -> str:
    """``path.pt``; a checkpoint in the reference's formats raises."""
    if not os.path.exists(path + ".pt"):
        for other in (".msgpack", ".orbax"):
            if os.path.exists(path + other):
                raise NotImplementedError(
                    f"[checkpoint] {path}{other} is in the reference's {other[1:]} format, which "
                    "the port does not read yet (ROADMAP.md, item 13)")
        raise FileNotFoundError(f"[checkpoint] no checkpoint at {path}.pt")
    return path + ".pt"


def load_checkpoint(path: str, template_state: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore ``path`` into ``template_state``'s model and optimizer (in
    place, on their device); returns ``(state, extra_metadata)`` with the
    restored step and EMA shadow. EMA presence may differ between the
    checkpoint and the resuming run (``training.ema`` toggled between runs):
    a shadow in the checkpoint is restored either way; resuming with EMA
    from a checkpoint without one starts the shadow at the restored
    params."""
    pt = _pt_file(path)
    model = template_state.model
    device = next(model.parameters()).device
    # read to the host: the state dicts' loaders put each tensor where the
    # live one lives (Adam's step counts stay on the host, as in a fresh run)
    raw = torch.load(pt, map_location="cpu", weights_only=True)
    model.load_state_dict(tp.local_tensors(model, raw["model"]))
    template_state.optimizer.load_state_dict(tp.optimizer_state(model, template_state.optimizer, raw["optimizer"],
                                                                cut=True))
    if "ema_params" in raw:
        ema = {k: v.to(device) for k, v in tp.local_tensors(model, raw["ema_params"]).items()}
    elif template_state.ema_params is not None:
        get_logger().info(
            "[checkpoint] no ema_params in checkpoint; warm-starting the EMA "
            "shadow from the restored params"
        )
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    else:
        ema = None
    state = dataclasses.replace(template_state, step=int(raw["step"]), ema_params=ema)
    return state, _read_sidecar(path)


def load_params_only(path: str, model: nn.Module, *, use_ema: bool = False) -> nn.Module:
    """Load ONLY the params and buffers of the checkpoint ``path`` into
    ``model`` (in place; returned): no optimizer template is needed, so the
    loading run's optimizer may differ from the saving run's (the frozen
    teacher of ``core/distill.py``). ``use_ema=True`` takes the EMA shadow as
    the params and raises when the checkpoint has none."""
    raw = torch.load(_pt_file(path), map_location="cpu", weights_only=True)
    sd = dict(raw["model"])
    if use_ema:
        if "ema_params" not in raw:
            raise ValueError(
                f"[checkpoint] use_ema requested but {path} carries no "
                "ema_params — the teacher was trained without training.ema"
            )
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
