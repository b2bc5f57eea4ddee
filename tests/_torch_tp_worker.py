"""Rank functions of the model-axis CPU tests (``tests/test_torch_tensor_parallel.py``).

Torch, numpy and the port only (a spawned rank unpickles its target by
module, and the test file imports JAX). ``spawn`` starts four ranks on the
CPU over gloo on a ``data=2 x model=2`` mesh and runs a list of cases in
each; the same case functions run in the test process with ``mesh=None``:
the one-process run the ranks are held to. Each case builds its model
whole from the reference's flax params (numpy) and cuts this rank's share
with ``models/convert.py:from_flax(params, model)``.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from multimodal_tta_tpu_torch.core.optim import EpochScheduler, build_optimizer
from multimodal_tta_tpu_torch.core.train_state import TrainState
from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
from multimodal_tta_tpu_torch.models.convert import from_flax
from multimodal_tta_tpu_torch.models.unetr import UNETR
from multimodal_tta_tpu_torch.models.vit import ViT
from multimodal_tta_tpu_torch.parallel.distributed import maybe_initialize_distributed, spawn_ranks
from multimodal_tta_tpu_torch.parallel.mesh import make_mesh
from multimodal_tta_tpu_torch.parallel.tensor import shard_model, sharded_params, whole_state_dict
from multimodal_tta_tpu_torch.tta.tent import TentAdapter

# the projections a model rank holds a share of
TP_WEIGHTS = ("query.", "key.", "value.", "out.", "Dense_0.", "Dense_1.")


def build(kind: str, kw: dict, params, mesh) -> torch.nn.Module:
    """The tiny ViT or UNETR with ``tp_axis="model"``, cut to this rank's
    share and loaded with its share of ``params`` (flax, numpy)."""
    if kind == "vit":
        model = ViT(**kw, tp_axis="model", device="cpu")
    else:
        model = UNETR(**kw, tp_axis="model", device="cpu")
    shard_model(model, mesh)
    model.load_state_dict(from_flax(params, model), strict=True)
    return model


def numpy_whole(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.detach().numpy().copy() for k, v in whole_state_dict(model).items()}


def _rows(mesh, x: np.ndarray) -> np.ndarray:
    return x if mesh is None else x[mesh.rows(x.shape[0])]


def _gather(mesh, t: torch.Tensor) -> np.ndarray:
    return (t if mesh is None else mesh.gather_rows(t.contiguous())).detach().numpy()


def forward_case(mesh, *, kind: str, kw: dict, params, x: np.ndarray) -> Dict[str, Any]:
    """The forward of the global batch ``x`` (this rank's rows, gathered),
    the bytes of attention and MLP weights this rank holds, the local shapes
    and the whole tree reassembled from the shares."""
    model = build(kind, kw, params, mesh)
    with torch.no_grad():
        out = model(torch.from_numpy(_rows(mesh, x)))
    outs = [_gather(mesh, t) for t in (out if isinstance(out, tuple) else (out,))]
    tp_bytes = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                   if any(k in n for k in TP_WEIGHTS))
    return {"out": outs, "tp_bytes": tp_bytes, "whole": numpy_whole(model),
            "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()},
            "sharded": sorted(sharded_params(model))}


def train_case(mesh, *, cfg: dict, kw: dict, params, batches: Sequence[dict], checkpoint: Optional[str] = None,
               resume: Optional[str] = None, more: Sequence[dict] = (), formats: Sequence[str] = ("msgpack",)
               ) -> Dict[str, Any]:
    """UNETR's ``run_step`` over global host ``batches``: the loss and the
    whole params after each step, and the gradients of the whole
    (replicated) params after the first step; with ``checkpoint`` the state
    is saved after them (in each of ``formats``, the sidecar naming the
    last) and the steps of ``more`` follow; with ``resume`` the run starts
    from that checkpoint."""
    config = ConfigNode(cfg)
    model = build("unetr", kw, params, mesh)
    optimizer, lr = build_optimizer(config.training, model, mesh)
    trainer = SegTrainer(config, device="cpu", mesh=mesh)
    trainer.setup(TrainState(model=model, optimizer=optimizer), None, EpochScheduler(config.training, lr))
    if resume:
        trainer.state, _ = load_checkpoint(resume, trainer.state)
    shards = sharded_params(model)
    out: Dict[str, Any] = {"loss": [], "params": [], "replicated_grads": None}

    def steps(bs):
        for batch in bs:
            trainer.run_step(batch)
            out["loss"].append(trainer.flush_step_metrics()["loss"])
            out["params"].append(numpy_whole(trainer.state.model))
            if out["replicated_grads"] is None:
                out["replicated_grads"] = {n: p.grad.numpy().copy() for n, p in model.named_parameters()
                                           if n not in shards and p.grad is not None}

    steps(batches)
    if checkpoint:
        for fmt in formats:
            save_checkpoint(checkpoint, trainer.state, {"epoch": 0}, fmt=fmt)
    steps(more)
    return out


def tent_case(mesh, *, cfg: dict, kw: dict, params, batches: Sequence[np.ndarray], n_valid: Sequence[int],
              threshold: float = 0.3) -> Dict[str, Any]:
    """Tent (adapt + predict, ``tta.predict``) on UNETR over global host
    ``batches``: the entropy traces, the predictions of the global batches
    and the whole adapted state."""
    config = ConfigNode(cfg)
    model = build("unetr", kw, params, mesh)
    adapter = TentAdapter(config.tta, config=config, device="cpu", mesh=mesh)
    fn = adapter.make_adapt_predict_fn(model, threshold=threshold)
    ents, preds = [], []
    for x, n in zip(batches, n_valid):
        _, pred = fn(model, torch.from_numpy(_rows(mesh, x)), n)
        preds.append(_gather(mesh, pred))
        ents.append(adapter._last_ents.numpy())
    return {"ents": ents, "preds": preds, "state": numpy_whole(model), "adapted": list(adapter._names)}


def broadcast_case(mesh, *, kw: dict) -> Dict[str, Any]:
    """``ExperimentManager.setup_model``'s order: the whole ViT built from
    a seed of its own on each rank (the rank), rank 0's weights broadcast,
    then this rank's share cut: the whole tree reassembled from the shares."""
    model = ViT(**kw, tp_axis="model", device="cpu", seed=0 if mesh is None else mesh.rank)
    if mesh is not None:
        mesh.broadcast_(list(model.parameters()) + list(model.buffers()))
    shard_model(model, mesh)
    return {"whole": numpy_whole(model)}


CASES = {"forward": forward_case, "train": train_case, "tent": tent_case, "broadcast": broadcast_case}


def _rank_main(rank: int, world: int, directory: str, cases: List[Tuple[str, dict]]) -> None:
    torch.set_num_threads(1)
    maybe_initialize_distributed("gloo", f"file://{directory}/store", world, rank, device="cpu",
                                 timeout=datetime.timedelta(seconds=120))
    mesh = make_mesh([torch.device("cpu")], data=world // 2, model=2)
    results = [CASES[name](mesh, **payload) for name, payload in cases]
    torch.save(results, os.path.join(directory, f"rank{rank}.pt"))


def spawn(cases: List[Tuple[str, dict]], directory: str, world: int = 4, timeout: float = 240.0) -> List[list]:
    """Run ``cases`` in ``world`` ranks of a ``data=world/2 x model=2`` mesh;
    returns each rank's list of results."""
    spawn_ranks(_rank_main, world, directory, (directory, cases), timeout)
    return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False) for r in range(world)]
