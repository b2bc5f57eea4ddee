"""Rank functions of the stage-axis CPU tests (``tests/test_torch_pipeline.py``).

Torch, numpy and the port only (a spawned rank unpickles its target by
module, and the test file imports JAX). ``spawn`` starts four ranks on the
CPU over gloo and builds two meshes over them, ``data=2 x stage=2`` and
``data=1 x stage=4``; each case names its mesh and returns what every rank
computed (the global results, the same on every rank). The sequential runs
the ranks are held to are in the test process. After the cases the same
ranks run the rank side of chip_smoke.py's phase 27 at fixture size
(``chip_smoke.run_axes_jobs``).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.core.optim import EpochScheduler, build_optimizer
from multimodal_tta_tpu_torch.core.train_state import TrainState
from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
from multimodal_tta_tpu_torch.models.convert import from_flax
from multimodal_tta_tpu_torch.models.unet3d import UNet3D
from multimodal_tta_tpu_torch.models.vit import ViT
from multimodal_tta_tpu_torch.parallel.distributed import maybe_initialize_distributed, spawn_ranks
from multimodal_tta_tpu_torch.parallel.mesh import make_mesh
from multimodal_tta_tpu_torch.parallel.pipeline import (gather_stages, make_pipeline_train_step, pipeline_apply,
                                                        pipeline_value_and_grad, stack_layer_params, stage_params,
                                                        vit_forward_pipelined)
from multimodal_tta_tpu_torch.tta.engine import TTAEngine


def layer_fn(p, x):
    """``tests/test_pipeline.py``'s toy residual layer."""
    return x + torch.tanh(x @ p["w"] + p["b"])


def mse(y, t):
    return ((y - t) ** 2).mean()


def _stacked(layers: dict, n: int) -> Dict[str, torch.Tensor]:
    return stack_layer_params({k: {n_: torch.from_numpy(v) for n_, v in d.items()} for k, d in layers.items()},
                              "layer", n)


def apply_case(mesh, *, layers: dict, n_layers: int, x: np.ndarray, n_micro: int) -> Dict[str, Any]:
    """``pipeline_apply`` of the toy stack: the output and the number of
    hops this rank sent."""
    sent = _count_sends()
    with torch.no_grad():
        y = pipeline_apply(mesh, layer_fn, _stacked(layers, n_layers), torch.from_numpy(x), n_micro=n_micro)
    return {"y": y.numpy(), "sends": sent.stop()}


def grad_case(mesh, *, layers: dict, n_layers: int, x: np.ndarray, target: np.ndarray, n_micro: int,
              remat: bool) -> Dict[str, Any]:
    """``pipeline_value_and_grad`` of the toy stack's mean squared error."""
    tgt = torch.from_numpy(target)
    loss, grads = pipeline_value_and_grad(mesh, layer_fn, _stacked(layers, n_layers), torch.from_numpy(x),
                                          lambda y: mse(y, tgt), n_micro=n_micro, remat=remat)
    return {"loss": float(loss), "grads": {k: v.numpy() for k, v in grads.items()}}


def train_case(mesh, *, layers: dict, n_layers: int, x: np.ndarray, target: np.ndarray, n_micro: int,
               steps: int, lr: float, momentum: float) -> Dict[str, Any]:
    """``steps`` of ``make_pipeline_train_step`` with SGD on this stage's
    layers: the losses, the whole stacked params after them, and this
    rank's layer count."""
    params = stage_params(mesh, {k: v.requires_grad_() for k, v in _stacked(layers, n_layers).items()})
    opt = torch.optim.SGD(list(params.values()), lr=lr, momentum=momentum)
    step = make_pipeline_train_step(mesh, layer_fn, mse, opt, n_micro=n_micro)
    losses = [float(step(params, torch.from_numpy(x), torch.from_numpy(target))) for _ in range(steps)]
    return {"losses": losses, "params": {k: v.numpy() for k, v in gather_stages(mesh, params).items()},
            "held": next(iter(params.values())).shape[0]}


def vit_case(mesh, *, kw: dict, params, x: np.ndarray, labels: np.ndarray, n_micro: int) -> Dict[str, Any]:
    """``vit_forward_pipelined`` of the tiny ViT: the CLS features and
    logits, then the cross-entropy's gradients of every param (a block's
    summed over the stage and data groups, the others over the data
    group)."""
    model = ViT(**kw, device="cpu")
    model.load_state_dict(from_flax(params), strict=True)
    cls, logits = vit_forward_pipelined(model, torch.from_numpy(x), mesh, n_micro=n_micro)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    grads = {}
    for n, p in model.named_parameters():
        g = p.grad.clone()
        if mesh.data > 1:
            dist.all_reduce(g, group=mesh.data_group)
        if n.startswith("block"):
            dist.all_reduce(g, group=mesh.stage_group)
        grads[n] = g.numpy()
    return {"cls": cls.detach().numpy(), "logits": logits.detach().numpy(), "loss": float(loss), "grads": grads}


def replica_case(mesh, *, cfg: dict, eval_cfg: dict, model_kw: dict, batches: List[dict]) -> Dict[str, Any]:
    """What a stage axis leaves whole: ``SegTrainer`` steps and
    ``TTAEngine.evaluate`` (Tent) on a small UNet3D, each stage rank
    computing its data rank's step: the losses, the params after each step,
    the metrics and the adapted state."""
    config = ConfigNode(cfg)
    model = UNet3D(**model_kw, device="cpu", seed=0)
    optimizer, lr = build_optimizer(config.training, model, mesh)
    trainer = SegTrainer(config, device="cpu", mesh=mesh)
    trainer.setup(TrainState(model=model, optimizer=optimizer), None, EpochScheduler(config.training, lr))
    losses, params = [], []
    for batch in batches:
        trainer.run_step(batch)
        losses.append(trainer.flush_step_metrics()["loss"])
        params.append({k: v.detach().numpy().copy() for k, v in model.state_dict().items()})
    fresh = UNet3D(**model_kw, device="cpu", seed=0)
    metrics = TTAEngine(ConfigNode(eval_cfg), device="cpu", mesh=mesh).evaluate(fresh, batches)
    return {"losses": losses, "params": params, "metrics": metrics,
            "state": {k: v.detach().numpy().copy() for k, v in fresh.state_dict().items()}}


class _count_sends:
    """Counts ``torch.distributed.send`` calls until ``stop``."""

    def __init__(self):
        self.n, self._send = 0, dist.send

        def send(*a, **k):
            self.n += 1
            return self._send(*a, **k)

        dist.send = send

    def stop(self) -> int:
        dist.send = self._send
        return self.n


CASES = {"apply": apply_case, "grad": grad_case, "train": train_case, "vit": vit_case, "replica": replica_case}


def _rank_main(rank: int, world: int, directory: str, cases: List[Tuple[str, str, dict]], axes_jobs: list) -> None:
    torch.set_num_threads(1)
    maybe_initialize_distributed("gloo", f"file://{directory}/store", world, rank, device="cpu",
                                 timeout=datetime.timedelta(seconds=120))
    cpu = [torch.device("cpu")]
    meshes = {"d2s2": make_mesh(cpu, data=2, stage=2), "d1s4": make_mesh(cpu, data=1, stage=4)}
    results = [CASES[name](meshes[on], **payload) for name, on, payload in cases]
    torch.save(results, os.path.join(directory, f"rank{rank}.pt"))
    if axes_jobs:  # chip_smoke.py's phases at fixture size, in the same ranks
        import chip_smoke

        chip_smoke.run_axes_jobs(rank, world, "cpu", axes_jobs)


def spawn(cases: List[Tuple[str, str, dict]], directory: str, world: int = 4, timeout: float = 240.0,
          axes_jobs: list = ()) -> List[list]:
    """Run ``cases`` (name, mesh, payload) in ``world`` ranks, then the rank
    side of ``axes_jobs`` (``chip_smoke.run_axes_jobs``); returns each
    rank's list of results."""
    spawn_ranks(_rank_main, world, directory, (directory, cases, list(axes_jobs)), timeout)
    return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False) for r in range(world)]
