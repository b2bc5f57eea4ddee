"""Rank functions of the expert-axis CPU tests (``tests/test_torch_expert_parallel.py``).

Torch, numpy and the port only (a spawned rank unpickles its target by
module, and the test file imports JAX). ``spawn`` starts four ranks on the
CPU over gloo and builds two meshes over them, ``data=2 x expert=2`` and
``data=2 x model=2`` (Adafactor over a model axis); each case names its
mesh. The same case functions run in the test process with ``mesh=None``:
the one-process run the ranks are held to. A model is built whole from the
reference's flax params (numpy) and cut to this rank's share
(``shard_model``, ``shard_experts``, ``models/convert.py:from_flax(params,
model)``). After the cases the same ranks run the rank side of chip_smoke.py's
phase 26 at fixture size (``chip_smoke.run_axes_jobs``).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from multimodal_tta_tpu_torch.core.optim import Adafactor, EpochScheduler, build_optimizer
from multimodal_tta_tpu_torch.core.train_state import TrainState
from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
from multimodal_tta_tpu_torch.models.convert import from_flax
from multimodal_tta_tpu_torch.models.layers import capture_intermediates, pool_over_ranks
from multimodal_tta_tpu_torch.models.moe import MoEMlp
from multimodal_tta_tpu_torch.models.unet3d import UNet3D
from multimodal_tta_tpu_torch.models.unetr import UNETR
from multimodal_tta_tpu_torch.parallel.distributed import maybe_initialize_distributed, spawn_ranks
from multimodal_tta_tpu_torch.parallel.expert import shard_experts
from multimodal_tta_tpu_torch.parallel.mesh import make_mesh
from multimodal_tta_tpu_torch.parallel.tensor import (axis_of, cut_share, gather_share, narrow_param,
                                                      optimizer_state, shard_model, sharded_params,
                                                      whole_state_dict)
from multimodal_tta_tpu_torch.tta.engine import TTAEngine
from multimodal_tta_tpu_torch.tta.tent import TentAdapter

EXPERT_LEAVES = (".wi", ".bi", ".wo", ".bo")


def build(kind: str, kw: dict, params, mesh, frozen: Sequence[str] = ()) -> nn.Module:
    """The model whole, cut to this rank's share over the mesh's model and
    expert axes, loaded with its share of ``params`` (flax, numpy); the
    params whose name ends with one of ``frozen`` take no gradient."""
    model = {"unetr": UNETR, "unet": UNet3D}[kind](**kw, device="cpu")
    shard_model(model, mesh)
    shard_experts(model, mesh)
    model.load_state_dict(from_flax(params, model), strict=True)
    for n, p in model.named_parameters():
        if n.endswith(tuple(frozen)):
            p.requires_grad_(False)
    return model


def numpy_whole(model: nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.detach().numpy().copy() for k, v in whole_state_dict(model).items()}


def _rows(mesh, x: np.ndarray) -> np.ndarray:
    return x if mesh is None else x[mesh.rows(x.shape[0])]


def _gather(mesh, t: torch.Tensor) -> np.ndarray:
    return (t if mesh is None else mesh.gather_rows(t.contiguous())).detach().numpy()


def moe_case(mesh, *, kw: dict, params, x: np.ndarray, g: np.ndarray, aux_weight: float) -> Dict[str, Any]:
    """``MoEMlp`` on the global tokens ``x`` (this rank's rows): the output,
    the loss ``sum(y * g) + aux_weight * aux`` (the aux pooled over the data
    group, each data rank's share ``1 / data``), the input's and the
    router's gradients (the router's as this rank computed it, and summed
    over the data group), the experts' gradients whole, and the shares."""
    m = MoEMlp(**kw)
    shard_experts(m, mesh)
    m.load_state_dict(from_flax(params, m), strict=True)
    pool_over_ranks(m, mesh)
    xl = torch.from_numpy(_rows(mesh, x)).requires_grad_()
    with capture_intermediates(True) as inter:
        y = m(xl)
    data = 1 if mesh is None else mesh.data
    loss = (y * torch.from_numpy(_rows(mesh, g))).sum() + aux_weight * inter["moe_aux"][0] / data
    loss.backward()
    router = [m.router.weight.grad.clone(), m.router.bias.grad.clone()]
    summed = router if mesh is None else mesh.sum_flat([t.clone() for t in router])
    experts = [p.grad for p in (m.wi, m.bi, m.wo, m.bo)]
    experts = experts if mesh is None else mesh.sum_flat(experts)
    whole = {n: t for n, t in zip(("wi", "bi", "wo", "bo"), experts)}
    if mesh is not None and m.ep is not None:
        whole = {n: gather_share(t, 0, m.ep) for n, t in whole.items()}
    return {"y": _gather(mesh, y), "x_grad": _gather(mesh, xl.grad), "aux": float(inter["moe_aux"][0]),
            "router_grad": [t.numpy() for t in router], "router_grad_summed": [t.numpy() for t in summed],
            "expert_grads": {n: t.numpy() for n, t in whole.items()},
            "shapes": {n: tuple(p.shape) for n, p in m.named_parameters()}}


def train_case(mesh, *, kind: str, cfg: dict, kw: dict, params, batches: Sequence[dict],
               checkpoint: Optional[str] = None, resume: Optional[str] = None, more: Sequence[dict] = (),
               frozen: Sequence[str] = ()) -> Dict[str, Any]:
    """``run_step`` over global host ``batches``: the loss and the whole
    params after each step, the gradients of the whole (unsharded) params
    after the first step (summed over the data group, as the step sums
    them), the local shapes of the params and of their optimizer state;
    with ``checkpoint`` the state is saved after the steps and those of
    ``more`` follow; with ``resume`` the run starts from that checkpoint."""
    config = ConfigNode(cfg)
    model = build(kind, kw, params, mesh, frozen)
    optimizer, lr = build_optimizer(config.training, model, mesh)
    trainer = SegTrainer(config, device="cpu", mesh=mesh)
    trainer.setup(TrainState(model=model, optimizer=optimizer), None, EpochScheduler(config.training, lr))
    if resume:
        trainer.state, _ = load_checkpoint(resume, trainer.state)
    shards = sharded_params(model)
    out: Dict[str, Any] = {"loss": [], "params": [], "whole_grads": None}

    def steps(bs):
        for batch in bs:
            trainer.run_step(batch)
            out["loss"].append(trainer.flush_step_metrics()["loss"])
            out["params"].append(numpy_whole(trainer.state.model))
            if out["whole_grads"] is None:
                out["whole_grads"] = {n: p.grad.numpy().copy() for n, p in model.named_parameters()
                                      if n not in shards and p.grad is not None}

    steps(batches)
    if checkpoint:
        save_checkpoint(checkpoint, trainer.state, {"epoch": 0})
    steps(more)
    inner = getattr(optimizer, "optim", optimizer)  # ZeRO-1: this rank's partition of the state
    names = {id(p): n for n, p in model.named_parameters()}
    out["state_shapes"] = {names[id(p)]: {k: tuple(v.shape) for k, v in st.items() if torch.is_tensor(v)}
                           for p, st in inner.state.items()}
    out["shapes"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
    out["sharded"] = sorted(shards)
    return out


def adafactor_cuts_case(mesh, *, shapes: Dict[str, Tuple[int, ...]], dims: Dict[str, int], grads: List[dict],
                        kw: dict) -> Dict[str, Any]:
    """``Adafactor`` on whole tensors of ``shapes`` (identity layouts) with
    the gradients ``grads`` (one dict a step); over the mesh's expert group
    each rank holds the ``dims[name]`` cut of each: the params after the
    steps and the optimizer state, gathered whole through ``state_cut``."""
    holder = nn.Module()
    rng = np.random.RandomState(7)
    for n, s in shapes.items():
        holder.register_parameter(n, nn.Parameter(torch.from_numpy(rng.randn(*s).astype(np.float32))))
    axis = axis_of(mesh, "expert")
    if axis is not None:
        for n, d in dims.items():
            narrow_param(holder, n, d, axis.block(shapes[n][d], n), axis)
    cuts = {id(getattr(holder, n)): (d, d, axis) for n, (d, axis) in sharded_params(holder).items()}
    opt = Adafactor(list(holder.parameters()), layouts={}, cuts=cuts, **kw)
    for step in grads:
        for n, p in holder.named_parameters():
            g = torch.from_numpy(step[n])
            p.grad = g if axis is None else cut_share(g, dims[n], axis).clone()
        opt.step()
    sd = optimizer_state(holder, opt, opt.state_dict(), cut=False)
    return {"params": numpy_whole(holder),
            "state": {i: {k: v.numpy() for k, v in st.items() if torch.is_tensor(v)} for i, st in sd["state"].items()}}


def tent_case(mesh, *, cfg: dict, kw: dict, params, batches: Sequence[np.ndarray], n_valid: Sequence[int],
              mode: str, threshold: float = 0.3) -> Dict[str, Any]:
    """Tent (adapt + predict in ``mode``) on the MoE UNETR over global host
    ``batches``: the entropy traces, the predictions of the global batches,
    the whole adapted state, the adapted names and whether the experts
    stayed frozen and cut."""
    config = ConfigNode(cfg)
    model = build("unetr", kw, params, mesh)
    before = numpy_whole(model)
    adapter = TentAdapter(config.tta, config=config, device="cpu", mesh=mesh)
    fn = adapter.make_adapt_predict_fn(model, threshold=threshold, predict_mode=mode)
    ents, preds = [], []
    for x, n in zip(batches, n_valid):
        _, pred = fn(model, torch.from_numpy(_rows(mesh, x)), n)
        preds.append(_gather(mesh, pred))
        ents.append(adapter._last_ents.numpy())
    after = numpy_whole(model)
    experts = [k for k in after if k.endswith(EXPERT_LEAVES)]
    return {"ents": ents, "preds": preds, "state": after, "adapted": list(adapter._names),
            "experts_frozen": all(np.array_equal(after[k], before[k]) for k in experts) and bool(experts),
            "expert_rows": sorted({p.shape[0] for n, p in model.named_parameters() if n.endswith(EXPERT_LEAVES)})}


def evaluate_case(mesh, *, cfg: dict, kw: dict, params, batches: Sequence[dict]) -> Dict[str, Any]:
    """``TTAEngine.evaluate`` with the config's ``tta`` over global host
    ``batches``: the metrics and the whole state afterwards."""
    model = build("unetr", kw, params, mesh)
    engine = TTAEngine(ConfigNode(cfg), device="cpu", mesh=mesh)
    return {"metrics": engine.evaluate(model, list(batches)), "state": numpy_whole(model)}


CASES = {"moe": moe_case, "train": train_case, "adafactor_cuts": adafactor_cuts_case, "tent": tent_case,
         "evaluate": evaluate_case}


def _rank_main(rank: int, world: int, directory: str, cases: List[Tuple[str, str, dict]], axes_jobs: list) -> None:
    torch.set_num_threads(1)
    maybe_initialize_distributed("gloo", f"file://{directory}/store", world, rank, device="cpu",
                                 timeout=datetime.timedelta(seconds=120))
    cpu = [torch.device("cpu")]
    meshes = {"expert": make_mesh(cpu, data=world // 2, expert=2), "model": make_mesh(cpu, data=world // 2, model=2)}
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
