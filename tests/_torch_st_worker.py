"""Rank functions of the transformer tests over a space axis
(``tests/test_torch_space_transformers.py``, ``tests/test_torch_sequence_axis.py``,
``tests/test_torch_space_axes.py``).

Torch, numpy and the port only: a spawned rank unpickles its target by
module, and the test files import JAX. ``spawn`` starts four ranks on the
CPU over gloo, builds every mesh of ``MESHES`` over them (each case names
its own), and one more process that runs the same cases without a mesh: the
one-process run the ranks are held to (as ``tests/_torch_sp_worker.py``
does). A model is built whole from the case's state and cut to this rank's
share over a model or expert axis (``shard_model``, ``shard_experts``). A
rank's batches are its rows and depth slab (a classifier's: its image rows)
of the global host batches (``Mesh.local``), and a per-voxel result is
gathered back (``Mesh.gather``). After the cases the ranks may run
chip_smoke.py's four-rank ``space_axes`` job at fixture size.
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

import _torch_pp_worker as ppw
import _torch_sa_worker as saw
import _torch_sm_worker as smw
import _torch_sp_worker as spw
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.core.optim import EpochScheduler, build_optimizer
from multimodal_tta_tpu_torch.core.train_state import TrainState
from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
from multimodal_tta_tpu_torch.models.layers import capture_intermediates, pool_over_ranks
from multimodal_tta_tpu_torch.models.vit import SelfAttention
from multimodal_tta_tpu_torch.parallel import space as sp
from multimodal_tta_tpu_torch.parallel.distributed import maybe_initialize_distributed, spawn_ranks
from multimodal_tta_tpu_torch.parallel.expert import shard_experts
from multimodal_tta_tpu_torch.parallel.mesh import make_mesh
from multimodal_tta_tpu_torch.parallel.tensor import shard_model, sharded_params, whole_tensors
from multimodal_tta_tpu_torch.registry import get_model
from multimodal_tta_tpu_torch.tta.engine import classifier_logits_apply
from multimodal_tta_tpu_torch.tta.tent import TentAdapter

WORLD = 4
MESHES = {"d2s2": dict(data=2, space=2), "s4": dict(data=1, space=4), "s2m2": dict(data=1, space=2, model=2),
          "s2e2": dict(data=1, space=2, expert=2), "s2t2": dict(data=1, space=2, stage=2)}


def build(name: str, model_kw: dict, state: dict, mesh) -> torch.nn.Module:
    """The model whole from ``state``, cut to this rank's share over the
    mesh's model and expert axes."""
    factory = get_model(name)
    model = getattr(factory, "family", factory)(**model_kw, device="cpu")  # a classifier's: its family
    model.load_state_dict(state, strict=True)
    if mesh is not None:
        shard_model(model, mesh)
        shard_experts(model, mesh)
    return model


def _numpy(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {n: t.detach().numpy().copy() for n, t in tensors.items()}


def whole_params(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return _numpy(whole_tensors(model, dict(model.named_parameters())))


def _local(mesh, x: np.ndarray) -> np.ndarray:
    return x if mesh is None else mesh.local(x)


def forward_case(mesh, *, name: str, model_kw: dict, state: dict, x: np.ndarray, w: np.ndarray,
                 classifier: bool = False) -> Dict[str, Any]:
    """The forward of the global batch ``x`` (a segmenter's logits gathered
    whole; a classifier's CLS features and logits, whole on every rank of
    the space group, its rows gathered), and the gradients of
    ``sum(logits * w)`` summed over the data x space group, whole (a loss
    alike on every space rank counts ``1 / space`` on each); and how many
    token gathers the forward made (``space.gather_depth`` of the keys and
    values in a ``SelfAttention``, or of a ``[B, n, C]`` token tensor in a
    model; ``space.relayout``'s own gathers are a level's layout)."""
    model = build(name, model_kw, state, mesh)
    gathers, gather_depth = [], sp.gather_depth

    def counted(x, ax, dim=2):
        caller = sys._getframe(1)
        if isinstance(caller.f_locals.get("self"), SelfAttention) or (
                x.dim() == 3 and caller.f_code.co_filename != sp.__file__):
            gathers.append(1)
        return gather_depth(x, ax, dim)

    sp.gather_depth = counted
    try:
        with sp.sharded(mesh):
            out = model(torch.from_numpy(_local(mesh, x)))
    finally:
        sp.gather_depth = gather_depth
    logits = out[1] if classifier else out
    if classifier:
        share = 1.0 if mesh is None else float(mesh.space)
        loss = (logits * torch.from_numpy(w if mesh is None else w[mesh.rows(w.shape[0])])).sum() / share
    else:
        loss = (logits * torch.from_numpy(_local(mesh, w))).sum()
    loss.backward()
    params = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
    grads = [p.grad for _, p in params] if mesh is None else mesh.sum_flat([p.grad for _, p in params])
    grads = whole_tensors(model, {n: g for (n, _), g in zip(params, grads)})
    if classifier:
        gather = (lambda t: t) if mesh is None else (lambda t: mesh.gather_rows(t.contiguous()))
        outs = [gather(t.detach()).numpy() for t in out]
    else:
        outs = [(out if mesh is None else mesh.gather(out.detach())).detach().numpy()]
    return {"out": outs, "grads": _numpy(grads), "token_gathers": len(gathers)}


def _trainer(mesh, cfg: dict, name: str, model_kw: dict, state: dict, device_transform):
    config = ConfigNode(cfg)
    model = build(name, model_kw, state, mesh)
    optimizer, lr = build_optimizer(config.training, model, mesh)
    trainer = SegTrainer(config, device_transform=device_transform, device="cpu", mesh=mesh)
    trainer.setup(TrainState(model=model, optimizer=optimizer), None, EpochScheduler(config.training, lr))
    return trainer


def train_case(mesh, *, cfg: dict, name: str, model_kw: dict, state: dict, batches: Sequence[dict],
               device_transform: Optional[dict] = None) -> Dict[str, Any]:
    """``run_step`` over global host ``batches``: each step's loss, the
    first step's gradients (summed over the data x space group, whole), the
    whole params after each step and the sown MoE scalars."""
    trainer = _trainer(mesh, cfg, name, model_kw, state, device_transform)
    model = trainer.state.model
    out: Dict[str, Any] = {"loss": [], "params": [], "moe": [], "grads": None,
                           "sharded": sorted(sharded_params(model))}
    apply = trainer.state.apply_gradients

    def first_apply():
        out["grads"] = _numpy(whole_tensors(model, {n: p.grad for n, p in model.named_parameters()
                                                    if p.grad is not None}))
        trainer.state.apply_gradients = apply
        return apply()

    trainer.state.apply_gradients = first_apply
    for batch in batches:
        trainer.run_step(batch)
        out["loss"].append(trainer.flush_step_metrics()["loss"])
        out["params"].append(whole_params(model))
        if trainer.moe_stats is not None:
            out["moe"].append({k: v.numpy().copy() for k, v in trainer.moe_stats.items()})
    return out


def route_case(mesh, *, name: str, model_kw: dict, state: dict, x: np.ndarray) -> Dict[str, Any]:
    """The flagship's bottleneck MoE routing on the global ``x`` (a training
    forward): the dispatch tensor of every MoE block, each rank's block of
    tokens gathered over the space group when its level is split."""
    from multimodal_tta_tpu_torch.models import moe as moe_module

    model = build(name, model_kw, state, mesh)
    model.train()
    pool_over_ranks(model, mesh)
    seen = []
    routed = moe_module.dispatch_combine

    def recording(gates, k, cap, space=None):
        got = routed(gates, k, cap, space)
        d = got[0].detach()
        seen.append(sp.all_gather_cat(d.contiguous(), 1, space.size, space.group) if space is not None else d)
        return got

    moe_module.dispatch_combine = recording
    try:
        with torch.no_grad(), sp.sharded(mesh), capture_intermediates() as inter:
            model(torch.from_numpy(_local(mesh, x)))
    finally:
        moe_module.dispatch_combine = routed
    gather = (lambda t: t) if mesh is None else (lambda t: mesh.gather_rows(t.contiguous()))
    return {"dispatch": [gather(d).numpy() for d in seen], "aux": [float(a) for a in inter["moe_aux"]]}


def classifier_tent_case(mesh, *, cfg: dict, name: str, model_kw: dict, state: dict, batches: Sequence[np.ndarray],
                         n_valid: Sequence[int]) -> Dict[str, Any]:
    """Tent on a classifier's logits (``classifier_logits_apply``) over
    global host batches of images, in strict mode: each batch's entropies,
    predictions (whole on every space rank; the rows gathered) and the
    adapted state."""
    config = ConfigNode(cfg)
    model = classifier_logits_apply(build(name, model_kw, state, mesh))
    adapter = TentAdapter(config.tta, config=config, device="cpu", mesh=mesh)
    fn = adapter.make_adapt_predict_fn(model, threshold=0.5, predict_mode="post")
    gather = (lambda t: t) if mesh is None else (lambda t: mesh.gather_rows(t.contiguous()))
    out: Dict[str, Any] = {"ents": [], "preds": []}
    for x, n in zip(batches, n_valid):
        _, pred = fn(model, torch.from_numpy(_local(mesh, x)), n)
        out["preds"].append(gather(pred).numpy())
        out["ents"].append(adapter._last_ents.numpy())
    out["state"] = spw.numpy_state(model)
    return out


def attention_case(mesh, *, hidden: int, heads: int, state: dict, x: np.ndarray, w: np.ndarray) -> Dict[str, Any]:
    """``SelfAttention`` on this rank's block of the global tokens ``x``
    [B, N, H] (split over the space group when N divides): the gathered
    output, and the gradients of ``sum(y * w)`` into the tokens (gathered)
    and into the projections (summed over the space group)."""
    attn = SelfAttention(hidden, heads)
    attn.load_state_dict(state, strict=True)
    ax = sp.axis_of(mesh)
    xt = torch.from_numpy(x)
    wt = torch.from_numpy(w)
    if ax is not None:
        xt, wt = sp.slice_depth(xt, ax, dim=1), sp.slice_depth(wt, ax, dim=1)
    xt = xt.contiguous().requires_grad_(True)
    y = attn(xt, ax)
    (y * wt).sum().backward()
    grads = [p.grad for p in attn.parameters()]
    if ax is not None:
        grads = [sp.space_sum(g, ax) for g in grads]
        y, xg = sp.all_gather_cat(y.detach().contiguous(), 1, ax.size, ax.group), sp.all_gather_cat(
            xt.grad.contiguous(), 1, ax.size, ax.group)
    else:
        xg = xt.grad
    return {"y": y.detach().numpy(), "x_grad": xg.numpy(),
            "grads": {n: g.numpy().copy() for (n, _), g in zip(attn.named_parameters(), grads)}}


CASES = {"forward": forward_case, "train": train_case, "route": route_case, "classifier_tent": classifier_tent_case,
         "attention": attention_case, "tent": spw.tent_case, "evaluate": spw.evaluate_case,
         "adapter": saw.adapter_case, "probs": saw.probs_case, "pipeline_vit": ppw.vit_case,
         "moe_layer": smw.moe_case}
MESH_ONLY = ("pipeline_vit",)  # its one-process reference runs in the test process


def _rank_main(rank: int, procs: int, directory: str, axes_jobs: list) -> None:
    """Rank ``rank`` of ``procs - 1`` ranks, or (the last process) the
    one-process run of the same cases; the cases come in a file (see
    ``tests/_torch_sp_worker.py``)."""
    cases = torch.load(os.path.join(directory, "cases.pt"), weights_only=False)
    torch.set_num_threads(1)
    world, meshes = procs - 1, None
    if rank < world:
        maybe_initialize_distributed("gloo", f"file://{directory}/store", world, rank, device="cpu",
                                     timeout=datetime.timedelta(seconds=120))
        cpu = [torch.device("cpu")]
        meshes = {n: make_mesh(cpu, **sizes) for n, sizes in MESHES.items()}  # every rank, one order
    results = []
    for name, on, payload in cases:
        if meshes is None and name in MESH_ONLY:
            results.append(None)
            continue
        results.append(CASES[name](None if meshes is None else meshes[on], **payload))
    torch.save(results, os.path.join(directory, f"rank{rank}.pt"))
    if meshes is not None:
        if axes_jobs:  # chip_smoke.py's four-rank jobs at fixture size, in the same ranks
            import chip_smoke

            chip_smoke.run_axes_jobs(rank, world, "cpu", axes_jobs)
        dist.barrier()


def spawn(cases: List[Tuple[str, str, dict]], directory: str, timeout: float = 300.0,
          axes_jobs: list = ()) -> Tuple[List[list], list]:
    """Run ``cases`` (name, mesh, payload) on four spawned CPU ranks and in
    one more spawned process without a mesh; returns (each rank's list of
    results, the one process's)."""
    torch.save(cases, os.path.join(directory, "cases.pt"))
    spawn_ranks(_rank_main, WORLD + 1, directory, (directory, list(axes_jobs)), timeout)
    out = [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False) for r in range(WORLD + 1)]
    return out[:WORLD], out[WORLD]
