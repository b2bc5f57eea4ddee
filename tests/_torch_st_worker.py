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
gathered back (``Mesh.gather``). A case may name several meshes: the ranks
run it on each, the one process once. After the cases the ranks may run
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
from multimodal_tta_tpu_torch.models.layers import BatchNorm, capture_intermediates, pool_over_ranks, running_statistics
from multimodal_tta_tpu_torch.models.vit import SelfAttention
from multimodal_tta_tpu_torch.parallel import space as sp
from multimodal_tta_tpu_torch.parallel.distributed import maybe_initialize_distributed, spawn_ranks
from multimodal_tta_tpu_torch.parallel.expert import shard_experts
from multimodal_tta_tpu_torch.parallel.mesh import make_mesh
from multimodal_tta_tpu_torch.parallel.tensor import shard_model, sharded_params, whole_tensors
from multimodal_tta_tpu_torch.registry import get_tta_method
from multimodal_tta_tpu_torch.tta.engine import classifier_logits_apply
from multimodal_tta_tpu_torch.tta.tent import TentAdapter

WORLD = 4
MESHES = {"d2s2": dict(data=2, space=2), "s4": dict(data=1, space=4), "s2m2": dict(data=1, space=2, model=2),
          "s2e2": dict(data=1, space=2, expert=2), "s2t2": dict(data=1, space=2, stage=2),
          "d2m2": dict(data=2, model=2), "d2e2": dict(data=2, expert=2)}


def build(name: str, model_kw: dict, state: dict, mesh) -> torch.nn.Module:
    """The model whole from ``state``, cut to this rank's share over the
    mesh's model and expert axes."""
    model = spw.port_model(name, model_kw, state)
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


def classifier_case(mesh, *, name: str, model_kw: dict, state: dict, x: np.ndarray, w: np.ndarray) -> Dict[str, Any]:
    """A classifier's training-mode forward (batch statistics pooled over
    the ranks) of the global images ``x``: its features and logits (whole on
    every space rank, the rows gathered), the gradients of ``sum(logits *
    w)`` (``1 / space`` of it on each space rank) summed over the ranks,
    the running statistics after it, and the rows that each BatchNorm call
    saw (``(module, rows)`` in call order: a slab's on a split level, the
    whole height on a gathered one). The gradients, flat in ``grad_names``'
    order, come back from the first rank alone."""
    model = build(name, model_kw, state, mesh)
    model.train()
    pool_over_ranks(model, mesh)
    rows = []
    hooks = [m.register_forward_pre_hook(lambda mod, args, n=n: rows.append((n, int(args[0].shape[2]))))
             for n, m in model.named_modules() if isinstance(m, BatchNorm)]
    try:
        with sp.sharded(mesh):
            feats, logits = model(torch.from_numpy(_local(mesh, x)))
    finally:
        for h in hooks:
            h.remove()
    share = 1.0 if mesh is None else float(mesh.space)
    ((logits * torch.from_numpy(w if mesh is None else w[mesh.rows(w.shape[0])])).sum() / share).backward()
    params = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
    grads = [p.grad for _, p in params] if mesh is None else mesh.sum_flat([p.grad for _, p in params])
    gather = (lambda t: t) if mesh is None else (lambda t: mesh.gather_rows(t.contiguous()))
    stats = {k: v.numpy().copy() for k, v in running_statistics(model).items()}
    lead = mesh is None or mesh.rank == 0  # the summed gradients are every rank's: one copy comes back
    return {"out": [gather(t.detach()).numpy() for t in (feats, logits)], "stats": stats, "bn_rows": rows,
            "grad_names": [n for n, _ in params],
            "grads": torch.cat([g.reshape(-1).float() for g in grads]).numpy() if lead else None}


def classifier_norm_case(mesh, *, cfg: dict, name: str, model_kw: dict, state: dict, batches: Sequence[np.ndarray],
                         n_valid: Sequence[int]) -> Dict[str, Any]:
    """The ``norm`` adapter on a classifier's logits over global host
    ``batches``: the running statistics after each batch, and the adapted
    model's inference-mode logits of the last batch (rows gathered); the
    affines stay, as ``classifier_case``'s logits show."""
    config = ConfigNode(cfg)
    model = classifier_logits_apply(build(name, model_kw, state, mesh))
    adapter = get_tta_method("norm")(config.tta, config=config, device="cpu", mesh=mesh)
    fn = adapter.make_adapt_fn(model)
    out: Dict[str, Any] = {"states": []}
    for x, n in zip(batches, n_valid):
        fn(model, torch.from_numpy(_local(mesh, x)), n)
        out["states"].append({k: v.numpy().copy() for k, v in running_statistics(model).items()})
    gather = (lambda t: t) if mesh is None else (lambda t: mesh.gather_rows(t.contiguous()))
    with torch.no_grad(), sp.sharded(mesh):
        out["logits"] = gather(model(torch.from_numpy(_local(mesh, batches[-1])))).numpy()
    return out


def ulp_case(mesh, *, kind: str, cfg: dict, name: str, model_kw: dict, state: dict, batches: Sequence,
             device_transform: Optional[dict] = None) -> Dict[str, Any]:
    """A step over a model or expert group (``kind``: "train", a
    ``SegTrainer`` step on each batch; "tent", continual Tent) in which the
    group's second rank of data rank 0 moves every whole gradient (and the
    loss) by one ulp before the reduction: the whole gradients before and
    after the first reduction, and the whole params after each step."""
    axis = "model" if mesh.model > 1 else "expert"
    bumped = mesh.data_rank == 0 and getattr(mesh, f"{axis}_rank") == 1
    seen: Dict[str, list] = {}
    reduce = mesh.sum_flat

    def perturbed(tensors, shards=None):
        tensors = list(tensors)
        whole = [i for i in range(len(tensors)) if shards is None or shards[i] is None]
        if bumped:
            for i in whole:
                tensors[i] = torch.nextafter(tensors[i], torch.full_like(tensors[i], float("inf")))
        out = reduce(tensors, shards)
        if not seen:
            seen["pre"] = [tensors[i].detach().numpy().copy() for i in whole]
            seen["post"] = [out[i].detach().numpy().copy() for i in whole]
        return out

    config = ConfigNode(cfg)
    params = []
    mesh.sum_flat = perturbed
    try:
        if kind == "train":
            trainer = _trainer(mesh, cfg, name, model_kw, state, device_transform)
            model = trainer.state.model
            for batch in batches:
                trainer.run_step(batch)
                params.append(whole_only(model))
        else:
            model = build(name, model_kw, state, mesh)
            adapter = TentAdapter(config.tta, config=config, device_transform=device_transform, device="cpu",
                                  mesh=mesh)
            fn = adapter.make_adapt_fn(model)
            for x in batches:
                fn(model, torch.from_numpy(_local(mesh, x)), x.shape[0])
                params.append(whole_only(model))
    finally:
        del mesh.sum_flat
    return dict(seen, params=params, bumped=bumped)


def whole_only(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The params that no model or expert axis cuts (``sharded_params``)."""
    cut = sharded_params(model)
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters() if n not in cut}


CASES = {"forward": forward_case, "train": train_case, "route": route_case, "classifier_tent": classifier_tent_case,
         "attention": attention_case, "tent": spw.tent_case, "evaluate": spw.evaluate_case,
         "adapter": saw.adapter_case, "probs": saw.probs_case, "pipeline_vit": ppw.vit_case,
         "moe_layer": smw.moe_case, "classifier": classifier_case, "classifier_norm": classifier_norm_case,
         "ulp": ulp_case}
# no one-process run: the pipeline's reference runs in the test process, the
# ulp pins hold ranks to ranks
MESH_ONLY = ("pipeline_vit", "ulp")


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
        elif meshes is None:
            results.append(CASES[name](None, **payload))
        elif isinstance(on, str):
            results.append(CASES[name](meshes[on], **payload))
        else:  # one result a mesh
            results.append({m: CASES[name](meshes[m], **payload) for m in on})
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
