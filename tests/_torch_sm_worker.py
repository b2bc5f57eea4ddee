"""Rank functions of the space-axis model tests (``tests/test_torch_space_models.py``).

Torch, numpy and the port only: a spawned rank unpickles its target by
module, and the test file imports JAX. ``spawn`` starts ``data * space``
ranks on the CPU over gloo and one more process without a mesh (the
one-process run they are held to), as ``tests/_torch_sp_worker.py`` does,
and runs the cases of ``CASES`` in each: training through ``SegTrainer``
(each step's loss, the first step's gradients summed over the world, the
params and buffers after each step, the sown MoE scalars), the MoE block
alone on a split token axis (its routing token for token), and Tent and
``TTAEngine.evaluate`` (``tests/_torch_sp_worker.py``'s cases).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

import _torch_sp_worker as spw
from multimodal_tta_tpu_torch.models import moe as moe_module
from multimodal_tta_tpu_torch.models.layers import capture_intermediates, init_flax_defaults, pool_over_ranks
from multimodal_tta_tpu_torch.models.moe import MoEMlp
from multimodal_tta_tpu_torch.parallel import space as sp
from multimodal_tta_tpu_torch.parallel.distributed import maybe_initialize_distributed, spawn_ranks
from multimodal_tta_tpu_torch.parallel.mesh import make_mesh


def _numpy(tensors) -> Dict[str, np.ndarray]:
    return {n: t.detach().numpy().copy() for n, t in tensors}


def train_case(mesh, *, cfg: dict, name: str, model_kw: dict, state: dict, batches: Sequence[dict],
               device_transform: Optional[dict] = None) -> Dict[str, Any]:
    """``run_step`` over global host ``batches``: each step's loss, the first
    step's gradients (summed over the world, before the update), the params
    and the buffers (BatchNorm's running statistics) after each step, and
    the MoE scalars each step sowed."""
    trainer = spw._trainer(mesh, cfg, name, model_kw, state, device_transform)
    model = trainer.state.model
    out: Dict[str, Any] = {"loss": [], "params": [], "buffers": [], "moe": [], "grads": None}
    apply = trainer.state.apply_gradients

    def first_apply():
        out["grads"] = _numpy((n, p.grad) for n, p in model.named_parameters() if p.grad is not None)
        trainer.state.apply_gradients = apply
        return apply()

    trainer.state.apply_gradients = first_apply
    for batch in batches:
        trainer.run_step(batch)
        out["loss"].append(trainer.flush_step_metrics()["loss"])
        out["params"].append(_numpy(model.named_parameters()))
        out["buffers"].append(_numpy(model.named_buffers()))
        if trainer.moe_stats is not None:
            out["moe"].append({k: v.numpy().copy() for k, v in trainer.moe_stats.items()})
    return out


def moe_case(mesh, *, x: np.ndarray, w: np.ndarray, hidden: int, mlp_dim: int, experts: int, k: int,
             capacity_factor: float, seed: int) -> Dict[str, Any]:
    """``MoEMlp`` on this rank's rows and block of tokens of the global
    ``x`` [B, N, H] (the tokens split over the space axis, in rank order):
    the gathered output, dispatch tensor and input gradient, the sown aux
    and dropped share, and the params' gradients summed over the world, of
    ``sum(y * w) + aux`` (the aux term, alike on every rank, divided by the
    rank count)."""
    moe = MoEMlp(hidden, mlp_dim, experts, k, capacity_factor)
    init_flax_defaults(moe, seed)
    moe.train()
    pool_over_ranks(moe, mesh)
    ax = sp.axis_of(mesh)
    local, gather = (mesh.local, mesh.gather) if mesh is not None else (lambda t: t, lambda t: t)
    xt = torch.from_numpy(local(x)).contiguous().requires_grad_(True)
    seen = []
    routed = moe_module.dispatch_combine

    def recording(*a, **kw):
        got = routed(*a, **kw)
        seen.append(got[0].detach())
        return got

    moe_module.dispatch_combine = recording
    try:
        with capture_intermediates() as inter:
            y = moe(xt, space=ax)
    finally:
        moe_module.dispatch_combine = routed
    ranks = 1 if mesh is None else mesh.data * mesh.space
    aux, dropped = inter["moe_aux"][0], inter["moe_dropped"][0]
    ((y * torch.from_numpy(local(w))).sum() + aux / ranks).backward()
    params = [(n, p) for n, p in moe.named_parameters()]
    grads = [p.grad for _, p in params]
    if mesh is not None:
        grads = mesh.sum_flat(grads)
    return {"y": gather(y.detach()).numpy(), "dispatch": gather(seen[0]).numpy(),
            "x_grad": gather(xt.grad).numpy(), "aux": float(aux), "dropped": float(dropped),
            "grads": {n: g.numpy().copy() for (n, _), g in zip(params, grads)}}


CASES = {"train": train_case, "moe": moe_case, "tent": spw.tent_case, "evaluate": spw.evaluate_case}


def _rank_main(rank: int, procs: int, directory: str, space: int) -> None:
    """Rank ``rank`` of ``procs - 1`` ranks, or (the last process) the
    one-process run of the same cases, alongside them; the cases come in a
    file (see ``tests/_torch_sp_worker.py``)."""
    cases = torch.load(os.path.join(directory, "cases.pt"), weights_only=False)
    torch.set_num_threads(1)
    world, mesh = procs - 1, None
    if rank < world:
        maybe_initialize_distributed("gloo", f"file://{directory}/store", world, rank, device="cpu",
                                     timeout=datetime.timedelta(seconds=120))
        mesh = make_mesh([torch.device("cpu")], data=world // space, space=space)
    results = [CASES[name](mesh, **payload) for name, payload in cases]
    torch.save(results, os.path.join(directory, f"rank{rank}.pt"))
    if mesh is not None:
        dist.barrier()


def spawn(cases: List[Tuple[str, dict]], directory: str, data: int = 2, space: int = 2,
          timeout: float = 240.0) -> Tuple[List[list], list]:
    """Run ``cases`` on a ``data x space`` mesh of spawned CPU ranks, and in
    one more spawned process without a mesh; returns (each rank's list of
    results, the one process's)."""
    world = data * space
    torch.save(cases, os.path.join(directory, "cases.pt"))
    spawn_ranks(_rank_main, world + 1, directory, (directory, space), timeout)
    out = [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False) for r in range(world + 1)]
    return out[:world], out[world]
