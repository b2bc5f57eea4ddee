"""Rank functions of the space-axis CPU tests (``tests/test_torch_space_parallel.py``).

Torch, numpy and the port only: a spawned rank unpickles its target by
module, and the test file imports JAX. ``spawn`` starts ``data * space``
ranks on the CPU over gloo (a ``file://`` store in the caller's directory),
builds the ``data x space`` mesh in each, runs a list of cases and returns
each rank's results (``parallel/distributed.py:spawn_ranks`` stops every
rank when one fails or the time limit passes).

Each case is ``CASES[name](mesh, **payload)``; one more spawned process
runs the same functions with ``mesh=None`` alongside the ranks: the
one-process run they are held to. A rank's batches are its rows and depth slab of the global host
batches (``Mesh.local``), and a per-voxel result is gathered back
(``Mesh.gather``).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.core.optim import EpochScheduler, build_optimizer
from multimodal_tta_tpu_torch.core.train_state import TrainState
from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
from multimodal_tta_tpu_torch.parallel import space as sp
from multimodal_tta_tpu_torch.parallel.distributed import maybe_initialize_distributed, spawn_ranks
from multimodal_tta_tpu_torch.parallel.mesh import make_mesh
from multimodal_tta_tpu_torch.registry import get_model
from multimodal_tta_tpu_torch.tta.engine import TTAEngine
from multimodal_tta_tpu_torch.tta.stream import StreamTTAController
from multimodal_tta_tpu_torch.tta.tent import TentAdapter


def numpy_state(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def port_model(name: str, model_kw: dict, state: Dict[str, torch.Tensor]) -> torch.nn.Module:
    factory = get_model(name)
    model = getattr(factory, "family", factory)(**model_kw, device="cpu")  # a classifier's: its family
    model.load_state_dict(state, strict=True)
    return model


def _trainer(mesh, cfg: dict, name: str, model_kw: dict, state: dict, device_transform):
    config = ConfigNode(cfg)
    model = port_model(name, model_kw, state)
    optimizer, lr = build_optimizer(config.training, model, mesh)
    trainer = SegTrainer(config, device_transform=device_transform, device="cpu", mesh=mesh)
    trainer.setup(TrainState(model=model, optimizer=optimizer), None, EpochScheduler(config.training, lr))
    return trainer


def train_case(mesh, *, cfg: dict, name: str, model_kw: dict, state: dict, batches: Sequence[dict],
               device_transform: Optional[dict] = None) -> Dict[str, Any]:
    """``run_step`` over global host ``batches``: each step's loss, its
    first step's gradients (summed over the world, before the update) and
    the params after each step."""
    trainer = _trainer(mesh, cfg, name, model_kw, state, device_transform)
    out: Dict[str, Any] = {"loss": [], "params": [], "grads": None}
    apply = trainer.state.apply_gradients

    def first_apply():
        out["grads"] = {n: p.grad.detach().numpy().copy() for n, p in trainer.state.model.named_parameters()
                        if p.grad is not None}
        trainer.state.apply_gradients = apply
        return apply()

    trainer.state.apply_gradients = first_apply
    for batch in batches:
        trainer.run_step(batch)
        out["loss"].append(trainer.flush_step_metrics()["loss"])
        out["params"].append({n: p.detach().numpy().copy() for n, p in trainer.state.model.named_parameters()})
    return out


def tent_case(mesh, *, cfg: dict, name: str, model_kw: dict, state: dict, batches: Sequence[np.ndarray],
              n_valid: Sequence[int], mode: str, device_transform: Optional[dict] = None,
              threshold: float = 0.3) -> Dict[str, Any]:
    """A Tent adapter's ``make_adapt_predict_fn`` in ``mode`` over global
    host ``batches``: the entropy traces, the global predictions, the
    adapted state after each batch and at the end, and the gate entropies
    of a forward-only call."""
    config = ConfigNode(cfg)
    model = port_model(name, model_kw, state)
    adapter = TentAdapter(config.tta, config=config, device_transform=device_transform, device="cpu", mesh=mesh)
    fn = adapter.make_adapt_predict_fn(model, threshold=threshold, predict_mode=mode)
    local = (lambda t: t) if mesh is None else mesh.local
    gather = (lambda t: t) if mesh is None else mesh.gather
    ents, preds, states = [], [], []
    for x, n in zip(batches, n_valid):
        _, pred = fn(model, torch.from_numpy(local(x)), n)
        preds.append(gather(pred).numpy())
        ents.append(adapter._last_ents.numpy())
        states.append(numpy_state(model))
    fp = adapter.make_forward_predict_fn(model, threshold)
    gate = fp(model, torch.from_numpy(local(batches[0])), n_valid[0])[1:]
    return {"ents": ents, "preds": preds, "state": numpy_state(model), "states": states, "gate": gate}


def evaluate_case(mesh, *, cfg: dict, name: str, model_kw: dict, state: dict, batches: Sequence[dict],
                  device_transform: Optional[dict] = None) -> Dict[str, Any]:
    """``TTAEngine.evaluate`` over global host ``batches``: the metrics and
    the model's state afterwards."""
    config = ConfigNode(cfg)
    model = port_model(name, model_kw, state)
    engine = TTAEngine(config, device_transform=device_transform, device="cpu", mesh=mesh)
    return {"metrics": engine.evaluate(model, list(batches)), "state": numpy_state(model)}


def stream_case(mesh, *, cfg: dict, name: str, model_kw: dict, state: dict, batches: Sequence[np.ndarray],
                n_valid: Sequence[int], device_transform: Optional[dict] = None) -> Dict[str, Any]:
    """A continual Tent stream over ragged global host batches."""
    config = ConfigNode(cfg)
    model = port_model(name, model_kw, state)
    adapter = TentAdapter(config.tta, config=config, device_transform=device_transform, device="cpu", mesh=mesh)
    ctrl = StreamTTAController(adapter, model, threshold=0.3, policy="continual")
    preds, ents = [], []
    for x, n in zip(batches, n_valid):
        pred, info = ctrl.step(x, n)
        preds.append(pred[:n].numpy())
        ents.append(info["entropy_final"])
    return {"preds": preds, "ents": ents}


def collectives_case(mesh, *, x: np.ndarray, w_halo: np.ndarray, w_gather: np.ndarray, lo: int,
                     hi: int) -> Dict[str, Any]:
    """``halo_exchange`` and ``gather_depth`` on this rank's slab of the
    NCDHW volume ``x`` (split on dim 2): the forwards, and the gradients of
    ``sum(out * w[s])`` summed over the space ranks (``w`` per space rank)."""
    ax = sp.axis_of(mesh)
    t = torch.from_numpy(x)[mesh.rows(x.shape[0])]
    t = t[:, :, mesh.slab(x.shape[2])].contiguous().requires_grad_(True)
    rows = mesh.rows(x.shape[0])
    out = {}
    halo = sp.halo_exchange(t, lo, hi, ax)
    (halo * torch.from_numpy(w_halo[ax.rank])[rows]).sum().backward()
    out["halo"], out["halo_grad"] = halo.detach().numpy(), t.grad.numpy().copy()
    t.grad = None
    whole = sp.gather_depth(t, ax)
    (whole * torch.from_numpy(w_gather[ax.rank])[rows]).sum().backward()
    out["gather"], out["gather_grad"] = whole.detach().numpy(), t.grad.numpy().copy()
    s = torch.full((2,), float(mesh.rank + 1), requires_grad=True)
    total = sp.space_sum(s, ax, grad=True)
    (total * float(ax.rank + 1)).sum().backward()
    out["space_sum"], out["space_sum_grad"] = total.detach().numpy(), s.grad.numpy()
    return out


def errors_case(mesh, *, cfg: dict, model_kw: dict, state: dict, shape: Tuple[int, ...]) -> Dict[str, str]:
    """What the space axis refuses, by message; None for what runs: the CNN
    classifiers over a split image height (ROADMAP.md's item 12b-v-d,
    closed), the transformers, the sequence axis, a space axis beside
    another. A classifier's forward runs on this rank's rows of a
    ``[2, 64, 64, 3]`` batch."""
    from multimodal_tta_tpu_torch.tta.engine import classifier_logits_apply

    out = {}

    def message(key, fn):
        try:
            fn()
            out[key] = None
        except (NotImplementedError, ValueError) as e:
            out[key] = f"{type(e).__name__}: {e}"

    tiny = dict(in_channels=2, num_classes=1, image_size=list(shape[:3]), device="cpu")
    image = torch.from_numpy(mesh.local(np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)))
    for name, kw in (("resnet18", {}), ("densenet121", dict(growth_rate=4, block_config=(1, 1), init_features=8)),
                     ("efficientnet_b0", {})):
        model = classifier_logits_apply(get_model(name).from_config(ConfigNode({"num_classes": 3}), device="cpu",
                                                                    seed=None, **kw))

        def forward(model=model):
            with torch.no_grad(), sp.sharded(mesh):
                model(image)

        message(name, forward)
    message("unetr", lambda: get_model("unetr")(
        patch_size=4, hidden_size=16, mlp_dim=32, num_heads=2, num_layers=2, feature_size=4, **tiny))
    message("swin_unetr", lambda: get_model("swin_unetr")(
        feature_size=12, depths=(1, 1), num_heads=(1, 2), window_size=2, **tiny))
    message("sequence", lambda: get_model("unetr")(
        patch_size=4, hidden_size=16, mlp_dim=32, num_heads=2, num_layers=2, feature_size=4, seq_shard_axis="space",
        **tiny))
    message("vit", lambda: get_model("vit_b_16").from_config(ConfigNode(
        {"num_classes": 3, "image_size": 32}), device="cpu", seed=None, patch=16, hidden=16, depth=1, heads=2,
        mlp_dim=32, seq_shard_axis="space"))
    for axis in ("model", "expert", "stage"):  # over the same four ranks, every rank alike
        message(f"beside_{axis}", lambda: make_mesh([torch.device("cpu")], data=1, space=2, **{axis: 2}))
    message("thin_slab", lambda: sp.level_axes(sp.axis_of(mesh), 1, (2, 2)))
    return out


MESH_ONLY = ("collectives", "errors")  # no one-process run
CASES = {"train": train_case, "tent": tent_case, "evaluate": evaluate_case, "stream": stream_case,
         "collectives": collectives_case, "errors": errors_case}


def _rank_main(rank: int, procs: int, directory: str, space: int) -> None:
    """Rank ``rank`` of ``procs - 1`` ranks, or (the last process) the
    one-process run of the same cases, alongside them. The cases come in a
    file: process arguments larger than a pipe's buffer would hold each
    start until the process before it has imported torch."""
    cases = torch.load(os.path.join(directory, "cases.pt"), weights_only=False)
    torch.set_num_threads(1)
    world, mesh = procs - 1, None
    if rank < world:
        maybe_initialize_distributed("gloo", f"file://{directory}/store", world, rank, device="cpu",
                                     timeout=datetime.timedelta(seconds=120))
        mesh = make_mesh([torch.device("cpu")], data=world // space, space=space)
    results = [None if mesh is None and name in MESH_ONLY else CASES[name](mesh, **payload)
               for name, payload in cases]
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
