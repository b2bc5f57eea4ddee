"""Rank functions of the space-axis adapter tests (``tests/test_torch_space_adapters.py``).

Torch, numpy and the port only: a spawned rank unpickles its target by
module, and the test file imports JAX. ``spawn`` starts ``data * space``
ranks on the CPU over gloo and one more process without a mesh (the
one-process run they are held to), as ``tests/_torch_sp_worker.py`` does,
and runs the cases of ``CASES`` in each: an adapter (pl, eata, sar, cotta,
memo, Tent with windows) over global host batches, ``TTAEngine.evaluate``
(``tests/_torch_sp_worker.py``'s case: flip TTA, the sliding window), the
evaluator's probabilities and mirror-ensemble variance, the depth flip and
its gradient, and ``cli.predict``. A rank's batches are its rows and depth
slab of the global batches (``Mesh.local``), and a per-voxel result is
gathered back (``Mesh.gather``).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

import _torch_sp_worker as spw
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.evaluation.seg_eval import SegmentationEvaluationStrategy
from multimodal_tta_tpu_torch.parallel import space as sp
from multimodal_tta_tpu_torch.parallel.distributed import maybe_initialize_distributed, spawn_ranks
from multimodal_tta_tpu_torch.parallel.mesh import make_mesh
from multimodal_tta_tpu_torch.registry import get_tta_method
from multimodal_tta_tpu_torch.tta.engine import classifier_logits_apply


def _local(mesh):
    return (lambda t: t) if mesh is None else mesh.local


def _gather(mesh):
    return (lambda t: t) if mesh is None else mesh.gather


def adapter_case(mesh, *, cfg: dict, name: str, model_kw: dict, state: dict, batches: Sequence[np.ndarray],
                 n_valid: Sequence[int], draws: Optional[List[dict]] = None, device_transform: Optional[dict] = None,
                 threshold: float = 0.3, classifier: bool = False, predict_mode: str = "post") -> Dict[str, Any]:
    """``tta.method``'s adapter over global host ``batches``
    (``make_adapt_predict_fn``, strict by default): each batch's entropies, gathered
    predictions and adapted state, SAR's recovery resets and entropy EMA,
    CoTTA's teacher; ``draws`` (one per batch, the global batch's) replace
    the adapter's own. A ``classifier`` adapts its logits
    (``classifier_logits_apply``), whole on every space rank: its
    predictions gather their rows only, and its states keep the adapted
    tensors and the running statistics (a backbone's frozen kernels would
    fill the ranks' memory over many cases)."""
    config = ConfigNode(cfg)
    model = spw.port_model(name, model_kw, state)
    gather = _gather(mesh)
    if classifier:
        model = classifier_logits_apply(model)
        gather = (lambda t: t) if mesh is None else (lambda t: mesh.gather_rows(t.contiguous()))
    adapter = get_tta_method(config.tta.method)(config.tta, config=config, device_transform=device_transform,
                                                device="cpu", mesh=mesh)
    if draws is not None:
        queue = list(draws)
        adapter.batch_draws = lambda shape, n, post=False: queue.pop(0)
    fn = adapter.make_adapt_predict_fn(model, threshold=threshold, predict_mode=predict_mode)
    snapshot = lambda: spw.numpy_state(model)  # noqa: E731
    if classifier:
        kept = set(adapter._names)
        snapshot = lambda: {k: v for k, v in spw.numpy_state(model).items()  # noqa: E731
                            if k in kept or k.endswith((".mean", ".var"))}
    resets = []
    copy_source = adapter._copy_source

    def counted():  # the episodic reset, SAR's recovery
        resets[-1] += 1
        copy_source()

    adapter._copy_source = counted
    out: Dict[str, Any] = {"ents": [], "preds": [], "states": [], "em": [], "teacher": []}
    for x, n in zip(batches, n_valid):
        resets.append(0)
        _, pred = fn(model, torch.from_numpy(_local(mesh)(x)), n)
        out["preds"].append(gather(pred).numpy())
        out["ents"].append(adapter._last_ents.numpy())
        out["states"].append(snapshot())
        if hasattr(adapter, "_em"):
            out["em"].append(float(adapter._em))
        if hasattr(adapter, "_teacher"):
            out["teacher"].append([t.numpy().copy() for t in adapter._teacher])
    out.update(state=snapshot(), resets=resets, names=list(adapter._names))
    return out


def probs_case(mesh, *, cfg: dict, name: str, model_kw: dict, state: dict, image: np.ndarray) -> Dict[str, Any]:
    """The evaluator's forward (``_probs_fn`` with the variance map, under
    the mesh's space axis) on the global ``image``: the gathered logits,
    probabilities and variance."""
    strategy = SegmentationEvaluationStrategy(ConfigNode(cfg))
    model = spw.port_model(name, model_kw, state)
    with torch.no_grad(), sp.sharded(mesh):
        out = strategy._probs_fn(model, with_variance=True, space=sp.axis_of(mesh))(
            torch.from_numpy(_local(mesh)(image)))
    return dict(zip(("logits", "prob", "var"), (_gather(mesh)(t).numpy() for t in out)))


def flip_case(mesh, *, x: np.ndarray, w: np.ndarray, dims: Tuple[int, ...]) -> Dict[str, Any]:
    """``space.flip`` of this rank's rows and slab of ``x`` [B, D, H, W, C]
    on ``dims``: the gathered result, and the gradient of ``sum(out * w)``
    (``w`` the global weights, each rank its share) gathered."""
    ax = sp.axis_of(mesh)
    t = torch.from_numpy(mesh.local(x)).requires_grad_(True)
    y = sp.flip(t, dims, ax)
    (y * torch.from_numpy(mesh.local(w))).sum().backward()
    return {"y": mesh.gather(y.detach()).numpy(), "grad": mesh.gather(t.grad).numpy()}


def predict_case(mesh, *, argv: Sequence[str], root: str, mesh_argv: Sequence[str] = ()) -> Dict[str, Any]:
    """``cli.predict`` on the CPU into ``<root>/pred_ranks`` over the ranks'
    group (with ``mesh_argv``), or ``<root>/pred_one`` in one process: its
    manifest rows."""
    from multimodal_tta_tpu_torch.cli import predict

    tag = "one" if mesh is None else "ranks"
    argv = list(argv) + [f"task.run_name=predict_{tag}", f"predict.out_dir={root}/pred_{tag}"]
    cwd = os.getcwd()
    try:
        return {"rows": predict.main(argv + ([] if mesh is None else list(mesh_argv)), device="cpu")}
    finally:
        os.chdir(cwd)


MESH_ONLY = ("flip",)  # no one-process run
CASES = {"adapter": adapter_case, "evaluate": spw.evaluate_case, "probs": probs_case, "flip": flip_case,
         "predict": predict_case}


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
