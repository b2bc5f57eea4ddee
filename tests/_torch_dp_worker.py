"""Rank functions of the multi-rank CPU tests (``tests/test_torch_data_parallel.py``).

This module imports torch, numpy and the port only: a spawned rank unpickles
its target by module, and the test file imports JAX. ``spawn`` starts
``world`` ranks on the CPU over gloo (a ``file://`` store in a directory of
the caller's, no TCP port), runs a list of cases in each, and returns each
rank's results; a rank that raises, or a run past its time limit, fails the
call with the rank's traceback, and every rank is stopped
(``parallel/distributed.py:spawn_ranks``).

Each case is ``CASES[name](mesh, **payload)``. The same functions run in the
test process with ``mesh=None``: the one-process run the ranks are held to.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from multimodal_tta_tpu_torch.core.optim import EpochScheduler, build_optimizer
from multimodal_tta_tpu_torch.core.train_state import TrainState
from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
from multimodal_tta_tpu_torch.data.device_cache import DeviceCachedLoader
from multimodal_tta_tpu_torch.models.layers import running_statistics
from multimodal_tta_tpu_torch.models.unet3d import UNet3D
from multimodal_tta_tpu_torch.parallel.distributed import maybe_initialize_distributed, spawn_ranks
from multimodal_tta_tpu_torch.parallel.mesh import make_mesh
from multimodal_tta_tpu_torch.registry import get_tta_method
from multimodal_tta_tpu_torch.tta.engine import TTAEngine
from multimodal_tta_tpu_torch.tta.stream import StreamTTAController
from multimodal_tta_tpu_torch.tta.tent import TentAdapter


def numpy_state(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def port_model(model_kw: dict, state: Dict[str, torch.Tensor]) -> torch.nn.Module:
    model = UNet3D(**model_kw, device="cpu")
    model.load_state_dict(state, strict=True)
    return model


# ---------------------------------------------------------------------------
# cases


def train_case(mesh, *, cfg: dict, model_kw: dict, state: dict, batches: Sequence[dict],
               device_transform: Optional[dict] = None, checkpoint: Optional[str] = None,
               resume: Optional[str] = None, more: Sequence[dict] = (), formats: Sequence[str] = ("msgpack",),
               frozen: Sequence[str] = ()) -> Dict[str, Any]:
    """``run_step`` over ``batches`` (global host batches): the loss and the
    params after each step. With ``checkpoint`` the state is saved after
    them (in each of ``formats``, the sidecar naming the last; rank 0
    writes, or for orbax every rank its own chunks), and the steps of
    ``more`` follow; with ``resume`` the run starts from that checkpoint.
    The params named in ``frozen`` take no gradient and stay out of the
    optimizer."""
    config = ConfigNode(cfg)
    model = port_model(model_kw, state)
    for name, p in model.named_parameters():
        if name in frozen:
            p.requires_grad_(False)
    optimizer, lr = build_optimizer(config.training, model, mesh)
    trainer = SegTrainer(config, device_transform=device_transform, device="cpu", mesh=mesh)
    trainer.setup(TrainState(model=model, optimizer=optimizer), None, EpochScheduler(config.training, lr))
    if resume:
        trainer.state, _ = load_checkpoint(resume, trainer.state)
    out: Dict[str, Any] = {"loss": [], "params": [], "stats": [], "moe": []}

    def steps(bs):
        for batch in bs:
            trainer.run_step(batch)
            out["loss"].append(trainer.flush_step_metrics()["loss"])
            out["params"].append({n: p.detach().numpy().copy() for n, p in trainer.state.model.named_parameters()})
            out["stats"].append({n: t.numpy() for n, t in running_statistics(trainer.state.model).items()})
            if trainer.moe_stats is not None:
                out["moe"].append({k: v.numpy() for k, v in trainer.moe_stats.items()})

    steps(batches)
    if checkpoint:
        for fmt in formats:
            save_checkpoint(checkpoint, trainer.state, {"epoch": 0}, fmt=fmt)
        out["saved_state_bytes"] = _optimizer_state_bytes(trainer.state.optimizer)
    steps(more)
    return out


def _optimizer_state_bytes(optimizer) -> int:
    """The bytes of optimizer state this rank holds."""
    inner = getattr(optimizer, "optimizer", optimizer)
    inner = getattr(inner, "optim", inner)  # ZeroRedundancyOptimizer's local optimizer
    return sum(t.numel() * t.element_size() for s in inner.state.values() for t in s.values()
               if isinstance(t, torch.Tensor))


def evaluate_case(mesh, *, cfg: dict, model_kw: dict, state: dict, batches: Sequence[dict],
                  device_transform: Optional[dict] = None) -> Dict[str, Any]:
    """``TTAEngine.evaluate`` over ``batches`` (``tta.method`` none, tent
    or norm): the metric dict and the model's state afterwards."""
    config = ConfigNode(cfg)
    model = port_model(model_kw, state)
    engine = TTAEngine(config, device_transform=device_transform, device="cpu", mesh=mesh)
    metrics = engine.evaluate(model, list(batches))
    return {"metrics": metrics, "state": numpy_state(model)}


def tent_case(mesh, *, cfg: dict, model_kw: dict, state: dict, batches: Sequence[np.ndarray],
              n_valid: Sequence[int], mode: Optional[str], draws: Optional[List[dict]] = None,
              device_transform: Optional[dict] = None, threshold: float = 0.3,
              floors: Optional[Sequence[Optional[float]]] = None) -> Dict[str, Any]:
    """A Tent adapter over global host ``batches``: rank ``r`` adapts on its
    rows. ``mode`` None is ``make_adapt_fn``, else ``make_adapt_predict_fn``
    in that mode; ``draws`` (one per batch, the global batch's) replace the
    adapter's own. Returns the entropy traces, the predictions of the global
    batches, the adapted state and the gate entropies of a forward-only
    call."""
    config = ConfigNode(cfg)
    model = port_model(model_kw, state)
    adapter = TentAdapter(config.tta, config=config, device_transform=device_transform, device="cpu", mesh=mesh)
    if draws is not None:
        queue = list(draws)
        adapter.batch_draws = lambda shape, n, post=False: queue.pop(0)
    fn = adapter.make_adapt_fn(model) if mode is None else adapter.make_adapt_predict_fn(
        model, threshold=threshold, predict_mode=mode)
    ents, preds = [], []
    for i, (x, n) in enumerate(zip(batches, n_valid)):
        rows = x if mesh is None else x[mesh.rows(x.shape[0])]
        floor = None if floors is None else floors[i]
        out = fn(model, torch.from_numpy(rows), n, ent_floor=floor)
        if mode is not None:
            pred = out[1] if mesh is None else mesh.gather_rows(out[1])
            preds.append(pred.numpy())
        ents.append(adapter._last_ents.numpy())
    fp = adapter.make_forward_predict_fn(model, threshold)
    x = batches[0]
    gate = fp(model, torch.from_numpy(x if mesh is None else x[mesh.rows(x.shape[0])]), n_valid[0])[1:]
    return {"ents": ents, "preds": preds, "state": numpy_state(model), "gate": gate}


def adapter_case(mesh, *, cfg: dict, model_kw: dict, state: dict, batches: Sequence[np.ndarray],
                 n_valid: Sequence[int], mode: Optional[str], draws: Optional[List[dict]] = None,
                 device_transform: Optional[dict] = None, threshold: float = 0.3) -> Dict[str, Any]:
    """``tta.method``'s adapter (pl, eata, sar, cotta, memo) over global host
    ``batches``, as ``tent_case``; also the batches on which SAR's recovery
    snapped back to source and its entropy EMA after each batch, and
    CoTTA's teacher after each batch."""
    config = ConfigNode(cfg)
    model = port_model(model_kw, state)
    adapter = get_tta_method(config.tta.method)(config.tta, config=config, device_transform=device_transform,
                                                device="cpu", mesh=mesh)
    if draws is not None:
        queue = list(draws)
        adapter.batch_draws = lambda shape, n, post=False: queue.pop(0)
    fn = adapter.make_adapt_fn(model) if mode is None else adapter.make_adapt_predict_fn(
        model, threshold=threshold, predict_mode=mode)
    resets = []
    copy_source = adapter._copy_source

    def counted():  # SAR's recovery (continual: nothing else snaps back mid-batch)
        resets[-1] += 1
        copy_source()

    adapter._copy_source = counted
    out: Dict[str, Any] = {"ents": [], "preds": [], "em": [], "teacher": []}
    for x, n in zip(batches, n_valid):
        resets.append(0)
        res = fn(model, torch.from_numpy(x if mesh is None else x[mesh.rows(x.shape[0])]), n)
        if mode is not None:
            out["preds"].append((res[1] if mesh is None else mesh.gather_rows(res[1])).numpy())
        out["ents"].append(adapter._last_ents.numpy())
        if hasattr(adapter, "_em"):
            out["em"].append(float(adapter._em))
        if hasattr(adapter, "_teacher"):
            out["teacher"].append([t.numpy().copy() for t in adapter._teacher])
    out.update(state=numpy_state(model), resets=resets, names=list(adapter._names))
    return out


def predict_case(mesh, *, argv: Sequence[str]) -> Dict[str, Any]:
    """``cli.predict`` on the CPU (over the ranks' group when there is one):
    its manifest rows."""
    from multimodal_tta_tpu_torch.cli import predict

    cwd = os.getcwd()
    try:
        return {"rows": predict.main(list(argv), device="cpu")}
    finally:
        os.chdir(cwd)


def stream_case(mesh, *, cfg: dict, model_kw: dict, state: dict, batches: Sequence[np.ndarray],
                n_valid: Sequence[int], device_transform: Optional[dict] = None) -> Dict[str, Any]:
    """A continual Tent stream over ragged global host batches (the
    controller pads them to the data axis): predictions and entropies."""
    config = ConfigNode(cfg)
    model = port_model(model_kw, state)
    adapter = TentAdapter(config.tta, config=config, device_transform=device_transform, device="cpu", mesh=mesh)
    ctrl = StreamTTAController(adapter, model, threshold=0.3, policy="continual")
    preds, ents = [], []
    for x, n in zip(batches, n_valid):
        pred, info = ctrl.step(x, n)
        preds.append(pred[:n].numpy())
        ents.append(info["entropy_final"])
    return {"preds": preds, "ents": ents}


class IdDataset:
    """``n`` samples whose image holds the sample's index (exact in f16)."""

    def __init__(self, n: int, shape: Tuple[int, ...] = (2, 2, 2, 1)):
        self.n, self.shape = n, shape

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict:
        return {"image": np.full(self.shape, float(i), np.float32), "label": np.zeros(self.shape, np.float32)}


def sharded_store_case(mesh, *, n: int, batch_size: int, seed: int, epochs: int) -> Dict[str, Any]:
    """The sample ids of each batch this rank holds, per epoch, from the
    sharded store, then the two errors of the reference."""
    loader = DeviceCachedLoader(IdDataset(n), batch_size=batch_size, shuffle=True, drop_last=True, seed=seed,
                                device="cpu", shard_store=True, mesh=mesh, num_workers=1)
    out: Dict[str, Any] = {"sharded": loader.shard_store, "store_rows": int(loader._images.shape[0]),
                           "len": len(loader), "epochs": []}
    for _ in range(epochs):
        out["epochs"].append([(b["image"][:, 0, 0, 0, 0].float().numpy().astype(int).tolist(), b["_n_valid"])
                              for b in loader])
    errors = []
    for kw in ({"batch_size": batch_size, "drop_last": False}, {"batch_size": batch_size + 1, "drop_last": True}):
        try:
            DeviceCachedLoader(IdDataset(n), seed=seed, device="cpu", shard_store=True, mesh=mesh, **kw)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_case(mesh, *, store: str) -> Dict[str, Any]:
    """``maybe_initialize_distributed`` without a process group: no launch
    (False), torchrun's environment (one rank over TCP on localhost), a
    missing address, and a rendezvous that cannot complete (raises)."""
    import torch.distributed as dist

    env = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    for k in env:
        os.environ.pop(k, None)
    out: Dict[str, Any] = {"no_launch": maybe_initialize_distributed(device="cpu"),
                           "initialized_after_no_launch": dist.is_initialized()}
    os.environ.update({"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"})
    try:
        maybe_initialize_distributed(device="cpu")
    except ValueError as e:
        out["missing_address"] = str(e)
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())})
    out["torchrun_env"] = maybe_initialize_distributed(device="cpu")
    out["rank_world_backend"] = (dist.get_rank(), dist.get_world_size(), dist.get_backend())
    m = make_mesh([torch.device("cpu")])
    out["mesh"] = (m.data, m.rank, str(m.device))
    dist.destroy_process_group()
    for k in env:
        os.environ.pop(k, None)
    t0 = time.perf_counter()
    try:  # a second rank never comes: the store times out and the call raises
        maybe_initialize_distributed("gloo", f"file://{store}", 2, 0, device="cpu",
                                     timeout=datetime.timedelta(seconds=2))
        out["failed_rendezvous"] = None
    except RuntimeError as e:
        out["failed_rendezvous"] = str(e)
    out["failed_rendezvous_s"] = time.perf_counter() - t0
    out["initialized_after_failure"] = dist.is_initialized()
    return out


def errors_case(mesh, *, cfg: dict, model_kw: dict, state: dict) -> Dict[str, str]:
    """What the data axis refuses, by message (None: nothing raised): the
    serving artifact, windows that do not split over the ranks,
    ``sync_over_mesh=false``; ``pl`` and every other method build their
    engine over the ranks (``engines``: the adapter's class by method)."""
    out = {}

    def message(key, fn):
        try:
            fn()
            out[key] = None
        except (NotImplementedError, ValueError) as e:
            out[key] = f"{type(e).__name__}: {e}"

    def config(**tta):
        c = ConfigNode(cfg)
        for k, v in tta.items():
            c.set_path(f"tta.{k}", v)
        return c

    model = port_model(model_kw, state)
    message("pl", lambda: TTAEngine(config(method="pl"), device="cpu", mesh=mesh))
    out["engines"] = {m: type(TTAEngine(config(method=m), device="cpu", mesh=mesh).adapter).__name__
                      for m in ("tent", "pl", "eata", "norm", "sar", "cotta", "memo")}
    message("artifact", lambda: TentAdapter(config().tta, config=config(), device="cpu", mesh=mesh)
            .serving_export_spec(model, 0.3))
    message("windows", lambda: TentAdapter(config(window={"enabled": True, "windows_per_step": 3}).tta,
                                           device="cpu", mesh=mesh))
    message("sync", lambda: TentAdapter(config(sync_over_mesh=False).tta, device="cpu", mesh=mesh))
    return out


def fail_on_rank_one(rank: int, world: int) -> None:
    """Rank 1 raises; rank 0 waits as a rank blocked in a collective would."""
    if rank == 1:
        raise ValueError("rank 1 failed on purpose")
    time.sleep(60)


def hang(rank: int, world: int) -> None:
    time.sleep(600)


CASES = {"train": train_case, "errors": errors_case, "evaluate": evaluate_case, "tent": tent_case,
         "adapter": adapter_case, "predict": predict_case, "stream": stream_case,
         "sharded_store": sharded_store_case, "launch": launch_case}


# ---------------------------------------------------------------------------
# the ranks


def _rank_main(rank: int, world: int, directory: str, cases: List[Tuple[str, dict]]) -> None:
    torch.set_num_threads(1)
    mesh = None
    if world > 1:
        maybe_initialize_distributed("gloo", f"file://{directory}/store", world, rank, device="cpu",
                                     timeout=datetime.timedelta(seconds=120))
        mesh = make_mesh([torch.device("cpu")])
    results = [CASES[name](mesh, **payload) for name, payload in cases]
    torch.save(results, os.path.join(directory, f"rank{rank}.pt"))


def spawn(cases: List[Tuple[str, dict]], directory: str, world: int = 2, timeout: float = 240.0) -> List[list]:
    """Run ``cases`` in ``world`` spawned ranks (``world=1``: one spawned
    process without a group); returns each rank's list of results."""
    spawn_ranks(_rank_main, world, directory, (directory, cases), timeout)
    return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False) for r in range(world)]
