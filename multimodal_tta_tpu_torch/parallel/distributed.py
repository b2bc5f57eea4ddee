"""Process-group start-up (the port of
``multimodal_tta_tpu/parallel/distributed.py``).

One process per device. A launch under ``torchrun`` (``python -m
torch.distributed.run --nproc_per_node=N ...``) sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``; these
take the place of the reference's ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``. With neither that
environment nor arguments, ``maybe_initialize_distributed`` returns
``False`` and changes nothing: a single-process run is untouched.

Two choices differ from the reference on purpose:

  * a failed rendezvous RAISES. The reference logs a warning and carries on
    single-host, which would hide a broken launch behind a run that trains
    on one device;
  * the process group gets an explicit ``timeout``, so that a lost rank
    fails the run instead of hanging it.

The backend is chosen before the group exists and never switched after a
failure: what the caller names, else ``default_backend`` of this host's
rank devices: ``"gloo"`` for the CPU and for ranks that share a card
(``training.devices=[0, 0]``: NCCL refuses two ranks on one card,
"Duplicate GPU detected"), ``"nccl"`` otherwise.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time
import traceback
from typing import Any, Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist

from .. import DeviceLike
from ..utils.logger import get_logger

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def default_backend(devices: Union[DeviceLike, Sequence[DeviceLike]] = "cuda") -> str:
    """The backend for the ranks of this host on ``devices`` (one device, or
    each local rank's): ``"nccl"`` when they are distinct cards, ``"gloo"``
    for the CPU or when two ranks share a card, which NCCL refuses."""
    devs = [torch.device(d) for d in (devices if isinstance(devices, (list, tuple)) else [devices])]
    if any(d.type != "cuda" for d in devs):
        return "gloo"
    return "nccl" if len(set(devs)) == len(devs) else "gloo"


def maybe_initialize_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    device: Union[DeviceLike, Sequence[DeviceLike]] = "cuda",
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Start the default process group when a multi-process launch is
    detected (torchrun's environment) or explicit arguments are given;
    returns True when one is up. ``backend`` defaults to
    ``default_backend(device)``, ``device`` being this host's rank devices
    (``mesh.select_devices``) or one device. A rendezvous that fails
    raises."""
    if dist.is_initialized():
        return True
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if init_method is None and world_size is None:
        return False
    if world_size is None or rank is None:
        raise ValueError(
            f"[distributed] a process group needs both the world size and the rank "
            f"(got world_size={world_size}, rank={rank}; torchrun sets WORLD_SIZE and RANK)")
    if init_method is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not addr or not port:
            raise ValueError(
                "[distributed] WORLD_SIZE is set but MASTER_ADDR/MASTER_PORT are not; launch with "
                "torchrun or pass init_method")
        init_method = f"tcp://{addr}:{port}"
    backend = backend or default_backend(device)
    try:
        dist.init_process_group(backend=backend, init_method=init_method, world_size=int(world_size),
                                rank=int(rank), timeout=timeout)
    except Exception as e:
        raise RuntimeError(
            f"[distributed] process group rendezvous failed (backend={backend}, "
            f"init_method={init_method}, world_size={world_size}, rank={rank}): {e}") from e
    get_logger().info(
        f"torch.distributed initialized: rank {dist.get_rank()}/{dist.get_world_size()} "
        f"(local rank {local_rank()}), backend {backend}")
    return True


def local_rank() -> int:
    """This process's index on its host (torchrun's ``LOCAL_RANK``; the
    global rank without it)."""
    lr = _env_int("LOCAL_RANK")
    if lr is not None:
        return lr
    return dist.get_rank() if dist.is_initialized() else 0


def local_world_size() -> int:
    """The processes on this host (torchrun's ``LOCAL_WORLD_SIZE``; the
    world size without it)."""
    n = _env_int("LOCAL_WORLD_SIZE")
    if n is not None:
        return n
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary_host() -> bool:
    """Rank 0, or a run without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def from_primary(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank (``obj`` itself without a process
    group): the run directory, a time stamp."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def _rank_entry(fn: Callable, rank: int, world: int, directory: str, args: bytes) -> None:
    """A spawned rank: ``fn(rank, world, *pickle.loads(args))``; its
    traceback, if it raises, in ``directory/rank{rank}.err``."""
    try:
        fn(rank, world, *pickle.loads(args))
    except BaseException:
        with open(os.path.join(directory, f"rank{rank}.err"), "w", encoding="utf-8") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, directory: str, args: Sequence = (), timeout: float = 600.0) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` processes started on this
    host (``fn`` importable by module: a started process unpickles it) and
    wait for all of them. The first rank that fails, or the time limit,
    stops every rank, and the call raises with each failed rank's traceback
    (written to ``directory``). Each rank is forked from this process's
    forkserver, a fresh interpreter that the first call starts with
    ``fn``'s module imported, or with what the caller preloaded before
    starting it (``multiprocessing.set_forkserver_preload``): the ranks
    share one import of torch. ``args`` go by value, pickled here: the
    forkserver hands a rank fewer than 256 file descriptors, and
    multiprocessing's pickler would share each CPU tensor through one."""
    import multiprocessing as mp

    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload([fn.__module__])  # read only where this call starts the server
    payload = pickle.dumps(tuple(args))
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, world, directory, payload), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    late = time.monotonic() > deadline
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(directory, f"rank{r}.err")
        if os.path.exists(err):
            with open(err, encoding="utf-8") as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0:
            stopped = f" (stopped at the {timeout} s limit)" if late else ""
            errors.append(f"rank {r}: exit code {p.exitcode}{stopped}")
    if errors:
        raise RuntimeError("ranks failed:\n" + "\n".join(errors))


__all__ = ["maybe_initialize_distributed", "is_primary_host", "local_rank", "local_world_size",
           "from_primary", "barrier", "default_backend", "spawn_ranks", "DEFAULT_TIMEOUT"]
