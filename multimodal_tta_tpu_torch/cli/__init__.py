"""Command-line entry points of the port: ``train``, ``adapt`` and
``predict``, the counterparts of the repository's ``main.py``, ``adapt.py``
and ``predict.py``, with the same config grammar over ``configs/``:

    python -m multimodal_tta_tpu_torch.cli.train task=hecktor21 dataset=hecktor21 model=unet ...

Each module's ``main(argv=None, device="cuda")`` runs on the GPU and raises
without one; ``device="cpu"`` runs it on the CPU, as the tests do. A run
changes the working directory to its run directory
(``hydra.job.chdir: true`` in ``configs/config.yaml``).

``train`` and ``adapt`` also run one process per device under torchrun
(``python -m torch.distributed.run --nproc_per_node=N -m
multimodal_tta_tpu_torch.cli.train ...``): the ranks share rank 0's run
directory, and only rank 0 writes the log file, the checkpoints and
``tta_metrics.json``. The backend is NCCL on the card, and gloo when
``training.devices`` puts two ranks of the host on one card
(``training.devices=[0,0]``), which NCCL refuses.
"""

import os



def start_ranks(cfg, device, log_name: str):
    """``(mesh, run_dir, logger)`` of this process: a torchrun launch
    starts the process group (its backend from the ranks' devices,
    ``default_backend``; a plain run is one rank), the mesh of
    ``training.devices`` / ``training.mesh``, rank 0's run directory (moved
    into), and the logger (the file ``<run_dir>/<log_name>`` on rank 0)."""
    from ..conf import setup_run_dir
    from ..parallel.distributed import is_primary_host, maybe_initialize_distributed
    from ..parallel.mesh import mesh_from_config, select_devices
    from ..utils.logger import setup_logger

    maybe_initialize_distributed(device=select_devices(cfg.select("training", None), device))
    mesh = mesh_from_config(cfg, device)
    run_dir = setup_run_dir(cfg)
    logger = setup_logger(log_file=os.path.join(run_dir, log_name) if is_primary_host() else None)
    return mesh, run_dir, logger


CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                          "configs")
