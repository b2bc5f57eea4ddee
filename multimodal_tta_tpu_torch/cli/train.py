"""Training entry point (the port of ``main.py``).

    python -m multimodal_tta_tpu_torch.cli.train task=hecktor21 dataset=hecktor21 model=unet \
        training.epochs=300 training.batch_size=8 dataset.target_center=CHUS

Composes ``configs/`` with the overrides, makes the run directory (and
moves into it), logs to ``<run_dir>/train.log`` and trains through
``ExperimentManager``; checkpoints land in ``<run_dir>/checkpoints``.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Sequence

from .. import DeviceLike, resolve_device
from ..conf import compose, setup_run_dir
from ..utils.host_alloc import retain_host_memory
from ..utils.logger import setup_logger
from . import CONFIG_DIR


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = "cuda") -> Dict[str, List]:
    """Train; returns the run's histories (``train_history``, ``eval_history``)."""
    dev = resolve_device(device)
    retain_host_memory()  # reuse faulted pages on lazily-backed VM hosts
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = compose(CONFIG_DIR, "config", argv)

    run_dir = setup_run_dir(cfg)
    logger = setup_logger(log_file=os.path.join(run_dir, "train.log"))
    logger.info(f"Run dir: {run_dir}")
    logger.info(f"Running Configs:\n{cfg.to_yaml()}")

    from ..core.experiment_manager import ExperimentManager

    manager = ExperimentManager(cfg, device=dev)
    manager.setup_model()
    manager.setup_data(mode="train")
    manager.setup_optimizer()
    manager.setup_scheduler()
    manager.setup_trainer(run_dir)

    try:
        return manager.train(cfg.training.epochs)
    except Exception as e:
        logger.error(f"[Train] Training failed: {e}")
        raise


if __name__ == "__main__":
    main()
