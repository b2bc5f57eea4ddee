"""Prediction-export entry point (the port of ``predict.py``): segment a split
and write NIfTI masks.

    python -m multimodal_tta_tpu_torch.cli.predict task=hecktor21 dataset=hecktor21 model=unet \
        training.resume=outputs/.../checkpoints/best_model \
        dataset.target_center=CHUS tta=tent tta.steps=4 tta.lr=0.05 \
        predict.save_prob=true

Loads a checkpoint (a ``.msgpack`` of the JAX package or the port, or a
``.pt``), streams a split, optionally TTA-adapts per batch, and
writes every case's segmentation back into its source NIfTI grid, plus a
``predictions.csv`` provenance manifest. The model is left as the
checkpoint gave it. Under torchrun (or ``training.devices=[0, 0]`` and
friends, as ``cli.adapt``) each rank adapts and writes its rows of every
batch, and the files and ``predictions.csv`` are those of one process:

    torchrun --nproc_per_node=2 -m multimodal_tta_tpu_torch.cli.predict ... tta=sar

Config surface (all optional):
  predict.split     split to export (default "test")
  predict.out_dir   output directory (default <run_dir>/predictions)
  predict.save_prob also write float32 probability volumes (default false)
  predict.save_uncertainty  also write per-voxel mirror-ensemble
                    disagreement (std) volumes + a per-case
                    mean_uncert_in_pred triage column; requires
                    evaluation.flip_tta.enable=true (default false)
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict, List, Optional, Sequence

from .. import DeviceLike, resolve_device
from ..conf import compose
from ..utils.config import get_config
from ..utils.host_alloc import retain_host_memory
from . import CONFIG_DIR, start_ranks
from .adapt import load_serving_state


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = "cuda") -> List[Dict[str, Any]]:
    """Export; returns the ``predictions.csv`` rows."""
    dev = resolve_device(device)
    retain_host_memory()  # reuse faulted pages on lazily-backed VM hosts
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = compose(CONFIG_DIR, "config", argv)

    mesh, run_dir, logger = start_ranks(cfg, dev, "predict.log")
    logger.info(f"Run dir: {run_dir}")

    from ..core.experiment_manager import ExperimentManager
    from ..evaluation.export import PredictionExporter
    from ..tta.engine import TTAEngine

    manager = ExperimentManager(cfg, device=dev, mesh=mesh)
    dev = manager.device
    manager.setup_model()
    manager.setup_optimizer()

    split = str(get_config(cfg, "predict.split", "test")).lower()
    if split == "test":
        loader = manager.setup_test_data()
    else:
        manager.setup_data("train")
        loader = {"train": manager.train_loader, "val": manager.val_loader}[split]
    if loader is None:
        raise ValueError(f"predict.split='{split}' has no data under this config")

    load_serving_state(manager, cfg, logger, "exporting from")
    model = manager.state.model

    builder = manager._builder
    device_transform = None
    if hasattr(builder, "build_transform"):
        device_transform = builder.build_transform(split).device_spec()

    engine = TTAEngine(cfg, device_transform=device_transform, device=dev, mesh=mesh)
    adapt_fn = None
    carry = False
    if engine.adapter is not None:
        logger.info(f"Exporting WITH TTA method '{engine.method}' "
                    f"({'episodic' if engine.episodic else 'continual'})")
        adapt_fn = engine.adapter.make_adapt_fn(model)
        carry = not engine.episodic

    out_dir = str(get_config(cfg, "predict.out_dir", os.path.join(run_dir, "predictions")))
    exporter = PredictionExporter(
        engine.strategy,
        out_dir,
        save_prob=bool(get_config(cfg, "predict.save_prob", False)),
        save_uncertainty=bool(get_config(cfg, "predict.save_uncertainty", False)),
        logger=logger,
    )
    try:
        rows = exporter.run(model, loader, adapt_fn=adapt_fn, carry_state=carry, device=dev, mesh=mesh)
    finally:
        if engine.adapter is not None:
            engine.adapter.restore()  # the adapted norms back to the checkpoint's values
    logger.info(f"Wrote {len(rows)} cases to {out_dir}")
    return rows


if __name__ == "__main__":
    main()
