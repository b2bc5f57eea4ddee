"""Test-time adaptation + evaluation entry point (the port of ``adapt.py``).

    python -m multimodal_tta_tpu_torch.cli.adapt task=hecktor21 dataset=hecktor21 model=unet \
        tta=tent tta.steps=2 training.resume=outputs/.../checkpoints/best_model \
        dataset.target_center=CHUS

Loads a (trained) checkpoint, streams the test split, runs the configured
TTA method per batch (episodic or continual) through ``TTAEngine.evaluate``,
and writes the seg_eval metric dict overall and per domain to
``<run_dir>/tta_metrics.json`` — with and without adaptation when
``tta.report_no_adapt=true``. The model is left as the checkpoint gave it.
The streaming protocol (``tta.stream.enabled``) needs ``tta/stream.py``,
which is not ported yet.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, Optional, Sequence

from .. import DeviceLike, resolve_device
from ..conf import compose, setup_run_dir
from ..utils.config import get_config
from ..utils.host_alloc import retain_host_memory
from ..utils.logger import setup_logger
from . import CONFIG_DIR


def load_serving_state(manager, cfg, logger, what: str):
    """``training.resume`` into the manager's state (the EMA shadow when
    ``training.use_ema_params``); a random-init model is kept, with a
    warning, when no checkpoint is named."""
    from ..core.checkpoint import load_checkpoint, resolve_serving_params

    resume = get_config(cfg, "training.resume", None)
    if not resume:
        logger.warning(f"No training.resume checkpoint given — {what} a RANDOM-init model")
        return
    manager.state, _ = load_checkpoint(str(resume), manager.state)
    logger.info(f"Loaded checkpoint: {resume}")
    use_ema = bool(get_config(cfg, "training.use_ema_params", False))
    manager.state = resolve_serving_params(manager.state, use_ema)
    if use_ema:
        logger.info(f"{what.capitalize()} the EMA shadow weights")


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Adapt + evaluate; returns ``{"no_adapt"?, "adapted"}`` metric dicts."""
    dev = resolve_device(device)
    retain_host_memory()  # reuse faulted pages on lazily-backed VM hosts
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = compose(CONFIG_DIR, "config", argv)
    if bool(get_config(cfg, "tta.stream.enabled", False)):
        raise NotImplementedError(
            "tta.stream.enabled: the streaming protocol (tta/stream.py, StreamTTAController) is "
            "not ported yet (ROADMAP.md item 8)")

    run_dir = setup_run_dir(cfg)
    logger = setup_logger(log_file=os.path.join(run_dir, "adapt.log"))
    logger.info(f"Run dir: {run_dir}")
    logger.info(f"TTA Configs:\n{cfg.to_yaml()}")

    from ..core.experiment_manager import ExperimentManager
    from ..tta.engine import TTAEngine

    manager = ExperimentManager(cfg, device=dev)
    manager.setup_model()
    test_loader = manager.setup_test_data()
    manager.setup_optimizer()
    load_serving_state(manager, cfg, logger, "adapting")
    model = manager.state.model

    builder = manager._builder
    device_transform = None
    if hasattr(builder, "build_transform"):
        device_transform = builder.build_transform("test").device_spec()

    engine = TTAEngine(cfg, device_transform=device_transform, device=dev)

    results = {}
    if bool(get_config(cfg, "tta.report_no_adapt", False)):
        logger.info("Evaluating WITHOUT adaptation (source model)...")
        no_adapt = engine.strategy.evaluate_epoch(model, test_loader, device=dev)
        results["no_adapt"] = no_adapt
        logger.info(f"[no-adapt] {no_adapt}")

    logger.info(f"Evaluating with TTA method '{engine.method}'...")
    adapted = engine.evaluate(model, test_loader)
    logger.info(f"[adapted] {adapted}")
    results["adapted"] = adapted

    out_path = os.path.join(run_dir, "tta_metrics.json")
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(results, f, indent=2)
    logger.info(f"Metrics written to {out_path}")
    return results


if __name__ == "__main__":
    main()
