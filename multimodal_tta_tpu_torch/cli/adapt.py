"""Test-time adaptation + evaluation entry point (the port of ``adapt.py``).

    python -m multimodal_tta_tpu_torch.cli.adapt task=hecktor21 dataset=hecktor21 model=unet \
        tta=tent tta.steps=2 training.resume=outputs/.../checkpoints/best_model \
        dataset.target_center=CHUS

Loads a (trained) checkpoint (``training.resume``: a ``.msgpack`` of the
JAX package or the port, or a ``.pt``), streams the test split, runs the configured
TTA method per batch (episodic or continual) through ``TTAEngine.evaluate``,
and writes the seg_eval metric dict overall and per domain to
``<run_dir>/tta_metrics.json`` — with and without adaptation when
``tta.report_no_adapt=true``. With ``tta.stream.enabled=true`` the batches go
through the streaming protocol instead (``tta/stream.py``: reset policy,
entropy watchdog, gated serving), one test pass per centre of
``tta.stream.domain_order`` or the test split's own order, and
``evaluate_stream``'s Dice report is written under ``adapted``. The model
is left as the checkpoint gave it. Under torchrun each rank adapts and
scores its rows of every batch (tent and norm), every rank computes the
global metrics, and rank 0 writes them.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, Optional, Sequence

from .. import DeviceLike, resolve_device
from ..conf import compose
from ..parallel.distributed import is_primary_host
from ..utils.config import get_config
from ..utils.host_alloc import retain_host_memory
from . import CONFIG_DIR, start_ranks


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


def run_stream(engine, model, builder, test_loader, cfg, logger) -> Dict[str, Any]:
    """The streaming protocol over the test data: one loader per centre of
    ``tta.stream.domain_order`` (``builder.get_loader("test",
    target_center=...)``), else the test split in its order with each
    batch's first domain label. The model is restored afterwards."""
    from ..tta.stream import StreamTTAController, evaluate_stream

    if engine.adapter is None:
        raise ValueError("tta.stream.enabled requires a TTA method (tta=tent)")
    thr = float(get_config(cfg, "evaluation.seg.threshold", 0.5))
    ctrl = StreamTTAController.from_config(engine.adapter, model, cfg, threshold=thr)
    order = get_config(cfg, "tta.stream.domain_order", None)
    if order:
        stream = ((dom, batch) for dom in order
                  for batch in builder.get_loader("test", target_center=str(dom)))
    else:
        stream = ((batch.get("domain", ["?"])[0], batch) for batch in test_loader)
    logger.info(
        f"Streaming TTA: policy={ctrl.policy} guard={ctrl.guard} "
        f"order={list(order) if order else 'test-split order'}"
    )
    try:
        adapted = evaluate_stream(ctrl, stream)
    finally:
        engine.adapter.restore()
    logger.info(
        f"[stream] avg_dc={adapted['avg_dc']} reanchors={adapted['reanchors']} "
        + " ".join(f"{k}={v}" for k, v in adapted.items() if k.startswith("dom/"))
    )
    return adapted


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Adapt + evaluate; returns ``{"no_adapt"?, "adapted"}`` metric dicts."""
    dev = resolve_device(device)
    retain_host_memory()  # reuse faulted pages on lazily-backed VM hosts
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = compose(CONFIG_DIR, "config", argv)

    mesh, run_dir, logger = start_ranks(cfg, dev, "adapt.log")
    logger.info(f"Run dir: {run_dir}")
    logger.info(f"TTA Configs:\n{cfg.to_yaml()}")

    from ..core.experiment_manager import ExperimentManager
    from ..tta.engine import TTAEngine

    manager = ExperimentManager(cfg, device=dev, mesh=mesh)
    manager.setup_model()
    test_loader = manager.setup_test_data()
    manager.setup_optimizer()
    load_serving_state(manager, cfg, logger, "adapting")
    model = manager.state.model

    builder = manager._builder
    device_transform = None
    if hasattr(builder, "build_transform"):
        device_transform = builder.build_transform("test").device_spec()

    dev = manager.device
    engine = TTAEngine(cfg, device_transform=device_transform, device=dev, mesh=mesh)

    results = {}
    if bool(get_config(cfg, "tta.report_no_adapt", False)):
        logger.info("Evaluating WITHOUT adaptation (source model)...")
        no_adapt = engine.strategy.evaluate_epoch(model, test_loader, device=dev, mesh=engine.mesh)
        results["no_adapt"] = no_adapt
        logger.info(f"[no-adapt] {no_adapt}")

    if bool(get_config(cfg, "tta.stream.enabled", False)):
        adapted = run_stream(engine, model, builder, test_loader, cfg, logger)
    else:
        logger.info(f"Evaluating with TTA method '{engine.method}'...")
        adapted = engine.evaluate(model, test_loader)
        logger.info(f"[adapted] {adapted}")
    results["adapted"] = adapted

    if is_primary_host():
        out_path = os.path.join(run_dir, "tta_metrics.json")
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(results, f, indent=2)
        logger.info(f"Metrics written to {out_path}")
    return results


if __name__ == "__main__":
    main()
