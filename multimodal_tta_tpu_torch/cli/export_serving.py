"""Serving-artifact export entry point (the port of ``scripts/export_serving.py``).

Loads a trained checkpoint (a ``.msgpack`` of the JAX package or the
port, or a ``.pt``) and writes the serving step as one artifact
file (``serving/export.py``): the deployment bundle for a runtime with no
model code, config composer or checkpoint loader
(``cli/serve_artifact.py``).

    python -m multimodal_tta_tpu_torch.cli.export_serving task=hecktor21 dataset=hecktor21 \
        model=unet tta=tent training.resume=outputs/.../checkpoints/best_model \
        +export.path=unet_tent.mttap

Config surface (all optional, ``+export.*`` on the CLI):
  export.mode        adapt | forward (default: adapt when a TTA method is
                     configured, else forward)
  export.path        output file (default <run_dir>/serving.mttap)
  export.batch_size  serving batch (default training.batch_size)
  export.platforms   the device the artifact is traced on and serves on
                     (default "cuda"; the reference's platform list)
  export.predict     inline | post (default tta.predict)
  export.verify      run the loaded artifact once on zeros and compare with
                     the live step (default true)
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Sequence

from .. import DeviceLike, resolve_device
from ..conf import compose, setup_run_dir
from ..utils.config import get_config
from ..utils.host_alloc import retain_host_memory
from ..utils.logger import setup_logger
from . import CONFIG_DIR


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = "cuda") -> str:
    """Export; returns the artifact's path. ``export.platforms`` names the
    device when given, else ``device``."""
    retain_host_memory()  # reuse faulted pages on lazily-backed VM hosts
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = compose(CONFIG_DIR, "config", argv)
    dev = resolve_device(str(get_config(cfg, "export.platforms", device)).strip())

    run_dir = setup_run_dir(cfg)
    logger = setup_logger(log_file=os.path.join(run_dir, "export.log"))

    import torch

    from ..core.checkpoint import load_checkpoint, resolve_serving_params
    from ..core.experiment_manager import ExperimentManager
    from ..serving import export_adapt_serving, export_forward_serving, load_artifact, save_artifact
    from ..tta.engine import TTAEngine

    manager = ExperimentManager(cfg, device=dev)
    manager.setup_model()
    manager.setup_optimizer()

    resume = get_config(cfg, "training.resume", None)
    if not resume:
        raise ValueError("[export] training.resume=<checkpoint> is required")
    state, _ = load_checkpoint(str(resume), manager.state)
    logger.info(f"[export] loaded checkpoint {resume}")
    model = resolve_serving_params(state, bool(get_config(cfg, "training.use_ema_params", False))).model

    # serving shapes from the dataset contract: the loader emits [B,D,H,W,C]
    batch = int(get_config(cfg, "export.batch_size", get_config(cfg, "training.batch_size", 8)))
    x, y, z = (int(v) for v in get_config(cfg, "dataset.expected_shape"))
    channels = len(list(get_config(cfg, "dataset.modality_order", ["ct", "pt"])))
    image_shape = (batch, z, y, x, channels)

    method = str(get_config(cfg, "tta.method", "none")).lower()
    mode = str(get_config(cfg, "export.mode", "adapt" if method not in ("none", "") else "forward")).lower()
    path = str(get_config(cfg, "export.path", os.path.join(run_dir, "serving.mttap")))
    thr = float(get_config(cfg, "evaluation.seg.threshold", 0.5))

    # normalization folded into the artifact exactly as the live paths do
    # (building the builder reads the config only: no manifest or data)
    builder = manager.get_dataset_builder_for_task()
    device_transform = None
    if hasattr(builder, "build_transform"):
        device_transform = builder.build_transform("test").device_spec()

    engine = TTAEngine(cfg, device_transform=device_transform, device=dev)
    if mode == "adapt":
        if engine.adapter is None:
            raise ValueError("[export] export.mode=adapt needs a TTA method (tta=tent)")
        predict_mode = str(get_config(cfg, "export.predict", get_config(cfg, "tta.predict", "inline"))).lower()
        program, meta, state0 = export_adapt_serving(engine.adapter, model, image_shape, threshold=thr,
                                                     predict_mode=predict_mode, device=dev)
        save_artifact(path, program, meta, state0)
    elif mode == "forward":
        def probs(image):
            return engine.strategy._probs_fn(model)(image)[1]

        program, meta = export_forward_serving(probs, image_shape, device=dev)
        save_artifact(path, program, meta)
    else:
        raise ValueError(f"[export] unknown export.mode: {mode}")

    size_mb = os.path.getsize(path) / 1e6
    logger.info(f"[export] wrote {path} ({size_mb:.1f} MB, mode={mode}, device={dev}, "
                f"image={list(image_shape)})")

    if bool(get_config(cfg, "export.verify", True)):
        art = load_artifact(path, device=dev)
        img = torch.zeros(image_shape, device=dev)
        if mode == "forward":
            with torch.no_grad():
                ok = bool(torch.allclose(art.call(img), probs(img), rtol=1e-5, atol=1e-5))
        else:
            gen = torch.Generator(device=dev).manual_seed(0)
            out = art.call(*art.initial_state(), img, *art.draws(gen, batch), batch, float("nan"))
            pred = out[art.n_state + 1]
            ok = pred.dtype == torch.uint8 and tuple(pred.shape[:4]) == image_shape[:4]
        logger.info(f"[export] verify {'OK' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError("[export] artifact verification failed")
    return path


if __name__ == "__main__":
    main()
