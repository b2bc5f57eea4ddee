#!/usr/bin/env python3
"""chip_smoke.py's phase 20 alone: the port's training options on one CUDA
card.

    python3 scripts/torch_training_options.py [--runs TAG ...] [--teacher-steps 4]

Builds the CUDA kernels, trains the flagship UNet3D (channels 32..512, bf16)
for ``--teacher-steps`` steps of the HECKTOR21 recipe on synthetic volumes
and saves it as the distillation teacher (the whole smoke takes phase 11's
checkpoint instead), then runs ``chip_smoke.training_options_phase``: A
(UNETR with 8 experts, Adam and Adafactor), B (deep supervision 2), C
(UNet3D-WS distilled from the teacher, focus all and uncertain), D (the
flagship's bottleneck MoE, profiled) and the ``debug_nans`` check, or the
``--runs`` named (tags of ``chip_smoke.OPTION_RUNS``, and ``debug_nans``).
Counts the norm kernels' launches as the smoke does. Prints the card's name
and power limit, one line per run, and as the last line one JSON object with
every run's numbers. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", nargs="*", default=None)
    ap.add_argument("--teacher-steps", type=int, default=4)
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # the debug_nans check runs in strict mode

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_training_options: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.core.checkpoint import save_checkpoint
    from multimodal_tta_tpu_torch.core.optim import build_optimizer
    from multimodal_tta_tpu_torch.core.train_state import TrainState
    from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
    from multimodal_tta_tpu_torch.kernels import _build
    from multimodal_tta_tpu_torch.kernels.edt_minplus import minplus
    from multimodal_tta_tpu_torch.kernels.fused_instance_norm import fused_instance_norm
    from multimodal_tta_tpu_torch.models.unet3d import UNet3D

    # as chip_smoke.py: f32 is f32 (the f32 steps compare the kernel with the plain norm)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    for src in ("fused_instance_norm", "edt_minplus"):
        _build.load(src)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")

    # the teacher: the flagship after a few steps of the recipe
    root = os.path.join(REPO, "build", "training_options")  # build/ is in .gitignore
    shutil.rmtree(root, ignore_errors=True)
    cfg = ConfigNode(chip_smoke.train_recipe(root))
    teacher = UNet3D(channels=(32, 64, 128, 256, 512), dtype=torch.bfloat16, device=dev, seed=0)
    trainer = SegTrainer(cfg, device_transform=chip_smoke.DEVICE_TRANSFORM, device=dev)
    trainer.setup(TrainState(model=teacher, optimizer=build_optimizer(cfg.training, teacher)[0]))
    vols = chip_smoke.hecktor_volumes(8, 71)
    batch = {"image": np.stack([v["image"] for v in vols]), "label": np.stack([v["label"] for v in vols])}
    for _ in range(args.teacher_steps):
        trainer.run_step(batch)
    trainer.flush_step_metrics()
    path = os.path.join(root, "teacher", "flagship")
    save_checkpoint(path, trainer.state)
    del trainer, teacher

    def reset_counts():
        fused_instance_norm.launches = 0
        fused_instance_norm.backward_launches = 0
        minplus.launches = 0

    def read_counts() -> dict:
        return {"forward": fused_instance_norm.launches, "backward": fused_instance_norm.backward_launches,
                "minplus": minplus.launches}

    t0 = time.perf_counter()
    out = chip_smoke.training_options_phase(dev, os.path.join(root, "runs"), path, runs=args.runs,
                                            reset_counts=reset_counts, read_counts=read_counts)
    phase_s = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    for tag, r in out["runs"].items():
        print(f"{tag}: median warm step {r['median_step_ms']:.2f} ms, {r['volumes_per_s']:.2f} volumes/s, peak "
              f"{r['warm_peak_gib']:.2f} GiB, optimizer state {r['optimizer_state_bytes']} bytes, losses "
              f"{[round(v, 5) for v in r['losses']]}, f32 step {r['f32_step']}, run {r['run_s']:.1f} s", flush=True)
    print(f"phase took {phase_s:.1f} s; debug_nans {out.get('debug_nans')}")
    print(json.dumps({"card": card, "phase_s": phase_s, **out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
