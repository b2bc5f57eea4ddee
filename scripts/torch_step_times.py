#!/usr/bin/env python3
"""Time the port's serving steps and evaluation runs on one CUDA card, for the
tree the script is given: made to compare two checkouts within one session.

    python3 scripts/torch_step_times.py [--repo DIR] [--steps 10]

Imports ``multimodal_tta_tpu_torch`` and ``chip_smoke`` (for the flagship's
configuration) from ``--repo`` (default: the repository this file is in),
builds the flagship UNet3D (bf16, random weights from a seed) and times, on
the host's clock with a synchronise after each step: the online and the
strict Tent adapt+segment step (batch 2; ``--steps`` steps after 5 warm-up
steps), and ``TTAEngine.evaluate`` over 3 batches of 2 labelled volumes with
no adaptation, episodic Tent and continual Tent (the second and third of three
runs, per batch), with the metrics of the last run so that two trees can be
compared value by value. Prints the medians and, as the last line, one JSON
object. Needs a CUDA card; run the trees to compare in turns (a, b, b, a).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_step_times: needs a CUDA card", file=sys.stderr)
        return 2
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import numpy as np

    from chip_smoke import BATCH, DEVICE_TRANSFORM, DOMAINS, SHAPE, THRESHOLD, eval_config
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.models.unet3d import UNet3D
    from multimodal_tta_tpu_torch.tta.engine import TTAEngine
    from multimodal_tta_tpu_torch.tta.tent import TentAdapter

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    model = UNet3D(channels=(32, 64, 128, 256, 512), dtype=torch.bfloat16, device=dev, seed=0)
    source = {k: v.detach().clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((BATCH,) + SHAPE, generator=gen, device=dev) * 100
    out = {"repo": repo, "card": card, "steps": args.steps}

    for proto, predict, episodic in (("online", "inline", False), ("strict", "post", True)):
        model.load_state_dict(source)
        cfg = ConfigNode({"training": {"criterion": {"sigmoid": True}},
                          "tta": {"steps": 1, "lr": 1e-3, "momentum": 0.9, "episodic": episodic}})
        adapter = TentAdapter(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device=dev)
        step = adapter.make_adapt_predict_fn(model, threshold=THRESHOLD, predict_mode=predict)
        times = []
        for i in range(5 + args.steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(model, x, BATCH)
            torch.cuda.synchronize()
            if i >= 5:
                times.append((time.perf_counter() - t0) * 1e3)
        out[f"{proto}_ms_per_step"] = {"median": statistics.median(times), "min": min(times),
                                       "max": max(times)}

    rng = np.random.RandomState(7)
    zz, yy, xx = np.meshgrid(*(np.arange(n) for n in SHAPE[:3]), indexing="ij")
    loader = []
    for doms in DOMAINS:
        label = np.stack([
            ((zz - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2 + ((xx - c[2]) / r[2]) ** 2 <= 1.0
            for c, r in ((rng.uniform((16, 50, 50), (32, 94, 94)), rng.uniform((4, 10, 10), (10, 30, 30)))
                         for _ in range(BATCH))])[..., None].astype(np.float32)
        loader.append({"image": (rng.randn(BATCH, *SHAPE) * 100).astype(np.float32),
                       "label": label, "domain": doms})
    model.load_state_dict(source)
    for tag, method, episodic in (("none", "none", True), ("tent_episodic", "tent", True),
                                  ("tent_continual", "tent", False)):
        runs = []
        for _ in range(3):
            engine = TTAEngine(ConfigNode(eval_config(method, episodic)),
                               device_transform=DEVICE_TRANSFORM, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = engine.evaluate(model, loader)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3 / len(loader))
        out[f"evaluate_{tag}_ms_per_batch"] = {"first": runs[0], "warm": runs[1:]}
        out[f"evaluate_{tag}_metrics"] = {k: float(v) for k, v in sorted(metrics.items())}

    print(f"card: {card}; tree: {repo}")
    for k, v in out.items():
        if isinstance(v, dict) and not k.endswith("_metrics"):
            print(f"  {k}: " + ", ".join(f"{a} {b:.2f}" if isinstance(b, float) else f"{a} {[round(t, 2) for t in b]}"
                                         for a, b in v.items()))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
