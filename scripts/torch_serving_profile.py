#!/usr/bin/env python3
"""Where the time of the port's Tent serving step goes, on one CUDA card.

    python3 scripts/torch_serving_profile.py [--protocol online|strict] [--batch 2] [--steps 3]

Builds the flagship UNet3D (channels 32..512, bf16, random weights from a
seed) and the Tent adapter as chip_smoke.py does, warms the step up, then
runs ``--steps`` steps under ``torch.profiler`` and prints: the wall time
per step, the device time by kernel (top 15), the device time by kind
(fused-InstanceNorm Triton kernels, convolutions, the rest), and the device
busy share (summed kernel time over the profiled wall time). The last line
is one JSON object with the same numbers. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NORM_KERNELS = ("stats_kernel", "finish_kernel", "norm_kernel")
CONV_MARKS = ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad", "fprop", "nhwc")


def kind(name: str) -> str:
    low = name.lower()
    if any(k in low for k in NORM_KERNELS):
        return "instance_norm_triton"
    if any(k in low for k in CONV_MARKS):
        return "convolution"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--protocol", choices=("online", "strict"), default="online")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_serving_profile: needs a CUDA card", file=sys.stderr)
        return 2
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(REPO, "build", "triton_cache"))
    os.environ.setdefault("TRITON_HOME", os.path.join(REPO, "build", "triton_home"))
    sys.path.insert(0, REPO)
    from chip_smoke import DEVICE_TRANSFORM, SHAPE, THRESHOLD
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.models.unet3d import UNet3D
    from multimodal_tta_tpu_torch.tta.tent import TentAdapter

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    online = args.protocol == "online"
    model = UNet3D(channels=(32, 64, 128, 256, 512), dtype=torch.bfloat16, device=dev, seed=0)
    cfg = ConfigNode({"training": {"criterion": {"sigmoid": True}},
                      "tta": {"steps": 1, "lr": 1e-3, "momentum": 0.9, "episodic": not online}})
    adapter = TentAdapter(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device=dev)
    step = adapter.make_adapt_predict_fn(model, threshold=THRESHOLD,
                                         predict_mode="inline" if online else "post")
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((args.batch,) + SHAPE, generator=gen, device=dev) * 100
    for _ in range(3):
        step(model, x, args.batch)
    torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(model, x, args.batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0 and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    by_kind = {}
    for name, ms, _ in rows:
        by_kind[kind(name)] = by_kind.get(kind(name), 0.0) + ms
    per_step = {k: v / args.steps for k, v in by_kind.items()}

    print(f"card: {card}")
    print(f"{args.protocol} step, batch {args.batch}, {args.steps} steps: wall {wall_ms / args.steps:.3f} ms/step, "
          f"device {device_ms / args.steps:.3f} ms/step, busy share {device_ms / wall_ms:.3f}")
    for name, ms, count in rows[:15]:
        print(f"  {ms / args.steps:9.3f} ms/step  x{count // args.steps:<4d} {name[:110]}")
    print("by kind (ms/step): " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(per_step.items())))
    print(json.dumps({
        "protocol": args.protocol, "batch": args.batch, "steps": args.steps, "card": card,
        "wall_ms_per_step": wall_ms / args.steps, "device_ms_per_step": device_ms / args.steps,
        "busy_share": device_ms / wall_ms, "device_ms_per_step_by_kind": per_step,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
