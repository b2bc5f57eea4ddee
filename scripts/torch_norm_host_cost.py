#!/usr/bin/env python3
"""What one call of the port's fused InstanceNorm costs the host on a CUDA card.

    python3 scripts/torch_norm_host_cost.py [--calls 2000]

For one norm shape of each regime of the kernels (bf16, batch 2) it times,
on the host's clock over ``--calls`` back-to-back calls with no synchronise
inside the loop: the public wrapper with and without autograd, the forward
and the backward halves, the launcher's ``ctypes`` call alone, the two
allocations of a forward, the argument checks, and one eager ``torch.relu``
as a yardstick. "with sync" divides the time up to a final synchronise by the
calls: where it exceeds the host figure the loop is bound by the card. The
last line is one JSON object with the same numbers. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((2, 3, 9, 9, 512), (2, 12, 36, 36, 64), (2, 24, 72, 72, 32))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_norm_host_cost: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    norm = importlib.import_module("multimodal_tta_tpu_torch.kernels.fused_instance_norm")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")

    def bench(fn) -> tuple:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.calls):
            fn()
        host = (time.perf_counter() - t0) / args.calls * 1e6
        torch.cuda.synchronize()
        return host, (time.perf_counter() - t0) / args.calls * 1e6

    out = {}
    for shape in SHAPES:
        c = shape[-1]
        x = torch.randn(shape, device=dev).bfloat16()
        xr = x.clone().requires_grad_()
        g, b = torch.ones(c, device=dev), torch.zeros(c, device=dev)
        gy = torch.randn(shape, device=dev).bfloat16()
        y, stats = norm.instance_norm_forward(x, g, b)
        entry = norm._cached_plan(x, (y,), False)
        pointers = (x.data_ptr(), y.data_ptr(), g.data_ptr(), b.data_ptr(), stats.data_ptr())
        sizes = (shape[0], x.numel() // (shape[0] * c), c, 1, 1, 1e-5)
        launcher = norm._library().mtta_instance_norm_forward
        cases = {
            "fused_instance_norm, no autograd": lambda: norm.fused_instance_norm(x, g, b),
            "fused_instance_norm, x requires grad": lambda: norm.fused_instance_norm(xr, g, b),
            "instance_norm_forward": lambda: norm.instance_norm_forward(x, g, b),
            "instance_norm_backward": lambda: norm.instance_norm_backward(gy, x, g, b, stats, relu=True),
            "backward launch without the sum over the batch":
                lambda: norm._launch_backward(gy, x, g, b, stats, True, True),
            "forward launch alone (ctypes call, current stream, workspace)":
                lambda: norm._launch(launcher, "forward", x, entry, pointers, sizes),
            "the forward's two allocations":
                lambda: (torch.empty_like(x), torch.empty((2, shape[0], c), device=dev)),
            "argument checks": lambda: norm._check_inputs(x, g, b),
            "torch.relu (one eager op)": lambda: torch.relu(x),
        }
        p = norm.plan_for(x)
        print(f"{list(shape)} bf16: {p.regime}, cluster {p.cluster}, grid {p.grid}")
        out[str(list(shape))] = {}
        for name, fn in cases.items():
            host, synced = bench(fn)
            out[str(list(shape))][name] = {"host_us": host, "with_sync_us": synced}
            print(f"  {name}: host {host:.1f} us/call, with sync {synced:.1f} us/call")
    print(json.dumps({"card": card, "calls": args.calls, "us_per_call": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
