#!/usr/bin/env python3
"""Build the min-plus CUDA source and show what the compiler made of it.

    python3 scripts/torch_edt_kernel_check.py [--sass [FILE]] [--no-time]

Prints ``ptxas -v`` per kernel (registers, spills, shared memory), with
``--sass`` the instruction mix of each kernel (``cuobjdump -sass``; with a
file name the whole listing is written there), and unless ``--no-time`` the
time of ``squared_edt_volumes`` without the root for 1, 4 and 16 volumes of
[48,144,144] beside its operations bound. Whether the kernels are right, their
times on the evaluation path and the add/min probe are ``chip_smoke.py``'s
(phases 7 and 10) and ``tests/test_torch_kernels_cuda.py``'s. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass", nargs="?", const="-", default=None, metavar="FILE",
                    help="print the instruction mix per kernel; with FILE also write the whole listing there")
    ap.add_argument("--no-time", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_edt_kernel_check: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from multimodal_tta_tpu_torch.kernels import _build
    from multimodal_tta_tpu_torch.kernels import edt_minplus as K

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    built = _build.load("edt_minplus")
    print(f"built {os.path.relpath(built.path, REPO)} in {built.seconds:.1f}s")
    for line in built.log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())
    if args.sass:
        dump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
        sass = subprocess.run([dump, "-sass", built.path], capture_output=True, text=True,
                              timeout=300).stdout
        part, counts = None, {}
        for line in sass.splitlines():
            if "Function :" in line:
                part = line.split("Function :")[1].strip()
                counts[part] = {}
            elif part and "/*" in line and ";" in line:
                words = line.split("*/", 1)[1].split()
                op = next((w for w in words if not w.startswith("@")), "").split(".")[0]
                if op:
                    counts[part][op] = counts[part].get(op, 0) + 1
        for fn, c in counts.items():
            top = sorted(c.items(), key=lambda kv: -kv[1])[:14]
            print(f"  sass {fn}: " + ", ".join(f"{k} {v}" for k, v in top))
        if args.sass != "-":
            with open(args.sass, "w") as fh:
                fh.write(sass)

    if args.no_time:
        return 0
    gen = torch.Generator(device=dev).manual_seed(0)

    def cuda_ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    rate = 67e12 / 2
    for v in (1, 4, 16):
        pts = torch.rand((v, 48, 144, 144), generator=gen, device=dev) > 0.999
        ms = min(cuda_ms(lambda: K.squared_edt_volumes(pts, (3.0, 1.0, 1.0))) for _ in range(3))
        ops = 2 * pts.numel() * (48 + 144 + 144)
        grid = next(e.grid for k, e in K._plans.items() if k[0] == "volumes" and k[2] == tuple(pts.shape))
        print(f"time squared_edt_volumes [{v},48,144,144] (grid {grid}): {ms:.4f} ms; operations bound "
              f"{ops / rate * 1e3:.4f} ms at 33.5 T add-or-min/s -> {ops / rate * 1e3 / ms:.3f}; card {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
