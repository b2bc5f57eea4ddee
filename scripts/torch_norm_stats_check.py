#!/usr/bin/env python3
"""How far the fused InstanceNorm kernel and its plain version are from
f64 statistics at every norm of a BraTS mid-fusion forward, and how far
bf16 logits move with either norm.

    python3 scripts/torch_norm_stats_check.py        # needs one CUDA card

Builds the mid-fusion UNet at full width (channels 32..512, random weights
from a seed) and runs one forward on a synthetic BraTS batch
[2,160,192,160,4], in bf16 and in f32: prints the logits' relative L2
between the kernel and the plain norm, and in bf16 also against the f32
logits of the same weights. For every third norm call of the two bf16
forwards (kernel, then plain norm) it
feeds that norm's input to the kernel (``instance_norm_forward``) and to the
plain version: the largest error of each one's mean and rstd against f64
statistics of the same input, the share of bf16 outputs where the two
differ, and the channel's largest |mean| / std. Then the logits' relative
L2 kernel vs plain for the UNet3D (4 inputs, 3 classes), the late-fusion
UNet and UNet3D-WS at the same shape.
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_norm_stats_check: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import BRATS_BATCH, BRATS_SHAPE
    from multimodal_tta_tpu_torch.data.synthetic import brats_volumes
    from multimodal_tta_tpu_torch.kernels.fused_instance_norm import _plain_forward, instance_norm_forward, plan_for
    from multimodal_tta_tpu_torch.models import MultimodalUNetLateFusion, MultimodalUNetMidFusion, UNet3D, UNet3DWS
    from multimodal_tta_tpu_torch.models.layers import InstanceNorm, set_plain_norm

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    xb = torch.from_numpy(np.stack([v["image"] for v in brats_volumes(BRATS_BATCH, BRATS_SHAPE, seed=40)])).to(dev)

    def rel(a, b) -> float:
        return float((a - b).norm() / b.norm())

    def logits_pair(model, x):
        with torch.no_grad():
            got = model(x)
            set_plain_norm(model, True)
            plain = model(x)
            set_plain_norm(model, False)
        return got, plain

    mid = MultimodalUNetMidFusion(dtype=torch.bfloat16, device=dev, seed=0)
    inputs = []

    def keep(mod, args, kw, name):  # every third norm's NDHWC input
        inputs.append((name, mod, args[0].permute(0, 2, 3, 4, 1).contiguous()) if len(inputs) % 3 == 0 else None)

    hooks = [m.register_forward_pre_hook(lambda mod, args, kw, n=n: keep(mod, args, kw, n), with_kwargs=True)
             for n, m in mid.named_modules() if isinstance(m, InstanceNorm)]
    got, plain = logits_pair(mid, xb)
    for h in hooks:
        h.remove()
    mid32 = MultimodalUNetMidFusion(dtype=torch.float32, device=dev, seed=None)
    mid32.load_state_dict(mid.state_dict())
    got32, plain32 = logits_pair(mid32, xb)
    print(f"mid-fusion logits rel L2, kernel vs plain norm: bf16 {rel(got, plain):.4g}, f32 {rel(got32, plain32):.4g}; "
          f"bf16 (plain norm) vs f32 (plain norm) {rel(plain, plain32):.4g}")
    del got32, plain32, mid32

    for item in inputs:
        if item is None:
            continue
        name, mod, x = item
        with torch.no_grad():
            yk, stats = instance_norm_forward(x, mod.scale, mod.bias, relu=True)
            yp, mp, rp = _plain_forward(x, mod.scale, mod.bias, 1e-5, True)
            xd = x.double()
            md = xd.mean(dim=(1, 2, 3))
            rd = ((xd.square().mean(dim=(1, 2, 3)) - md.square()).clamp(min=0) + 1e-5).rsqrt()
        print(f"{name} {list(x.shape)} {plan_for(x).regime}: mean err kernel "
              f"{float((stats[0].double() - md).abs().max()):.3g} plain {float((mp.double() - md).abs().max()):.3g}; "
              f"rstd rel err kernel {float((stats[1].double() / rd - 1).abs().max()):.3g} plain "
              f"{float((rp.double() / rd - 1).abs().max()):.3g}; bf16 outputs that differ "
              f"{float((yk != yp).float().mean()):.3g}; max |mean|/std {float((md.abs() * rd).max()):.3g}")
    del inputs, mid, got, plain
    torch.cuda.empty_cache()

    for build, x in ((lambda: UNet3D(in_channels=4, num_classes=3, dtype=torch.bfloat16, device=dev, seed=0), xb),
                     (lambda: MultimodalUNetLateFusion(num_classes=3, dtype=torch.bfloat16, device=dev, seed=0),
                      xb[:1]),
                     (lambda: UNet3DWS(in_channels=4, num_classes=3, dtype=torch.bfloat16, device=dev, seed=0),
                      xb[:1])):
        model = build()
        got, plain = logits_pair(model, x)
        print(f"{type(model).__name__} bf16 {list(x.shape)}: logits rel L2 kernel vs plain norm {rel(got, plain):.4g}")
        del model, got, plain
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
