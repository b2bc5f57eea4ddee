#!/usr/bin/env python3
"""The reference's checkpoint formats in the port, on the card: the
flagship UNet3D at full width (channels 32..512, 21.7M params) with its Adam
state (mu, nu), saved and loaded as msgpack, torch and orbax, each restored
bitwise, ``REPEATS`` times over (``chip_smoke.checkpoint_io``, phase 11's
measurement, which also times the orbax reader's chunk decoding, the native
zstd of ``csrc/zstd_decode.cpp``); then the reference's orbax fixture
(``tests/data/orbax_reference``) read bitwise, with the decode rate of its
tensorstore frames (``chip_smoke.orbax_fixture_check``).

    python3 scripts/torch_orbax_io.py

Prints one JSON object with every time, the card's name and its power
limit. Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REPEATS = 3  # the first save and load of each format also warm the file cache


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("a CUDA card is needed", file=sys.stderr)
        return 2

    import chip_smoke
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.core import zstd
    from multimodal_tta_tpu_torch.core.optim import build_optimizer
    from multimodal_tta_tpu_torch.core.train_state import TrainState
    from multimodal_tta_tpu_torch.models.unet3d import UNet3D

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    root = os.path.join(REPO, "build", "orbax_io")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    def state(seed: int) -> TrainState:
        model = UNet3D(in_channels=2, num_classes=1, channels=(32, 64, 128, 256, 512), strides=(2, 2, 2, 2),
                       num_res_units=2, dtype=torch.bfloat16, device=dev, seed=seed)
        optimizer, _ = build_optimizer(ConfigNode(chip_smoke.train_recipe(root)).training, model)
        gen = torch.Generator(device=dev).manual_seed(seed)
        for _ in range(2):  # two Adam steps on seeded gradients: mu and nu hold values
            for p in model.parameters():
                p.grad = torch.randn(p.shape, generator=gen, device=dev, dtype=p.dtype) * 1e-3
            optimizer.step()
        return TrainState(model=model, optimizer=optimizer, step=2)

    def tensors(st: TrainState) -> list:
        out = list(st.model.state_dict().values())
        for entry in st.optimizer.state_dict()["state"].values():
            out += [v for v in entry.values() if torch.is_tensor(v)]
        return out

    t0 = time.perf_counter()
    zstd.lib()
    build_s = time.perf_counter() - t0
    src, dst = state(1), state(2)
    want = [t.detach().cpu().clone() for t in tensors(src)]

    def check(got: TrainState) -> bool:
        return got.step == 2 and all(torch.equal(a.cpu(), b) for a, b in zip(tensors(got), want))

    runs = [chip_smoke.checkpoint_io(src, dst, os.path.join(root, "flagship"), check) for _ in range(REPEATS)]
    formats = {fmt: {k: [r[fmt][k] for r in runs] for k in runs[0][fmt]} for fmt, _ in chip_smoke.CKPT_FORMATS}
    out = {"card": smi, "params": sum(p.numel() for p in src.model.parameters()), "zstd_build_s": build_s,
           "repeats": REPEATS, "formats": formats, "fixture": chip_smoke.orbax_fixture_check()}
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(out))
    ok = all(all(r["restored"]) for r in formats.values()) and out["fixture"]["bitwise"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
