#!/usr/bin/env python3
"""chip_smoke.py's phase 21 alone: the offline preprocessing on one CUDA card.

    python3 scripts/torch_preprocess.py

Builds the CUDA kernels and runs ``chip_smoke.preprocess_phase``: a raw
HECKTOR21 tree at HECKTOR 2021's grids through ``cli.prepare_hecktor21`` on
the card (one case again on the CPU), 2 raw BraTS cases through
``cli.prepare_brats``, the prepared manifest through ``cli.train`` and
``cli.adapt`` with Tent, and the ops nothing calls against the CPU. Counts
the kernels' launches as the smoke does. Prints the card's name and power
limit, the phase's numbers, and as the last line one JSON object with all of
them. Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_preprocess: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from multimodal_tta_tpu_torch.kernels import _build
    from multimodal_tta_tpu_torch.kernels.edt_minplus import minplus
    from multimodal_tta_tpu_torch.kernels.fused_instance_norm import fused_instance_norm, instance_norm_backward_plain

    # as chip_smoke.py: f32 is f32 (the unused ops are held to the CPU)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    for src in ("fused_instance_norm", "edt_minplus"):
        _build.load(src)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    def reset_counts():
        fused_instance_norm.launches = 0
        fused_instance_norm.backward_launches = 0
        minplus.launches = 0
        instance_norm_backward_plain.cuda_calls = 0

    def read_counts() -> dict:
        return {"forward": fused_instance_norm.launches, "backward": fused_instance_norm.backward_launches,
                "minplus": minplus.launches, "plain_backward": instance_norm_backward_plain.cuda_calls}

    t0 = time.perf_counter()
    out = chip_smoke.preprocess_phase(torch.device("cuda"), os.path.join(REPO, "build", "torch_preprocess"),
                                      reset_counts=reset_counts, read_counts=read_counts)
    phase_s = time.perf_counter() - t0
    h = out["hecktor"]
    print(f"prepare_hecktor21: {h['cases']} cases in {h['wall_s']:.2f} s, {h['cases_per_s']:.3f} cases/s, mean ms "
          f"by part {h['mean_part_ms']}, peak {h['peak_gib']:.3f} GiB; CT resample {h['ct_resample']}", flush=True)
    print(f"card vs CPU: {h['cpu_case']}; BraTS {out['brats']}", flush=True)
    for call in ("train", "adapt"):
        print(f"cli.{call}: launches {out[call]['launches']} (derived {out[call]['want']}), "
              f"{out[call]['wall_s']:.2f} s", flush=True)
    print(f"EDT {out['edt']}; ops {out['ops']}", flush=True)
    print(f"phase took {phase_s:.1f} s", flush=True)
    print(json.dumps({"card": card, "phase_s": phase_s, **out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
