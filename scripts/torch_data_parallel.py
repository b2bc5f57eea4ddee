#!/usr/bin/env python3
"""chip_smoke.py's phase 22 alone: the data axis over ranks on one CUDA card.

    python3 scripts/torch_data_parallel.py [--backend gloo] [--no-cli]

Builds the CUDA kernels, probes NCCL with two ranks on card 0 (unless
``--backend`` names the backend), then runs ``chip_smoke.data_parallel_phase``:
two ranks spawned on card 0 (``training.devices=[0, 0]``) against one
process on the same global batches, the flagship at full width (f32 gate,
bf16 timing), each rank's launches exactly and its kernels against their
plain versions; then, unless ``--no-cli``, ``cli.train`` and ``cli.adapt``
under ``python -m torch.distributed.run --nproc_per_node=1`` on a HECKTOR21
fixture written here at (144,144,48) (24 cases; the whole smoke uses phase
14's), and with ``--two-rank-cli`` ``cli.adapt`` over two ranks on card 0
(``training.devices=[0,0]``, over gloo). Prints the card's
name and power limit, the phase's lines, and as the last line one JSON
object with its numbers. Needs a CUDA card.
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
    ap.add_argument("--backend", default=None, help="the two ranks' backend (default: the NCCL probe decides)")
    ap.add_argument("--no-cli", action="store_true", help="skip the torchrun CLI runs")
    ap.add_argument("--two-rank-cli", action="store_true",
                    help="also cli.adapt over two ranks on card 0 (training.devices=[0,0], gloo)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_data_parallel: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from multimodal_tta_tpu_torch.data.synthetic import make_hecktor_fixture
    from multimodal_tta_tpu_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    for src in ("fused_instance_norm", "edt_minplus"):
        _build.load(src)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    root = os.path.join(REPO, "build", "data_parallel")  # build/ is in .gitignore
    shutil.rmtree(root, ignore_errors=True)
    manifest = None
    if not args.no_cli:
        manifest = make_hecktor_fixture(os.path.join(root, "fixture"), shape=chip_smoke.CLI_SHAPE,
                                        centers={"CHUS": 4, "CHUM": 10, "CHGJ": 10})
    dp = chip_smoke.data_parallel_phase(torch.device("cuda"), os.path.join(root, "phase"), backend=args.backend)
    if manifest is not None:
        dp["torchrun"] = chip_smoke.dp_torchrun_cli(manifest, os.path.join(root, "torchrun"),
                                                    two_ranks=args.two_rank_cli)
    chip_smoke.log_data_parallel(dp, card)
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"data_parallel": dp, "card": card}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
