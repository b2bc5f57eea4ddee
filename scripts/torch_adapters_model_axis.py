#!/usr/bin/env python3
"""chip_smoke.py's phases 24 and 25 alone, on one CUDA card.

    python3 scripts/torch_adapters_model_axis.py [--phase 24|25] [--no-cli]

Builds the CUDA kernels, then runs ``chip_smoke.adapters_phase`` (phase 24:
pl, eata, sar, cotta and memo through ``TTAEngine.evaluate`` over two ranks
sharing card 0 against one process, the flagship at full width, every norm
and min-plus call held to its plain version, bf16 ms per evaluated batch;
unless ``--no-cli``, ``cli.adapt tta=sar`` and ``cli.predict`` under torchrun
on a HECKTOR21 fixture written here at (144,144,48), the predictions
against one process's) and ``chip_smoke.model_axis_phase`` (phase 25: UNETR
at the width of ``configs/model/unetr.yaml`` over a ``data=2 x model=2`` mesh
of four ranks on card 0 against one process, every norm call held to its
plain version). Prints the card's name and
power limit, the phases' lines, and as the last line one JSON object with
their numbers. Needs a CUDA card.
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
    ap.add_argument("--phase", type=int, choices=(24, 25), default=None, help="one phase (default: both)")
    ap.add_argument("--no-cli", action="store_true", help="skip phase 24's torchrun CLI runs")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_adapters_model_axis: needs a CUDA card", file=sys.stderr)
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
    root = os.path.join(REPO, "build", "adapters_model_axis")  # build/ is in .gitignore
    shutil.rmtree(root, ignore_errors=True)
    out = {"card": card}
    if args.phase in (None, 24):
        manifest = None
        if not args.no_cli:
            manifest = make_hecktor_fixture(os.path.join(root, "fixture"), shape=chip_smoke.CLI_SHAPE,
                                            centers={"CHUS": 4, "CHUM": 4, "CHGJ": 4})
        out["adapters"] = chip_smoke.adapters_phase(torch.device("cuda"), os.path.join(root, "ad"))
        if manifest is not None:
            cli_root = os.path.join(root, "torchrun")
            out["adapters"]["torchrun"] = chip_smoke.ad_predict_check(
                manifest, cli_root, chip_smoke.ad_torchrun_cli(manifest, cli_root))
        chip_smoke.log_adapters(out["adapters"], card)
    if args.phase in (None, 25):
        torch.cuda.empty_cache()
        out["model_axis"] = chip_smoke.model_axis_phase(torch.device("cuda"), os.path.join(root, "tp"))
        chip_smoke.log_model_axis(out["model_axis"], card)
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
