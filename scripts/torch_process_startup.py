#!/usr/bin/env python3
"""What a fresh process costs on this host: the fixed part of every
command line and every spawned rank of ``chip_smoke.py``.

    python3 scripts/torch_process_startup.py

Measures, each by the wall of a child process: ``import torch``; ``import
torch``, the first CUDA tensor and a first convolution (one process, then
two at once); the imports of the port's three command-line modules; a
two-rank ``torch.distributed.run`` of a script that starts a gloo group,
touches the card and all-reduces one number; and gzip levels 1, 6 and 9 of
19.7 MB of random f32 (one [160,192,160] volume). Prints one JSON object:
each entry is ``[seconds, the end of the child's output]``. Needs a CUDA
card for the CUDA entries.
"""

from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TORCHRUN_SCRIPT = """import os, time, torch, torch.distributed as d
t = time.perf_counter()
d.init_process_group('gloo')
x = torch.zeros(1, device='cuda'); d.all_reduce(x.cpu())
print('rank', os.environ['RANK'], 'init+cuda', time.perf_counter() - t)
d.destroy_process_group()
"""


def run(cmd: list, n: int = 1) -> list:
    """``n`` copies of ``cmd`` started together: the seconds until all have
    ended, and the end of the first one's output."""
    t = time.perf_counter()
    procs = [subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(n)]
    outs = [p.communicate()[0] for p in procs]
    return [round(time.perf_counter() - t, 2), outs[0][-300:]]


def main() -> int:
    py = sys.executable
    r = {"import_torch": run([py, "-c", "import torch"])}
    r["cuda_init_1"] = run([py, "-c", (
        "import time; t = time.perf_counter(); import torch; a = time.perf_counter(); "
        "torch.zeros(1, device='cuda'); torch.cuda.synchronize(); b = time.perf_counter(); "
        "import torch.nn.functional as F; x = torch.randn(2, 2, 48, 144, 144, device='cuda'); "
        "w = torch.randn(32, 2, 3, 3, 3, device='cuda'); F.conv3d(x, w, padding=1); torch.cuda.synchronize(); "
        "print('import', a - t, 'init', b - a, 'conv', time.perf_counter() - b)")])
    r["cuda_init_2par"] = run([py, "-c", (
        "import time; t = time.perf_counter(); import torch; a = time.perf_counter(); "
        "torch.zeros(1, device='cuda'); torch.cuda.synchronize(); "
        "print('import', a - t, 'init', time.perf_counter() - a)")], n=2)
    r["pkg_import"] = run([py, "-c", (
        "import time; t = time.perf_counter(); import multimodal_tta_tpu_torch.cli.adapt, "
        "multimodal_tta_tpu_torch.cli.predict, multimodal_tta_tpu_torch.cli.train; print(time.perf_counter() - t)")])
    script = os.path.join(REPO, "build", "process_startup_rank.py")  # build/ is in .gitignore
    os.makedirs(os.path.dirname(script), exist_ok=True)
    with open(script, "w", encoding="utf-8") as f:
        f.write(TORCHRUN_SCRIPT)
    r["torchrun2_trivial"] = run([py, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2", script])
    os.remove(script)
    r["nproc"] = os.cpu_count()
    volume = np.random.RandomState(0).randn(160 * 192 * 160).astype(np.float32).tobytes()
    for level in (1, 6, 9):
        t = time.perf_counter()
        gzip.compress(volume, compresslevel=level)
        r[f"gzip{level}_19.7MB"] = round(time.perf_counter() - t, 2)
    print(json.dumps(r, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
