#!/usr/bin/env python3
"""chip_smoke.py's phases 26 and 27 alone, on one CUDA card.

    python3 scripts/torch_expert_pipeline.py [--phase 26|27] [--no-probe]

Builds the CUDA kernels, then runs phase 26 (``chip_smoke.expert_axis_*``:
MoE UNETR at the width of ``configs/model/unetr.yaml`` with 8 experts over a
``data=2 x expert=2`` mesh of four ranks on card 0 against one process,
every norm and min-plus call held to its plain version) and phase 27
(``chip_smoke.stage_axis_*``: ViT-B/16 pipelined over a ``data=2 x stage=2``
mesh of four ranks on card 0 against the sequential model), their ranks in
one spawn as the smoke runs them, and unless ``--no-probe``
``gloo_p2p_probe`` (whether gloo's ``send`` / ``recv`` take a CUDA tensor;
``parallel/pipeline.py`` stages its hops through host memory over gloo
either way). Prints the card's name and
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


def _gloo_p2p_probe_rank(rank: int, root: str) -> None:
    """Two gloo ranks on card 0: one ``send`` / ``recv`` of a CUDA tensor;
    the outcome in ``root``."""
    import datetime
    import json as _json

    import torch
    import torch.distributed as dist

    outcome = {"rank": rank}
    try:
        dist.init_process_group("gloo", init_method=f"file://{root}/store", world_size=2, rank=rank,
                                timeout=datetime.timedelta(seconds=30))
        t = torch.full((4,), 7.0, device="cuda:0") if rank == 0 else torch.zeros(4, device="cuda:0")
        if rank == 0:
            dist.send(t, 1)
        else:
            dist.recv(t, 0)
        torch.cuda.synchronize()
        outcome.update(accepted=True, value=float(t[0].cpu()))
    except Exception as e:  # the probe's answer, recorded
        outcome.update(accepted=False, error=f"{type(e).__name__}: {e}"[:2000])
    finally:
        with open(os.path.join(root, f"probe{rank}.json"), "w", encoding="utf-8") as f:
            _json.dump(outcome, f)
        if dist.is_initialized():
            dist.destroy_process_group()


def gloo_p2p_probe(root: str, timeout: float = 90.0) -> dict:
    """Whether gloo's ``send`` / ``recv`` take a CUDA tensor on this torch
    (its backend table lists them for CPU tensors only); what it says when
    they do not (or that a rank did not answer within ``timeout``)."""
    import multiprocessing as mp

    os.makedirs(root, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_p2p_probe_rank, args=(r, root), daemon=True) for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=30)
    ranks = []
    for r, p in enumerate(procs):
        path = os.path.join(root, f"probe{r}.json")
        ranks.append(json.load(open(path, encoding="utf-8")) if os.path.exists(path)
                     else {"rank": r, "accepted": False, "error": f"no answer (exit code {p.exitcode})"})
    ok = all(r.get("accepted") for r in ranks) and ranks[1].get("value") == 7.0
    return {"accepted": ok, "ranks": ranks, "seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", type=int, choices=(26, 27), default=None, help="one phase (default: both)")
    ap.add_argument("--no-probe", action="store_true", help="skip the gloo send / recv probe")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_expert_pipeline: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from multimodal_tta_tpu_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    for src in ("fused_instance_norm", "edt_minplus"):
        _build.load(src)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    root = os.path.join(REPO, "build", "expert_pipeline")  # build/ is in .gitignore
    shutil.rmtree(root, ignore_errors=True)
    out = {"card": card}
    if not args.no_probe:
        out["gloo_p2p_probe"] = gloo_p2p_probe(os.path.join(root, "p2p"))
        print(f"[stage_axis] gloo send / recv of a CUDA tensor: {json.dumps(out['gloo_p2p_probe'])}", flush=True)
    dev = torch.device("cuda")
    phases = {26: ("expert_axis", chip_smoke.expert_axis_prepare, chip_smoke.expert_axis_compare,
                   chip_smoke.log_expert_axis),
              27: ("stage_axis", chip_smoke.stage_axis_prepare, chip_smoke.stage_axis_compare,
                   chip_smoke.log_stage_axis)}
    chosen = [phases[p] for p in sorted(phases) if args.phase in (None, p)]
    preps = {}
    for name, prepare, _, _ in chosen:  # the one-process runs, then the ranks of both in one spawn
        torch.cuda.empty_cache()
        preps[name] = prepare(dev, os.path.join(root, name))
    torch.cuda.empty_cache()
    out["ranks_s"] = chip_smoke.spawn_axes(dev, [(n, p["spec"]) for n, p in preps.items()], os.path.join(root, "store"))
    failed = []
    for name, _, compare, log_phase in chosen:  # each phase compared, whatever another's outcome
        try:
            out[name] = compare(dev, preps[name])
        except AssertionError as e:
            print(f"[{name}] FAILED: {e}", flush=True)
            failed.append(name)
            continue
        log_phase(out[name], card)
    shutil.rmtree(root, ignore_errors=True)
    out["failed"] = failed
    print(json.dumps(out, default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
