"""BraTS offline preprocessing on the device (the port of
``scripts/prepare_brats.py``).

    python -m multimodal_tta_tpu_torch.cli.prepare_brats --config scripts/configs/brats.yaml --workers N

Walks a raw BraTS-layout tree (one directory per case holding
``<case>-<mod>.nii.gz`` and ``<case><seg_suffix>``), resamples the first
modality to ``target_spacing`` and the others and the segmentation onto its
grid on ``device`` (``ops/resample.py``), center pads/crops everything to
``output_size``, writes the volumes and the ``processed.csv`` manifest that
``data/brats.py`` reads (columns subject_id / modality / img_path /
label_path / split / status). The geometry helpers are the HECKTOR CLI's, as
in the reference script. ``main(argv, device="cuda")`` runs on the GPU and
raises without one; ``device="cpu"`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .. import DeviceLike, resolve_device
from ..data.csv_table import write_csv
from ..ops.resample import resample_to_reference, resample_to_spacing
from .prepare_hecktor21 import (
    apply_center_pad_crop,
    compute_center_pad_crop_params,
    ensure_dir,
    load_yaml,
    read_image,
    run_cases,
    timed,
    write_image,
)


def assign_split(case_id: str, rng: np.random.RandomState, ratios) -> str:
    r = rng.rand()
    if r < ratios[0]:
        return "train"
    if r < ratios[0] + ratios[1]:
        return "val"
    return "test"


def process_case(case_dir: Path, cfg: Dict[str, Any], out_img: Path, out_lab: Path, device: DeviceLike = "cuda",
                 part_ms: Optional[Dict[str, float]] = None):
    """One case: ``([(modality, image path)], label path)``. ``part_ms``, when
    given, gets the wall in ms of ``decode``, ``resample`` (every
    modality's and the segmentation's), ``crop_pad`` and ``write``."""
    case = case_dir.name
    mods = [str(m).lower() for m in cfg.get("modalities", ["t1n", "t1c", "t2w", "t2f"])]
    seg_suffix = cfg.get("seg_suffix", "-seg.nii.gz")
    spacing = tuple(float(x) for x in cfg.get("target_spacing", [1.0, 1.0, 1.0]))
    out_size = [int(x) for x in cfg.get("output_size", [160, 192, 160])]
    pad_img = float(cfg.get("pad_value_image", 0.0))
    pad_msk = float(cfg.get("pad_value_mask", 0.0))

    # 1) the reference grid: the first modality resampled to the target spacing
    with timed(part_ms, "decode"):
        ref_data, ref_grid_raw = read_image(case_dir / f"{case}-{mods[0]}.nii.gz")
    with timed(part_ms, "resample"):
        ref_data, ref_grid = resample_to_spacing(ref_data, ref_grid_raw, spacing, method="linear",
                                                 default_value=pad_img, device=device)

    vols = {mods[0]: (ref_data, ref_grid)}
    for m in mods[1:]:
        with timed(part_ms, "decode"):
            d, g = read_image(case_dir / f"{case}-{m}.nii.gz")
        with timed(part_ms, "resample"):
            vols[m] = resample_to_reference(d, g, ref_grid, method="linear", default_value=pad_img, device=device)

    with timed(part_ms, "decode"):
        seg, seg_grid = read_image(case_dir / f"{case}{seg_suffix}")
    with timed(part_ms, "resample"):
        seg, seg_grid = resample_to_reference(seg, seg_grid, ref_grid, method="nearest", default_value=pad_msk,
                                              device=device)

    # 2) center pad/crop all to the fixed output size
    pb, pa, cl, cu = compute_center_pad_crop_params(list(ref_data.shape), out_size)
    rows, writes = [], []
    for m, (d, g) in vols.items():
        with timed(part_ms, "crop_pad"):
            d2, g2 = apply_center_pad_crop(d, g, out_size, pad_img, pb, pa, cl, cu)
        p = out_img / f"{case}_{m}.nii.gz"
        writes.append((p, d2, g2, np.float32))
        rows.append((m, str(p)))
    with timed(part_ms, "crop_pad"):
        seg2, sg2 = apply_center_pad_crop(seg, seg_grid, out_size, pad_msk, pb, pa, cl, cu)
    lab_p = out_lab / f"{case}_seg.nii.gz"
    writes.append((lab_p, np.rint(seg2), sg2, np.uint8))
    # 3) the writes, a thread each: gzip level 9 of a volume takes seconds
    # and releases the GIL
    with timed(part_ms, "write"), ThreadPoolExecutor(max_workers=len(writes)) as pool:
        for done in [pool.submit(write_image, *w) for w in writes]:
            done.result()
    return rows, str(lab_p)


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Preprocess; returns the manifest rows (``rows``) and each processed
    case's wall by part (``part_ms``: case -> {part: ms})."""
    dev = resolve_device(device)
    ap = argparse.ArgumentParser(prog="python -m multimodal_tta_tpu_torch.cli.prepare_brats")
    ap.add_argument("--config", required=True)
    ap.add_argument("--workers", type=int, default=1,
                    help="Thread-pool width for the per-case pipeline; the output equals --workers 1. "
                         "Split assignment stays serial: its RNG consumption order pins the splits.")
    args = ap.parse_args(list(sys.argv[1:] if argv is None else argv))
    cfg = load_yaml(args.config)

    raw_root = Path(cfg["raw_root"])
    out_root = Path(cfg["out_root"])
    out_img = out_root / "images"
    out_lab = out_root / "labels"
    ensure_dir(out_img)
    ensure_dir(out_lab)

    ratios = cfg.get("split_ratios", [0.8, 0.1, 0.1])
    rng = np.random.RandomState(int(cfg.get("split_seed", 42)))
    case_dirs = sorted(p for p in raw_root.iterdir() if p.is_dir())
    # splits first, serially: one draw per case in sorted order is the split contract
    splits = [assign_split(d.name, rng, ratios) for d in case_dirs]
    part_ms: Dict[str, Dict[str, float]] = {}

    def run_case(item) -> List[Dict[str, Any]]:
        case_dir, split = item
        ms: Dict[str, float] = {}
        try:
            mod_rows, lab_p = process_case(case_dir, cfg, out_img, out_lab, device=dev, part_ms=ms)
        except Exception as e:  # a failed case is a status row, never a lost run
            return [{"subject_id": case_dir.name, "modality": "", "img_path": "", "label_path": "",
                     "split": split, "status": f"error:{type(e).__name__}"}]
        part_ms[case_dir.name] = ms
        return [{"subject_id": case_dir.name, "modality": m, "img_path": img_p, "label_path": lab_p,
                 "split": split, "status": "ok"} for m, img_p in mod_rows]

    per_case = run_cases(run_case, list(zip(case_dirs, splits)), args.workers)
    rows: List[Dict[str, Any]] = [r for case_rows in per_case for r in case_rows]
    n_done = sum(1 for cr in per_case if cr and cr[0]["status"] == "ok")

    out_csv = out_root / "processed.csv"
    write_csv(str(out_csv), rows)
    print(f"[DONE] cases={n_done}, errors={len(per_case) - n_done}")
    print(f"[MANIFEST] {out_csv}")
    return {"rows": rows, "part_ms": part_ms}


if __name__ == "__main__":
    main()
