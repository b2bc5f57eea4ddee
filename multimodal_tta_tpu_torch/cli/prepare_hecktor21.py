"""HECKTOR21 offline preprocessing on the device (the port of
``scripts/prepare_hecktor21.py``).

    python -m multimodal_tta_tpu_torch.cli.prepare_hecktor21 --config scripts/configs/hecktor21.yaml \
        --mode {full,split_only} --workers N

Per patient: CT -> fixed spacing (linear, pad -1024); PET/GT -> CT grid
(linear / nearest); physical bbox -> index ROI (8-corner, flip-robust);
out-of-bounds pad; ROI crop; center pad/crop to ``output_size``; cast; write
``.nii.gz``; one provenance row (raw/resampled sizes and spacings, bbox, ROI,
pads, status) in the manifest. The three resamples run on ``device``
(``ops/resample.py``); the rest is host numpy, as in the reference. A case
that fails becomes a ``status=error:<type>`` row and the run goes on.

The config is read with the port's YAML reader (``conf/yaml_subset.py``) and
the CSVs with ``data/csv_table.py``, which reads and writes them as pandas
does: the inner merge on ``PatientID``, the row labels the seeded
``np.random.RandomState`` split draw picks from, the manifest's columns and
cells are the reference script's, so both manifests read back equal under
``pandas.read_csv``. ``main(argv, device="cuda")`` runs on the GPU and raises
without one; ``device="cpu"`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import re
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import DeviceLike, resolve_device
from ..conf import yaml_subset
from ..data import nifti
from ..data.csv_table import Table, read_csv, write_csv
from ..ops.resample import (
    Grid,
    bbox_mm_to_index_roi,
    crop_image,
    pad_image,
    resample_to_reference,
    resample_to_spacing,
)

# the parts of a case whose wall ``process_case`` records (ms)
PARTS = ("decode", "resample_ct", "resample_pt", "resample_gt", "crop_pad", "write")


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return yaml_subset.load(f.read())


def ensure_dir(p: Path) -> None:
    p.mkdir(parents=True, exist_ok=True)


def patient_center_code(patient_id: str) -> str:
    m = re.match(r"^([A-Za-z]{4})", patient_id)
    return m.group(1).upper() if m else "UNK"


def read_image(path: Path) -> Tuple[np.ndarray, Grid]:
    img = nifti.load(str(path))
    data = np.asarray(img.get_fdata(np.float32))
    return data, Grid.from_ras_affine(img.affine, data.shape[:3])


def write_image(path: Path, data: np.ndarray, grid: Grid, dtype) -> None:
    nifti.save(data.astype(dtype), grid.to_ras_affine(), str(path))


@contextmanager
def timed(ms: Optional[Dict[str, float]], part: str):
    """Adds the block's wall to ``ms[part]`` (ms) when ``ms`` is given."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if ms is not None:
            ms[part] = ms.get(part, 0.0) + (time.perf_counter() - t0) * 1e3


# -----------------------------
# Split logic
# -----------------------------
def merge_on_patient(bbox: Table, info: Table) -> List[Dict[str, Any]]:
    """``pandas.merge(bbox, info, on="PatientID", how="inner")`` as rows: each
    bbox row in order, joined with every info row of its id in info's order;
    bbox's columns, then info's others (a name in both gets ``_x`` / ``_y``)."""
    shared = (set(bbox.columns) & set(info.columns)) - {"PatientID"}
    by_id: Dict[Any, List[Dict[str, Any]]] = {}
    for r in info.rows:
        by_id.setdefault(r["PatientID"], []).append(r)
    out = []
    for b in bbox.rows:
        left = {f"{k}_x" if k in shared else k: v for k, v in b.items()}
        for i in by_id.get(b["PatientID"], []):
            out.append({**left, **{f"{k}_y" if k in shared else k: v for k, v in i.items() if k != "PatientID"}})
    return out


def assign_splits(
    rows: List[Dict[str, Any]],
    enable_split: bool,
    source_centers: List[str],
    target_centers: List[str],
    val_per_center: int,
    seed: int,
    other_policy: str,
) -> List[Dict[str, Any]]:
    """The manifest rows with ``domain`` and ``split`` stamped on.

    Target centers are test in full; source centers are train with
    ``val_per_center`` cases per center held out to val by a seeded draw;
    unlisted centers follow ``other_policy`` ("source" / "target" / anything
    else = drop). The ``np.random.RandomState`` consumption order is the data
    contract: one RandomState(seed), source centers walked in sorted order,
    one replace=False draw of min(val_per_center, n) of the center's row
    labels (positions in ``rows``) per center (pinned by the goldens of
    tests/test_resample_preprocess.py and tests/test_torch_preprocess.py).
    """
    out = [dict(r) for r in rows]
    if not enable_split:
        for r in out:
            r.update(domain="all", split="train")
        return out

    src = {str(c).upper() for c in source_centers}
    tgt = {str(c).upper() for c in target_centers}
    policy = str(other_policy).lower().strip()
    fallback = policy if policy in ("source", "target") else "ignore"
    for r in out:
        code = str(r["center_code"]).upper()
        r["domain"] = "source" if code in src else "target" if code in tgt else fallback
        r["split"] = {"source": "train", "target": "test", "ignore": "ignore"}[r["domain"]]

    rng = np.random.RandomState(seed)
    groups: Dict[Any, List[int]] = {}
    for i, r in enumerate(out):
        if r["domain"] == "source":
            groups.setdefault(r["center_code"], []).append(i)
    for code in sorted(groups):
        labels = np.asarray(groups[code], np.int64)
        for i in rng.choice(labels, size=min(int(val_per_center), len(labels)), replace=False):
            out[int(i)]["split"] = "val"
    return out


def compute_center_pad_crop_params(cur_size, target_size):
    """Center-aligned pad/crop params (reference: 211-243)."""
    cur = np.asarray(cur_size, int)
    tgt = np.asarray(target_size, int)
    diff = tgt - cur
    pad_before = np.zeros(3, int)
    pad_after = np.zeros(3, int)
    crop_lower = np.zeros(3, int)
    crop_upper = np.zeros(3, int)
    for d in range(3):
        if diff[d] >= 0:
            pad_before[d] = diff[d] // 2
            pad_after[d] = diff[d] - pad_before[d]
        else:
            cut = -diff[d]
            crop_lower[d] = cut // 2
            crop_upper[d] = cut - crop_lower[d]
    return pad_before.tolist(), pad_after.tolist(), crop_lower.tolist(), crop_upper.tolist()


def apply_center_pad_crop(data, grid, target_size, pad_value, pad_before, pad_after, crop_lower, crop_upper):
    """Crop then pad to reach target_size (reference: 246-268)."""
    if any(v > 0 for v in crop_lower) or any(v > 0 for v in crop_upper):
        size = [int(s - lo - hi) for s, lo, hi in zip(data.shape, crop_lower, crop_upper)]
        data, grid = crop_image(data, grid, crop_lower, size)
    if any(v > 0 for v in pad_before) or any(v > 0 for v in pad_after):
        data, grid = pad_image(data, grid, pad_before, pad_after, pad_value)
    if list(data.shape) != [int(x) for x in target_size]:
        raise RuntimeError(f"[pad/crop] failed to reach target_size={target_size}, got={list(data.shape)}")
    return data, grid


def pad_if_needed(data, grid, start_idx, roi_size, pad_value):
    """Pad so the ROI fits inside the image (reference: 168-204)."""
    img_size = np.asarray(data.shape, int)
    start = np.asarray(start_idx, int)
    size = np.asarray(roi_size, int)
    end = start + size - 1

    pad_before = np.maximum(-start, 0)
    pad_after = np.maximum(end - (img_size - 1), 0)
    if np.any(pad_before > 0) or np.any(pad_after > 0):
        data, grid = pad_image(data, grid, pad_before.tolist(), pad_after.tolist(), pad_value)
        new_start = (start + pad_before).tolist()
        dbg = {"padded": True, "pad_before": pad_before.tolist(), "pad_after": pad_after.tolist()}
        return data, grid, new_start, dbg
    return data, grid, list(start_idx), {"padded": False, "pad_before": [0, 0, 0], "pad_after": [0, 0, 0]}


# -----------------------------
# split-only manifest
# -----------------------------
def case_file_layout(pid: str, nii_root: Path, out_root: Path, ct_suffix: str, pt_suffix: str, gt_suffix: str):
    """(raw, processed) path dicts for one case, keyed by modality: the
    on-disk contract shared with the reference pipeline's outputs
    (``<pid>_ct.nii.gz`` under images/, ``<pid>_gtvt.nii.gz`` under labels/)."""
    raw = {
        "ct": nii_root / f"{pid}{ct_suffix}",
        "pt": nii_root / f"{pid}{pt_suffix}",
        "gtvt": nii_root / f"{pid}{gt_suffix}",
    }
    proc = {
        "ct": out_root / "images" / f"{pid}_ct.nii.gz",
        "pt": out_root / "images" / f"{pid}_pt.nii.gz",
        "gtvt": out_root / "labels" / f"{pid}_gtvt.nii.gz",
    }
    return raw, proc


def write_manifest(rows: List[Dict[str, Any]], out_manifest_csv: Path, per_domain: bool) -> None:
    """The manifest and, when asked, its ``source.csv`` / ``target.csv``
    subsets (the reference writes each subset with the manifest's columns)."""
    write_csv(str(out_manifest_csv), rows)
    if not (per_domain and rows):
        return
    columns = list(dict.fromkeys(k for r in rows for k in r))
    for dom, name in (("source", "source.csv"), ("target", "target.csv")):
        sub = [{c: r.get(c) for c in columns} for r in rows if r.get("domain") == dom]
        if sub:
            write_csv(str(out_manifest_csv.with_name(name)), sub)


def build_manifest_csv_only(rows, nii_root, out_root, out_manifest_csv, export_per_domain_csv, ct_suffix, pt_suffix,
                            gt_suffix) -> List[Dict[str, Any]]:
    """``--mode split_only``: the manifest (raw paths, expected processed
    paths, existence-checked status) without reading a voxel; the column
    schema ``data/hecktor21.py`` reads."""
    for d in (out_root / "images", out_root / "labels", out_manifest_csv.parent):
        ensure_dir(d)

    out = []
    for r in rows:
        if "ignore" in (str(r.get("split", "")), str(r.get("domain", ""))):
            continue
        pid = str(r["PatientID"])
        raw, proc = case_file_layout(pid, nii_root, out_root, ct_suffix, pt_suffix, gt_suffix)
        row = {
            "patient_id": pid,
            "center_code": str(r["center_code"]),
            "center_id": r.get("CenterID", None),
            "domain": str(r.get("domain", "")),
            "split": str(r.get("split", "")),
            "status": "ok" if all(p.exists() for p in raw.values()) else "missing_file",
        }
        row.update({f"{m}_raw": str(p) for m, p in raw.items()})
        row.update({f"{m}_proc": str(p) for m, p in proc.items()})
        out.append(row)
    write_manifest(out, out_manifest_csv, export_per_domain_csv)
    return out


def process_case(pid, r, cfg_geo, paths, device: DeviceLike = "cuda",
                 part_ms: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """The geometry pipeline of one patient, its three resamples on
    ``device``; returns the manifest row. ``part_ms``, when given, gets the
    wall of each of ``PARTS`` in ms."""
    ct_path, pt_path, gt_path, img_out_dir, lab_out_dir = paths
    x1, x2 = float(r["x1"]), float(r["x2"])
    y1, y2 = float(r["y1"]), float(r["y2"])
    z1, z2 = float(r["z1"]), float(r["z2"])

    with timed(part_ms, "decode"):
        ct_raw, ct_grid_raw = read_image(ct_path)
        pt_raw, pt_grid_raw = read_image(pt_path)
        gt_raw, gt_grid_raw = read_image(gt_path)

    # 1) CT -> fixed spacing (reference grid); 2) PET/GT -> CT grid
    with timed(part_ms, "resample_ct"):
        ct, ct_grid = resample_to_spacing(ct_raw, ct_grid_raw, cfg_geo["target_spacing"],
                                          method=cfg_geo["interp_ct"], default_value=cfg_geo["pad_value_ct"],
                                          device=device)
    with timed(part_ms, "resample_pt"):
        pt, _ = resample_to_reference(pt_raw, pt_grid_raw, ct_grid, method=cfg_geo["interp_pt"],
                                      default_value=cfg_geo["pad_value_pt"], device=device)
    with timed(part_ms, "resample_gt"):
        gt, _ = resample_to_reference(gt_raw, gt_grid_raw, ct_grid, method=cfg_geo["interp_mask"],
                                      default_value=cfg_geo["pad_value_mask"], device=device)
    pt_grid = gt_grid = ct_grid

    with timed(part_ms, "crop_pad"):
        # 3) bbox(mm) -> index ROI; 4) pad if needed; 5) crop
        start_idx, roi_size, dbg_roi = bbox_mm_to_index_roi(ct_grid, x1, x2, y1, y2, z1, z2)
        ct_p, ct_g, start_use, dbg_pad_ct = pad_if_needed(ct, ct_grid, start_idx, roi_size, cfg_geo["pad_value_ct"])
        pt_p, pt_g, _, _ = pad_if_needed(pt, pt_grid, start_idx, roi_size, cfg_geo["pad_value_pt"])
        gt_p, gt_g, _, _ = pad_if_needed(gt, gt_grid, start_idx, roi_size, cfg_geo["pad_value_mask"])

        ct_c, ct_g = crop_image(ct_p, ct_g, start_use, roi_size)
        pt_c, pt_g = crop_image(pt_p, pt_g, start_use, roi_size)
        gt_c, gt_g = crop_image(gt_p, gt_g, start_use, roi_size)
        crop_size = list(ct_c.shape)

        # 6) center pad/crop to the fixed output size
        out_size = cfg_geo["output_size"]
        pb, pa, cl, cu = compute_center_pad_crop_params(crop_size, out_size)
        ct_o, ct_g = apply_center_pad_crop(ct_c, ct_g, out_size, cfg_geo["pad_value_ct"], pb, pa, cl, cu)
        pt_o, pt_g = apply_center_pad_crop(pt_c, pt_g, out_size, cfg_geo["pad_value_pt"], pb, pa, cl, cu)
        gt_o, gt_g = apply_center_pad_crop(gt_c, gt_g, out_size, cfg_geo["pad_value_mask"], pb, pa, cl, cu)

    # 7-8) cast + write
    ct_out = img_out_dir / f"{pid}_ct.nii.gz"
    pt_out = img_out_dir / f"{pid}_pt.nii.gz"
    gt_out = lab_out_dir / f"{pid}_gtvt.nii.gz"
    with timed(part_ms, "write"):
        write_image(ct_out, ct_o, ct_g, cfg_geo["save_float_dtype"])
        write_image(pt_out, pt_o, pt_g, cfg_geo["save_float_dtype"])
        write_image(gt_out, np.rint(gt_o), gt_g, cfg_geo["save_mask_dtype"])

    return {
        "status": "ok",
        "ct_proc": str(ct_out),
        "pt_proc": str(pt_out),
        "gtvt_proc": str(gt_out),
        "ct_size_raw": ",".join(map(str, ct_grid_raw.size)),
        "ct_spacing_raw": ",".join(f"{x:.6f}" for x in ct_grid_raw.spacing),
        "pt_size_raw": ",".join(map(str, pt_grid_raw.size)),
        "pt_spacing_raw": ",".join(f"{x:.6f}" for x in pt_grid_raw.spacing),
        "ct_size_resampled": ",".join(map(str, ct_grid.size)),
        "ct_spacing_resampled": ",".join(f"{x:.6f}" for x in ct_grid.spacing),
        "bbox_x1": x1, "bbox_x2": x2,
        "bbox_y1": y1, "bbox_y2": y2,
        "bbox_z1": z1, "bbox_z2": z2,
        "roi_start_idx": ",".join(map(str, dbg_roi["start_idx"])),
        "roi_end_idx": ",".join(map(str, dbg_roi["end_idx"])),
        "roi_size_idx": ",".join(map(str, dbg_roi["roi_size"])),
        "pad_ct_before": ",".join(map(str, dbg_pad_ct["pad_before"])),
        "pad_ct_after": ",".join(map(str, dbg_pad_ct["pad_after"])),
        "crop_size_before_fix": ",".join(map(str, crop_size)),
        "final_output_size": ",".join(map(str, out_size)),
        "final_spacing": ",".join(f"{x:.6f}" for x in cfg_geo["target_spacing"]),
    }


def geometry_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    ts = cfg.get("target_spacing", [1.0, 1.0, 3.0])
    return {
        "target_spacing": (float(ts[0]), float(ts[1]), float(ts[2])),
        "output_size": [int(x) for x in cfg.get("output_size", cfg.get("target_size", [144, 144, 48]))],
        "pad_value_ct": float(cfg.get("pad_value_ct", -1024.0)),
        "pad_value_pt": float(cfg.get("pad_value_pt", 0.0)),
        "pad_value_mask": float(cfg.get("pad_value_mask", 0.0)),
        "interp_ct": str(cfg.get("interp_ct", "linear")),
        "interp_pt": str(cfg.get("interp_pt", "linear")),
        "interp_mask": str(cfg.get("interp_mask", "nearest")),
        "save_float_dtype": np.dtype(str(cfg.get("save_float_dtype", "float32"))),
        "save_mask_dtype": np.dtype(str(cfg.get("save_mask_dtype", "uint8"))),
    }


def run_cases(fn, items: Sequence[Any], workers: int) -> List[Any]:
    """``[fn(i) for i in items]``, on a thread pool when ``workers > 1``: the
    order is kept, so the output equals the serial run's."""
    if max(int(workers), 1) > 1 and len(items) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=int(workers)) as ex:
            return list(ex.map(fn, items))
    return [fn(i) for i in items]


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Preprocess; returns the manifest rows (``rows``) and each processed
    case's wall by part (``part_ms``: patient id -> {part: ms})."""
    dev = resolve_device(device)
    ap = argparse.ArgumentParser(prog="python -m multimodal_tta_tpu_torch.cli.prepare_hecktor21")
    ap.add_argument("--config", required=True, help="Path to YAML config.")
    ap.add_argument("--mode", choices=["full", "split_only"], default="full")
    ap.add_argument("--workers", type=int, default=1,
                    help="Thread-pool width for the per-case pipeline; the output (files and manifest "
                         "row order) equals --workers 1.")
    args = ap.parse_args(list(sys.argv[1:] if argv is None else argv))
    cfg = load_yaml(args.config)

    nii_root = Path(cfg["nii_root"])
    out_root = Path(cfg["out_root"])
    out_manifest_csv = Path(cfg["out_manifest_csv"])
    export_per_domain_csv = bool(cfg.get("export_per_domain_csv", False))
    cfg_geo = geometry_config(cfg)
    ct_suffix = cfg.get("ct_suffix", "_ct.nii.gz")
    pt_suffix = cfg.get("pt_suffix", "_pt.nii.gz")
    gt_suffix = cfg.get("gt_suffix", "_gtvt.nii.gz")

    img_out_dir = out_root / "images"
    lab_out_dir = out_root / "labels"
    for d in (img_out_dir, lab_out_dir, out_manifest_csv.parent):
        ensure_dir(d)

    bbox = read_csv(cfg["bbox_csv"])
    required = ["PatientID", "x1", "x2", "y1", "y2", "z1", "z2"]
    missing = [c for c in required if c not in bbox.columns]
    if missing:
        raise RuntimeError(f"bbox_csv missing columns: {missing}. Found: {list(bbox.columns)}")
    info = read_csv(cfg["info_csv"])
    for c in ("PatientID", "CenterID"):
        if c not in info.columns:
            raise RuntimeError(f"info_csv missing '{c}'. Found: {list(info.columns)}")

    merged = merge_on_patient(bbox, info)
    for r in merged:
        r["center_code"] = patient_center_code(str(r["PatientID"]))
    merged = assign_splits(
        merged,
        enable_split=bool(cfg.get("enable_split", False)),
        source_centers=cfg.get("source_centers", []),
        target_centers=cfg.get("target_centers", []),
        val_per_center=int(cfg.get("val_per_center", 5)),
        seed=int(cfg.get("seed", 2026)),
        other_policy=cfg.get("other_centers_policy", "ignore"),
    )

    if args.mode == "split_only":
        rows = build_manifest_csv_only(merged, nii_root, out_root, out_manifest_csv, export_per_domain_csv,
                                       ct_suffix, pt_suffix, gt_suffix)
        print(f"[SPLIT_ONLY DONE] merged_rows={len(merged)}, exported_rows={len(rows)}")
        print(f"[MANIFEST] {out_manifest_csv}")
        return {"rows": rows, "part_ms": {}}

    # Skipped and missing rows resolve here; the heavy cases become tasks.
    # Manifest row order follows the merged CSV either way.
    pending: List[Any] = []
    rows: List[Optional[Dict[str, Any]]] = []
    n_skipped = 0
    for r in merged:
        pid = str(r["PatientID"])
        base = {
            "patient_id": pid,
            "center_code": str(r["center_code"]),
            "center_id": r.get("CenterID", None),
            "domain": str(r.get("domain", "")),
            "split": str(r.get("split", "")),
        }
        if base["split"] == "ignore" or base["domain"] == "ignore":
            n_skipped += 1
            continue
        raw, _ = case_file_layout(pid, nii_root, out_root, ct_suffix, pt_suffix, gt_suffix)
        raw_paths = {f"{m}_raw": str(p) for m, p in raw.items()}
        if not all(p.exists() for p in raw.values()):
            rows.append({**base, "status": "missing_file", **raw_paths})
            n_skipped += 1
            continue
        rows.append(None)  # filled by the task below
        pending.append((len(rows) - 1, pid, r, base, raw_paths,
                        (raw["ct"], raw["pt"], raw["gtvt"], img_out_dir, lab_out_dir)))

    part_ms: Dict[str, Dict[str, float]] = {}

    def run_task(task) -> None:
        slot, pid, r, base, raw_paths, paths = task
        ms: Dict[str, float] = {}
        try:
            row = process_case(pid, r, cfg_geo, paths, device=dev, part_ms=ms)
            rows[slot] = {**base, **raw_paths, **row}
            part_ms[pid] = ms
        except Exception as e:  # a failed case is a status row, never a lost run
            rows[slot] = {**base, "status": f"error:{type(e).__name__}", "error_msg": str(e), **raw_paths}

    run_cases(run_task, pending, args.workers)
    rows = [x for x in rows if x is not None]
    n_done = sum(1 for x in rows if x.get("status") == "ok")
    n_skipped += sum(1 for x in rows if x.get("status", "").startswith("error:"))

    write_manifest(rows, out_manifest_csv, export_per_domain_csv)
    print(f"[DONE] processed={n_done}, skipped={n_skipped}, total_in_merged_csv={len(merged)}")
    print(f"[MANIFEST] {out_manifest_csv}")
    return {"rows": rows, "part_ms": part_ms}


if __name__ == "__main__":
    main()
