"""Synthetic NIfTI dataset generators (the port's copy of
``multimodal_tta_tpu/data/synthetic.py``).

Used by the port's tests and by ``chip_smoke.py``, which trains, adapts and
exports through the command-line entry points from generated
full-working-shape volumes. For one seed they write the same volumes and
the same manifest rows as the reference; the manifests are written with the
``csv`` module as pandas' ``to_csv(index=False)`` writes them.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import csv

import numpy as np

from . import nifti


def _write_rows(path: str, rows: List[Dict]) -> None:
    """A header and one line per row (columns in first-seen key order)."""
    columns: List[str] = []
    for r in rows:
        columns += [k for k in r if k not in columns]
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.DictWriter(f, fieldnames=columns, lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)


def make_hecktor_fixture(
    root: str,
    *,
    centers: Dict[str, int] = None,
    shape: Tuple[int, int, int] = (12, 12, 6),  # (X,Y,Z)
    seed: int = 0,
    n_lesions: Tuple[int, int] = (1, 1),
    radius_range: Tuple[float, float] = (3.0, 3.0),
    lesion_contrast: Tuple[float, float] = (300.0, 6.0),  # (CT HU, PET SUV) bump
    domain_shift: Optional[Dict[str, Dict[str, float]]] = None,
) -> str:
    """Create a synthetic HECKTOR21 processed tree + manifest.csv.

    Returns the manifest path. Volumes contain ellipsoidal GTVt lesions so
    Dice is learnable; CT in HU-ish range, PET in SUV-ish range. Defaults
    produce one fixed-size ball per case (the cheap test fixture); pass
    ``n_lesions``/``radius_range`` spans for a harder model-comparison task
    (small lesions punish resolution loss, multiple lesions punish
    under-segmentation).

    ``domain_shift`` maps a center code to a scanner-shift spec applied to
    that center's volumes (the leave-one-center-out domain-gap simulator the
    TTA validation uses). Keys (all optional): ``ct_gain``, ``ct_bias``,
    ``pt_gain``, ``pt_gamma`` (PET nonlinearity), ``noise`` (extra additive
    CT noise sigma), ``bias_field`` (amplitude of a smooth multiplicative
    cosine bias field — survives masked z-score normalization, unlike pure
    gain/bias).
    """
    centers = centers or {"CHUS": 4, "CHUM": 4, "CHGJ": 3}
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    lab_dir = os.path.join(root, "labels")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)

    affine = np.diag([1.0, 1.0, 3.0, 1.0])
    X, Y, Z = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    rows = []
    # the volumes are drawn in order and written on threads (gzip releases the GIL)
    workers = min(8, os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        writes = []
        for center, n in centers.items():
            for i in range(n):
                pid = f"{center}{i:03d}"
                ct = rng.randn(*shape).astype(np.float32) * 200.0
                pt = np.abs(rng.randn(*shape)).astype(np.float32) * 4.0
                mask = np.zeros(shape, dtype=np.uint8)
                for _ in range(rng.randint(n_lesions[0], n_lesions[1] + 1)):
                    r = rng.uniform(*radius_range)
                    cx, cy, cz = (rng.randint(2, max(s - 2, 3)) for s in shape)
                    # ellipsoid, z squashed 2x (anisotropic spacing)
                    ball = ((X - cx) ** 2 + (Y - cy) ** 2 + ((Z - cz) * 2.0) ** 2) < r * r
                    mask |= ball.astype(np.uint8)
                # make the tumor visible in both modalities. The cast matters:
                # uint8 * python-float promotes to float64, which silently made
                # every fixture volume 8 bytes/voxel — 2x the production dtype
                # on disk AND a deflate worst case (zero-interleaved doubles
                # compressed ~60x slower at gzip-9: 10s vs 0.16s per volume)
                ct = ct + mask.astype(np.float32) * np.float32(lesion_contrast[0])
                pt = pt + mask.astype(np.float32) * np.float32(lesion_contrast[1])

                sh = (domain_shift or {}).get(center)
                if sh:
                    amp = float(sh.get("bias_field", 0.0))
                    if amp:
                        # smooth multiplicative field: product of random-phase
                        # cosines per axis (spatially varying, so it is NOT
                        # removed by per-channel z-score normalization)
                        fx, fy, fz = (rng.uniform(0.5, 1.5) for _ in range(3))
                        px, py, pz = (rng.uniform(0, 2 * np.pi) for _ in range(3))
                        field = 1.0 + amp * (
                            np.cos(2 * np.pi * fx * X / shape[0] + px)
                            * np.cos(2 * np.pi * fy * Y / shape[1] + py)
                            * np.cos(2 * np.pi * fz * Z / shape[2] + pz)
                        ).astype(np.float32)
                        ct = ct * field
                        pt = pt * field
                    ct = ct * float(sh.get("ct_gain", 1.0)) + float(sh.get("ct_bias", 0.0))
                    gamma = float(sh.get("pt_gamma", 1.0))
                    if gamma != 1.0:
                        pt = np.power(np.maximum(pt, 0.0) / 15.0, gamma) * 15.0
                    pt = pt * float(sh.get("pt_gain", 1.0))
                    noise = float(sh.get("noise", 0.0))
                    if noise:
                        ct = ct + rng.randn(*shape).astype(np.float32) * noise

                ct_p = os.path.join(img_dir, f"{pid}_ct.nii.gz")
                pt_p = os.path.join(img_dir, f"{pid}_pt.nii.gz")
                gt_p = os.path.join(lab_dir, f"{pid}_gtvt.nii.gz")
                writes += [pool.submit(nifti.save, v, affine, path)
                           for v, path in ((ct, ct_p), (pt, pt_p), (mask, gt_p))]
                if len(writes) > 6 * workers:  # a bounded queue of volumes in memory
                    writes.pop(0).result()
                rows.append(
                    {
                        "patient_id": pid,
                        "center_code": center,
                        "center_id": list(centers).index(center),
                        "domain": "source",
                        "split": "train",
                        "status": "ok",
                        "ct_proc": ct_p,
                        "pt_proc": pt_p,
                        "gtvt_proc": gt_p,
                    }
                )

        for w in writes:
            w.result()
    manifest = os.path.join(root, "manifest.csv")
    _write_rows(manifest, rows)
    return manifest


def make_brats_fixture(
    root: str,
    *,
    sources: Optional[Dict[str, Dict]] = None,
    shape: Tuple[int, int, int] = (10, 12, 10),  # (X,Y,Z)
    seed: int = 1,
    n_lesions: Optional[Tuple[int, int]] = None,
    radius_range: Tuple[float, float] = (6.0, 14.0),
) -> Dict[str, str]:
    """Create synthetic BraTS per-source trees + processed.csv files.

    Returns {source_name: csv_path}. Label values follow the per-profile
    taxonomies (gli/ssa: 1..3, ped: 1..4).

    Default labels are uniform-random voxels (cheap shape/split fixture —
    NOT learnable). Pass ``n_lesions`` to generate STRUCTURED tumors instead:
    nested ellipsoid shells carrying the profile's raw ids with
    modality-dependent contrast (t1c lights up enhancing tumor, t2f edema,
    ...), so segmentation is learnable — the BraTS analogue of the HECKTOR
    lesion fixture, used by the TTA validation.
    """
    sources = sources or {
        "glipre": {"profile": "gli", "cases": {"train": 3, "test": 2}},
        "ssa": {"profile": "ssa", "cases": {"train": 2}},
        "ped": {"profile": "ped", "cases": {"train": 2}},
    }
    rng = np.random.RandomState(seed)
    mods = ["t1n", "t1c", "t2w", "t2f"]
    affine = np.eye(4)
    # structured mode: per-modality intensity bump for each raw label id —
    # every region is separable from some modality combination
    contrast = {
        "t1n": {1: 1.5, 2: 0.5, 3: 1.0, 4: 0.8},
        "t1c": {1: 0.5, 2: 0.5, 3: 3.0, 4: 1.0},
        "t2w": {1: 1.0, 2: 2.0, 3: 0.5, 4: 1.5},
        "t2f": {1: 0.5, 2: 3.0, 3: 0.5, 4: 2.0},
    }
    grids = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij") if n_lesions else None

    def structured_label(max_label: int) -> np.ndarray:
        """Nested ellipsoid shells, innermost shell = the profile's
        enhancing-tumor id (gli/ssa: 3; ped: 1), outer shells the rest."""
        shell_ids = [3, 1, 2] if max_label == 3 else [1, 2, 3, 4]
        fracs = np.linspace(0.45, 1.0, len(shell_ids))
        lab = np.zeros(shape, np.uint8)
        X, Y, Z = grids
        for _ in range(rng.randint(n_lesions[0], n_lesions[1] + 1)):
            r = rng.uniform(*radius_range)
            cx, cy, cz = (rng.randint(3, max(s - 3, 4)) for s in shape)
            d2 = (X - cx) ** 2 + (Y - cy) ** 2 + (Z - cz) ** 2
            for sid, f in zip(reversed(shell_ids), reversed(fracs)):
                lab[d2 < (r * f) ** 2] = sid
        return lab

    out = {}
    for sname, spec in sources.items():
        sdir = os.path.join(root, sname)
        os.makedirs(sdir, exist_ok=True)
        max_label = 4 if spec["profile"] == "ped" else 3
        rows = []
        idx = 0
        for split, n in spec["cases"].items():
            for _ in range(n):
                case = f"{sname}_{idx:03d}"
                idx += 1
                if n_lesions:
                    lab = structured_label(max_label).astype(np.int16)
                else:
                    lab = rng.randint(0, max_label + 1, size=shape).astype(np.int16)
                lab_p = os.path.join(sdir, f"{case}_seg.nii.gz")
                nifti.save(lab.astype(np.uint8), affine, lab_p)
                for m in mods:
                    img = rng.randn(*shape).astype(np.float32)
                    if n_lesions:
                        for sid, amp in contrast[m].items():
                            img = img + amp * (lab == sid).astype(np.float32)
                    img_p = os.path.join(sdir, f"{case}_{m}.nii.gz")
                    nifti.save(img, affine, img_p)
                    rows.append(
                        {
                            "subject_id": case,
                            "modality": m,
                            "img_path": img_p,
                            "label_path": lab_p,
                            "split": split,
                        }
                    )
        csv_path = os.path.join(sdir, "processed.csv")
        _write_rows(csv_path, rows)
        out[sname] = csv_path
    return out


# the structured fixture's per-modality intensity bump of each raw label id
# (gli/ssa ids: 1 necrosis, 2 edema, 3 enhancing tumour), and the gli
# profile's regions (data/brats.py DEFAULT_REGION_MAPS) in ET, TC, WT order
_BRATS_CONTRAST = {"t1n": {1: 1.5, 2: 0.5, 3: 1.0}, "t1c": {1: 0.5, 2: 0.5, 3: 3.0},
                   "t2w": {1: 1.0, 2: 2.0, 3: 0.5}, "t2f": {1: 0.5, 2: 3.0, 3: 0.5}}
_GLI_REGIONS = ((3,), (1, 3), (1, 2, 3))


def brats_volumes(n: int, shape: Tuple[int, int, int] = (160, 192, 160), seed: int = 0,
                  domains: Tuple[str, ...] = ("brats24_glipre",)) -> List[Dict]:
    """``n`` in-memory BraTS samples as the BraTS builder yields them:
    ``image`` [D,H,W,4] f32 (t1n, t1c, t2w, t2f), ``label`` [D,H,W,3] f32
    region masks (ET, TC, WT) and ``domain`` (cycling through ``domains``).

    Each holds one tumour of nested ellipsoid shells (enhancing core,
    necrosis, edema) with the structured fixture's modality contrast over
    N(0, 1) noise, so the regions are learnable."""
    rng = np.random.default_rng(seed)
    grids = np.ogrid[tuple(slice(0, s) for s in shape)]
    out = []
    for i in range(n):
        centre = [rng.uniform(0.3 * s, 0.7 * s) for s in shape]
        radii = [rng.uniform(0.08 * s, 0.16 * s) for s in shape]
        d2 = sum(((g - c) / r) ** 2 for g, c, r in zip(grids, centre, radii))
        raw = np.zeros(shape, np.uint8)
        for sid, frac in ((2, 1.0), (1, 0.7), (3, 0.45)):  # edema, necrosis, enhancing core
            raw[d2 < frac ** 2] = sid
        image = np.empty(shape + (4,), np.float32)
        for m, bumps in enumerate(_BRATS_CONTRAST.values()):
            image[..., m] = rng.standard_normal(shape, dtype=np.float32)
            for sid, amp in bumps.items():
                image[..., m] += np.float32(amp) * (raw == sid)
        label = np.stack([np.isin(raw, ids) for ids in _GLI_REGIONS], axis=-1).astype(np.float32)
        out.append({"image": image, "label": label, "domain": domains[i % len(domains)]})
    return out
