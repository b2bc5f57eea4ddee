"""Serving runtime: an artifact and NIfTI volumes in, masks out (the port of
``scripts/serve_artifact.py``).

``cli/export_serving.py`` writes the artifact (model, TTA step and initial
state; no model code needed to load it); this is the loop a deployment runs
against it:

    python -m multimodal_tta_tpu_torch.cli.serve_artifact --artifact unet_tent.mttap \
        --manifest /data/manifest.csv --channels ct pt --out preds/

Per batch it decodes the channel NIfTIs (``data/nifti.py``, the native
decode where built), calls the artifact, threads the continual-TTA state
forward (or feeds the initial state again for an episodic artifact), and
writes each case's mask back into its source grid (geometry from the
header alone) plus a ``predictions.csv`` provenance manifest in the
preprocessing pipeline's error-capture style, flushed after every batch.
A case that fails to decode gets an error row and a zero volume; the tail
batch is zero-padded. Both artifact modes: ``adapt`` (the step's uint8
predictions and its entropy trace) and ``forward`` (probabilities,
thresholded here). The device dispatch of every batch runs under a
``DispatchWatchdog``. The runtime imports the data and serving layers only:
no ``models/``, no config composer, no checkpoint code.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import DeviceLike


def _image_spec(meta: dict):
    """(batch, spatial..., channels) of the artifact's image argument."""
    for a in meta.get("args", []):
        if a.get("name") == "image":
            return tuple(int(s) for s in a["shape"])
    raise ValueError("artifact meta has no 'image' argument spec")


def _decode_case(row: dict, channels, expect_dhwc):
    """Stack the case's channel volumes into [D,H,W,C] float32."""
    from ..data.nifti import load_canonical_dhw

    vols = [load_canonical_dhw(row[c]) for c in channels]
    img = np.stack(vols, axis=-1).astype(np.float32)
    if tuple(img.shape) != tuple(expect_dhwc):
        raise ValueError(
            f"case '{row.get('case_id', '?')}' decoded to {img.shape}, "
            f"artifact expects {tuple(expect_dhwc)} — preprocess to the "
            f"exported shape first"
        )
    return img


def _write_manifest(out_dir: str, rows) -> str:
    """(Re)write predictions.csv atomically from the rows so far."""
    manifest_out = os.path.join(out_dir, "predictions.csv")
    if not rows:
        return manifest_out
    keys = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    tmp = manifest_out + ".tmp"
    with open(tmp, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
    os.replace(tmp, manifest_out)
    return manifest_out


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = "cuda") -> List[Dict]:
    """Serve; returns the ``predictions.csv`` rows."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifact", required=True, help="artifact file (cli/export_serving.py)")
    ap.add_argument("--manifest", required=True,
                    help="CSV with case_id + one path column per channel")
    ap.add_argument("--channels", nargs="+", default=["ct", "pt"],
                    help="manifest column names holding the channel NIfTI "
                         "paths, in the model's channel order")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--regions", nargs="*", default=None,
                    help="region names for the prediction channels "
                         "(default: 'pred' / 'r<i>')")
    ap.add_argument("--threshold", type=float, default=0.5,
                    help="probability threshold (forward-mode artifacts "
                         "only; adapt artifacts bake theirs in at export)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generator that makes the step's random numbers")
    ap.add_argument("--limit", type=int, default=None, help="serve first N cases")
    ap.add_argument(
        "--dispatch-deadline", type=float, default=300.0,
        help="seconds a single batch's device dispatch may take before the "
             "serving loop declares the card hung and exits with a diagnosis "
             "(0 disables). Host-side decode does not count (the clock "
             "resets after decode); the first batch gets "
             "--first-dispatch-deadline to cover loading and kernel builds",
    )
    ap.add_argument(
        "--first-dispatch-deadline", type=float, default=None,
        help="deadline for the first batch's dispatch (includes one-time "
             "kernel builds); default 3x --dispatch-deadline",
    )
    args = ap.parse_args(argv)

    import torch

    from .. import resolve_device
    from ..data.nifti import peek_canonical_geometry, save as nifti_save
    from ..serving import load_artifact
    from ..utils.logger import setup_logger
    from ..utils.watchdog import DispatchWatchdog

    dev = resolve_device(device)
    os.makedirs(args.out, exist_ok=True)
    logger = setup_logger(log_file=os.path.join(args.out, "serve.log"))

    art = load_artifact(args.artifact, device=dev)
    mode = art.meta.get("mode", "adapt")
    spec = _image_spec(art.meta)
    batch, dhw, n_ch = spec[0], spec[1:-1], spec[-1]
    if n_ch != len(args.channels):
        raise ValueError(
            f"artifact expects {n_ch} channels, --channels names {len(args.channels)}"
        )
    logger.info(
        f"[serve] {args.artifact}: mode={mode}, image={list(spec)}, "
        f"n_state={art.n_state}, device={art.meta.get('device')}"
    )

    with open(args.manifest, newline="", encoding="utf-8") as f:
        cases = list(csv.DictReader(f))
    if args.limit:
        cases = cases[: args.limit]
    missing = [c for c in args.channels if cases and c not in cases[0]]
    if missing:
        raise ValueError(f"manifest lacks channel columns {missing}")

    episodic = bool(art.meta.get("episodic", False))
    state = art.initial_state()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    floor = float("nan")

    rows, n_written = [], 0
    # a hung dispatch never raises: the watchdog diagnoses and exits, and
    # progress is any completed batch (utils/watchdog.py)
    first_deadline = (
        args.first_dispatch_deadline
        if args.first_dispatch_deadline is not None
        else (args.dispatch_deadline * 3.0 if args.dispatch_deadline else 0.0)
    )
    with DispatchWatchdog(
        args.dispatch_deadline,
        what="serving batch dispatch (serve_artifact)",
        first_deadline_s=first_deadline,
    ) as watchdog:
        for start in range(0, len(cases), batch):
            chunk = cases[start : start + batch]
            n_valid = len(chunk)
            imgs, geoms = [], []
            for row in chunk:
                try:
                    imgs.append(_decode_case(row, args.channels, (*dhw, n_ch)))
                    geoms.append(peek_canonical_geometry(row[args.channels[0]]) + ("ok",))
                except Exception as e:  # error-capture row, keep serving
                    imgs.append(np.zeros((*dhw, n_ch), np.float32))
                    geoms.append((np.eye(4), tuple(reversed(dhw)), f"error:{type(e).__name__}:{e}"))
            while len(imgs) < batch:  # zero-pad the tail batch
                imgs.append(np.zeros((*dhw, n_ch), np.float32))
            # host decode done: only the device dispatch below counts against
            # the deadline (touch keeps the first batch's longer allowance)
            watchdog.touch()
            image = torch.from_numpy(np.stack(imgs)).to(dev)

            if mode == "adapt":
                step_state = art.initial_state() if episodic else state
                out = art.call(*step_state, image, *art.draws(gen, n_valid), n_valid, floor)
                state = list(out[: art.n_state])
                ent_final = float(out[art.n_state][-1])
                pred = out[art.n_state + 1][:n_valid].cpu().numpy()
            else:
                prob = art.call(image)[:n_valid].cpu().numpy()
                pred = (prob >= args.threshold).astype(np.uint8)
                ent_final = None

            n_regions = pred.shape[-1]
            regions = args.regions or (
                ["pred"] if n_regions == 1 else [f"r{i}" for i in range(n_regions)]
            )
            if len(regions) != n_regions:
                raise ValueError(
                    f"--regions names {len(regions)} channels, prediction has {n_regions}"
                )
            for i, row in enumerate(chunk):
                affine, shape_xyz, status = geoms[i]
                d, h, w = (int(s) for s in dhw)
                if status == "ok" and tuple(shape_xyz) != (w, h, d):
                    status = f"geometry_mismatch:source_xyz={tuple(shape_xyz)}"
                    affine = np.eye(4)
                case_id = row.get("case_id") or row.get("patient_id") or f"case{start + i}"
                out_row = {"case_id": case_id, "status": status}
                if ent_final is not None:
                    out_row["entropy_final"] = round(ent_final, 6)
                pred_xyzr = np.transpose(pred[i], (2, 1, 0, 3)).astype(np.uint8)
                files = []
                for r, name in enumerate(regions):
                    suffix = "pred" if n_regions == 1 else f"{name.lower()}_pred"
                    path = os.path.join(args.out, f"{case_id}_{suffix}.nii.gz")
                    nifti_save(pred_xyzr[..., r], affine, path, dtype=np.uint8)
                    files.append(os.path.basename(path))
                    out_row[f"voxels_{name.lower()}"] = int(pred_xyzr[..., r].sum())
                out_row["files"] = ";".join(files)
                rows.append(out_row)
                n_written += 1
            logger.info(
                f"[serve] batch {start // batch}: {n_valid} cases"
                + (f", entropy {ent_final:.4f}" if ent_final is not None else "")
            )
            watchdog.heartbeat()  # a completed batch is forward progress
            # the manifest after EVERY batch: if a later batch hangs and the
            # watchdog exits the process, the completed rows are on disk
            _write_manifest(args.out, rows)

    logger.info(f"[serve] wrote {n_written} cases -> {args.out}")
    print(json.dumps({"cases": n_written, "out": args.out, "mode": mode, "batch": batch}))
    return rows


if __name__ == "__main__":
    main()
