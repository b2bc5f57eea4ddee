"""Prediction export — write (adapted) segmentations back to NIfTI (the port
of ``multimodal_tta_tpu/evaluation/export.py``).

The reference computes metrics but never materializes its predictions
(reference: src/evaluation/seg_eval.py:239-399 — the masks die on device);
a deployment needs the segmentations themselves. This exporter runs the
SAME forward the evaluator scores (`SegmentationEvaluationStrategy._probs_fn`
is the single source of truth: transfer-dtype upcast, on-device
normalization, sliding-window and flip-TTA options, threshold), optionally
behind a per-batch TTA hook, and writes each case's mask back into its
source grid:

  - geometry comes header-only from the case's on-disk volume
    (``dataset.source_geometry(idx)`` -> canonical RAS+ affine + shape), so
    the written files overlay the inputs voxel-for-voxel in any viewer;
  - the (D,H,W)=(Z,Y,X) device layout is transposed back to the (X,Y,Z)
    NIfTI convention;
  - one uint8 mask per region channel (``<case>_pred.nii.gz`` when there is
    a single region, ``<case>_<region>_pred.nii.gz`` otherwise), optional
    float32 probability volumes;
  - a ``predictions.csv`` manifest with per-case provenance and a status
    column in the preprocessing pipeline's error-capture style (reference:
    scripts/prepare_hecktor21.py:681-694).

On the GPU each batch runs ``_probs_fn``, the threshold and (when asked)
the probability and the uncertainty map under ``torch.no_grad()``; what
the host writes crosses in ONE device-to-host copy per batch. Progress goes
to the logger, one line per batch.

Over ranks (``mesh``, ``parallel/mesh.py``) each rank adapts and predicts
its rows of every batch and writes its own cases (gzip-9 writes set an
export's pace); the ranks of a model, expert or stage group hold the same
rows and only the first of them writes (``Mesh.replica_lead``). Over a
space axis each rank computes on its depth slab, the probabilities (and
the uncertainty map) are gathered over the space group, and the group's
first rank writes the cases. The rows of ``predictions.csv`` are gathered
and rank 0 writes them in the order one process writes them: the files and
the manifest are those of one process.
"""

from __future__ import annotations

import csv
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .. import DeviceLike, resolve_device
from ..parallel import space as sp
from ..utils.logger import get_logger
from .seg_eval import as_list_str


class PredictionExporter:
    """Runs inference (optionally TTA-adapted) and writes NIfTI predictions."""

    def __init__(
        self,
        strategy,
        out_dir: str,
        *,
        save_prob: bool = False,
        save_uncertainty: bool = False,
        logger=None,
    ):
        self.strategy = strategy
        self.out_dir = str(out_dir)
        self.save_prob = bool(save_prob)
        # mirror-ensemble disagreement maps (per-voxel std of the un-flipped
        # view probabilities — ops/flip_tta.py); requires evaluation.flip_tta
        self.save_uncertainty = bool(save_uncertainty)
        self.logger = logger or get_logger()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _step(self, state: nn.Module, image: torch.Tensor, mesh=None) -> Dict[str, np.ndarray]:
        """One batch on the device -> host arrays ``pred`` (uint8) and, when
        asked, ``prob`` and ``uncert`` (f32), in one device-to-host copy.
        Over a space axis of ``mesh`` ``image`` is this rank's depth slab and
        the arrays are the whole volumes'."""
        space = sp.axis_of(mesh)
        with sp.sharded(mesh):
            out = self.strategy._probs_fn(state, with_variance=self.save_uncertainty, space=space)(image)
        prob, var = out[1], (out[2] if self.save_uncertainty else None)
        if space is not None:
            prob = sp.all_gather_cat(prob, 1, space.size, space.group)
            if var is not None:
                var = sp.all_gather_cat(var, 1, space.size, space.group)
        pred = (prob >= self.strategy.threshold).to(torch.uint8)
        if not (self.save_prob or self.save_uncertainty):
            return {"pred": pred.cpu().numpy()}
        fields = {"pred": pred.to(torch.float32)}
        if self.save_prob:
            fields["prob"] = prob.to(torch.float32)
        if self.save_uncertainty:
            fields["uncert"] = torch.sqrt(var).to(torch.float32)
        host = dict(zip(fields, torch.stack(list(fields.values())).cpu().numpy()))
        host["pred"] = host["pred"].astype(np.uint8)
        return host

    # ------------------------------------------------------------------
    def _case_geometry(self, dataset, index: int, dhw_shape):
        """Returns (affine, status). Falls back to identity when the dataset
        cannot provide source geometry (e.g. synthetic arrays)."""
        if dataset is None or not hasattr(dataset, "source_geometry"):
            return np.eye(4), "no_geometry:identity_affine"
        try:
            affine, shape_xyz = dataset.source_geometry(int(index))
        except Exception as e:  # missing file, unreadable header
            return np.eye(4), f"geometry_error:{type(e).__name__}"
        d, h, w = (int(s) for s in dhw_shape)
        if tuple(shape_xyz) != (w, h, d):
            return np.eye(4), (
                f"geometry_mismatch:source_xyz={tuple(shape_xyz)}_pred_xyz={(w, h, d)}"
            )
        return affine, "ok"

    def _write_case(
        self,
        case_id: str,
        domain: str,
        pred_dhwr: np.ndarray,
        prob_dhwr: Optional[np.ndarray],
        affine: np.ndarray,
        status: str,
        uncert_dhwr: Optional[np.ndarray] = None,
    ) -> Dict[str, Any]:
        from ..data import nifti

        regions = self.strategy.region_order
        # device layout (D,H,W,R)=(Z,Y,X,R) -> NIfTI (X,Y,Z,R)
        pred_xyzr = np.transpose(pred_dhwr, (2, 1, 0, 3)).astype(np.uint8)
        row: Dict[str, Any] = {"case_id": case_id, "domain": domain, "status": status}
        files: List[str] = []
        for r, name in enumerate(regions):
            suffix = "pred" if len(regions) == 1 else f"{name.lower()}_pred"
            path = os.path.join(self.out_dir, f"{case_id}_{suffix}.nii.gz")
            nifti.save(pred_xyzr[..., r], affine, path, dtype=np.uint8)
            files.append(path)
            row[f"voxels_{name.lower()}"] = int(pred_xyzr[..., r].sum())
        row["files"] = ";".join(os.path.basename(p) for p in files)
        if prob_dhwr is not None:
            prob_xyzr = np.transpose(prob_dhwr, (2, 1, 0, 3)).astype(np.float32)
            path = os.path.join(self.out_dir, f"{case_id}_prob.nii.gz")
            arr = prob_xyzr[..., 0] if prob_xyzr.shape[-1] == 1 else prob_xyzr
            nifti.save(arr, affine, path, dtype=np.float32)
            row["prob_file"] = os.path.basename(path)
        if uncert_dhwr is not None:
            unc_xyzr = np.transpose(uncert_dhwr, (2, 1, 0, 3)).astype(np.float32)
            path = os.path.join(self.out_dir, f"{case_id}_uncert.nii.gz")
            arr = unc_xyzr[..., 0] if unc_xyzr.shape[-1] == 1 else unc_xyzr
            nifti.save(arr, affine, path, dtype=np.float32)
            row["uncert_file"] = os.path.basename(path)
            # a scalar triage signal per case: mean in-mask disagreement
            # (uncertain PREDICTIONS rank for human review first)
            m = pred_dhwr.astype(bool)
            row["mean_uncert_in_pred"] = float(uncert_dhwr[m].mean()) if m.any() else 0.0
        return row

    # ------------------------------------------------------------------
    def run(
        self,
        state: nn.Module,
        data_loader,
        adapt_fn=None,
        carry_state: bool = False,
        device: DeviceLike = "cuda",
        mesh=None,
    ) -> List[Dict[str, Any]]:
        """Export predictions for every case in the loader.

        ``adapt_fn``/``carry_state`` follow evaluate_epoch's TTA hook
        contract (adapt before predict; carry = continual; over ranks
        ``adapt_fn`` gets this rank's rows and the global valid count).
        Returns the manifest rows (also written to
        ``<out_dir>/predictions.csv``), all of them on every rank.
        """
        dev = resolve_device(device)
        mesh = mesh if mesh is not None and mesh.parallel else None
        writes = mesh is None or mesh.replica_lead
        if writes:
            os.makedirs(self.out_dir, exist_ok=True)
        dataset = getattr(data_loader, "dataset", None)

        from ..data.prefetch import prefetch_to_device

        stream = prefetch_to_device(
            data_loader,
            dev,
            array_keys=("image",),
            image_transfer_dtype=self.strategy._transfer_dtype,
            mesh=mesh,
        )
        n_batches = len(data_loader) if hasattr(data_loader, "__len__") else "?"

        # each case's files are written on a thread while the next batch runs
        # (gzip level 9 of a mask takes seconds and releases the GIL)
        written: List[List[Future]] = []  # this rank's rows of each batch, as they are written
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
            for b, batch in enumerate(stream):
                image = batch["image"]
                B = int(batch["_n_valid"])
                case_ids = as_list_str(batch.get("case_id"), B)
                domains = as_list_str(batch.get("domain"), B)
                indices = np.asarray(batch.get("index", np.arange(B))).reshape(-1)
                first, n_here = 0, B  # this rank's first row of the global batch and its valid rows
                if mesh is not None:
                    first, n_here = mesh.rows(image.shape[0] * mesh.data).start, int(batch["_n_local"])

                eval_state = state
                if adapt_fn is not None:
                    eval_state = adapt_fn(state, image, B)
                    if carry_state:
                        state = eval_state

                out = self._step(eval_state, image, mesh)
                pred = out["pred"][:n_here]
                prob = out["prob"][:n_here] if self.save_prob else None
                uncert = out["uncert"][:n_here] if self.save_uncertainty else None

                rows_b: List[Future] = []
                for i in range(n_here if writes else 0):
                    c = first + i
                    affine, status = self._case_geometry(
                        dataset, int(indices[c]), pred.shape[1:4]
                    )
                    if status != "ok":
                        self.logger.warning(
                            f"[export] case '{case_ids[c]}': {status} — writing "
                            f"with identity affine"
                        )
                    rows_b.append(pool.submit(
                        self._write_case,
                        case_ids[c],
                        domains[c],
                        pred[i],
                        prob[i] if prob is not None else None,
                        affine,
                        status,
                        uncert_dhwr=uncert[i] if uncert is not None else None,
                    ))
                written.append(rows_b)
                self.logger.info(f"[export] batch {b + 1}/{n_batches}: {B} cases")

        batch_rows = [[f.result() for f in rows_b] for rows_b in written]
        rows = self._merge_rows(batch_rows, mesh)
        manifest = os.path.join(self.out_dir, "predictions.csv")
        if rows and (mesh is None or dist.get_rank() == 0):
            keys: List[str] = []
            for r in rows:
                for k in r:
                    if k not in keys:
                        keys.append(k)
            with open(manifest, "w", newline="", encoding="utf-8") as f:
                writer = csv.DictWriter(f, fieldnames=keys)
                writer.writeheader()
                writer.writerows(rows)
        self.logger.info(f"[export] {len(rows)} cases -> {self.out_dir}")
        return rows

    @staticmethod
    def _merge_rows(batch_rows: List[List[Dict[str, Any]]], mesh) -> List[Dict[str, Any]]:
        """Every rank's manifest rows in one process's order: batch by
        batch, the writing ranks' rows in rank order (= data rank order)."""
        if mesh is None:
            return [r for rows_b in batch_rows for r in rows_b]
        every: List[Any] = [None] * dist.get_world_size()
        dist.all_gather_object(every, batch_rows)
        return [r for b in range(len(batch_rows)) for ranks_rows in every for r in ranks_rows[b]]
