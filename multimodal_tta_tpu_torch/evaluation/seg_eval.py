"""Segmentation evaluation strategy ("seg_eval"), the port of
``multimodal_tta_tpu/evaluation/seg_eval.py``.

BraTS-style region evaluation with the reference's flat metric-dict key
schema — ``{region}_dc``, ``avg_dc``, ``miou``, ``jc``, ``loss``, optional
``{region}_hd95``/``{region}_asd``/``{region}_nsd`` (+averages), and
per-domain variants under ``dom/<domain>/...`` — so downstream log parsing
is unchanged.

One eval step per batch runs under ``torch.no_grad()`` on the device:
forward, sigmoid -> threshold -> per-sample/per-region dice/iou with
empty-GT gating, the optional DiceCE loss per sample, and (when enabled)
HD95/ASD/NSD through the on-device euclidean distance transform. Only
``[B,R]`` metric tensors leave the device, packed into one copy per batch;
the accumulators are numpy float64 on the host, as in the reference.

Where the reference threads a functional ``TrainState``, the ``state`` here
is the port's ``nn.Module``; a per-batch ``adapt_fn`` adapts it in place.

Over ranks (``mesh``): each rank scores its rows of the padded global
batch (its own surfaces through the min-plus kernel), and the packed
per-sample metrics are gathered, so every rank accumulates the global
batch's values in the same order and returns the metrics one process
returns. Over a space axis each rank runs the forward on its depth slab
(``parallel/space.py``), the probabilities (the logits too, for the loss)
and labels are gathered over the space group, and every space rank scores
the same whole volumes (the same metrics, computed once per space rank);
the data group gathers the rows. Flip TTA mirrors the depth over the group
(``space.flip_depth``); sliding-window inference lays its grid on the whole
volume and runs each window split, or whole where its depth does not split
(``ops/sliding_window.py``).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import DeviceLike, resolve_device
from ..conf.node import ConfigNode
from ..data.prefetch import TRANSFER_DTYPES, prefetch_to_device
from ..ops.losses import make_criterion
from ..ops.seg_metrics import binary_dice_iou
from ..parallel import space as sp
from ..registry import register_evaluation_strategy
from ..utils.config import get_config
from ..utils.logger import get_logger


def as_list_str(x: Any, batch_size: int) -> List[str]:
    """Normalize a batch 'domain' field to List[str] of length B."""
    if x is None:
        return [""] * batch_size
    if isinstance(x, (list, tuple)):
        return [str(v) for v in x]
    if isinstance(x, str):
        return [x] * batch_size
    if isinstance(x, np.ndarray):
        if x.ndim == 0:
            return [str(x.item())] * batch_size
        if x.size == batch_size:
            return [str(int(v)) for v in x.reshape(-1)]
    return [str(x)] * batch_size


def diag_mm_from_shape(d: int, h: int, w: int, spacing: Tuple[float, float, float]) -> float:
    """Volume-diagonal upper bound in mm."""
    sd, sh, sw = spacing
    dd = max(d - 1, 0) * sd
    hh = max(h - 1, 0) * sh
    ww = max(w - 1, 0) * sw
    return float(math.sqrt(dd * dd + hh * hh + ww * ww))


class _Accum:
    """Per-region sum/count accumulator (overall + per-domain)."""

    def __init__(self, n_regions: int):
        self.r = n_regions
        self.sum = np.zeros(n_regions, np.float64)
        self.cnt = np.zeros(n_regions, np.float64)

    def add(self, values: np.ndarray, valid: np.ndarray) -> None:
        """values/valid: [B, R]."""
        v = np.where(valid, values, 0.0)
        self.sum += v.sum(axis=0)
        self.cnt += valid.astype(np.float64).sum(axis=0)

    def means(self) -> List[float]:
        return [float(self.sum[c] / self.cnt[c]) if self.cnt[c] > 0 else 0.0 for c in range(self.r)]

    def valid_mean(self) -> float:
        means = self.means()
        valid_idx = [i for i in range(self.r) if self.cnt[i] > 0]
        return float(sum(means[i] for i in valid_idx) / max(1, len(valid_idx)))


@register_evaluation_strategy("seg_eval")
class SegmentationEvaluationStrategy:
    def __init__(self, config: Optional[ConfigNode] = None):
        self.config = config or ConfigNode()
        self.logger = get_logger()

        seg_cfg = get_config(self.config, "evaluation.seg", ConfigNode())
        self.threshold = float(get_config(seg_cfg, "threshold", 0.5))
        self.region_order = [str(r) for r in get_config(seg_cfg, "region_order", ["ET", "TC", "WT"])]

        spacing = list(get_config(seg_cfg, "spacing", [1.0, 1.0, 1.0]))
        if len(spacing) != 3:
            raise ValueError(f"[SegEval] evaluation.seg.spacing must have length 3, got {spacing}")
        self.spacing = (float(spacing[0]), float(spacing[1]), float(spacing[2]))

        self.report_loss = bool(get_config(self.config, "evaluation.loss.report_loss", False))

        surf_cfg = get_config(self.config, "evaluation.surface", ConfigNode())
        self.enable_surface = bool(get_config(surf_cfg, "enable", False))
        self.asd_symmetric = bool(get_config(surf_cfg, "asd_symmetric", False))
        # Normalized Surface Dice at tolerance (mm): scalar, or per-region
        # list matching region_order. None disables the metric (default).
        nsd_tol = get_config(surf_cfg, "nsd_tol", None)
        if nsd_tol is None:
            self.nsd_tol = None
        elif isinstance(nsd_tol, (list, tuple)):
            if len(nsd_tol) != len(self.region_order):
                raise ValueError(
                    f"[SegEval] evaluation.surface.nsd_tol list must match "
                    f"region_order length {len(self.region_order)}, got {list(nsd_tol)}"
                )
            self.nsd_tol = [float(t) for t in nsd_tol]
        else:
            self.nsd_tol = float(nsd_tol)

        # When transforms defer normalization to the device
        # (training.data.transforms.on_device), the eval forward must apply it
        # too — the datasets then emit RAW intensities.
        tcfg = get_config(self.config, "training.data.transforms", ConfigNode())
        self._norm_fn = None
        if bool(get_config(tcfg, "on_device", False)) and bool(get_config(tcfg, "normalize", False)):
            from ..ops.intensity import make_intensity_normalizer

            channel_names = get_config(self.config, "dataset.modality_order", None)
            self._norm_fn = make_intensity_normalizer(
                normalize=True,
                intensity_policy=get_config(tcfg, "intensity_policy", None),
                channel_names=[str(c) for c in channel_names] if channel_names else None,
                mean=get_config(tcfg, "mean", None),
                std=get_config(tcfg, "std", None),
            )

        # Optional sliding-window inference (for volumes larger than the
        # card's memory allows whole). Whole-volume forward when disabled.
        sw_cfg = get_config(self.config, "evaluation.sliding_window", ConfigNode())
        self.sw_enable = bool(get_config(sw_cfg, "enable", False))
        self.sw_roi = tuple(int(x) for x in get_config(sw_cfg, "roi_size", [64, 64, 64]))
        self.sw_overlap = float(get_config(sw_cfg, "overlap", 0.25))
        self.sw_mode = str(get_config(sw_cfg, "mode", "gaussian"))

        # Flip-averaged test-time augmentation (ops/flip_tta.py): average
        # probabilities over every spatial mirror combination — 2^k forwards
        # per batch. NDHWC spatial axes are 1 (D), 2 (H), 3 (W).
        ft_cfg = get_config(self.config, "evaluation.flip_tta", ConfigNode())
        self.flip_enable = bool(get_config(ft_cfg, "enable", False))
        self.flip_axes = tuple(int(a) for a in get_config(ft_cfg, "axes", [1, 2, 3]))
        if self.flip_enable and not all(1 <= a <= 3 for a in self.flip_axes):
            raise ValueError(
                f"[SegEval] evaluation.flip_tta.axes must be spatial (1..3 "
                f"in NDHWC), got {list(self.flip_axes)}"
            )

        crit_cfg = get_config(self.config, "training.criterion", ConfigNode())
        # Eval loss mirrors training config but always sigmoid.
        eval_crit = ConfigNode(
            {
                "sigmoid": True,
                "softmax": False,
                "include_background": bool(get_config(crit_cfg, "include_background", True)),
                "squared_pred": bool(get_config(crit_cfg, "squared_pred", False)),
                "jaccard": bool(get_config(crit_cfg, "jaccard", False)),
                "lambda_dice": float(get_config(crit_cfg, "lambda_dice", 1.0)),
                "lambda_ce": float(get_config(crit_cfg, "lambda_ce", 1.0)),
            }
        )
        w = get_config(crit_cfg, "weight", None)
        if w is not None and len(list(w)) > 0:
            eval_crit["ce_weight"] = [float(x) for x in list(w)]
        self.loss_fn = make_criterion(eval_crit)

        td = str(get_config(self.config, "training.transfer_dtype", "float32")).lower()
        self._transfer_dtype = TRANSFER_DTYPES[td]

        # Optional best-model criterion (a trainer delegates to the
        # strategy's is_best_model). Unset -> min validation loss.
        self.best_metric = get_config(self.config, "evaluation.best_metric", None)
        self.best_mode = str(get_config(self.config, "evaluation.best_mode", "max")).lower()

    def is_best_model(self, eval_stats: Dict[str, float], best_metrics: Dict[str, float]) -> bool:
        if self.best_metric is None:
            current = eval_stats.get("loss", 0.0)
            return current < best_metrics.get("loss", float("inf"))
        name = str(self.best_metric)
        current = eval_stats.get(name)
        if current is None:
            return False
        if self.best_mode == "min":
            return current < best_metrics.get(name, float("inf"))
        return current > best_metrics.get(name, float("-inf"))

    # ------------------------------------------------------------------
    def _probs_fn(self, state: nn.Module, with_variance: bool = False, space=None):
        """Closure: raw device image -> (logits, prob).

        Single source of truth for the inference forward — upcast from the
        compact transfer dtype, on-device normalization, sliding-window and
        flip-TTA options — so that whoever exports masks exports exactly the
        masks the evaluator scores.

        ``with_variance=True`` (requires flip-TTA enabled) returns
        ``(logits, prob, var)`` with the mirror-ensemble disagreement map
        (ops/flip_tta.py). ``space``: the image is this rank's depth slab
        (its normalizer's statistics span the space group, its flips and
        windows are the whole volume's) and so are the results; call it
        inside ``space.sharded``.
        """
        if with_variance and not self.flip_enable:
            raise ValueError(
                "[SegEval] uncertainty maps need an ensemble: enable "
                "evaluation.flip_tta (the variance is computed over the "
                "mirror views)"
            )

        if self.sw_enable:
            from ..ops.sliding_window import sliding_window_inference

            def forward(x):
                return sliding_window_inference(
                    state, x, self.sw_roi, num_classes=len(self.region_order),
                    overlap=self.sw_overlap, mode=self.sw_mode, space=space,
                )

        else:
            forward = state

        def probs(image):
            image = image.to(torch.float32)  # upcast compact transfer dtypes
            if self._norm_fn is not None:
                image = self._norm_fn(image, space=space)
            if self.flip_enable:
                from ..ops.flip_tta import flip_averaged_probs

                return flip_averaged_probs(
                    forward, image, self.flip_axes, torch.sigmoid,
                    with_variance=with_variance, space=space,
                )
            logits = forward(image)
            return logits, torch.sigmoid(logits)

        return probs

    @torch.no_grad()
    def _eval_step(self, state: nn.Module, image: torch.Tensor, label: torch.Tensor,
                   mesh=None) -> Dict[str, torch.Tensor]:
        """One batch on the device -> ``[B,R]`` metric tensors (``loss``: [B]).
        Over a space axis of ``mesh`` the forward runs on the slabs and the
        whole volumes are scored."""
        label = label.to(torch.float32)
        space = sp.axis_of(mesh)
        with sp.sharded(mesh):
            logits, prob = self._probs_fn(state, space=space)(image)
        if space is not None:
            prob = sp.all_gather_cat(prob, 1, space.size, space.group)
            label = sp.all_gather_cat(label, 1, space.size, space.group)
            if self.report_loss:
                logits = sp.all_gather_cat(logits, 1, space.size, space.group)
        pred = (prob >= self.threshold).to(torch.float32)
        gt = (label > 0.5).to(torch.float32)

        dice, iou, valid = binary_dice_iou(pred, gt)
        b, r = pred.shape[0], pred.shape[-1]
        pred_empty = pred.reshape(b, -1, r).sum(dim=1) == 0

        out = {"dice": dice, "iou": iou, "valid": valid, "pred_empty": pred_empty}

        if self.report_loss:
            out["loss"] = torch.stack(
                [self.loss_fn(logits[i:i + 1], label[i:i + 1]) for i in range(b)]
            )  # [B]

        if self.enable_surface:
            from ..ops.surface import batched_surface_metrics

            res = batched_surface_metrics(
                pred,
                gt,
                spacing=self.spacing,
                symmetric_asd=self.asd_symmetric,
                nsd_tol=self.nsd_tol,
            )
            out["hd95"], out["asd"] = res[0], res[1]
            if self.nsd_tol is not None:
                out["nsd"] = res[2]

        return out

    @staticmethod
    def _to_host(out: Dict[str, torch.Tensor], mesh=None) -> Dict[str, np.ndarray]:
        """All of a step's ``[B,R]`` tensors in ONE device->host copy (over
        ranks, after one gather of the global batch's rows)."""
        b, r = out["dice"].shape
        keys = list(out)
        packed = torch.stack([
            (out[k][:, None].expand(b, r) if out[k].dim() == 1 else out[k]).to(torch.float32)
            for k in keys
        ], dim=1)  # [B, K, R]
        if mesh is not None:
            packed = mesh.gather_rows(packed)
        packed = packed.transpose(0, 1).cpu().numpy()
        host = dict(zip(keys, packed))
        for k in ("valid", "pred_empty"):
            host[k] = host[k] > 0.5
        if "loss" in host:
            host["loss"] = host["loss"][:, 0]
        return host

    # ------------------------------------------------------------------
    def evaluate_epoch(
        self,
        state: nn.Module,
        data_loader,
        adapt_fn=None,
        carry_state: bool = False,
        device: DeviceLike = "cuda",
        mesh=None,
    ) -> Dict[str, float]:
        """Evaluate (optionally with per-batch test-time adaptation).

        adapt_fn(state, image, n_valid) -> adapted state is invoked per batch
        BEFORE the eval step (the TTA hook point). With ``carry_state`` the
        adapted state flows into the next batch (continual TTA); otherwise
        each batch adapts from the source state (episodic) — the port's
        adapters reset the module they adapt in place themselves. Over ranks
        ``adapt_fn`` gets this rank's rows and the global valid count.
        """
        dev = resolve_device(device)
        mesh = mesh if mesh is not None and mesh.parallel else None
        space = sp.axis_of(mesh)
        for p in state.parameters():
            if p.device != dev:
                raise ValueError(f"[SegEval] model is on {p.device}, evaluation on {dev}")
        R = len(self.region_order)

        acc_dice, acc_iou = _Accum(R), _Accum(R)
        acc_hd95, acc_asd, acc_nsd = _Accum(R), _Accum(R), _Accum(R)
        dom_dice: Dict[str, _Accum] = defaultdict(lambda: _Accum(R))
        dom_iou: Dict[str, _Accum] = defaultdict(lambda: _Accum(R))
        dom_hd95: Dict[str, _Accum] = defaultdict(lambda: _Accum(R))
        dom_asd: Dict[str, _Accum] = defaultdict(lambda: _Accum(R))
        dom_nsd: Dict[str, _Accum] = defaultdict(lambda: _Accum(R))
        report_nsd = self.enable_surface and self.nsd_tol is not None

        total_loss = 0.0
        n_samples = 0

        # cast + pin + H2D ahead of the eval step
        stream = prefetch_to_device(
            data_loader,
            dev,
            image_transfer_dtype=self._transfer_dtype,
            label_transfer_dtype=torch.uint8,
            mesh=mesh,
        )

        for batch in stream:
            image = batch["image"]
            label = batch["label"]
            if label.dim() != image.dim():
                raise ValueError(f"[SegEval] label must be [B,...,R], got {tuple(label.shape)}")
            if int(label.shape[-1]) != R:
                raise ValueError(
                    f"[SegEval] label channels={label.shape[-1]} but region_order={R}"
                )
            B = int(batch["_n_valid"])
            domains = as_list_str(batch.get("domain"), B)

            eval_state = state
            if adapt_fn is not None:
                eval_state = adapt_fn(state, image, B)
                if carry_state:
                    state = eval_state

            out = self._to_host(self._eval_step(eval_state, image, label, mesh), mesh)
            dice = out["dice"][:B]
            iou = out["iou"][:B]
            valid = out["valid"][:B]
            pred_empty = out["pred_empty"][:B]

            if self.enable_surface:
                D, H, W = image.shape[1:4]
                D *= sp.space_size(space)
                diag = diag_mm_from_shape(D, H, W, self.spacing)
                hd95 = out["hd95"][:B]
                asd = out["asd"][:B]
                # penalty: GT non-empty & pred empty -> volume diagonal; and
                # sanitize nan/inf among valid entries
                penalty = valid & pred_empty
                hd95 = np.where(penalty, diag, hd95)
                asd = np.where(penalty, diag, asd)
                hd95 = np.where(valid & ~np.isfinite(hd95), diag, hd95)
                asd = np.where(valid & ~np.isfinite(asd), diag, asd)
                if report_nsd:
                    # NSD is a similarity in [0,1]: the worst-case penalty
                    # (empty/degenerate prediction against non-empty GT) is 0.
                    nsd = out["nsd"][:B]
                    nsd = np.where(penalty, 0.0, nsd)
                    nsd = np.where(valid & ~np.isfinite(nsd), 0.0, nsd)

            acc_dice.add(dice, valid)
            acc_iou.add(iou, valid)
            if self.enable_surface:
                acc_hd95.add(hd95, valid)
                acc_asd.add(asd, valid)
                if report_nsd:
                    acc_nsd.add(nsd, valid)

            for i in range(B):
                dom = domains[i]
                v = valid[i : i + 1]
                dom_dice[dom].add(dice[i : i + 1], v)
                dom_iou[dom].add(iou[i : i + 1], v)
                if self.enable_surface:
                    dom_hd95[dom].add(hd95[i : i + 1], v)
                    dom_asd[dom].add(asd[i : i + 1], v)
                    if report_nsd:
                        dom_nsd[dom].add(nsd[i : i + 1], v)

            if self.report_loss:
                total_loss += float(out["loss"][:B].sum())
                n_samples += B

        # ---- finalize (the reference's exact key schema) ----
        metrics: Dict[str, float] = {}
        mean_dice = acc_dice.means()
        for name, v in zip(self.region_order, mean_dice):
            metrics[f"{name.lower()}_dc"] = v
        metrics["avg_dc"] = acc_dice.valid_mean()
        miou = acc_iou.valid_mean()
        metrics["miou"] = miou
        metrics["jc"] = miou
        metrics["loss"] = float(total_loss / max(1, n_samples)) if self.report_loss else 0.0

        if self.enable_surface:
            for name, v in zip(self.region_order, acc_hd95.means()):
                metrics[f"{name.lower()}_hd95"] = v
            metrics["avg_hd95"] = acc_hd95.valid_mean()
            for name, v in zip(self.region_order, acc_asd.means()):
                metrics[f"{name.lower()}_asd"] = v
            metrics["avg_asd"] = acc_asd.valid_mean()
            if report_nsd:
                for name, v in zip(self.region_order, acc_nsd.means()):
                    metrics[f"{name.lower()}_nsd"] = v
                metrics["avg_nsd"] = acc_nsd.valid_mean()

        for dom in sorted(dom_dice.keys()):
            safe = dom if dom != "" else "unknown"
            for name, v in zip(self.region_order, dom_dice[dom].means()):
                metrics[f"dom/{safe}/{name.lower()}_dc"] = v
            metrics[f"dom/{safe}/avg_dc"] = dom_dice[dom].valid_mean()
            metrics[f"dom/{safe}/miou"] = dom_iou[dom].valid_mean()
            if self.enable_surface:
                for name, v in zip(self.region_order, dom_hd95[dom].means()):
                    metrics[f"dom/{safe}/{name.lower()}_hd95"] = v
                metrics[f"dom/{safe}/avg_hd95"] = dom_hd95[dom].valid_mean()
                for name, v in zip(self.region_order, dom_asd[dom].means()):
                    metrics[f"dom/{safe}/{name.lower()}_asd"] = v
                metrics[f"dom/{safe}/avg_asd"] = dom_asd[dom].valid_mean()
                if report_nsd:
                    for name, v in zip(self.region_order, dom_nsd[dom].means()):
                        metrics[f"dom/{safe}/{name.lower()}_nsd"] = v
                    metrics[f"dom/{safe}/avg_nsd"] = dom_nsd[dom].valid_mean()

        return metrics
