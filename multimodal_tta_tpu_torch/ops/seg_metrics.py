"""Batched segmentation metrics as torch reductions (the port of
``multimodal_tta_tpu/ops/seg_metrics.py``).

``binary_dice_iou`` gives per-sample, per-region Dice/IoU with BraTS-style
empty-GT gating: regions with an empty ground truth are marked invalid and
excluded from the aggregate means by the caller.

Layout is channels-last ``[B, *spatial, R]``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def binary_dice_iou(
    pred: torch.Tensor,
    gt: torch.Tensor,
    eps: float = 1e-7,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """pred, gt: [B, *spatial, R] binary ({0,1}, any numeric dtype).

    Returns (dice [B,R], iou [B,R], valid [B,R] bool) where valid means the
    GT region is non-empty. Sums are taken in float32.
    """
    b, r = pred.shape[0], pred.shape[-1]
    p = pred.reshape(b, -1, r).to(torch.float32)
    g = gt.reshape(b, -1, r).to(torch.float32)

    inter = (p * g).sum(dim=1)
    p_sum = p.sum(dim=1)
    g_sum = g.sum(dim=1)

    valid = g_sum > 0
    dice = (2.0 * inter + eps) / (p_sum + g_sum + eps)
    union = p_sum + g_sum - inter
    iou = (inter + eps) / (union + eps)
    return dice, iou, valid


def dice_iou_from_logits(
    logits: torch.Tensor,
    gt: torch.Tensor,
    threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sigmoid -> threshold -> dice/iou/valid, plus pred emptiness per region.

    Returns (dice, iou, valid, pred_empty), all [B, R].
    """
    prob = torch.sigmoid(logits)
    pred = (prob >= threshold).to(torch.float32)
    gt_bin = (gt > 0.5).to(torch.float32)
    dice, iou, valid = binary_dice_iou(pred, gt_bin)
    b, r = pred.shape[0], pred.shape[-1]
    pred_empty = pred.reshape(b, -1, r).sum(dim=1) == 0
    return dice, iou, valid, pred_empty
