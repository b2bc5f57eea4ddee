"""Segmentation losses and adaptation objectives (the port of
``multimodal_tta_tpu/ops/losses.py``): ``entropy_loss``, the Tent objective,
and ``dice_ce_loss`` with MONAI's DiceCELoss semantics —

  - sigmoid (multi-label) XOR softmax (multi-class) activation
  - include_background: drop channel 0 from the dice term when False
  - squared_pred / jaccard dice denominators
  - lambda_dice / lambda_ce combination weights
  - ce weight: per-channel pos_weight for BCE (sigmoid mode) or class weights
    for CE (softmax mode)
  - smooth_nr / smooth_dr = 1e-5 (MONAI defaults), mean reduction

The generalized Wasserstein Dice criterion (``gwdl``) comes with the
training slice. Shapes are channels-last ``[B, *spatial, C]``.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..utils.config import get_config


def _flatten_spatial(x: torch.Tensor) -> torch.Tensor:
    """[B, *spatial, C] -> [B, V, C]."""
    return x.reshape(x.shape[0], -1, x.shape[-1])


def soft_dice_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    *,
    include_background: bool = True,
    squared_pred: bool = False,
    jaccard: bool = False,
    smooth_nr: float = 1e-5,
    smooth_dr: float = 1e-5,
) -> torch.Tensor:
    """Soft dice loss on activated predictions.

    pred/target: [B, *spatial, C] float. Returns scalar mean over (B, C).
    """
    pred = _flatten_spatial(pred)
    target = _flatten_spatial(target)

    if not include_background and pred.shape[-1] > 1:
        pred = pred[..., 1:]
        target = target[..., 1:]

    inter = (pred * target).sum(dim=1)  # [B, C]
    if squared_pred:
        p_sum = (pred * pred).sum(dim=1)
        g_sum = (target * target).sum(dim=1)
    else:
        p_sum = pred.sum(dim=1)
        g_sum = target.sum(dim=1)

    denom = p_sum + g_sum
    if jaccard:
        denom = 2.0 * denom - 2.0 * inter  # union-style denominator

    dice = (2.0 * inter + smooth_nr) / (denom + smooth_dr)
    return (1.0 - dice).mean()


def binary_cross_entropy_with_logits(
    logits: torch.Tensor,
    target: torch.Tensor,
    pos_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Numerically-stable BCE-with-logits, optional per-channel pos_weight
    (``torch.nn.BCEWithLogitsLoss(pos_weight=w, reduction='mean')``, written
    out as the reference writes it). logits/target: [..., C]."""
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    if pos_weight is not None:
        w = torch.as_tensor(pos_weight, dtype=logits.dtype, device=logits.device)
        loss = -(w * target * log_p + (1.0 - target) * log_not_p)
    else:
        loss = -(target * log_p + (1.0 - target) * log_not_p)
    return loss.mean()


def softmax_cross_entropy(
    logits: torch.Tensor,
    target_idx: torch.Tensor,
    class_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """CE with integer targets. logits [B, *spatial, C], target [B, *spatial].

    Matches torch.nn.CrossEntropyLoss(weight=w, reduction='mean') including
    the weighted-mean normalization by the summed per-sample weights.
    """
    log_probs = F.log_softmax(logits, dim=-1)
    nll = -log_probs.gather(-1, target_idx.unsqueeze(-1)).squeeze(-1)  # [B, *spatial]
    if class_weight is not None:
        w = torch.as_tensor(class_weight, dtype=logits.dtype, device=logits.device)
        pix_w = w[target_idx]
        return (nll * pix_w).sum() / torch.clamp(pix_w.sum(), min=1e-12)
    return nll.mean()


def dice_ce_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    *,
    sigmoid: bool = True,
    softmax: bool = False,
    include_background: bool = True,
    to_onehot_y: bool = False,
    squared_pred: bool = False,
    jaccard: bool = False,
    lambda_dice: float = 1.0,
    lambda_ce: float = 1.0,
    ce_weight: Optional[Sequence[float]] = None,
    smooth_nr: float = 1e-5,
    smooth_dr: float = 1e-5,
) -> torch.Tensor:
    """Combined Dice + CE/BCE loss (MONAI DiceCELoss semantics).

    sigmoid mode:  logits/target [B, *spatial, C]; BCE with pos_weight.
    softmax mode:  logits [B, *spatial, C]; target int [B, *spatial] when
                   to_onehot_y else one-hot [B, *spatial, C]. CE with class
                   weights; dice on softmax probabilities.
    """
    if sigmoid and softmax:
        raise ValueError("sigmoid and softmax cannot both be True")
    if not sigmoid and not softmax:
        raise ValueError("one of sigmoid/softmax must be True")

    w = None
    if ce_weight is not None:
        w = torch.tensor(list(ce_weight), dtype=logits.dtype, device=logits.device)
    dice_kw = dict(include_background=include_background, squared_pred=squared_pred,
                   jaccard=jaccard, smooth_nr=smooth_nr, smooth_dr=smooth_dr)

    if sigmoid:
        target_f = target.to(logits.dtype)
        l_dice = soft_dice_loss(torch.sigmoid(logits), target_f, **dice_kw)
        l_ce = binary_cross_entropy_with_logits(logits, target_f, pos_weight=w)
    else:
        if to_onehot_y and target.dim() == logits.dim() - 1:
            target_idx = target.to(torch.int64)
            target_1h = F.one_hot(target_idx, logits.shape[-1]).to(logits.dtype)
        elif target.dim() == logits.dim():
            target_1h = target.to(logits.dtype)
            target_idx = torch.argmax(target_1h, dim=-1)
        else:
            raise ValueError(
                f"softmax mode: target ndim {target.dim()} incompatible with logits ndim {logits.dim()}"
            )
        l_dice = soft_dice_loss(torch.softmax(logits, dim=-1), target_1h, **dice_kw)
        l_ce = softmax_cross_entropy(logits, target_idx, class_weight=w)

    return lambda_dice * l_dice + lambda_ce * l_ce


def make_dice_ce_loss(crit_cfg) -> "partial":
    """Build a dice_ce_loss closure from a training.criterion config node."""
    softmax = bool(get_config(crit_cfg, "softmax", False))
    sigmoid = bool(get_config(crit_cfg, "sigmoid", not softmax))
    if softmax and sigmoid:
        raise ValueError("[criterion] softmax=True and sigmoid=True cannot both be set")
    if not softmax and not sigmoid:
        raise ValueError("[criterion] one of softmax/sigmoid must be True")
    ce_weight = get_config(crit_cfg, "ce_weight", None)
    if ce_weight is None:
        ce_weight = get_config(crit_cfg, "weight", None)
    return partial(
        dice_ce_loss,
        sigmoid=sigmoid,
        softmax=softmax,
        include_background=bool(get_config(crit_cfg, "include_background", True)),
        to_onehot_y=bool(get_config(crit_cfg, "to_onehot_y", softmax)),
        squared_pred=bool(get_config(crit_cfg, "squared_pred", False)),
        jaccard=bool(get_config(crit_cfg, "jaccard", False)),
        lambda_dice=float(get_config(crit_cfg, "lambda_dice", 1.0)),
        lambda_ce=float(get_config(crit_cfg, "lambda_ce", 1.0)),
        ce_weight=None if ce_weight is None else [float(x) for x in list(ce_weight)],
    )


def make_criterion(crit_cfg) -> "partial":
    """Dispatch a ``training.criterion`` node to its loss family by
    ``name`` (default ``dice_ce``). Returns a ``loss(logits, label)``
    closure. ``gwdl`` (generalized Wasserstein Dice) is not ported yet."""
    name = str(get_config(crit_cfg, "name", "dice_ce")).lower()
    if name == "dice_ce":
        return make_dice_ce_loss(crit_cfg)
    if name == "gwdl":
        raise NotImplementedError(
            "[criterion] gwdl is not ported yet (ROADMAP.md, training slice)"
        )
    raise ValueError(f"[criterion] unknown criterion name: {name!r} (dice_ce | gwdl)")


def entropy_loss(
    logits: torch.Tensor,
    *,
    sigmoid: bool = True,
    focus: str = "all",
    per_sample: bool = False,
) -> torch.Tensor:
    """Prediction-entropy objective for Tent-style TTA.

    sigmoid mode: per-voxel per-channel Bernoulli entropy.
    softmax mode: per-voxel categorical entropy over the channel axis.

    focus:
      "all"       — mean over every voxel (the plain Tent objective).
      "uncertain" — self-normalized entropy ``sum(H * w) / sum(w)`` with
                    ``w = H.detach()``.

    Returns a scalar over the whole batch, as the reference does, or with
    ``per_sample=True`` one value per sample ``[B]`` — the reference's
    ``jax.vmap(lambda lg: entropy_loss(lg[None]))``.
    """
    if sigmoid:
        p = torch.sigmoid(logits)
        h = -(p * F.logsigmoid(logits) + (1 - p) * F.logsigmoid(-logits))
    else:
        logp = F.log_softmax(logits, dim=-1)
        h = -(logp.exp() * logp).sum(dim=-1)
    dims = tuple(range(1 if per_sample else 0, h.dim()))
    if focus == "uncertain":
        w = h.detach()
        return (h * w).sum(dim=dims) / torch.clamp(w.sum(dim=dims), min=1e-12)
    if focus != "all":
        raise ValueError(f"Unknown entropy focus: {focus}")
    return h.mean(dim=dims)
