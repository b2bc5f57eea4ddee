"""Segmentation losses and adaptation objectives (the port of
``multimodal_tta_tpu/ops/losses.py``): ``entropy_loss``, the Tent objective,
``pseudo_label_loss``, the hard pseudo-label objective, and ``dice_ce_loss`` with MONAI's DiceCELoss semantics —

  - sigmoid (multi-label) XOR softmax (multi-class) activation
  - include_background: drop channel 0 from the dice term when False
  - squared_pred / jaccard dice denominators
  - lambda_dice / lambda_ce combination weights
  - ce weight: per-channel pos_weight for BCE (sigmoid mode) or class weights
    for CE (softmax mode)
  - smooth_nr / smooth_dr = 1e-5 (MONAI defaults), mean reduction

the generalized Wasserstein Dice criterion (``gwdl``, optionally with
class-weighted CE), and the two losses the reference exports and calls
nowhere, ``focal_loss`` and the batch-hard ``triplet_margin_loss``. Shapes
are channels-last ``[B, *spatial, C]``.

Over the space axis (``space=``, ``parallel/space.py``) the spatial dims
hold this rank's depth slab: a mean over voxels is this slab's sum over the
whole volume's count (the ranks' parts add up in the gradient sum), and a
ratio of sums (Dice) is taken from the space group's sums, alike on every
rank, and counted once as ``1 / space`` of it on each.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from ..parallel.space import space_size, space_sum
from ..utils.config import get_config


class _Constant:
    """A small constant table (class weights, a distance matrix) built once
    per device and dtype, so that a loss called once per sample copies it to
    the card once and not on every call."""

    def __init__(self, values):
        self.values = values
        self._tensors = {}

    def on(self, like: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        key = (like.device, like.dtype if dtype is None else dtype)
        if key not in self._tensors:
            self._tensors[key] = torch.tensor(self.values, dtype=key[1], device=key[0])
        return self._tensors[key]


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
    space=None,
) -> torch.Tensor:
    """Soft dice loss on activated predictions.

    pred/target: [B, *spatial, C] float. Returns scalar mean over (B, C)
    (over a space axis: ``1 / space`` of it, from the group's sums).
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

    if space is not None:
        sums = space_sum(torch.stack([inter, p_sum, g_sum]), space, grad=True)
        inter, p_sum, g_sum = sums[0], sums[1], sums[2]
    denom = p_sum + g_sum
    if jaccard:
        denom = 2.0 * denom - 2.0 * inter  # union-style denominator

    dice = (2.0 * inter + smooth_nr) / (denom + smooth_dr)
    return (1.0 - dice).mean() / space_size(space)


def binary_cross_entropy_with_logits(
    logits: torch.Tensor,
    target: torch.Tensor,
    pos_weight: Optional[torch.Tensor] = None,
    space=None,
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
    if space is not None:
        return loss.sum() / float(loss.numel() * space_size(space))
    return loss.mean()


def softmax_cross_entropy(
    logits: torch.Tensor,
    target_idx: torch.Tensor,
    class_weight: Optional[torch.Tensor] = None,
    space=None,
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
        return (nll * pix_w).sum() / torch.clamp(space_sum(pix_w.sum(), space), min=1e-12)
    if space is not None:
        return nll.sum() / float(nll.numel() * space_size(space))
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
    ce_weight: Union[Sequence[float], torch.Tensor, None] = None,
    smooth_nr: float = 1e-5,
    smooth_dr: float = 1e-5,
    space=None,
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
        w = torch.as_tensor(ce_weight, dtype=logits.dtype, device=logits.device)
    dice_kw = dict(include_background=include_background, squared_pred=squared_pred,
                   jaccard=jaccard, smooth_nr=smooth_nr, smooth_dr=smooth_dr, space=space)

    if sigmoid:
        target_f = target.to(logits.dtype)
        l_dice = soft_dice_loss(torch.sigmoid(logits), target_f, **dice_kw)
        l_ce = binary_cross_entropy_with_logits(logits, target_f, pos_weight=w, space=space)
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
        l_ce = softmax_cross_entropy(logits, target_idx, class_weight=w, space=space)

    return lambda_dice * l_dice + lambda_ce * l_ce


def make_dice_ce_loss(crit_cfg) -> Callable:
    """Build a dice_ce_loss closure from a training.criterion config node.
    Its ``ce_weight`` tensor is built once per device and dtype."""
    softmax = bool(get_config(crit_cfg, "softmax", False))
    sigmoid = bool(get_config(crit_cfg, "sigmoid", not softmax))
    if softmax and sigmoid:
        raise ValueError("[criterion] softmax=True and sigmoid=True cannot both be set")
    if not softmax and not sigmoid:
        raise ValueError("[criterion] one of softmax/sigmoid must be True")
    ce_weight = get_config(crit_cfg, "ce_weight", None)
    if ce_weight is None:
        ce_weight = get_config(crit_cfg, "weight", None)
    loss = partial(
        dice_ce_loss,
        sigmoid=sigmoid,
        softmax=softmax,
        include_background=bool(get_config(crit_cfg, "include_background", True)),
        to_onehot_y=bool(get_config(crit_cfg, "to_onehot_y", softmax)),
        squared_pred=bool(get_config(crit_cfg, "squared_pred", False)),
        jaccard=bool(get_config(crit_cfg, "jaccard", False)),
        lambda_dice=float(get_config(crit_cfg, "lambda_dice", 1.0)),
        lambda_ce=float(get_config(crit_cfg, "lambda_ce", 1.0)),
    )
    if ce_weight is None:
        return loss
    weight = _Constant([float(x) for x in list(ce_weight)])
    return lambda logits, target, **kw: loss(logits, target, ce_weight=weight.on(logits), **kw)


def generalized_wasserstein_dice_loss(
    logits: torch.Tensor,
    label: torch.Tensor,
    distance_matrix,
    *,
    background_index: int = 0,
    smooth: float = 1e-5,
    space=None,
) -> torch.Tensor:
    """Generalized Wasserstein Dice Loss (Fidon et al., BrainLes 2017),
    softmax label-map formulation. With the class-distance matrix ``M``
    ([C, C], M[l, l] = 0), per voxel ``delta_i = sum_c M[y_i, c] * p_i(c)``,
    the generalized true positives ``TP = sum_i M[y_i, b] * (M[y_i, b] -
    delta_i)`` and the loss ``1 - (2 TP + s) / (2 TP + sum_i delta_i + s)``,
    averaged over the batch. With ``M = 1 - I`` it is foreground soft Dice.
    Over a space axis the per-sample sums are the space group's, and the
    value ``1 / space`` of it, as for ``soft_dice_loss``.

    logits: [B, *spatial, C]; label: [B, *spatial] int class map."""
    M = torch.as_tensor(distance_matrix, dtype=torch.float32, device=logits.device)
    if M.dim() != 2 or M.shape[0] != M.shape[1]:
        raise ValueError(f"distance_matrix must be square, got {tuple(M.shape)}")
    if logits.shape[-1] != M.shape[0]:
        raise ValueError(
            f"distance_matrix is {M.shape[0]}x{M.shape[0]} but logits have "
            f"{logits.shape[-1]} classes"
        )
    p = torch.softmax(logits.float(), dim=-1)
    y = label.to(torch.int64)
    delta = (M[y] * p).sum(dim=-1)  # [B, *spatial]
    gamma = M[y, background_index]  # [B, *spatial]
    b = logits.shape[0]
    tp = (gamma * (gamma - delta)).reshape(b, -1).sum(dim=-1)
    all_error = delta.reshape(b, -1).sum(dim=-1)
    if space is not None:
        tp, all_error = space_sum(torch.stack([tp, all_error]), space, grad=True)
    wasserstein_dice = (2.0 * tp + smooth) / (2.0 * tp + all_error + smooth)
    return (1.0 - wasserstein_dice).mean() / space_size(space)


def gwdl_ce_loss(
    logits: torch.Tensor,
    label: torch.Tensor,
    *,
    distance_matrix,
    background_index: int = 0,
    smooth: float = 1e-5,
    lambda_ce: float = 0.0,
    ce_weight: Union[Sequence[float], torch.Tensor, None] = None,
    space=None,
) -> torch.Tensor:
    """GWDL optionally combined with voxel CE: ``gwdl + lambda_ce * CE``
    (class-weighted with ``ce_weight``, which keeps a rare class from being
    abandoned when its transport cost to a neighbour is cheap)."""
    loss = generalized_wasserstein_dice_loss(
        logits, label, distance_matrix, background_index=background_index, smooth=smooth, space=space)
    if lambda_ce:
        w = None if ce_weight is None else torch.as_tensor(ce_weight, dtype=torch.float32,
                                                           device=logits.device)
        loss = loss + lambda_ce * softmax_cross_entropy(
            logits.float(), label.to(torch.int64), class_weight=w, space=space)
    return loss


def make_gwdl_loss(crit_cfg) -> Callable:
    """Build a GWDL closure from ``training.criterion`` with ``name: gwdl``:
    softmax mode (label maps) and an explicit square ``distance_matrix``
    with a zero diagonal are required; ``lambda_ce`` (default 0) blends in
    voxel CE. The matrix and ``ce_weight`` are built once per device."""
    if bool(get_config(crit_cfg, "sigmoid", False)):
        raise ValueError(
            "[criterion/gwdl] GWDL is a softmax label-map loss; set "
            "criterion.softmax=true (multi-label sigmoid masks have no "
            "single true class to transport from)"
        )
    m = get_config(crit_cfg, "distance_matrix", None)
    if m is None:
        raise ValueError(
            "[criterion/gwdl] training.criterion.distance_matrix is required "
            "(C x C list, M[l][l]=0) — e.g. uniform 1-I, or a label-tree "
            "metric grading semantically close classes cheaper"
        )
    matrix = [[float(v) for v in row] for row in m]
    n = len(matrix)
    if any(len(r) != n for r in matrix) or any(matrix[i][i] != 0.0 for i in range(n)):
        raise ValueError("[criterion/gwdl] distance_matrix must be square with a zero diagonal")
    ce_weight = get_config(crit_cfg, "ce_weight", None)
    loss = partial(
        gwdl_ce_loss,
        background_index=int(get_config(crit_cfg, "background_index", 0)),
        smooth=float(get_config(crit_cfg, "smooth", 1e-5)),
        lambda_ce=float(get_config(crit_cfg, "lambda_ce", 0.0)),
    )
    tables = (_Constant(matrix), None if ce_weight is None else _Constant([float(x) for x in list(ce_weight)]))

    def gwdl(logits, label, space=None):
        m, w = (None if t is None else t.on(logits, torch.float32) for t in tables)
        return loss(logits, label, distance_matrix=m, ce_weight=w, space=space)

    return gwdl


def make_criterion(crit_cfg) -> Callable:
    """Dispatch a ``training.criterion`` node to its loss family by
    ``name`` (default ``dice_ce``; ``gwdl`` = generalized Wasserstein
    Dice). Both return a ``loss(logits, label)`` closure."""
    name = str(get_config(crit_cfg, "name", "dice_ce")).lower()
    if name == "dice_ce":
        return make_dice_ce_loss(crit_cfg)
    if name == "gwdl":
        return make_gwdl_loss(crit_cfg)
    raise ValueError(f"[criterion] unknown criterion name: {name!r} (dice_ce | gwdl)")


def focal_loss(logits: torch.Tensor, target: torch.Tensor, alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Binary focal loss with logits (reference: src/utils/losses.py:6-24),
    the mean over every element."""
    p = torch.sigmoid(logits)
    t = target.to(logits.dtype)
    ce = -(t * F.logsigmoid(logits) + (1 - t) * F.logsigmoid(-logits))
    p_t = p * t + (1 - p) * (1 - t)
    alpha_t = alpha * t + (1 - alpha) * (1 - t)
    return torch.mean(alpha_t * (1 - p_t) ** gamma * ce)


def triplet_margin_loss(embeddings: torch.Tensor, labels: torch.Tensor, margin: float = 0.3) -> torch.Tensor:
    """Batch-hard triplet loss on L2 distances (the reference's standard
    formulation). The distances are formed as the reference forms them
    (difference, square, sum, a floor of 1e-12, root; not ``torch.cdist``,
    whose matmul form rounds differently), and ``torch.maximum`` /
    ``amax`` / ``amin`` split the gradient between ties as JAX's
    ``maximum`` / ``max`` / ``min`` do."""
    sq = torch.sum((embeddings[:, None, :] - embeddings[None, :, :]) ** 2, dim=-1)
    d = torch.sqrt(torch.maximum(sq, torch.tensor(1e-12, dtype=sq.dtype, device=sq.device)))
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(labels.shape[0], dtype=torch.bool, device=labels.device)
    pos_mask = same & ~eye
    neg_mask = ~same

    inf = torch.tensor(float("inf"), dtype=d.dtype, device=d.device)
    hardest_pos = torch.amax(torch.where(pos_mask, d, -inf), dim=1)
    hardest_neg = torch.amin(torch.where(neg_mask, d, inf), dim=1)
    valid = torch.isfinite(hardest_pos) & torch.isfinite(hardest_neg)
    loss = torch.maximum(hardest_pos - hardest_neg + margin, torch.zeros((), dtype=d.dtype, device=d.device))
    return torch.sum(torch.where(valid, loss, torch.zeros_like(loss))) / torch.clamp(valid.sum(), min=1)


def reduce_dims(t: torch.Tensor, dims, op: str = "sum") -> torch.Tensor:
    """``t.sum(dims)`` / ``t.mean(dims)``; with no dims ``t`` as it is (a
    classifier's per-sample value: torch would reduce every dim for
    ``dim=()``)."""
    if not dims:
        return t
    return t.sum(dim=dims) if op == "sum" else t.mean(dim=dims)


def _entropy_map(logits: torch.Tensor, sigmoid: bool) -> torch.Tensor:
    """Per-voxel (per-channel, sigmoid) entropy."""
    if sigmoid:
        p = torch.sigmoid(logits)
        return -(p * F.logsigmoid(logits) + (1 - p) * F.logsigmoid(-logits))
    logp = F.log_softmax(logits, dim=-1)
    return -(logp.exp() * logp).sum(dim=-1)


def entropy_sums(logits: torch.Tensor, *, sigmoid: bool = True, focus: str = "all"):
    """``entropy_loss`` over the whole batch as ``(numerator, denominator)``
    sums: the loss is ``num / den`` ("all"; ``den`` the element count, a
    float) or ``num / max(den, 1e-12)`` ("uncertain"). Over ranks the ranks'
    denominators meet before the division; ``den`` carries no gradient."""
    h = _entropy_map(logits, sigmoid)
    if focus == "uncertain":
        w = h.detach()
        return (h * w).sum(), w.sum()
    if focus != "all":
        raise ValueError(f"Unknown entropy focus: {focus}")
    return h.sum(), float(h.numel())


def entropy_loss(
    logits: torch.Tensor,
    *,
    sigmoid: bool = True,
    focus: str = "all",
    per_sample: bool = False,
    space=None,
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

    Over a space axis (``space``) the value is this slab's part: its sum
    over the space group's denominator; the parts add up to the whole.
    """
    h = _entropy_map(logits, sigmoid)
    dims = tuple(range(1 if per_sample else 0, h.dim()))
    if focus == "uncertain":
        w = h.detach()
        return reduce_dims(h * w, dims) / torch.clamp(space_sum(reduce_dims(w, dims), space), min=1e-12)
    if focus != "all":
        raise ValueError(f"Unknown entropy focus: {focus}")
    if space is not None:
        return reduce_dims(h, dims) / float(math.prod(h.shape[d] for d in dims) * space_size(space))
    return reduce_dims(h, dims, "mean")


def pseudo_label_loss(
    logits: torch.Tensor,
    *,
    sigmoid: bool = True,
    conf_threshold: float = 0.9,
    per_sample: bool = False,
    space=None,
) -> torch.Tensor:
    """Hard pseudo-label self-training objective for test-time adaptation:
    cross-entropy of the outputs against their OWN hard predictions,
    restricted to voxels whose confidence clears ``conf_threshold``. The
    pseudo-labels and the confidence gate carry no gradient.

    sigmoid mode: per-voxel per-channel Bernoulli CE with hard labels
    ``p >= 0.5``, confidence ``max(p, 1-p)``. softmax mode: categorical CE
    against the argmax channel, confidence the max probability. Normalized
    by the confident-voxel count, so a batch with no confident voxel gives
    loss 0 and zero gradient.

    Returns a scalar over the whole batch, or with ``per_sample=True`` one
    value per sample ``[B]`` (each normalized by its own count).
    """
    ce, w = _pseudo_label_terms(logits, sigmoid, conf_threshold)
    dims = tuple(range(1 if per_sample else 0, ce.dim()))
    return reduce_dims(ce * w, dims) / torch.clamp(space_sum(reduce_dims(w, dims), space), min=1.0)


def _pseudo_label_terms(logits: torch.Tensor, sigmoid: bool, conf_threshold: float):
    """Per-voxel CE against the hard pseudo-labels and the confidence gate."""
    if sigmoid:
        p = torch.sigmoid(logits).detach()
        hard = (p >= 0.5).to(logits.dtype)
        w = (torch.maximum(p, 1.0 - p) >= conf_threshold).to(logits.dtype)
        return -(hard * F.logsigmoid(logits) + (1.0 - hard) * F.logsigmoid(-logits)), w
    logp = F.log_softmax(logits, dim=-1)
    p = logp.exp().detach()
    hard = torch.argmax(p, dim=-1, keepdim=True)
    w = (p.amax(dim=-1) >= conf_threshold).to(logits.dtype)
    return -torch.gather(logp, -1, hard)[..., 0], w


def pseudo_label_sums(logits: torch.Tensor, *, sigmoid: bool = True, conf_threshold: float = 0.9):
    """``pseudo_label_loss`` over the whole batch as ``(numerator,
    denominator)``: the loss is ``num / max(den, 1)``; ``den`` (the
    confident-voxel count) carries no gradient."""
    ce, w = _pseudo_label_terms(logits, sigmoid, conf_threshold)
    return (ce * w).sum(), w.sum()
