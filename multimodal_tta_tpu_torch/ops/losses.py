"""Adaptation objectives (the port of ``multimodal_tta_tpu/ops/losses.py``;
this slice carries ``entropy_loss``, the Tent objective). Shapes are
channels-last ``[B, *spatial, C]``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
