"""On-device data augmentation of the train step (the port of
``multimodal_tta_tpu/ops/augment.py``): the per-sample intensity scale and
shift, and modality dropout.

Each augmentation is split in two: ``*_draws`` takes the random numbers
from an explicit ``torch.Generator``, and ``apply_*`` is a function of the
input and the draws only, so a test can feed both packages the same draws.
Layout: channels-last ``[B, *spatial, C]``, as every public function of the
port. ``rand_rot90`` is not ported yet (ROADMAP.md, remaining inference ops).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _per_sample(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.to(device=x.device, dtype=x.dtype).reshape((x.shape[0],) + (1,) * (x.dim() - 1))


def intensity_scale_shift_draws(
    b: int,
    generator: torch.Generator,
    *,
    scale: float = 0.1,
    shift: float = 0.1,
    prob: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample ``(factor [b], offset [b])``: a factor in
    ``[1 - scale, 1 + scale)`` with probability ``prob`` (else 1) and an
    offset in ``[-shift, shift)`` with probability ``prob`` (else 0), on the
    generator's device."""
    u = torch.rand((4, b), generator=generator, device=generator.device)
    factor = torch.where(u[0] < prob, 1.0 + (2.0 * u[1] - 1.0) * scale, 1.0)
    offset = torch.where(u[2] < prob, (2.0 * u[3] - 1.0) * shift, 0.0)
    return factor, offset


def apply_intensity_scale_shift(x: torch.Tensor, factor: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """``x * factor + offset`` with one factor and offset per sample."""
    return x * _per_sample(factor, x) + _per_sample(offset, x)


def rand_intensity_scale_shift(
    x: torch.Tensor,
    generator: torch.Generator,
    *,
    scale: float = 0.1,
    shift: float = 0.1,
    prob: float = 0.5,
) -> torch.Tensor:
    """Per-sample random multiplicative scale and additive shift, each applied
    with probability ``prob`` (reference: RandScaleIntensity/RandShiftIntensity
    with factors/offsets 0.1, prob 0.5 — transforms.py:109-116).

    x: [B, ...]; randomness is per-sample."""
    factor, offset = intensity_scale_shift_draws(x.shape[0], generator, scale=scale,
                                                 shift=shift, prob=prob)
    return apply_intensity_scale_shift(x, factor, offset)


def modality_dropout_draws(b: int, m: int, generator: torch.Generator, *, prob: float = 0.25) -> torch.Tensor:
    """``drop [b, m]`` (bool): each modality of each sample dropped with
    probability ``prob``, except one modality per sample, drawn uniformly,
    which is always kept."""
    drop = torch.rand((b, m), generator=generator, device=generator.device) < prob
    keep = torch.randint(0, m, (b,), generator=generator, device=generator.device)
    drop[torch.arange(b, device=drop.device), keep] = False
    return drop


def apply_modality_dropout(x: torch.Tensor, drop: torch.Tensor) -> torch.Tensor:
    """Zero the modalities (last axis) of each sample where ``drop`` is set."""
    b, m = x.shape[0], x.shape[-1]
    mask = drop.to(x.device).reshape((b,) + (1,) * (x.dim() - 2) + (m,))
    return torch.where(mask, torch.zeros((), dtype=x.dtype, device=x.device), x)


def modality_dropout(x: torch.Tensor, generator: torch.Generator, *, prob: float = 0.25) -> torch.Tensor:
    """Randomly zero whole modalities (channels) per sample, guaranteeing at
    least one modality survives (missing-modality-robust training).

    x: [B, ..., M]."""
    return apply_modality_dropout(x, modality_dropout_draws(x.shape[0], x.shape[-1], generator, prob=prob))
