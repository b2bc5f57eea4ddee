"""Flip-averaged test-time augmentation for segmentation inference (the
port of ``multimodal_tta_tpu/ops/flip_tta.py``).

Run the forward on every combination of spatial mirror flips, un-flip each
probability map, and average. Mirroring is the one augmentation whose
inverse is exact, so the ensemble is label-consistent by construction; it
costs 2^k forwards, which run one after another. Composable with
sliding-window inference: the flips wrap whatever forward the evaluator uses.
Over a space axis (``space``) the image is this rank's depth slab and a
depth flip is ``parallel/space.py:flip_depth``; every other step is local.
"""

from __future__ import annotations

from itertools import combinations
from typing import Callable, Sequence, Tuple

import torch

from ..parallel.space import flip


def flip_combos(axes: Sequence[int]) -> Tuple[Tuple[int, ...], ...]:
    """All subsets of the flip axes, the empty (clean) combo first."""
    axes = tuple(int(a) for a in axes)
    out = []
    for r in range(len(axes) + 1):
        out.extend(combinations(axes, r))
    return tuple(out)


def flip_averaged_probs(
    forward: Callable[[torch.Tensor], torch.Tensor],
    image: torch.Tensor,
    axes: Sequence[int],
    to_prob: Callable[[torch.Tensor], torch.Tensor],
    with_variance: bool = False,
    space=None,
):
    """Returns ``(clean_logits, averaged_probs)`` — or, with
    ``with_variance=True``, ``(clean_logits, averaged_probs, var_probs)``.

    ``forward`` maps an image batch to logits; ``to_prob`` maps logits to
    probabilities (sigmoid / softmax). Each of the 2^len(axes) flip
    combinations is applied to the input, forwarded, un-flipped in
    probability space, and averaged. The clean (no-flip) forward's logits
    are returned as-is so callers can report losses on the un-augmented
    view.

    ``var_probs`` is the per-voxel POPULATION variance of the un-flipped
    view probabilities — the mirror-ensemble disagreement map: zero where
    the model is flip-equivariant, high where it segments differently under
    mirroring.

    ``space``: ``image`` is this rank's depth slab (dim 1) of the volume, and
    the results are this rank's slabs.
    """
    combos = flip_combos(axes)
    clean_logits = forward(image)
    p0 = to_prob(clean_logits)
    total = p0
    total_sq = p0 * p0 if with_variance else None
    for combo in combos[1:]:
        x = flip(image, combo, space)
        p = flip(to_prob(forward(x)), combo, space)
        total = total + p
        if with_variance:
            total_sq = total_sq + p * p
    n = float(len(combos))
    mean = total / n
    if not with_variance:
        return clean_logits, mean
    var = torch.clamp(total_sq / n - mean * mean, min=0.0)
    return clean_logits, mean, var
