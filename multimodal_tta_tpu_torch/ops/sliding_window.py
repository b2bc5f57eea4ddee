"""Sliding-window 3D inference (the port of
``multimodal_tta_tpu/ops/sliding_window.py``), for volumes that exceed one
card's memory whole:

  - window grid positions are computed from (volume, roi, overlap)
  - every window goes through the same forward; its logits accumulate into
    the output canvas in place
  - overlap blending via a constant or gaussian importance map (MONAI's two
    modes), normalized at the end

Over a space axis (``space``, ``parallel/space.py``) the volume is this
rank's depth slab; the window grid is the whole (padded) volume's. Each
rank gathers the volume's depth (the input only), and a window whose
depth splits over the group (``space.splits``) runs split: each rank
forwards its part of the window's depth, and the window's logits are
gathered over the group. A window whose depth does not split runs whole
on every rank of the group. Each rank blends only the planes of its own
slab, voxel for voxel in one process's order, so its canvas is its slab's
and the blended logits are those one process blends from the same
windows' logits.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import space as sp


def window_starts(size: int, roi: int, overlap: float) -> list:
    """Start offsets covering [0, size) with windows of length roi and the
    given fractional overlap (MONAI dense-patch convention)."""
    if roi >= size:
        return [0]
    interval = max(1, int(roi * (1.0 - overlap)))
    n = int(math.ceil((size - roi) / interval)) + 1
    starts = [min(i * interval, size - roi) for i in range(n)]
    # dedupe while keeping order
    out = []
    for s in starts:
        if not out or s != out[-1]:
            out.append(s)
    return out


def gaussian_importance(roi: Sequence[int], sigma_scale: float = 0.125) -> np.ndarray:
    """Gaussian window-importance map (MONAI's 'gaussian' blend mode)."""
    grids = []
    for r in roi:
        x = np.arange(r, dtype=np.float64)
        center = (r - 1) / 2.0
        sigma = max(r * sigma_scale, 1e-3)
        grids.append(np.exp(-0.5 * ((x - center) / sigma) ** 2))
    w = grids[0][:, None, None] * grids[1][None, :, None] * grids[2][None, None, :]
    w = np.maximum(w, w.max() * 1e-3)  # avoid zero weights at corners
    return w.astype(np.float32)


def sliding_window_inference(
    apply_fn: Callable,
    volume: torch.Tensor,
    roi_size: Tuple[int, int, int],
    *,
    num_classes: int,
    overlap: float = 0.25,
    mode: str = "gaussian",
    space=None,
) -> torch.Tensor:
    """Run ``apply_fn(window [B,d,h,w,C]) -> logits [B,d,h,w,K]`` over a
    window grid of ``volume`` [B,D,H,W,C]; returns blended f32 logits
    [B,D,H,W,K]. ``space``: ``volume`` is this rank's depth slab and so are
    the logits returned (``apply_fn`` a model that reads the ambient axis)."""
    rd, rh, rw = (int(r) for r in roi_size)
    lo, hi = 0, volume.shape[1]  # the planes this rank blends (padding never)
    if space is not None:
        lo, hi = hi * space.rank, hi * (space.rank + 1)
        volume = sp.all_gather_cat(volume, 1, space.size, space.group)
    b, D, H, W, _ = volume.shape

    # pad volume up to at least the roi
    pad_d, pad_h, pad_w = max(0, rd - D), max(0, rh - H), max(0, rw - W)
    if pad_d or pad_h or pad_w:
        volume = F.pad(volume, (0, 0, 0, pad_w, 0, pad_h, 0, pad_d))
    Dp, Hp, Wp = D + pad_d, H + pad_h, W + pad_w

    if mode == "gaussian":
        imp = torch.from_numpy(gaussian_importance((rd, rh, rw))).to(volume.device)
    elif mode == "constant":
        imp = torch.ones((rd, rh, rw), dtype=torch.float32, device=volume.device)
    else:
        raise ValueError(f"Unknown blend mode: {mode}")
    imp_k = imp[None, :, :, :, None]  # [1,d,h,w,1]

    split = space is not None and sp.splits(rd, space.size)
    out = torch.zeros((b, hi - lo, Hp, Wp, num_classes), dtype=torch.float32, device=volume.device)
    wgt = torch.zeros((1, hi - lo, Hp, Wp, 1), dtype=torch.float32, device=volume.device)
    for sd in window_starts(Dp, rd, overlap):
        a, z = max(sd, lo), min(sd + rd, hi)  # the window's planes in this rank's slab
        for sh in window_starts(Hp, rh, overlap):
            for sw in window_starts(Wp, rw, overlap):
                win = volume[:, sd:sd + rd, sh:sh + rh, sw:sw + rw]
                if split:
                    with sp.ambient(space):
                        part = apply_fn(sp.slice_depth(win, space, dim=1)).to(torch.float32)
                    logits = sp.all_gather_cat(part, 1, space.size, space.group)
                else:  # whole (on every rank of a space group)
                    with sp.ambient(None):
                        logits = apply_fn(win).to(torch.float32)
                if a >= z:
                    continue
                dst = (slice(None), slice(a - lo, z - lo), slice(sh, sh + rh), slice(sw, sw + rw))
                out[dst] += logits[:, a - sd:z - sd] * imp_k[:, a - sd:z - sd]
                wgt[dst] += imp_k[:, a - sd:z - sd]
    blended = out / torch.clamp(wgt, min=1e-8)
    return blended[:, :, :H, :W, :]
