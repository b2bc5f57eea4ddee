"""Surface-distance metrics (HD95 / ASD / NSD) on the device (the port of
``multimodal_tta_tpu/ops/surface.py``).

  1. surface extraction = mask & ~erode(mask) with a 6-connected cross
     element and zero border (scipy/MONAI convention)
  2. EXACT anisotropic squared euclidean distance transform via three
     separable min-plus passes: along each axis,
     ``g[i] = min_j (f[j] + ((i-j)*spacing)^2)``. All surfaces of a group of
     (sample, region) pairs go through ``kernels.edt_minplus.
     squared_edt_volumes`` at once: for CUDA tensors that is one launch of
     the hand-written kernel, which reads the lines of every axis where they
     lie, builds the cost in shared memory and writes the root.
  3. directed distances gathered at the other mask's surface voxels;
     HD95 = max of the two directed 95th percentiles (numpy-style linear
     interpolation); ASD = mean of pred->gt distances (symmetric: both
     directions pooled); NSD (normalized surface Dice at tolerance tau,
     Nikolov et al. 2018) = the fraction of surface voxels, pooled over both
     surfaces, whose distance to the OTHER surface is <= tau.

Everything carries a leading pair dimension: no Python loop runs over the
pairs, only over groups of them sized by a byte budget. Empty masks produce
+inf (NSD: one-sided empty -> 0, both empty -> +inf), which the evaluation
layer replaces with the volume-diagonal penalty (NSD: 0). Nothing here reads
a value back to the host: emptiness is handled with ``torch.where`` on the
device.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels.edt_minplus import squared_edt_volumes

_INF = float("inf")
# Pairs go through in groups whose temporaries stay under this budget. Per
# voxel and pair: two distance fields (8 bytes), their masked copy (8), the
# sorted values (8) and the sort's int64 indices (16), masks and surfaces (8).
# 2 GiB holds the 6 (sample, region) pairs of a BraTS batch of 2 at
# [160,192,160] (1.42 GB): one group, so one EDT launch a batch.
_GROUP_BYTES = 2 << 30
_PAIR_BYTES_PER_VOXEL = 48


def extract_surface(mask: torch.Tensor) -> torch.Tensor:
    """mask: [..., D, H, W] {0,1} or bool. Surface = fg voxels with a bg
    6-neighbor (border counts as bg, matching binary_erosion's border_value=0)."""
    m = mask if mask.dtype == torch.bool else mask > 0.5
    d, h, w = m.shape[-3:]
    p = F.pad(m, (1, 1, 1, 1, 1, 1))  # zero border
    eroded = (
        m
        & p[..., 0:d, 1:h + 1, 1:w + 1] & p[..., 2:d + 2, 1:h + 1, 1:w + 1]
        & p[..., 1:d + 1, 0:h, 1:w + 1] & p[..., 1:d + 1, 2:h + 2, 1:w + 1]
        & p[..., 1:d + 1, 1:h + 1, 0:w] & p[..., 1:d + 1, 1:h + 1, 2:w + 2]
    )
    return m & ~eroded


def squared_edt(points: torch.Tensor, spacing: Tuple[float, float, float]) -> torch.Tensor:
    """Exact anisotropic squared EDT to the True voxels of ``points``,
    [D,H,W] or a stack of volumes [V,D,H,W] (each transformed on its own).

    A volume without points yields +inf everywhere. The result is contiguous.
    """
    if points.dim() == 3:
        return squared_edt_volumes(points[None].contiguous(), spacing)[0]
    return squared_edt_volumes(points.contiguous(), spacing)


def _masked_percentile(values: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """np.percentile(values[mask], q) with linear interpolation along the
    last axis; +inf where the mask is empty. values/mask: [N] or [P, N]. The
    count stays on the device: an empty mask clamps the indices to 0 and the
    result is replaced by +inf."""
    v = torch.sort(torch.where(mask, values, _INF), dim=-1).values
    k = mask.sum(dim=-1)
    pos = (k.to(values.dtype) - 1.0) * (q / 100.0)
    lo = torch.floor(pos).to(torch.int64).clamp(min=0)
    hi = torch.ceil(pos).to(torch.int64).clamp(min=0)
    vlo = v.gather(-1, lo[..., None])[..., 0]
    vhi = v.gather(-1, hi[..., None])[..., 0]
    w = pos - lo.to(values.dtype)
    return torch.where(k > 0, vlo * (1.0 - w) + vhi * w, _INF)


def _pair_metrics(pred, gt, spacing, percentile: float, symmetric_asd: bool, tol):
    """pred/gt: [P, D, H, W] bool; tol: None or [P] f32. Returns [P] tensors
    (hd95, asd) or (hd95, asd, nsd). The distance sums are taken in f64 and
    the mean rounded once to f32."""
    p = pred.shape[0]
    surf = extract_surface(torch.cat([gt, pred]))  # [2P, D, H, W]: gt surfaces, then pred surfaces
    dist = squared_edt_volumes(surf, spacing, sqrt=True).reshape(2 * p, -1)  # fields to them
    surf = surf.reshape(2 * p, -1)
    # row k: the pred-surface voxels of pair k in the field to its gt surface
    # (pred->gt distances); row P + k: its gt-surface voxels in the field to
    # the pred surface (gt->pred distances)
    at = torch.cat([surf[p:], surf[:p]])

    hd = _masked_percentile(dist, at, percentile)
    hd95 = torch.maximum(hd[:p], hd[p:])
    count = at.sum(dim=-1)
    total = torch.where(at, dist, 0.0).sum(dim=-1, dtype=torch.float64)
    n1, n2 = count[:p], count[p:]
    sum1, sum2 = total[:p], total[p:]
    if symmetric_asd:
        asd = torch.where(n1 + n2 > 0, (sum1 + sum2) / (n1 + n2).clamp(min=1), _INF)
    else:
        asd = torch.where(n1 > 0, sum1 / n1.clamp(min=1), _INF)
    # any empty surface on a referenced side -> inf (host applies penalties)
    hd95 = torch.where((n1 > 0) & (n2 > 0), hd95, _INF)
    asd = torch.where(n2 > 0, asd, _INF).to(dist.dtype)
    if tol is None:
        return hd95, asd

    hits = (at & (dist <= torch.cat([tol, tol])[:, None])).sum(dim=-1)
    hits = (hits[:p] + hits[p:]).to(dist.dtype)
    nsd = torch.where(n1 + n2 > 0, hits / (n1 + n2).clamp(min=1), _INF)
    return hd95, asd, nsd


def surface_metrics_single(
    pred: torch.Tensor,
    gt: torch.Tensor,
    spacing: Tuple[float, float, float],
    *,
    percentile: float = 95.0,
    symmetric_asd: bool = False,
    nsd_tol=None,
):
    """HD95 and ASD (and optionally NSD) for one region pair pred/gt
    [D,H,W] {0,1}: the one-pair case of ``batched_surface_metrics``.

    Returns (hd95, asd) 0-dim tensors, +inf when either surface is empty.
    With ``nsd_tol`` (a tolerance in the same physical units as ``spacing``,
    a number or a 0-dim tensor) returns (hd95, asd, nsd) where

        nsd = (|{p in S_pred : d(p, S_gt) <= tol}| +
               |{g in S_gt  : d(g, S_pred) <= tol}|) / (|S_pred| + |S_gt|)

    — one empty surface gives 0 (the infinite distance field counts no voxel
    as within tolerance), both empty gives +inf for the host layer to
    sanitize. The NSD reuses the two distance fields HD95/ASD computed.
    """
    tol = None
    if nsd_tol is not None:
        tol = torch.as_tensor(nsd_tol, dtype=torch.float32, device=pred.device).reshape(1)
    res = _pair_metrics((pred > 0.5)[None], (gt > 0.5)[None], spacing, percentile, symmetric_asd, tol)
    return tuple(x[0] for x in res)


def batched_surface_metrics(
    pred: torch.Tensor,
    gt: torch.Tensor,
    *,
    spacing: Tuple[float, float, float],
    percentile: float = 95.0,
    symmetric_asd: bool = False,
    nsd_tol=None,
):
    """pred/gt: [B, D, H, W, R] {0,1} -> (hd95 [B,R], asd [B,R]).

    With ``nsd_tol`` (scalar, or per-region sequence of length R) also
    returns nsd [B,R]. All B*R (sample, region) pairs of a group are
    processed together (one distance transform of their 2*B*R surfaces, one
    sort); groups are cut so that the temporaries of one stay under a fixed
    byte budget. The results stay on the device.
    """
    b, r = pred.shape[0], pred.shape[-1]
    vol = tuple(pred.shape[1:4])
    # pair index = i * r + region
    pr = (pred > 0.5).movedim(-1, 1).reshape((b * r,) + vol)
    gr = (gt > 0.5).movedim(-1, 1).reshape((b * r,) + vol)
    tol = None
    if nsd_tol is not None:
        tol = torch.as_tensor(nsd_tol, dtype=torch.float32).reshape(-1).expand(r).repeat(b).to(pred.device)
    group = max(1, _GROUP_BYTES // (_PAIR_BYTES_PER_VOXEL * vol[0] * vol[1] * vol[2]))
    out = [_pair_metrics(pr[k:k + group], gr[k:k + group], spacing, percentile, symmetric_asd,
                         None if tol is None else tol[k:k + group])
           for k in range(0, b * r, group)]
    return tuple(torch.cat(parts).reshape(b, r) for parts in zip(*out))
