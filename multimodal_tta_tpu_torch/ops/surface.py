"""Surface-distance metrics (HD95 / ASD / NSD) on the device (the port of
``multimodal_tta_tpu/ops/surface.py``).

  1. surface extraction = mask & ~erode(mask) with a 6-connected cross
     element and zero border (scipy/MONAI convention)
  2. EXACT anisotropic squared euclidean distance transform via three
     separable min-plus passes: along each axis,
     ``g[i] = min_j (f[j] + ((i-j)*spacing)^2)``. For CUDA tensors each pass
     launches the hand-written kernel behind ``kernels.edt_minplus.minplus``.
  3. directed distances gathered at the other mask's surface voxels;
     HD95 = max of the two directed 95th percentiles (numpy-style linear
     interpolation); ASD = mean of pred->gt distances (symmetric: both
     directions pooled); NSD (normalized surface Dice at tolerance tau,
     Nikolov et al. 2018) = the fraction of surface voxels, pooled over both
     surfaces, whose distance to the OTHER surface is <= tau.

Empty masks produce +inf (NSD: one-sided empty -> 0, both empty -> +inf),
which the evaluation layer replaces with the volume-diagonal penalty
(NSD: 0). Nothing here reads a value back to the host: emptiness is handled
with ``torch.where`` on the device.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels.edt_minplus import minplus

_INF = float("inf")


def extract_surface(mask: torch.Tensor) -> torch.Tensor:
    """mask: [D,H,W] {0,1}. Surface = fg voxels with a bg 6-neighbor
    (border counts as bg, matching binary_erosion's border_value=0)."""
    m = mask > 0.5
    d, h, w = m.shape
    p = F.pad(m, (1, 1, 1, 1, 1, 1))  # zero border
    eroded = (
        m
        & p[0:d, 1:h + 1, 1:w + 1] & p[2:d + 2, 1:h + 1, 1:w + 1]
        & p[1:d + 1, 0:h, 1:w + 1] & p[1:d + 1, 2:h + 2, 1:w + 1]
        & p[1:d + 1, 1:h + 1, 0:w] & p[1:d + 1, 1:h + 1, 2:w + 2]
    )
    return m & ~eroded


def _minplus_lastaxis(f: torch.Tensor, spacing: float) -> torch.Tensor:
    """1-D sampled-function squared-distance transform along the LAST axis.

    f: contiguous [..., n] f32 squared-distance estimates; returns
    g[..., i] = min_j f[..., j] + ((i-j)*spacing)^2.
    """
    n = f.shape[-1]
    i = torch.arange(n, dtype=f.dtype, device=f.device)
    cost = ((i[None, :] - i[:, None]) * spacing) ** 2  # [j, i]
    return minplus(f.reshape(-1, n), cost).reshape(f.shape)


def squared_edt(points: torch.Tensor, spacing: Tuple[float, float, float]) -> torch.Tensor:
    """Exact anisotropic squared EDT to the True voxels of ``points`` [D,H,W].

    All-False input yields +inf everywhere. Each axis is moved to the last
    position and copied contiguous for the line kernel (three copies per
    transform; the result of the last pass is already in [D,H,W] order).
    """
    f = torch.where(points > 0.5, 0.0, _INF).to(torch.float32)
    for ax in range(3):
        f = f.movedim(ax, -1).contiguous()
        f = _minplus_lastaxis(f, float(spacing[ax]))
        f = f.movedim(-1, ax)
    return f


def _masked_percentile(values: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """np.percentile(values[mask], q) with linear interpolation; +inf when the
    mask is empty. values/mask are flat tensors of equal length. The count
    stays on the device: an empty mask clamps the indices to 0 and the
    result is replaced by +inf."""
    v = torch.where(mask, values, _INF)
    v, _ = torch.sort(v)
    k = mask.sum()
    pos = (k.to(values.dtype) - 1.0) * (q / 100.0)
    lo = torch.floor(pos).to(torch.int64).clamp(min=0)
    hi = torch.ceil(pos).to(torch.int64).clamp(min=0)
    vlo = v[lo]
    vhi = v[hi]
    w = pos - lo.to(values.dtype)
    return torch.where(k > 0, vlo * (1.0 - w) + vhi * w, _INF)


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
    [D,H,W] {0,1}.

    Returns (hd95, asd) 0-dim tensors, +inf when either surface is empty.
    With ``nsd_tol`` (a tolerance in the same physical units as ``spacing``,
    a number or a 0-dim tensor) returns (hd95, asd, nsd) where

        nsd = (|{p in S_pred : d(p, S_gt) <= tol}| +
               |{g in S_gt  : d(g, S_pred) <= tol}|) / (|S_pred| + |S_gt|)

    — one empty surface gives 0 (the infinite distance field counts no voxel
    as within tolerance), both empty gives +inf for the host layer to
    sanitize. The NSD reuses the two distance fields HD95/ASD computed.
    """
    s_pred = extract_surface(pred)
    s_gt = extract_surface(gt)

    d_to_gt = torch.sqrt(squared_edt(s_gt, spacing))  # distance field to gt surface
    d_to_pred = torch.sqrt(squared_edt(s_pred, spacing))

    sp = s_pred.reshape(-1)
    sg = s_gt.reshape(-1)
    d1 = d_to_gt.reshape(-1)  # at pred-surface voxels: pred->gt distances
    d2 = d_to_pred.reshape(-1)  # at gt-surface voxels: gt->pred distances

    hd_a = _masked_percentile(d1, sp, percentile)
    hd_b = _masked_percentile(d2, sg, percentile)
    hd95 = torch.maximum(hd_a, hd_b)

    n1 = sp.sum()
    n2 = sg.sum()
    sum1 = torch.where(sp, d1, 0.0).sum()
    sum2 = torch.where(sg, d2, 0.0).sum()
    if symmetric_asd:
        asd = torch.where(n1 + n2 > 0, (sum1 + sum2) / (n1 + n2).clamp(min=1), _INF)
    else:
        asd = torch.where(n1 > 0, sum1 / n1.clamp(min=1), _INF)
    # any empty surface on a referenced side -> inf (host applies penalties)
    hd95 = torch.where((n1 > 0) & (n2 > 0), hd95, _INF)
    asd = torch.where(n2 > 0, asd, _INF)
    if nsd_tol is None:
        return hd95, asd

    tol = torch.as_tensor(nsd_tol, dtype=d1.dtype, device=d1.device)
    hits = torch.where(sp, (d1 <= tol).to(d1.dtype), 0.0).sum() + torch.where(
        sg, (d2 <= tol).to(d2.dtype), 0.0
    ).sum()
    nsd = torch.where(n1 + n2 > 0, hits / (n1 + n2).clamp(min=1), _INF)
    return hd95, asd, nsd


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
    returns nsd [B,R]. (sample, region) pairs go through one after another,
    so peak memory is one volume's transform; the results stay on the device.
    """
    b, r = pred.shape[0], pred.shape[-1]
    tol_r = None
    if nsd_tol is not None:
        tol_r = torch.as_tensor(nsd_tol, dtype=torch.float32).reshape(-1).expand(r).to(pred.device)
    out = []
    for i in range(b):
        for c in range(r):
            out.append(torch.stack(surface_metrics_single(
                pred[i, ..., c], gt[i, ..., c], spacing,
                percentile=percentile, symmetric_asd=symmetric_asd,
                nsd_tol=None if tol_r is None else tol_r[c],
            )))
    res = torch.stack(out).reshape(b, r, -1)
    return tuple(res[..., k] for k in range(res.shape[-1]))
