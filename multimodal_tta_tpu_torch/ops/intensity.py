"""On-device intensity normalization (the port of
``multimodal_tta_tpu/ops/intensity.py``).

Two modes, as in the reference:
  (A) intensity_policy: per-channel clip + masked z-score (stats over voxels
      above a threshold, falling back to all voxels when the mask has fewer
      than ``min_count`` members).
  (B) legacy per-channel (x - mean) / std.

Layout: channels-last. The normalizer built here takes a batch
``[B, *spatial, C]`` and takes its statistics per sample — the per-sample
application that the reference's Tent step writes as ``jax.vmap``. The
fallback is a ``torch.where`` select, so nothing waits on the device.

Over the space axis (``space=``, ``parallel/space.py``) the batch is this
rank's depth slab: the counts and sums of a statistic are summed over the
space group, the reference's formula kept (two all-reduces a call: the
means, then the squared deviations).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..parallel.space import space_size, space_sum


def zscore_masked(
    x: torch.Tensor,
    mask_gt: float,
    eps: float = 1e-6,
    min_count: int = 16,
    dim: Optional[Sequence[int]] = None,
    space=None,
) -> torch.Tensor:
    """Z-score ``x`` using stats over voxels > mask_gt, reduced over ``dim``
    (all dims when None). Falls back to whole-volume stats where fewer than
    ``min_count`` voxels pass the mask. With ``space`` the reduced dims hold
    this rank's slab of a volume split over the space axis."""
    dim = tuple(range(x.dim())) if dim is None else tuple(dim)
    if space is not None:
        return _zscore_masked_split(x, mask_gt, eps, min_count, dim, space)
    m = x > mask_gt
    cnt = m.sum(dim=dim, keepdim=True)
    use_mask = cnt >= min_count

    mf = m.to(x.dtype)
    n_masked = torch.clamp(cnt.to(x.dtype), min=1.0)
    mu_masked = (x * mf).sum(dim=dim, keepdim=True) / n_masked
    var_masked = (((x - mu_masked) ** 2) * mf).sum(dim=dim, keepdim=True) / n_masked

    mu_all = x.mean(dim=dim, keepdim=True)
    var_all = ((x - mu_all) ** 2).mean(dim=dim, keepdim=True)

    mu = torch.where(use_mask, mu_masked, mu_all)
    var = torch.where(use_mask, var_masked, var_all)
    sd = torch.clamp(torch.sqrt(var), min=eps)
    return (x - mu) / sd


def _zscore_masked_split(x, mask_gt, eps, min_count, dim, space) -> torch.Tensor:
    """``zscore_masked`` over a slab: the count, the masked sum and the sum
    summed over the space group, then the two squared deviations."""
    m = x > mask_gt
    mf = m.to(x.dtype)
    n_all = float(math.prod(x.shape[d] for d in dim) * space_size(space))
    first = space_sum(torch.stack([m.sum(dim=dim, keepdim=True).to(x.dtype), (x * mf).sum(dim=dim, keepdim=True),
                                   x.sum(dim=dim, keepdim=True)]), space)
    cnt, use_mask = first[0], first[0] >= min_count
    n_masked = torch.clamp(cnt, min=1.0)
    mu_masked, mu_all = first[1] / n_masked, first[2] / n_all
    second = space_sum(torch.stack([(((x - mu_masked) ** 2) * mf).sum(dim=dim, keepdim=True),
                                    ((x - mu_all) ** 2).sum(dim=dim, keepdim=True)]), space)
    mu = torch.where(use_mask, mu_masked, mu_all)
    var = torch.where(use_mask, second[0] / n_masked, second[1] / n_all)
    sd = torch.clamp(torch.sqrt(var), min=eps)
    return (x - mu) / sd


def _channel_rule(policy_channels: Dict[str, Any], name: str) -> Dict[str, Any]:
    rule = policy_channels.get(name, {})
    if hasattr(rule, "to_container"):
        rule = rule.to_container()
    return rule if isinstance(rule, dict) else {}


def _parse_rules(ip: Dict[str, Any], channel_names: Optional[Sequence[str]], c: int) -> List[Dict[str, Any]]:
    names: Optional[List[str]] = None
    if channel_names is not None:
        names = [str(x) for x in channel_names]
    elif isinstance(ip.get("channel_names"), (list, tuple)):
        names = [str(x) for x in ip["channel_names"]]
    local = names if names is not None else [str(i) for i in range(c)]
    if len(local) != c:
        raise ValueError(
            f"[intensity] len(channel_names)={len(local)} != C={c}; set "
            f"dataset.modality_order or transforms.channel_names to match"
        )
    channels_cfg = ip.get("channels", {}) or {}
    out = []
    for nm in local:
        rule = _channel_rule(channels_cfg, nm)
        clip = rule.get("clip", None)
        zc = rule.get("zscore", None)
        out.append({
            "clip": (float(clip[0]), float(clip[1]))
            if isinstance(clip, (list, tuple)) and len(clip) == 2 else None,
            "zscore": {
                "masked": bool(zc.get("masked", True)),
                "mask_gt": float(zc.get("mask_gt", float("-inf"))),
                "eps": float(zc.get("eps", 1e-6)),
                "min_count": int(zc.get("min_count", 16)),
            } if isinstance(zc, dict) else None,
        })
    return out


def make_intensity_normalizer(
    *,
    normalize: bool,
    intensity_policy: Optional[Any] = None,
    channel_names: Optional[Sequence[str]] = None,
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``f(x[B, *spatial, C], space=None) -> x[B, *spatial, C]`` with
    per-sample statistics (config semantics as in the reference); ``space``
    when ``x`` is this rank's depth slab (``parallel/space.py``)."""
    if not normalize:
        return lambda x, space=None: x

    ip: Dict[str, Any] = {}
    if intensity_policy is not None:
        ip = (intensity_policy.to_container() if hasattr(intensity_policy, "to_container")
              else dict(intensity_policy))

    if bool(ip.get("enabled", False)):

        def normalize_policy(x: torch.Tensor, space=None) -> torch.Tensor:
            c = x.shape[-1]
            rules = _parse_rules(ip, channel_names, c)
            per_sample = tuple(range(1, x.dim() - 1))
            outs = []
            for ci in range(c):
                ch = x[..., ci]
                rule = rules[ci]
                if rule["clip"] is not None:
                    ch = torch.clamp(ch, *rule["clip"])
                zc = rule["zscore"]
                if zc is not None:
                    if zc["masked"]:
                        ch = zscore_masked(ch, zc["mask_gt"], zc["eps"], zc["min_count"], dim=per_sample,
                                           space=space)
                    elif space is not None:
                        n = float(math.prod(ch.shape[1:]) * space_size(space))
                        mu = space_sum(ch.sum(dim=per_sample, keepdim=True), space) / n
                        var = space_sum(((ch - mu) ** 2).sum(dim=per_sample, keepdim=True), space) / n
                        ch = (ch - mu) / torch.clamp(torch.sqrt(var), min=zc["eps"])
                    else:
                        mu = ch.mean(dim=per_sample, keepdim=True)
                        sd = torch.clamp(ch.std(dim=per_sample, keepdim=True, correction=0), min=zc["eps"])
                        ch = (ch - mu) / sd
                outs.append(ch)
            return torch.stack(outs, dim=-1)

        return normalize_policy

    mean_l = [0.0] if mean is None else [float(m) for m in mean]
    std_l = [1.0] if std is None else [float(s) for s in std]

    def normalize_meanstd(x: torch.Tensor, space=None) -> torch.Tensor:
        c = x.shape[-1]
        mu = torch.tensor(mean_l * c if len(mean_l) == 1 else mean_l, dtype=x.dtype, device=x.device)
        sd = torch.tensor(std_l * c if len(std_l) == 1 else std_l, dtype=x.dtype, device=x.device)
        if mu.shape[0] != c or sd.shape[0] != c:
            raise ValueError(f"[intensity] mean/std length != C={c}")
        return (x - mu) / sd

    return normalize_meanstd
