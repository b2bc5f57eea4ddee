"""SSIM / MS-SSIM for 2D and 3D volumes (the port of
``multimodal_tta_tpu/ops/ssim.py``; nothing calls them, in the reference
either).

Separable Gaussian filtering (win_size 11, sigma 1.5), per-channel maps with
the channel-last layout, ``data_range`` scaling and the 5-scale MS-SSIM
weights; 2D or 3D by the input's rank: [B, H, W, C] or [B, D, H, W, C]. The
valid-mode blur is ``F.conv1d`` along each spatial axis, the 2x average pool
between scales ``F.avg_pool2d`` / ``3d``. On the card cuDNN takes an f32
convolution in TF32 unless ``torch.backends.cudnn.allow_tf32`` is off;
results are held to the CPU's with it off.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_kernel1d(size: int, sigma: float, device: torch.device) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
    return g / torch.sum(g)


def _filter_separable(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Valid-mode separable Gaussian blur over every spatial axis of
    [B, *spatial, C]."""
    k = kernel.shape[0]
    for ax in range(1, x.dim() - 1):
        x = torch.movedim(x, ax, -1)
        shape = x.shape
        out = F.conv1d(x.reshape(-1, 1, shape[-1]), kernel.reshape(1, 1, k))  # [N, 1, L] as NCW
        x = torch.movedim(out.reshape(shape[:-1] + (shape[-1] - k + 1,)), -1, ax)
    return x


def _ssim_maps(x: torch.Tensor, y: torch.Tensor, data_range: float, win_size: int, win_sigma: float, k1: float,
               k2: float) -> Tuple[torch.Tensor, torch.Tensor]:
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    kernel = _gaussian_kernel1d(win_size, win_sigma, x.device)

    mu_x = _filter_separable(x, kernel)
    mu_y = _filter_separable(y, kernel)
    mu_xx = _filter_separable(x * x, kernel)
    mu_yy = _filter_separable(y * y, kernel)
    mu_xy = _filter_separable(x * y, kernel)

    sigma_x = mu_xx - mu_x * mu_x
    sigma_y = mu_yy - mu_y * mu_y
    sigma_xy = mu_xy - mu_x * mu_y

    cs_map = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    ssim_map = ((2 * mu_x * mu_y + c1) / (mu_x * mu_x + mu_y * mu_y + c1)) * cs_map
    return ssim_map, cs_map


def _check(x: torch.Tensor, y: torch.Tensor, what: str) -> None:
    if x.shape != y.shape:
        raise ValueError(f"{what} shape mismatch: {tuple(x.shape)} vs {tuple(y.shape)}")
    if x.dim() not in (4, 5):
        raise ValueError(f"{what} expects [B,H,W,C] or [B,D,H,W,C], got ndim={x.dim()}")


def ssim(x: torch.Tensor, y: torch.Tensor, *, data_range: float = 1.0, win_size: int = 11, win_sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03, size_average: bool = True) -> torch.Tensor:
    """SSIM over [B, *spatial, C] inputs (2D or 3D spatial), in f32."""
    _check(x, y, "ssim")
    ssim_map, _ = _ssim_maps(x.float(), y.float(), data_range, win_size, win_sigma, k1, k2)
    per_sample = torch.mean(ssim_map, dim=tuple(range(1, ssim_map.dim())))
    return torch.mean(per_sample) if size_average else per_sample


def _avg_pool2x(x: torch.Tensor) -> torch.Tensor:
    """2x average pool of every spatial axis of [B, *spatial, C] (valid)."""
    pool = F.avg_pool2d if x.dim() == 4 else F.avg_pool3d
    return torch.movedim(pool(torch.movedim(x, -1, 1), 2, 2), 1, -1)


def ms_ssim(x: torch.Tensor, y: torch.Tensor, *, data_range: float = 1.0, win_size: int = 11,
            win_sigma: float = 1.5, weights: Optional[Sequence[float]] = None, k1: float = 0.01, k2: float = 0.03,
            size_average: bool = True) -> torch.Tensor:
    """Multi-scale SSIM with a 2x average pool between scales."""
    _check(x, y, "ms_ssim")
    weights = _MSSSIM_WEIGHTS if weights is None else weights
    weights_t = torch.tensor([float(w) for w in weights], dtype=torch.float32, device=x.device)
    n_scales = len(weights)

    min_side = min(x.shape[1:-1])
    need = (win_size + 1) * (2 ** (n_scales - 1))
    if min_side <= need - 2:
        raise ValueError(f"ms_ssim: smallest spatial side {min_side} too small for {n_scales} scales "
                         f"with win_size {win_size} (needs > {need - 2})")

    x, y = x.float(), y.float()
    mcs = []
    for i in range(n_scales):
        ssim_map, cs_map = _ssim_maps(x, y, data_range, win_size, win_sigma, k1, k2)
        dims = tuple(range(1, ssim_map.dim()))
        if i < n_scales - 1:
            mcs.append(torch.clamp(torch.mean(cs_map, dim=dims), min=0.0))
            x, y = _avg_pool2x(x), _avg_pool2x(y)
        else:
            last = torch.clamp(torch.mean(ssim_map, dim=dims), min=0.0)

    stacked = torch.stack(mcs + [last], dim=0)  # [S, B]
    per_sample = torch.prod(stacked ** weights_t[:, None], dim=0)
    return torch.mean(per_sample) if size_average else per_sample


class SSIM:
    """Callable wrapper mirroring the reference's SSIM module API."""

    def __init__(self, data_range: float = 1.0, size_average: bool = True, win_size: int = 11,
                 win_sigma: float = 1.5):
        self.kw = dict(data_range=data_range, size_average=size_average, win_size=win_size, win_sigma=win_sigma)

    def __call__(self, x, y):
        return ssim(x, y, **self.kw)


class MS_SSIM:
    def __init__(self, data_range: float = 1.0, size_average: bool = True, win_size: int = 11,
                 win_sigma: float = 1.5, weights=None):
        self.kw = dict(data_range=data_range, size_average=size_average, win_size=win_size, win_sigma=win_sigma,
                       weights=weights)

    def __call__(self, x, y):
        return ms_ssim(x, y, **self.kw)
