"""UNet3D-WS, the wide-stem (space-to-depth) UNet (the port of
``multimodal_tta_tpu/models/unet3d_ws.py``), registered as ``unet_ws``.

  - stem: a 2x2x2 space-to-depth packs the input to half resolution with 8x
    the channels before any convolution;
  - body: the residual UNet with one stride level fewer, all at half
    resolution or below, the same channel ladder;
  - head: 8 x num_classes at half resolution in f32, unpacked to full
    resolution by depth-to-space.

At full width (channels 32..512): 72 parameter tensors, 32 of them norm
affines, 16 norm calls a forward. ``remat`` is accepted and, as in the
reference, not used. ``forward`` takes and returns NDHWC.

Over the space axis (``parallel/space.py``) ``x`` is this rank's depth
slab. The levels are the input's, the stem's half resolution, then the
body's by ``strides[1:]``, each split or whole by the flagship's rule
(``space.level_axes``). On a split stem level the space-to-depth packing
and the head's unpacking are local (an even slab packs to its half); on a
whole one the input is gathered first and the logits sliced back to this
rank's slab. The body's transitions are the flagship's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .. import DeviceLike, resolve_device
from ..registry import register_model
from ..utils.config import get_config
from ..parallel import space as sp
from .layers import ResidualUnit, TransposedConvUp, head_linear
from .unet3d import finish_model


def space_to_depth_3d(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NDHWC [B,D,H,W,C] -> [B,D/r,H/r,W/r,C*r^3] (the reference's packing)."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // r, r, h // r, r, w // r, r, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, d // r, h // r, w // r, c * r ** 3)


def depth_to_space_3d(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """NDHWC [B,D,H,W,C*r^3] -> [B,D*r,H*r,W*r,C]."""
    b, d, h, w, cr = x.shape
    c = cr // r ** 3
    x = x.reshape(b, d, h, w, r, r, r, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, d * r, h * r, w * r, c)


@register_model("unet_ws")
class UNet3DWS(nn.Module):
    def __init__(
        self,
        in_channels: int = 2,
        num_classes: int = 1,
        channels: Sequence[int] = (32, 64, 128, 256, 512),
        strides: Sequence[int] = (2, 2, 2, 2),
        num_res_units: int = 2,
        act: str = "RELU",
        norm: str = "INSTANCE",
        dropout: float = 0.0,
        dtype: torch.dtype = torch.float32,
        remat=False,
        *,
        device: DeviceLike = "cuda",
        seed: Optional[int] = 0,
    ):
        super().__init__()
        resolve_device(device)
        self.in_channels = int(in_channels)
        self.num_classes = int(num_classes)
        self.channels = tuple(int(c) for c in channels)
        self.strides = tuple(int(s) for s in strides)
        self.dtype = dtype
        self.remat = remat  # the reference accepts it and does not use it
        chs, sts = self.channels, self.strides[1:]  # the stem takes one 2x level
        n = len(sts)

        def block(cin, feat, stride):
            return ResidualUnit(cin, feat, stride, subunits=max(1, num_res_units), norm=norm, act=act,
                                dropout=dropout, dtype=dtype)

        self.stem = block(8 * self.in_channels, chs[0], 1)
        for i in range(n):
            self.add_module(f"enc{i}", block(chs[i], chs[i + 1], sts[i]))
        self.bottleneck = block(chs[n], chs[-1], 1)
        for i in range(n):
            up_in = chs[-1] if i == n - 1 else chs[i + 2]
            self.add_module(f"up{i}", TransposedConvUp(up_in, chs[i + 1], sts[i], dtype=dtype))
            self.add_module(f"dec{i}", block(chs[i + 1] + chs[i], chs[i + 1], 1))
        self.head = nn.Conv3d(chs[1], self.num_classes * 8, 1, bias=True)
        finish_model(self, seed, device)

    @classmethod
    def from_config(cls, cfg, **overrides) -> "UNet3DWS":
        kw = dict(
            in_channels=int(get_config(cfg, "in_channels", 2)),
            num_classes=int(get_config(cfg, "num_classes", 1)),
            channels=tuple(int(c) for c in get_config(cfg, "channels", [32, 64, 128, 256, 512])),
            strides=tuple(int(s) for s in get_config(cfg, "strides", [2, 2, 2, 2])),
            num_res_units=int(get_config(cfg, "num_res_units", 2)),
            act=str(get_config(cfg, "act", "RELU")),
            norm=str(get_config(cfg, "norm", "INSTANCE")),
            dropout=float(get_config(cfg, "dropout", 0.0)),
        )
        kw.update(overrides)
        return cls(**kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, D, H, W, C_in] -> logits [B, D, H, W, num_classes] (f32)."""
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"UNet3DWS expects {self.in_channels} channels, got {x.shape[-1]}")
        space = sp.current()
        for ax, dim in enumerate(x.shape[1:4]):
            dim = dim * (sp.space_size(space) if ax == 0 else 1)  # the whole depth
            if dim % (2 * 2 ** (len(self.strides) - 1)) != 0:
                raise ValueError(f"spatial dim {ax}={dim} not divisible for the WS stem + strides")
        n = len(self.strides) - 1
        # the input level, the stem's half resolution, then the body's levels
        axes = sp.level_axes(space, x.shape[1], (2,) + self.strides[1:])
        gathered = axes[0] is not None and axes[1] is None
        x = x.to(self.dtype)
        if gathered:
            x = sp.gather_depth(x, space, dim=1)  # the stem level is whole
        h = space_to_depth_3d(x, 2).contiguous().permute(0, 4, 1, 2, 3)
        h = self.stem(h, axes[1])
        skips = [h]
        for i in range(n):
            if axes[i + 1] is not None and axes[i + 2] is None:
                h = sp.gather_depth(h, space)  # the stage's output level is whole
            h = getattr(self, f"enc{i}")(h, axes[i + 2])
            skips.append(h)
        h = self.bottleneck(h, axes[n + 1])
        for i in reversed(range(n)):
            h = getattr(self, f"up{i}")(h)
            if axes[i + 2] is None and axes[i + 1] is not None:
                h = sp.slice_depth(h, space)  # this rank's slab of a whole level's output
            h = getattr(self, f"dec{i}")(torch.cat([h, skips[i]], dim=1), axes[i + 1])
        out = depth_to_space_3d(head_linear(h, self.head), 2)
        return sp.slice_depth(out, space, dim=1) if gathered else out
