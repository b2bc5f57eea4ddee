"""3D residual UNet — the flagship segmentation model (the port of
``multimodal_tta_tpu/models/unet3d.py``).

The module tree carries flax's names (``enc0.unit0.conv``,
``enc0.unit0.n.norm.scale``, ``enc0.residual_proj``, ``up0.up``, ``dec0``,
``bottleneck``, ``head``), so the flagship has the reference's 82 parameter
tensors, 36 of them norm affines, and ``models/convert.py`` maps flax
params onto it by name. ``forward`` takes and returns NDHWC.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike, resolve_device
from ..registry import register_model
from ..utils.config import get_config
from .layers import ConvBlock, ResidualUnit, TransposedConvUp

# flax lecun_normal: truncated normal at +-2 sd, rescaled so the kept part
# has variance 1 / fan_in (jax.nn.initializers.variance_scaling)
_TRUNC_SD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    sd = math.sqrt(1.0 / fan_in) / _TRUNC_SD
    nn.init.trunc_normal_(w, mean=0.0, std=sd, a=-2.0 * sd, b=2.0 * sd, generator=gen)


@register_model("unet")
class UNet3D(nn.Module):
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
        spatial_dims: int = 3,
        dtype: torch.dtype = torch.float32,
        remat=False,
        deep_supervision: int = 0,
        moe_experts: int = 0,
        *,
        device: DeviceLike = "cuda",
        seed: int = 0,
    ):
        super().__init__()
        if spatial_dims != 3:
            raise ValueError("UNet3D supports spatial_dims=3 only")
        if len(strides) != len(channels) - 1:
            raise ValueError(
                f"len(strides)={len(strides)} must equal len(channels)-1={len(channels) - 1}"
            )
        for flag, what in ((remat, "remat"), (deep_supervision, "deep_supervision"),
                           (moe_experts, "moe_experts")):
            if flag:
                raise NotImplementedError(
                    f"UNet3D {what} is not ported yet (ROADMAP.md: training slice / "
                    f"remaining models)"
                )
        device = resolve_device(device)
        self.in_channels = int(in_channels)
        self.num_classes = int(num_classes)
        self.channels = tuple(int(c) for c in channels)
        self.strides = tuple(int(s) for s in strides)
        self.dtype = dtype
        chs, sts = self.channels, self.strides
        n = len(sts)

        def block(cin, feat, stride):
            if num_res_units > 0:
                return ResidualUnit(cin, feat, stride, subunits=num_res_units, norm=norm,
                                    act=act, dropout=dropout, dtype=dtype)
            return ConvBlock(cin, feat, strides=stride, norm=norm, act=act,
                             dropout=dropout, dtype=dtype)

        for i in range(n):
            self.add_module(f"enc{i}", block(self.in_channels if i == 0 else chs[i - 1], chs[i], sts[i]))
        self.bottleneck = block(chs[n - 1], chs[n], 1)
        for i in range(n):
            self.add_module(f"up{i}", TransposedConvUp(chs[i + 1], chs[i], sts[i], dtype=dtype))
            skip = chs[i - 1] if i > 0 else self.in_channels
            self.add_module(f"dec{i}", block(chs[i] + skip, chs[i], 1))
        self.head = nn.Conv3d(chs[0], self.num_classes, 1, bias=True)

        self._init_params(seed)
        # conv kernels in channels_last_3d, the memory order of the activations
        self.to(device=device, memory_format=torch.channels_last_3d)

    @torch.no_grad()
    def _init_params(self, seed: int) -> None:
        """flax's defaults from an explicit generator: lecun-normal kernels
        (fan_in = kernel volume x input features), zero biases, ones and
        zeros in the norms. The numbers differ from JAX's PRNG; the parity
        tests carry JAX's weights across with ``models/convert.py``."""
        gen = torch.Generator().manual_seed(int(seed))
        for m in self.modules():
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                in_axis = 1 if isinstance(m, nn.Conv3d) else 0
                fan_in = m.weight.shape[in_axis] * math.prod(m.kernel_size)
                _lecun_normal_(m.weight, fan_in, gen)
                if m.bias is not None:
                    m.bias.zero_()

    @classmethod
    def from_config(cls, cfg, **overrides) -> "UNet3D":
        """Build from a model config node (the reference's keys)."""
        kw = dict(
            in_channels=int(get_config(cfg, "in_channels", 2)),
            num_classes=int(get_config(cfg, "num_classes", 1)),
            channels=tuple(int(c) for c in get_config(cfg, "channels", [32, 64, 128, 256, 512])),
            strides=tuple(int(s) for s in get_config(cfg, "strides", [2, 2, 2, 2])),
            num_res_units=int(get_config(cfg, "num_res_units", 2)),
            act=str(get_config(cfg, "act", "RELU")),
            norm=str(get_config(cfg, "norm", "INSTANCE")),
            dropout=float(get_config(cfg, "dropout", 0.0)),
            spatial_dims=int(get_config(cfg, "spatial_dims", 3)),
            deep_supervision=int(get_config(cfg, "deep_supervision", 0)),
            moe_experts=int(get_config(cfg, "moe_experts", 0)),
        )
        kw.update(overrides)
        return cls(**kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, D, H, W, C_in] -> logits [B, D, H, W, num_classes] (f32).

        enc0..enc{n-1} downsample, the bottleneck keeps the deepest
        resolution, and the decoder mirrors with transposed-conv up + skip
        concat, the last stage concatenating the raw input."""
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"UNet3D expects {self.in_channels} input channels, got {x.shape[-1]}")
        total_stride = math.prod(self.strides)
        for ax, dim in enumerate(x.shape[1:4]):
            if dim % total_stride != 0:
                raise ValueError(
                    f"UNet3D spatial dim {ax} = {dim} must be divisible by the total "
                    f"downsampling factor {total_stride} (strides={list(self.strides)})"
                )
        n = len(self.strides)
        x = x.to(self.dtype).permute(0, 4, 1, 2, 3)  # NCDHW view of NDHWC memory
        skips = []
        h = x
        for i in range(n):
            h = getattr(self, f"enc{i}")(h)
            skips.append(h)
        h = self.bottleneck(h)
        for i in reversed(range(n)):
            h = getattr(self, f"up{i}")(h)
            skip = skips[i - 1] if i > 0 else x
            h = getattr(self, f"dec{i}")(torch.cat([h, skip], dim=1))
        # the f32 1x1x1 head as a matmul over the channels of the NDHWC view,
        # as XLA lowers the reference's 1x1x1 conv: cuDNN takes the weight
        # gradient of a one-output 1x1x1 conv in a direct kernel that cost
        # 148 of 227 ms in a batch-8 training step on an H100 (PERF.md)
        w = self.head.weight.reshape(self.num_classes, -1)
        return F.linear(h.permute(0, 2, 3, 4, 1).float(), w, self.head.bias)
