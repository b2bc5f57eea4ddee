"""3D residual UNet — the flagship segmentation model (the port of
``multimodal_tta_tpu/models/unet3d.py``).

The module tree carries flax's names (``enc0.unit0.conv``,
``enc0.unit0.n.norm.scale``, ``enc0.residual_proj``, ``up0.up``, ``dec0``,
``bottleneck``, ``head``), so the flagship has the reference's 82 parameter
tensors, 36 of them norm affines, and ``models/convert.py`` maps flax
params onto it by name. ``forward`` takes and returns NDHWC. ``remat``:
``True`` rematerializes every level's blocks (the bottleneck's too), an
int n the blocks of the n highest-resolution levels, the reference's rule.

Two training options of the reference:
  * ``moe_experts > 0``: a pre-norm residual MoE token FFN over the
    bottleneck's positions (``moe_ln``, then ``moe_bottleneck``, a
    ``models/moe.py:MoEMlp`` with expert hidden ``moe_mlp_mult`` x the
    bottleneck channels), in every forward, outside remat;
  * ``deep_supervision = k``: 1x1x1 f32 heads ``ds_head{i}`` on the decoder
    output at R/2^i for i in 1..min(k, levels - 1). They exist from
    construction (flax's init creates them) and run only in a training
    forward inside ``layers.capture_intermediates`` (``SegTrainer``'s
    step), after the level's block and outside its remat, sowing ``ds{i}``;
    an eval, TTA or serving forward computes the logits alone.

Over the space axis (``parallel/space.py``, ambient inside
``space.sharded(mesh)``) ``x`` is this rank's depth slab: each level is
split or whole by the reference's rule (``space.level_axes``), an encoder
stage whose output level is whole takes its input gathered, and an ``up``
whose output level is split keeps its slab of the whole output; the skip
concatenation is local. The bottleneck MoE takes the bottleneck level's
axis: a split level's tokens are this rank's block of each sequence
(``models/moe.py``), a whole level's are every rank's alike. A ``ds{i}``
head is per voxel: on a split level it sows this rank's slab of the
logits, on a whole level the whole logits (``SegTrainer`` counts such a
term once).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .. import DeviceLike, resolve_device
from ..registry import register_model
from ..utils.config import get_config
from ..parallel import space as sp
from .layers import (ConvBlock, LayerNorm, ResidualUnit, TransposedConvUp, capturing, head_linear,
                     init_flax_defaults, remat_call, sow)
from .moe import MoEMlp


def remat_levels(remat, n_levels: int) -> int:
    """How many resolution levels are rematerialized: ``True`` all of them
    (the bottleneck, at level ``n_levels``, too), an int n the n highest,
    where the activation memory is (the reference's rule)."""
    return n_levels + 1 if remat is True else int(remat or 0)


def finish_model(model: nn.Module, seed: Optional[int], device: DeviceLike,
                 memory_format: torch.memory_format = torch.channels_last_3d) -> None:
    """The last step of every model's constructor: flax's initialisers from
    ``seed`` (``None`` leaves the params for an enclosing model to set),
    inference mode (the reference's ``train=False``; ``SegTrainer`` switches
    to training for its step), and the params on ``device`` with conv
    kernels in ``channels_last_3d`` (``channels_last`` for the 2D
    classifiers), the memory order of the activations."""
    if seed is not None:
        init_flax_defaults(model, seed)
    model.eval()
    model.to(device=resolve_device(device), memory_format=memory_format)


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
        moe_k: int = 1,
        moe_capacity_factor: float = 1.25,
        moe_mlp_mult: float = 2.0,
        *,
        device: DeviceLike = "cuda",
        seed: Optional[int] = 0,
    ):
        super().__init__()
        if spatial_dims != 3:
            raise ValueError("UNet3D supports spatial_dims=3 only")
        if len(strides) != len(channels) - 1:
            raise ValueError(
                f"len(strides)={len(strides)} must equal len(channels)-1={len(channels) - 1}"
            )
        resolve_device(device)
        self.remat = remat
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
        self.moe_experts = int(moe_experts)
        if self.moe_experts > 0:
            self.moe_ln = LayerNorm(chs[n], dtype)
            self.moe_bottleneck = MoEMlp(chs[n], int(moe_mlp_mult * chs[n]), self.moe_experts, moe_k,
                                         moe_capacity_factor, dtype=dtype)
        for i in range(n):
            self.add_module(f"up{i}", TransposedConvUp(chs[i + 1], chs[i], sts[i], dtype=dtype))
            skip = chs[i - 1] if i > 0 else self.in_channels
            self.add_module(f"dec{i}", block(chs[i] + skip, chs[i], 1))
        self.ds_levels = min(int(deep_supervision or 0), n - 1)
        for i in range(1, self.ds_levels + 1):
            self.add_module(f"ds_head{i}", nn.Conv3d(chs[i], self.num_classes, 1, bias=True))
        self.head = nn.Conv3d(chs[0], self.num_classes, 1, bias=True)
        finish_model(self, seed, device)

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
            moe_k=int(get_config(cfg, "moe_k", 1)),
            moe_capacity_factor=float(get_config(cfg, "moe_capacity_factor", 1.25)),
            moe_mlp_mult=float(get_config(cfg, "moe_mlp_mult", 2.0)),
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
        space = sp.current()
        for ax, dim in enumerate(x.shape[1:4]):
            dim = dim * (space.size if space is not None and ax == 0 else 1)
            if dim % total_stride != 0:
                raise ValueError(
                    f"UNet3D spatial dim {ax} = {dim} must be divisible by the total "
                    f"downsampling factor {total_stride} (strides={list(self.strides)})"
                )
        n = len(self.strides)
        levels = remat_levels(self.remat, n)
        axes = sp.level_axes(space, x.shape[1], self.strides)  # each level's axis, None where it is whole
        x = x.to(self.dtype).permute(0, 4, 1, 2, 3)  # NCDHW view of NDHWC memory
        skips = []
        h = x
        for i in range(n):
            if axes[i] is not None and axes[i + 1] is None:
                h = sp.gather_depth(h, space)  # the stage's output level is whole
            h = remat_call(getattr(self, f"enc{i}"), h, axes[i + 1], enabled=i < levels)
            skips.append(h)
        h = remat_call(self.bottleneck, h, axes[n], enabled=n < levels)
        if self.moe_experts > 0:
            b, c = h.shape[:2]
            tokens = h.permute(0, 2, 3, 4, 1).reshape(b, -1, c)  # [B, D*H*W, C] in flax's raster order
            tokens = tokens + self.moe_bottleneck(self.moe_ln(tokens), space=axes[n])
            h = tokens.reshape(b, *h.shape[2:], c).permute(0, 4, 1, 2, 3)
        heads = self.training and capturing()
        for i in reversed(range(n)):
            h = getattr(self, f"up{i}")(h)
            if axes[i + 1] is None and axes[i] is not None:
                h = sp.slice_depth(h, space)  # this rank's slab of a whole level's output
            skip = skips[i - 1] if i > 0 else x
            h = remat_call(getattr(self, f"dec{i}"), torch.cat([h, skip], dim=1), axes[i], enabled=i < levels)
            if heads and 1 <= i <= self.ds_levels:
                sow(f"ds{i}", head_linear(h, getattr(self, f"ds_head{i}")))
        return head_linear(h, self.head)
