"""SegResNet, Myronenko 2018 without the VAE branch (the port of
``multimodal_tta_tpu/models/segresnet.py``), registered as ``segresnet``.

  - a stem conv to ``init_filters``; encoder stages double the channels
    with a stride-2 conv, then ``blocks_down[i]`` pre-activation residual
    blocks (norm -> act -> conv, twice, identity add);
  - decoder stages halve the channels with a 1x1x1 conv, upsample nearest
    2x and ADD the encoder skip, then ``blocks_up[j]`` blocks;
  - a final norm -> act -> 1x1x1 f32 head.

The norm is GroupNorm by default (``F.group_norm`` in f32, no kernel).
Remat: ``True`` all stages, an int n the n highest-resolution ones (a
decoder stage counts as the stage it upsamples to). With 4 inputs and 3
classes: 83 parameter tensors, 50 of them norm affines. ``forward`` takes
and returns NDHWC.

Over the space axis (``parallel/space.py``) ``x`` is this rank's depth
slab and each stage's level is split or whole by the flagship's rule
(``space.level_axes``, strides 2): the 3x3x3 convs take halos, a ``down``
conv whose output level is whole takes its input gathered, the group norms'
statistics span the space group (``layers.GroupNorm``), and a decoder
stage that upsamples a whole level into a split one keeps its slab of the
repeat before the additive skip.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .. import DeviceLike, resolve_device
from ..registry import register_model
from ..utils.config import get_config
from ..parallel import space as sp
from .layers import Norm, check_dropout, conv3d_same, get_act, head_linear, remat_call, repeat_nearest
from .unet3d import finish_model


class PreActResBlock(nn.Module):
    """norm -> act -> conv3 -> norm -> act -> conv3, identity add."""

    def __init__(self, features: int, norm: str = "GROUP", act: str = "RELU", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.relu = str(act).upper() == "RELU"
        self.act = get_act(act)
        self.n0 = Norm(norm, features)
        self.conv0 = nn.Conv3d(features, features, 3, bias=False)
        self.n1 = Norm(norm, features)
        self.conv1 = nn.Conv3d(features, features, 3, bias=False)

    def _norm_act(self, n: Norm, x: torch.Tensor, space) -> torch.Tensor:
        return n(x, relu=True, space=space) if self.relu else self.act(n(x, space=space))

    def forward(self, x: torch.Tensor, space=None) -> torch.Tensor:
        """``space``: the level's space axis when ``x`` is a depth slab."""
        y = conv3d_same(self._norm_act(self.n0, x, space), self.conv0, self.dtype, space)
        y = conv3d_same(self._norm_act(self.n1, y, space), self.conv1, self.dtype, space)
        return x + y


@register_model("segresnet")
class SegResNet(nn.Module):
    def __init__(
        self,
        in_channels: int = 2,
        num_classes: int = 1,
        init_filters: int = 16,
        blocks_down: Sequence[int] = (1, 2, 2, 4),
        blocks_up: Sequence[int] = (1, 1, 1),
        norm: str = "GROUP",
        act: str = "RELU",
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
        self.blocks_down = tuple(int(b) for b in blocks_down)
        self.blocks_up = tuple(int(b) for b in blocks_up)
        if len(self.blocks_up) != len(self.blocks_down) - 1:
            raise ValueError(f"len(blocks_up)={len(self.blocks_up)} must equal "
                             f"len(blocks_down)-1={len(self.blocks_down) - 1}")
        self.dropout = float(dropout)
        self.dtype = dtype
        self.remat = remat
        self.relu = str(act).upper() == "RELU"
        self.act = get_act(act)
        f0 = int(init_filters)
        self.stem = nn.Conv3d(self.in_channels, f0, 3, bias=False)
        for i, n_blocks in enumerate(self.blocks_down):
            feat = f0 * 2 ** i
            if i > 0:
                self.add_module(f"down{i}", nn.Conv3d(feat // 2, feat, 3, stride=2, bias=False))
            for b in range(n_blocks):
                self.add_module(f"enc{i}_{b}", PreActResBlock(feat, norm, act, dtype))
        n_stages = len(self.blocks_down)
        for j, n_blocks in enumerate(self.blocks_up):
            i = n_stages - 1 - j
            feat = f0 * 2 ** (i - 1)
            self.add_module(f"up_proj{i}", nn.Conv3d(feat * 2, feat, 1, bias=False))
            for b in range(n_blocks):
                self.add_module(f"dec{i}_{b}", PreActResBlock(feat, norm, act, dtype))
        self.final_norm = Norm(norm, f0)
        self.head = nn.Conv3d(f0, self.num_classes, 1, bias=True)
        finish_model(self, seed, device)

    @classmethod
    def from_config(cls, cfg, **overrides) -> "SegResNet":
        kw = dict(
            in_channels=int(get_config(cfg, "in_channels", 2)),
            num_classes=int(get_config(cfg, "num_classes", 1)),
            init_filters=int(get_config(cfg, "init_filters", 16)),
            blocks_down=tuple(int(b) for b in get_config(cfg, "blocks_down", [1, 2, 2, 4])),
            blocks_up=tuple(int(b) for b in get_config(cfg, "blocks_up", [1, 1, 1])),
            norm=str(get_config(cfg, "norm", "GROUP")),
            act=str(get_config(cfg, "act", "RELU")),
            dropout=float(get_config(cfg, "dropout", 0.0)),
        )
        kw.update(overrides)
        return cls(**kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, D, H, W, C_in] -> logits [B, D, H, W, num_classes] (f32)."""
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"SegResNet expects {self.in_channels} input channels, got {x.shape[-1]}")
        n_stages = len(self.blocks_down)
        total_stride = 2 ** (n_stages - 1)
        space = sp.current()
        for ax, dim in enumerate(x.shape[1:4]):
            dim = dim * (sp.space_size(space) if ax == 0 else 1)  # the whole depth
            if dim % total_stride != 0:
                raise ValueError(f"SegResNet spatial dim {ax} = {dim} must be divisible by "
                                 f"{total_stride} ({n_stages} stages)")
        stages = n_stages if self.remat is True else int(self.remat or 0)
        axes = sp.level_axes(space, x.shape[1], [2] * (n_stages - 1))  # each stage's axis, None where whole
        x = x.to(self.dtype).permute(0, 4, 1, 2, 3)  # NCDHW view of NDHWC memory
        h = conv3d_same(x, self.stem, self.dtype, axes[0])
        check_dropout(self, self.dropout)

        skips = []
        for i, n_blocks in enumerate(self.blocks_down):
            if i > 0:
                if axes[i - 1] is not None and axes[i] is None:
                    h = sp.gather_depth(h, space)  # the stage's level is whole
                h = conv3d_same(h, getattr(self, f"down{i}"), self.dtype, axes[i])
            for b in range(n_blocks):
                h = remat_call(getattr(self, f"enc{i}_{b}"), h, axes[i], enabled=i < stages)
            skips.append(h)

        for j, n_blocks in enumerate(self.blocks_up):
            i = n_stages - 1 - j
            h = repeat_nearest(conv3d_same(h, getattr(self, f"up_proj{i}"), self.dtype, axes[i]), (2, 2, 2))
            if axes[i] is None and axes[i - 1] is not None:
                h = sp.slice_depth(h, space)  # this rank's slab of the whole level's repeat
            h = h + skips[i - 1]
            for b in range(n_blocks):
                h = remat_call(getattr(self, f"dec{i}_{b}"), h, axes[i - 1], enabled=i - 1 < stages)

        if self.relu:
            h = self.final_norm(h, relu=True, space=axes[0])
        else:
            h = self.act(self.final_norm(h, space=axes[0]))
        return head_linear(h, self.head)
