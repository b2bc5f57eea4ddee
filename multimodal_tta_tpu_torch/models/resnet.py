"""ResNet classifier family (2D; the port of ``multimodal_tta_tpu/models/resnet.py``).

Registered names ``resnet18/34/50/101/152``. ``forward`` takes NHWC
``[B, H, W, C]`` and returns ``(pooled features [B, F], logits [B,
num_classes])`` in f32, the reference wrapper's contract; with
``reid_mode`` the features are the L2-normalized BNNeck embedding.

Module names are flax's (``stem``, ``stem_bn``, ``layer{L}_{J}`` with
``Conv_k`` / ``BatchNorm_k`` / ``downsample_conv`` / ``downsample_bn``,
``projection``, ``bnneck``, ``fc``), so ``models/convert.py`` carries the
reference's variables across and ``models/pretrained.py`` maps torchvision's
names onto them. Inside, activations are NCHW views of NHWC memory
(``channels_last``). Every BatchNorm is ``layers.BatchNorm`` (momentum 0.9,
eps 1e-5): running statistics in inference mode, the batch's in training.
This module also holds the 2D helpers the other classifiers share.

Over a space axis (inside ``space.sharded(mesh)``) ``x`` is this rank's
rows of the images (``Mesh.local`` cuts dim 1, the height). The model
lists the ``(stride, halo)`` of each op that reads a level
(``row_ops``: the stem, its max-pool, each block), ``space.row_axes``
plans which of them run on the rank's slab, and the first op that breaks
the height rule takes its input gathered and runs whole, as does every op
after it. A split conv or pool takes its neighbours' rows in place of its
padding along H (``conv2d``, ``max_pool``), a split mean sums over the
space group (``mean_hw``), and BatchNorm pools its sums over data x space
(``layers.BatchNorm``). The features come out whole on every rank of the
group.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike, resolve_device
from ..parallel import space as sp
from ..registry import register_model
from ..utils.config import get_config
from .layers import BatchNorm
from .unet3d import finish_model


def conv2d(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype, space=None) -> torch.Tensor:
    """``conv(x)`` in the compute dtype (flax ``nn.Conv(dtype=...)``) with
    the module's symmetric padding: the reference pads every 2D conv
    explicitly and symmetrically, or takes "SAME" where it is symmetric.
    With ``space`` ``x`` is this rank's slab of a split height: the conv
    takes its neighbours' rows (``space.row_halos``; zeros at the image's
    ends) in place of its padding along H and gives its slab of the whole
    conv's output."""
    b = None if conv.bias is None else conv.bias.to(dtype)
    x, pad = x.to(dtype), conv.padding
    if space is not None:
        x = sp.halo_exchange(x, *sp.row_halos(conv.kernel_size[0], conv.stride[0], pad[0]), space)
        pad = (0, pad[1])
    return F.conv2d(x, conv.weight.to(dtype), b, conv.stride, pad, conv.dilation, conv.groups)


def conv_rows(conv: nn.Conv2d) -> Tuple[int, int]:
    """``(stride, widest halo)`` of ``conv`` over a split height (an op of
    ``row_ops``)."""
    s = conv.stride[0]
    return s, max(sp.row_halos(conv.kernel_size[0], s, conv.padding[0]))


POOL_ROWS = (2, 1)  # the stems' 3x3/2/1 max-pool: halos (1, 0)


def max_pool(x: torch.Tensor, space=None) -> torch.Tensor:
    """``F.max_pool2d(x, 3, 2, 1)``, the stems' pool. Over a split height
    (``space``) its windows take a row of the left neighbour, -inf at the
    image's top as the pool's own padding, and give this rank's slab of the
    whole pool's output."""
    if space is None:
        return F.max_pool2d(x, 3, 2, 1)
    x = sp.halo_exchange(x, *sp.row_halos(3, 2, 1), space, fill=float("-inf"))
    return F.max_pool2d(x, 3, 2, (0, 1))


def mean_hw(x: torch.Tensor, space=None, keepdim: bool = False) -> torch.Tensor:
    """The mean of ``x`` over H and W in at least f32 (f64 stays f64, as
    flax); over a split height (``space``) the whole image's: each rank's
    sums summed over the space group with their gradient
    (``space.space_sum``), over the whole H x W."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if space is None:
        return xf.mean(dim=(2, 3), keepdim=keepdim)
    total = sp.space_sum(xf.sum(dim=(2, 3), keepdim=keepdim), space, grad=True)
    return total / float(x.shape[2] * space.size * x.shape[3])


def pooled(x: torch.Tensor, space=None) -> torch.Tensor:
    """``jnp.mean(x, axis=(1, 2)).astype(f32)``: summed in at least f32,
    rounded to the compute dtype, then f32 (``mean_hw``: over the whole
    image)."""
    return mean_hw(x, space).to(x.dtype).float()


def row_plan(ops, x: torch.Tensor) -> List[Optional[sp.SpaceAxis]]:
    """The axis of each op of ``ops`` (``row_ops``) for the NCHW input ``x``
    under the ambient space axis (``space.row_axes``; every entry None
    without one)."""
    return sp.row_axes(sp.current(), x.shape[2], ops)


def to_rows(x: torch.Tensor, have, want) -> torch.Tensor:
    """``x`` on the next op's axis: gathered where a split level ends."""
    return sp.relayout(x, have, want, have, dim=2)


def nchw(x: torch.Tensor, in_channels: int, dtype: torch.dtype) -> torch.Tensor:
    """An NHWC input as the NCHW view of its memory, in the compute dtype."""
    if x.dim() != 4 or x.shape[-1] != in_channels:
        raise ValueError(f"expected NHWC input with {in_channels} channels, got {tuple(x.shape)}")
    return x.to(dtype).permute(0, 3, 1, 2)


def finish_classifier(model: nn.Module, seed: Optional[int], device: DeviceLike) -> None:
    finish_model(model, seed, device, memory_format=torch.channels_last)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, features: int, strides: int = 1, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(in_features, features, 3, strides, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.BatchNorm_1 = BatchNorm(features)
        self._downsample(in_features, features, strides)
        self.rows = conv_rows(self.Conv_0)  # the 1x1 downsample reads the same slab, without halos

    def _downsample(self, in_features: int, out: int, strides: int) -> None:
        if strides != 1 or in_features != out:
            self.downsample_conv = nn.Conv2d(in_features, out, 1, strides, bias=False)
            self.downsample_bn = BatchNorm(out)
        else:
            self.downsample_conv = self.downsample_bn = None

    def _residual(self, x: torch.Tensor, space=None) -> torch.Tensor:
        if self.downsample_conv is None:
            return x
        return self.downsample_bn(conv2d(x, self.downsample_conv, self.dtype, space))

    def forward(self, x: torch.Tensor, space=None) -> torch.Tensor:
        y = self.BatchNorm_0(conv2d(x, self.Conv_0, self.dtype, space), relu=True)
        y = self.BatchNorm_1(conv2d(y, self.Conv_1, self.dtype, space))
        return F.relu(y + self._residual(x, space))


class Bottleneck(BasicBlock):
    expansion = 4

    def __init__(self, in_features: int, features: int, strides: int = 1, dtype=torch.float32):
        nn.Module.__init__(self)
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(in_features, features, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = nn.Conv2d(features, features, 3, strides, 1, bias=False)
        self.BatchNorm_1 = BatchNorm(features)
        self.Conv_2 = nn.Conv2d(features, features * 4, 1, bias=False)
        self.BatchNorm_2 = BatchNorm(features * 4)
        self._downsample(in_features, features * 4, strides)
        self.rows = conv_rows(self.Conv_1)

    def forward(self, x: torch.Tensor, space=None) -> torch.Tensor:
        y = self.BatchNorm_0(conv2d(x, self.Conv_0, self.dtype, space), relu=True)
        y = self.BatchNorm_1(conv2d(y, self.Conv_1, self.dtype, space), relu=True)
        y = self.BatchNorm_2(conv2d(y, self.Conv_2, self.dtype, space))
        return F.relu(y + self._residual(x, space))


_SPECS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
    "resnet152": (Bottleneck, (3, 8, 36, 3)),
}


class ResNet(nn.Module):
    """x: [B, H, W, C] -> (features [B, F], logits [B, num_classes])."""

    def __init__(self, variant: str = "resnet18", num_classes: int = 1000, reid_mode: bool = False,
                 embedding_dim: int = 512, dtype: torch.dtype = torch.float32, in_channels: int = 3, *,
                 device: DeviceLike = "cuda", seed: Optional[int] = 0):
        super().__init__()
        if variant not in _SPECS:
            raise ValueError(f"Unknown resnet variant: {variant}")
        resolve_device(device)
        block_cls, stages = _SPECS[variant]
        self.variant, self.dtype, self.in_channels = variant, dtype, int(in_channels)
        self.reid_mode = bool(reid_mode)
        self.stem = nn.Conv2d(self.in_channels, 64, 7, 2, 3, bias=False)
        self.stem_bn = BatchNorm(64)
        cin = 64
        for i, (n_blocks, f) in enumerate(zip(stages, (64, 128, 256, 512))):
            for j in range(n_blocks):
                strides = 2 if (i > 0 and j == 0) else 1
                self.add_module(f"layer{i + 1}_{j}", block_cls(cin, f, strides, dtype))
                cin = f * block_cls.expansion
        self.blocks = [f"layer{i + 1}_{j}" for i, n in enumerate(stages) for j in range(n)]
        self.row_ops = [conv_rows(self.stem), POOL_ROWS] + [getattr(self, n).rows for n in self.blocks]
        if self.reid_mode:
            self.projection = nn.Linear(cin, embedding_dim)
            self.bnneck = BatchNorm(embedding_dim, use_bias=False)
            self.fc = nn.Linear(embedding_dim, num_classes, bias=False)
        else:
            self.fc = nn.Linear(cin, num_classes)
        finish_classifier(self, seed, device)

    @classmethod
    def from_config(cls, cfg, **overrides) -> "ResNet":
        kw = dict(
            variant=str(get_config(cfg, "name", "resnet18")),
            num_classes=int(get_config(cfg, "num_classes", 1000)),
            reid_mode=bool(get_config(cfg, "reid_mode", False)),
            embedding_dim=int(get_config(cfg, "embedding_dim", 512)),
            in_channels=int(get_config(cfg, "in_channels", 3)),
        )
        kw.update(overrides)
        kw.pop("remat", None)
        return cls(**kw)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = nchw(x, self.in_channels, self.dtype)
        have, axes = sp.current(), row_plan(self.row_ops, x)
        x = to_rows(x, have, axes[0])
        x = self.stem_bn(conv2d(x, self.stem, self.dtype, axes[0]), relu=True)
        x = max_pool(to_rows(x, axes[0], axes[1]), axes[1])
        for i, name in enumerate(self.blocks, 2):
            x = getattr(self, name)(to_rows(x, axes[i - 1], axes[i]), axes[i])
        feats = pooled(x, axes[-1])
        if self.reid_mode:
            emb = self.bnneck(F.linear(feats, self.projection.weight, self.projection.bias))
            logits = F.linear(emb, self.fc.weight)
            emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)
            return emb, logits
        return feats, F.linear(feats, self.fc.weight, self.fc.bias)


class _VariantFactory:
    """Registry adapter binding a concrete variant name to a model family
    (the registry contract is ``from_config(cfg, **overrides)``)."""

    def __init__(self, family, name: str):
        self.family = family
        self.name = name

    def from_config(self, cfg, **overrides):
        overrides["variant"] = self.name
        return self.family.from_config(cfg, **overrides)

    def __repr__(self):
        return f"<{self.family.__name__} variant '{self.name}'>"


for _name in _SPECS:
    register_model(_name)(_VariantFactory(ResNet, _name))


def get_resnet_model(name: str, **kw) -> ResNet:
    if name not in _SPECS:
        raise ValueError(f"Unknown resnet variant: {name}")
    return ResNet(variant=name, **kw)
