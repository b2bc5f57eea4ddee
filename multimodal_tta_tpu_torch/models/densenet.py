"""DenseNet classifier family (2D; the port of ``multimodal_tta_tpu/models/densenet.py``).

Registered names ``densenet121/169/201/161``; ``forward`` takes NHWC and
returns ``(pooled features, logits)`` in f32, as the ResNets do. Module
names are flax's: the stem ``Conv_0`` / ``BatchNorm_0``, ``block{B}_layer{L}``
(``BatchNorm_0``, ``Conv_0``, ``BatchNorm_1``, ``Conv_1``), ``transition{T}``
(``BatchNorm_0``, ``Conv_0``), ``final_bn``, ``classifier``. ``growth_rate``,
``block_config`` and ``init_features`` override the variant's topology, as
in the reference. Over a space axis each op of ``row_ops`` (the stem, its
max-pool, each dense layer and transition) runs on the rank's rows of the
images or whole, as ``models/resnet.py`` says; a transition's 2x2 average
pool takes no halo and needs an even slab.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike, resolve_device
from ..parallel import space as sp
from ..registry import register_model
from ..utils.config import get_config
from .layers import BatchNorm
from .resnet import (POOL_ROWS, _VariantFactory, conv2d, conv_rows, finish_classifier, max_pool, nchw, pooled,
                     row_plan, to_rows)

_SPECS = {
    # (growth_rate, block_config, init_features)
    "densenet121": (32, (6, 12, 24, 16), 64),
    "densenet169": (32, (6, 12, 32, 32), 64),
    "densenet201": (32, (6, 12, 48, 32), 64),
    "densenet161": (48, (6, 12, 36, 24), 96),
}


class DenseLayer(nn.Module):
    def __init__(self, in_features: int, growth_rate: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.BatchNorm_0 = BatchNorm(in_features)
        self.Conv_0 = nn.Conv2d(in_features, 4 * growth_rate, 1, bias=False)
        self.BatchNorm_1 = BatchNorm(4 * growth_rate)
        self.Conv_1 = nn.Conv2d(4 * growth_rate, growth_rate, 3, 1, 1, bias=False)
        self.rows = conv_rows(self.Conv_1)

    def forward(self, x: torch.Tensor, space=None) -> torch.Tensor:
        y = conv2d(self.BatchNorm_0(x, relu=True), self.Conv_0, self.dtype, space)
        y = conv2d(self.BatchNorm_1(y, relu=True), self.Conv_1, self.dtype, space)
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, in_features: int, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.BatchNorm_0 = BatchNorm(in_features)
        self.Conv_0 = nn.Conv2d(in_features, features, 1, bias=False)
        self.rows = (2, 0)  # the 2x2/2 average pool: no halo

    def forward(self, x: torch.Tensor, space=None) -> torch.Tensor:
        return F.avg_pool2d(conv2d(self.BatchNorm_0(x, relu=True), self.Conv_0, self.dtype, space), 2, 2)


class DenseNet(nn.Module):
    def __init__(self, variant: str = "densenet121", num_classes: int = 1000, dtype: torch.dtype = torch.float32,
                 growth_rate: Optional[int] = None, block_config: Optional[Sequence[int]] = None,
                 init_features: Optional[int] = None, in_channels: int = 3, *,
                 device: DeviceLike = "cuda", seed: Optional[int] = 0):
        super().__init__()
        if variant not in _SPECS:
            raise ValueError(f"Unknown densenet variant: {variant}")
        resolve_device(device)
        growth, blocks, init_feat = _SPECS[variant]
        growth = growth if growth_rate is None else int(growth_rate)
        blocks = blocks if block_config is None else tuple(int(b) for b in block_config)
        init_feat = init_feat if init_features is None else int(init_features)
        self.variant, self.dtype, self.in_channels = variant, dtype, int(in_channels)
        self.Conv_0 = nn.Conv2d(self.in_channels, init_feat, 7, 2, 3, bias=False)
        self.BatchNorm_0 = BatchNorm(init_feat)
        self.stages = []
        feat = init_feat
        for bi, n_layers in enumerate(blocks):
            for li in range(n_layers):
                self.add_module(f"block{bi}_layer{li}", DenseLayer(feat + li * growth, growth, dtype))
                self.stages.append(f"block{bi}_layer{li}")
            feat = feat + n_layers * growth
            if bi != len(blocks) - 1:
                self.add_module(f"transition{bi}", Transition(feat, feat // 2, dtype))
                self.stages.append(f"transition{bi}")
                feat = feat // 2
        self.final_bn = BatchNorm(feat)
        self.classifier = nn.Linear(feat, num_classes)
        self.row_ops = [conv_rows(self.Conv_0), POOL_ROWS] + [getattr(self, n).rows for n in self.stages]
        finish_classifier(self, seed, device)

    @classmethod
    def from_config(cls, cfg, **overrides) -> "DenseNet":
        kw = dict(
            variant=str(get_config(cfg, "name", "densenet121")),
            num_classes=int(get_config(cfg, "num_classes", 1000)),
            in_channels=int(get_config(cfg, "in_channels", 3)),
        )
        kw.update(overrides)
        kw.pop("remat", None)
        return cls(**kw)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = nchw(x, self.in_channels, self.dtype)
        have, axes = sp.current(), row_plan(self.row_ops, x)
        x = to_rows(x, have, axes[0])
        x = self.BatchNorm_0(conv2d(x, self.Conv_0, self.dtype, axes[0]), relu=True)
        x = max_pool(to_rows(x, axes[0], axes[1]), axes[1])
        for i, name in enumerate(self.stages, 2):
            x = getattr(self, name)(to_rows(x, axes[i - 1], axes[i]), axes[i])
        feats = pooled(self.final_bn(x, relu=True), axes[-1])
        return feats, F.linear(feats, self.classifier.weight, self.classifier.bias)


for _name in _SPECS:
    register_model(_name)(_VariantFactory(DenseNet, _name))
