"""EfficientNet classifier family (2D; the port of
``multimodal_tta_tpu/models/efficientnet.py``).

Registered names ``efficientnet_b0`` ... ``b7`` and ``efficientnet_v2_s/m/l``;
``forward`` takes NHWC and returns ``(pooled features, logits)`` in f32.
MBConv with squeeze-excitation (depthwise ``k x k`` conv: ``groups = mid``),
FusedMBConv for v2 (a single ``k x k`` conv at expand 1), SiLU, and the
reference's torchvision structure: symmetric ``(k - 1) // 2`` paddings,
BatchNorm eps 1e-3 for v2 and 1e-5 for the b-series, the v2 stem width taken
from the first stage. Module names are flax's (``stem``, ``stem_bn``,
``stage{S}_block{J}`` with ``Conv_k`` / ``BatchNorm_k`` /
``SqueezeExcite_0.Conv_0|1`` in creation order, ``head_conv``, ``head_bn``,
``classifier``). Over a space axis each op of ``row_ops`` (the stem, each
block's ``k x k`` conv, depthwise or fused) runs on the rank's rows of the
images or whole, as ``models/resnet.py`` says; the squeeze-excitation's
mean is the whole image's (``resnet.mean_hw``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike, resolve_device
from ..parallel import space as sp
from ..registry import register_model
from ..utils.config import get_config
from .layers import BatchNorm
from .resnet import _VariantFactory, conv2d, conv_rows, finish_classifier, mean_hw, nchw, pooled, row_plan, to_rows

# B0 baseline stage spec: (expand, channels, layers, stride, kernel)
_B0_STAGES = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]
# (width_mult, depth_mult)
_B_SCALES = {
    "efficientnet_b0": (1.0, 1.0),
    "efficientnet_b1": (1.0, 1.1),
    "efficientnet_b2": (1.1, 1.2),
    "efficientnet_b3": (1.2, 1.4),
    "efficientnet_b4": (1.4, 1.8),
    "efficientnet_b5": (1.6, 2.2),
    "efficientnet_b6": (1.8, 2.6),
    "efficientnet_b7": (2.0, 3.1),
}
# v2: explicit stages (expand, channels, layers, stride, kernel, fused)
_V2_STAGES = {
    "efficientnet_v2_s": [
        (1, 24, 2, 1, 3, True),
        (4, 48, 4, 2, 3, True),
        (4, 64, 4, 2, 3, True),
        (4, 128, 6, 2, 3, False),
        (6, 160, 9, 1, 3, False),
        (6, 256, 15, 2, 3, False),
    ],
    "efficientnet_v2_m": [
        (1, 24, 3, 1, 3, True),
        (4, 48, 5, 2, 3, True),
        (4, 80, 5, 2, 3, True),
        (4, 160, 7, 2, 3, False),
        (6, 176, 14, 1, 3, False),
        (6, 304, 18, 2, 3, False),
        (6, 512, 5, 1, 3, False),
    ],
    "efficientnet_v2_l": [
        (1, 32, 4, 1, 3, True),
        (4, 64, 7, 2, 3, True),
        (4, 96, 7, 2, 3, True),
        (4, 192, 10, 2, 3, False),
        (6, 224, 19, 1, 3, False),
        (6, 384, 25, 2, 3, False),
        (6, 640, 7, 1, 3, False),
    ],
}


def _round_channels(c: float, mult: float, divisor: int = 8) -> int:
    c *= mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return int(new_c)


def _round_layers(n: int, mult: float) -> int:
    return int(math.ceil(n * mult))


def stages_of(variant: str) -> List[Tuple[int, int, int, int, int, bool]]:
    """``(expand, channels, layers, stride, kernel, fused)`` per stage."""
    if variant in _V2_STAGES:
        return _V2_STAGES[variant]
    wm, dm = _B_SCALES[variant]
    return [(e, _round_channels(c, wm), _round_layers(n, dm), s, k, False) for (e, c, n, s, k) in _B0_STAGES]


class SqueezeExcite(nn.Module):
    def __init__(self, in_channels: int, channels: int, se_ratio: float = 0.25, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        squeeze = max(1, int(in_channels * se_ratio))
        self.Conv_0 = nn.Conv2d(channels, squeeze, 1)
        self.Conv_1 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x: torch.Tensor, space=None) -> torch.Tensor:
        se = mean_hw(x, space, keepdim=True).to(x.dtype)
        se = conv2d(F.silu(conv2d(se, self.Conv_0, self.dtype)), self.Conv_1, self.dtype)
        return x * torch.sigmoid(se)


class MBConv(nn.Module):
    def __init__(self, in_features: int, expand: int, features: int, strides: int, kernel: int,
                 fused: bool = False, dtype=torch.float32, bn_eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.residual = strides == 1 and in_features == features
        mid = in_features * expand
        pad = (kernel - 1) // 2
        # (conv, silu after its norm) in the reference's creation order
        if fused and expand == 1:
            convs = [(nn.Conv2d(in_features, features, kernel, strides, pad, bias=False), True)]
        elif fused:
            convs = [(nn.Conv2d(in_features, mid, kernel, strides, pad, bias=False), True),
                     (nn.Conv2d(mid, features, 1, bias=False), False)]
        else:
            convs = [(nn.Conv2d(in_features, mid, 1, bias=False), True)] if expand != 1 else []
            convs += [(nn.Conv2d(mid, mid, kernel, strides, pad, groups=mid, bias=False), True),
                      (nn.Conv2d(mid, features, 1, bias=False), False)]
        self.acts = [act for _, act in convs]
        for i, (conv, _) in enumerate(convs):
            self.add_module(f"Conv_{i}", conv)
            self.add_module(f"BatchNorm_{i}", BatchNorm(conv.out_channels, epsilon=bn_eps))
        # the squeeze-excitation sits after the depthwise conv, before the projection
        self.SqueezeExcite_0 = None if fused else SqueezeExcite(in_features, mid, dtype=dtype)
        self.rows = conv_rows(next(c for c, _ in convs if c.kernel_size[0] > 1))

    def forward(self, x: torch.Tensor, space=None) -> torch.Tensor:
        y = x
        n = len(self.acts)
        for i, act in enumerate(self.acts):
            if self.SqueezeExcite_0 is not None and i == n - 1:
                y = self.SqueezeExcite_0(y, space)
            y = getattr(self, f"BatchNorm_{i}")(conv2d(y, getattr(self, f"Conv_{i}"), self.dtype, space))
            if act:
                y = F.silu(y)
        return y + x if self.residual else y


class EfficientNet(nn.Module):
    def __init__(self, variant: str = "efficientnet_b0", num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3, *,
                 device: DeviceLike = "cuda", seed: Optional[int] = 0):
        super().__init__()
        if variant not in _B_SCALES and variant not in _V2_STAGES:
            raise ValueError(f"Unknown efficientnet variant: {variant}")
        resolve_device(device)
        self.variant, self.dtype, self.in_channels = variant, dtype, int(in_channels)
        v2 = variant in _V2_STAGES
        # torchvision builds the v2 variants with BatchNorm eps 1e-3
        self.bn_eps = 1e-3 if v2 else 1e-5
        stages = stages_of(variant)
        stem = stages[0][1] if v2 else _round_channels(32, _B_SCALES[variant][0])
        self.stem = nn.Conv2d(self.in_channels, stem, 3, 2, 1, bias=False)
        self.stem_bn = BatchNorm(stem, epsilon=self.bn_eps)
        self.blocks = []
        cin = stem
        for si, (e, c, n, s, k, fused) in enumerate(stages):
            for li in range(n):
                self.add_module(f"stage{si}_block{li}",
                                MBConv(cin, e, c, s if li == 0 else 1, k, fused, dtype, self.bn_eps))
                self.blocks.append(f"stage{si}_block{li}")
                cin = c
        head = 1280 if v2 else _round_channels(1280, _B_SCALES[variant][0])
        self.head_conv = nn.Conv2d(cin, head, 1, bias=False)
        self.head_bn = BatchNorm(head, epsilon=self.bn_eps)
        self.classifier = nn.Linear(head, num_classes)
        self.row_ops = [conv_rows(self.stem)] + [getattr(self, n).rows for n in self.blocks]
        finish_classifier(self, seed, device)

    @classmethod
    def from_config(cls, cfg, **overrides) -> "EfficientNet":
        kw = dict(
            variant=str(get_config(cfg, "name", "efficientnet_b0")),
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
        x = F.silu(self.stem_bn(conv2d(x, self.stem, self.dtype, axes[0])))
        for i, name in enumerate(self.blocks, 1):
            x = getattr(self, name)(to_rows(x, axes[i - 1], axes[i]), axes[i])
        feats = pooled(F.silu(self.head_bn(conv2d(x, self.head_conv, self.dtype, axes[-1]))), axes[-1])
        return feats, F.linear(feats, self.classifier.weight, self.classifier.bias)


for _name in list(_B_SCALES) + list(_V2_STAGES):
    register_model(_name)(_VariantFactory(EfficientNet, _name))
