"""Building blocks for 3D segmentation models (the port of
``multimodal_tta_tpu/models/layers.py``).

Tensors inside a model are NCDHW in ``torch.channels_last_3d`` memory, so
the memory order is the reference's NDHWC: cuDNN's convolutions take that
layout, and ``x.permute(0, 2, 3, 4, 1)`` is a free, contiguous NDHWC view
for the norm kernel.

Numerics follow flax, which the parity tests check:
  * ``padding="SAME"`` pads ``(total // 2, total - total // 2)`` per dim,
    so a stride-2 3x3x3 conv over an even dim pads (0, 1), not (1, 1).
  * ``nn.ConvTranspose`` (``transpose_kernel=False``) equals
    ``conv_transpose3d`` with the spatially flipped kernel; the flip lives
    in ``models/convert.py``, so a module here holds torch's layout.
  * ``dtype=`` casts inputs and kernels to the compute dtype; params stay
    f32. The norm takes f32 statistics and casts its output back.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.fused_instance_norm import fused_instance_norm, instance_norm_plain

IntOr3 = Union[int, Sequence[int]]

_UNPORTED = "ROADMAP.md, 'Remaining models'"


def get_act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    name = str(name).upper()
    table = {
        "RELU": F.relu,
        "LEAKYRELU": lambda x: F.leaky_relu(x, negative_slope=0.01),
        "PRELU": F.relu,  # as in the reference: PReLU's slope is not a param here
        "GELU": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu default
        "SILU": F.silu,
        "SWISH": F.silu,
        "TANH": torch.tanh,
        "SIGMOID": torch.sigmoid,
        "ELU": F.elu,
    }
    if name not in table:
        raise ValueError(f"Unknown activation '{name}'. Known: {sorted(table)}")
    return table[name]


def _triple(v: IntOr3) -> Tuple[int, int, int]:
    if isinstance(v, int):
        return (v, v, v)
    t = tuple(int(x) for x in v)
    if len(t) != 3:
        raise ValueError(f"Expected 3 spatial dims, got {v}")
    return t


def conv3d_same(x: torch.Tensor, conv: nn.Conv3d, dtype: torch.dtype) -> torch.Tensor:
    """``conv(x)`` with flax ``padding="SAME"`` in the compute dtype."""
    pads = []
    for n, k, s in zip(x.shape[2:], conv.kernel_size, conv.stride):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    w = conv.weight.to(dtype)
    b = None if conv.bias is None else conv.bias.to(dtype)
    x = x.to(dtype)
    if all(lo == hi for lo, hi in pads):
        return F.conv3d(x, w, b, stride=conv.stride, padding=tuple(lo for lo, _ in pads))
    # F.pad lists the last dim first
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return F.conv3d(F.pad(x, flat), w, b, stride=conv.stride)


class InstanceNorm(nn.Module):
    """Per-sample per-channel normalization over the spatial dims, with the
    ReLU optionally fused (the reference's ``InstanceNorm``; same param
    names: 1-D ``scale`` and ``bias``). Runs the fused kernel; ``plain=True``
    runs the plain PyTorch version instead, the reference forward that the
    kernel is held against."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.plain = False
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        fn = instance_norm_plain if self.plain else fused_instance_norm
        y = fn(x.permute(0, 2, 3, 4, 1).contiguous(), self.scale, self.bias,
               eps=self.epsilon, act="relu" if relu else None)
        return y.permute(0, 4, 1, 2, 3)


class Norm(nn.Module):
    """Config-string-selected normalization over the channel axis. This
    slice ports INSTANCE, the flagship's norm."""

    def __init__(self, kind: str, features: int):
        super().__init__()
        kind = str(kind).upper()
        if kind != "INSTANCE":
            raise NotImplementedError(
                f"norm '{kind}' is not ported yet ({_UNPORTED}); INSTANCE is"
            )
        self.norm = InstanceNorm(features, epsilon=1e-5)

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        return self.norm(x, relu=relu)


class ConvBlock(nn.Module):
    """Conv3D -> Norm -> Act. With norm INSTANCE and act RELU the ReLU runs
    inside the norm kernel."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: IntOr3 = 3,
        strides: IntOr3 = 1,
        norm: str = "INSTANCE",
        act: str = "RELU",
        dropout: float = 0.0,
        use_norm: bool = True,
        use_act: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if dropout > 0.0:
            raise NotImplementedError(
                "ConvBlock dropout is a training-time op; it comes with the training slice"
            )
        self.dtype = dtype
        self.conv = nn.Conv3d(in_features, features, _triple(kernel_size),
                              stride=_triple(strides), bias=not use_norm)
        self.n = Norm(norm, features) if use_norm else None
        self.act = get_act(act) if use_act else None
        self.fuse_relu = use_norm and use_act and str(act).upper() == "RELU"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv3d_same(x, self.conv, self.dtype)
        if self.n is not None:
            x = self.n(x, relu=self.fuse_relu)
        if self.act is not None and not self.fuse_relu:
            x = self.act(x)
        return x


class ResidualUnit(nn.Module):
    """``subunits`` ConvBlocks (the first carries the stride) plus a strided
    1x1x1 projection residual when the shape changes."""

    def __init__(
        self,
        in_features: int,
        features: int,
        strides: IntOr3 = 1,
        kernel_size: IntOr3 = 3,
        subunits: int = 2,
        norm: str = "INSTANCE",
        act: str = "RELU",
        dropout: float = 0.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        strides = _triple(strides)
        if any(s != 1 for s in strides) or in_features != features:
            self.residual_proj = nn.Conv3d(in_features, features, 1, stride=strides, bias=True)
        else:
            self.residual_proj = None
        self.n_sub = max(1, int(subunits))
        for i in range(self.n_sub):
            self.add_module(f"unit{i}", ConvBlock(
                in_features if i == 0 else features, features, kernel_size,
                strides if i == 0 else 1, norm, act, dropout, dtype=dtype,
            ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x if self.residual_proj is None else conv3d_same(x, self.residual_proj, self.dtype)
        y = x
        for i in range(self.n_sub):
            y = getattr(self, f"unit{i}")(y)
        return y + res.to(y.dtype)


class TransposedConvUp(nn.Module):
    """Strided transposed-conv upsampling (kernel = stride, VALID)."""

    def __init__(self, in_features: int, features: int, strides: IntOr3 = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        s = _triple(strides)
        self.up = nn.ConvTranspose3d(in_features, features, s, stride=s, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose3d(x.to(self.dtype), self.up.weight.to(self.dtype),
                                  self.up.bias.to(self.dtype), stride=self.up.stride)


def set_plain_norm(module: nn.Module, plain: bool) -> None:
    """Route every InstanceNorm under ``module`` to the plain PyTorch version
    (``True``) or to the fused kernel (``False``, the default)."""
    for m in module.modules():
        if isinstance(m, InstanceNorm):
            m.plain = plain
