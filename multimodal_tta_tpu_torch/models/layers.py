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

Models are built in inference mode, the reference's ``train=False``:
dropout is the identity there and ``BatchNorm`` reads its running
statistics. ``SegTrainer`` runs its step in training mode (the reference's
``train=True``), where dropout raises, as the reference cannot train with
it, and ``BatchNorm`` normalizes with the batch's statistics and moves its
running statistics once. ``remat_call`` is the reference's ``nn.remat``
(``torch.utils.checkpoint``); its recompute moves no statistics.
"""

from __future__ import annotations

import math
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.fused_instance_norm import fused_instance_norm, instance_norm_plain, split_instance_norm
from ..parallel.space import halo_exchange, slice_depth, space_sum

IntOr3 = Union[int, Sequence[int]]

# flax lecun_normal: truncated normal at +-2 sd, rescaled so the kept part
# has variance 1 / fan_in (jax.nn.initializers.variance_scaling)
_TRUNC_SD = 0.87962566103423978


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


def conv3d_same(x: torch.Tensor, conv: nn.Module, dtype: torch.dtype, space=None) -> torch.Tensor:
    """``conv(x)`` with flax ``padding="SAME"`` in the compute dtype (an
    ``nn.Conv3d`` on NCDHW, or an ``nn.Conv2d`` on NCHW).

    With ``space`` (``parallel/space.py``) ``x`` is this rank's depth slab
    of a volume split over the space axis: the SAME padding of the whole
    depth applies its zeros at the volume's two ends only, and the slab
    takes its neighbours' planes at the inner boundaries
    (``halo_exchange``): ``lo`` = the left pad planes before it and
    ``k - stride - lo`` after it, so that it computes its own slab of the
    whole conv's output (a 3x3x3 conv: 1 each side; stride 2, pad (0, 1): 1
    after; 1x1x1: none)."""
    conv_fn = F.conv3d if x.dim() == 5 else F.conv2d
    depth = x.shape[2] * (space.size if space is not None else 1)
    pads = []
    for n, k, s in zip((depth,) + tuple(x.shape[3:]), conv.kernel_size, conv.stride):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    w = conv.weight.to(dtype)
    b = None if conv.bias is None else conv.bias.to(dtype)
    x = x.to(dtype)
    if space is not None:
        k, s, lo = conv.kernel_size[0], conv.stride[0], pads[0][0]
        hi = max(k - s - lo, 0)
        if x.shape[2] % s or (x.shape[2] + lo + hi - k) // s + 1 != x.shape[2] // s:
            raise ValueError(f"[space] a slab of {x.shape[2]} planes cannot take a depth conv of kernel {k}, "
                             f"stride {s}")
        x = halo_exchange(x, lo, hi, space)
        pads[0] = (0, 0)
    if all(lo == hi for lo, hi in pads):
        return conv_fn(x, w, b, stride=conv.stride, padding=tuple(lo for lo, _ in pads))
    # F.pad lists the last dim first
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return conv_fn(F.pad(x, flat), w, b, stride=conv.stride)


class InstanceNorm(nn.Module):
    """Per-sample per-channel normalization over the spatial dims, with the
    ReLU optionally fused (the reference's ``InstanceNorm``; same param
    names: 1-D ``scale`` and ``bias``). Runs the fused kernel; ``plain=True``
    runs the plain PyTorch version instead, the reference forward that the
    kernel is held against. Over a split depth (``space``, the level's axis
    from ``parallel/space.py``) the statistics span the space group."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.plain = False
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, relu: bool = False, space=None) -> torch.Tensor:
        act = "relu" if relu else None
        x = x.permute(0, 2, 3, 4, 1).contiguous()
        if space is not None:
            # the statistics span the space group: the kernel's stats and
            # apply entries around an all-reduce (a CPU tensor takes their
            # plain versions; on the card each is held to its plain version
            # alone, so the plain-norm switch does not apply here)
            if self.plain:
                raise NotImplementedError("[space] the plain norm over a split depth: the split entries each have "
                                          "their plain version (kernels/fused_instance_norm.py)")
            n = float(x[0, ..., 0].numel() * space.size)
            y = split_instance_norm(x, self.scale, self.bias, n=n, reduce=lambda t: space_sum(t, space),
                                    eps=self.epsilon, act=act)
        else:
            fn = instance_norm_plain if self.plain else fused_instance_norm
            y = fn(x, self.scale, self.bias, eps=self.epsilon, act=act)
        return y.permute(0, 4, 1, 2, 3)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` (``math.gcd(8, C)`` groups, eps 1e-5) or, with
    ``groups=None``, ``nn.LayerNorm`` over the channels: statistics and
    affine in f32, the output cast back to the input's dtype, as flax does
    for a bf16 input. 1-D ``scale`` and ``bias``, the reference's names.

    Over a split depth (``space``) a group's statistics span the space
    group in two passes, as ``F.group_norm`` takes them in one process: the
    slabs' per (sample, group) sums of x meet (``space_sum``, with their
    gradient) for the mean, then their sums of the squared deviations from
    it for the variance. flax takes E[x^2] - E[x]^2 in one pass, which
    loses f32 precision where a group's mean is large against its spread
    (SegResNet's residual stream). The layer norm is per voxel and takes no
    collective."""

    def __init__(self, features: int, groups=None, epsilon: float = 1e-5):
        super().__init__()
        self.groups = groups
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, relu: bool = False, space=None) -> torch.Tensor:
        xf = x.float()
        if self.groups is None:
            y = F.layer_norm(xf.movedim(1, -1), (xf.shape[1],), self.scale, self.bias,
                             self.epsilon).movedim(-1, 1)
        elif space is None:
            y = F.group_norm(xf, self.groups, self.scale, self.bias, self.epsilon)
        else:
            y = _split_group_norm(xf, self.groups, self.scale, self.bias, self.epsilon, space)
        return (F.relu(y) if relu else y).to(x.dtype)


def _split_group_norm(x: torch.Tensor, groups: int, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                      space) -> torch.Tensor:
    """Group norm of an f32 ``[B, C, d, H, W]`` slab of a depth split over
    ``space``: the space group's sums per (sample, group), the mean, then
    the squared deviations from it."""
    v = x.movedim(1, -1)  # NDHWC (a free view of channels_last_3d memory)
    b, c = x.shape[:2]
    xg = v.reshape(b, -1, groups, c // groups)  # a group: consecutive channels
    n = float(xg.shape[1] * xg.shape[3] * space.size)
    mean = (space_sum(xg.sum(dim=(1, 3)), space, grad=True) / n)[:, None, :, None]
    dev = xg - mean
    var = (space_sum(dev.square().sum(dim=(1, 3)), space, grad=True) / n)[:, None, :, None]
    y = dev * torch.rsqrt(var + eps)
    return (y.reshape(v.shape) * scale + bias).movedim(-1, 1)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)`` over the last axis, as the
    transformers build it: epsilon 1e-6 (flax's default, not the config
    norm's 1e-5), statistics and affine in f32, the output cast to the
    compute dtype ``dtype``. 1-D ``scale`` and ``bias`` and nothing else, so
    Tent's structural mask adapts it. flax takes the variance as
    E[x^2] - E[x]^2; ``F.layer_norm`` takes it in two passes."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32, epsilon: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias, self.epsilon)
        return y.to(self.dtype)


@contextmanager
def frozen_statistics(module: nn.Module):
    """A training-mode ``BatchNorm`` of ``module`` still normalizes with the
    batch's statistics inside the block, but leaves its running statistics
    as they are: the reference computes such a forward and drops the
    statistics it returns (a remat recompute; the SAR ascent, consistency
    and MEMO gradient passes)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    held = [m.frozen for m in bns]
    for m in bns:
        m.frozen = True
    try:
        yield
    finally:
        for m, f in zip(bns, held):
            m.frozen = f


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=...)`` over the channel axis
    (dim 1) of an ``[N, C, ...]`` tensor, as the reference builds it:

      * training mode (``train=True``): the batch's statistics over every
        axis but the channel, in f32 (f64 stays f64, as in flax), as
        ``mean = E[x]`` and the biased ``var = max(E[x^2] - E[x]^2, 0)``
        (flax's ``use_fast_variance``); the running statistics become
        ``0.9 * running + 0.1 * batch`` once per forward, unless ``frozen``
        (``frozen_statistics``). Padded rows of a batch pool in, as in the
        reference. Gradients flow through the batch statistics.
      * inference mode: the running statistics.

    The output is ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32,
    cast to the input's dtype (the compute dtype, flax's ``dtype=``), the
    ReLU optionally fused before the cast. Params ``scale``/``bias`` (1-D;
    ``use_bias=False`` drops the bias: the BNNeck), buffers ``mean``/``var``
    as flax's ``batch_stats``, no ``num_batches_tracked``. torch's own
    BatchNorm updates with the unbiased variance and is not used.

    Over ranks (``pool_over_ranks``): the per-channel sums of x and x^2 are
    summed over the data and space axes before the statistics are formed,
    over the global padded batch (every rank holds as many rows) and the
    whole depth, as XLA computes the reference's statistics on a sharded
    batch; every rank then moves the same running statistics. A level that
    is whole over a space axis is held alike by the space group's ranks:
    its sums and count both take the group's size as a factor, so the
    statistics are the same, and each rank's share of their gradient is
    ``1 / space`` of it, as for every whole level."""

    momentum = 0.9  # every BatchNorm of the reference
    pools_over_ranks = True

    def __init__(self, features: int, epsilon: float = 1e-5, use_bias: bool = True):
        super().__init__()
        self.epsilon = float(epsilon)
        self.frozen = False
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.mesh = None  # the data axis the statistics pool over (pool_over_ranks)

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # at least f32, as flax
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            red, c = [0] + list(range(2, x.dim())), x.shape[1]
            sums, world = pooled_sums(torch.cat([xf.sum(red), xf.square().sum(red)]), self.mesh)
            count = float(x.numel() // c * world)
            mean = sums[:c] / count
            var = torch.clamp(sums[c:] / count - mean.square(), min=0.0)
            if not self.frozen:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_(self.mean * m + mean.detach() * (1.0 - m))
                    self.var.copy_(self.var * m + var.detach() * (1.0 - m))
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (xf - mean.view(shape)) * mul.view(shape)
        if self.bias is not None:
            y = y + self.bias.view(shape)
        return (F.relu(y) if relu else y).to(x.dtype)


def pooled_sums(t: torch.Tensor, mesh) -> Tuple[torch.Tensor, int]:
    """``t`` summed over the data and space axes of ``mesh``
    (differentiable) and their rank count; ``(t, 1)`` without a mesh
    (``pool_over_ranks``)."""
    if mesh is None:
        return t, 1
    return mesh.sum_with_grad(t), mesh.data * mesh.space


def pool_over_ranks(model: nn.Module, mesh) -> None:
    """Every batch statistic of ``model`` (``BatchNorm``, the MoE load
    balance of ``models/moe.py``) pools over the data axis of ``mesh`` from
    now on; a mesh of one rank, or None, turns the pooling off."""
    mesh = mesh if mesh is not None and mesh.parallel else None
    for m in model.modules():
        if getattr(m, "pools_over_ranks", False):
            m.mesh = mesh


def has_batch_statistics(model: nn.Module) -> bool:
    """True when ``model`` holds a ``BatchNorm`` (running statistics)."""
    return any(isinstance(m, BatchNorm) for m in model.modules())


def reject_torch_batchnorm(model: nn.Module) -> None:
    """Raise on torch's own BatchNorm inside ``model``: it moves its running
    variance by torch's rule (the unbiased batch variance), not the
    reference's. The TTA methods call this when they bind a model."""
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._NormBase):
            raise ValueError(
                f"{type(m).__name__} is torch's BatchNorm, whose running statistics follow torch's "
                "rules; build the model with multimodal_tta_tpu_torch.models.layers.BatchNorm")


def running_statistics(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Copies of the running statistics of every ``BatchNorm`` in ``model``,
    by buffer name (``{}`` for a model without them)."""
    return {f"{n}.{b}" if n else b: t.detach().clone()
            for n, m in model.named_modules() if isinstance(m, BatchNorm)
            for b, t in m.named_buffers(recurse=False)}


@torch.no_grad()
def load_running_statistics(model: nn.Module, stats: Dict[str, torch.Tensor]) -> None:
    """Write ``stats`` (``running_statistics``) back into ``model``'s buffers."""
    if stats:
        buffers = dict(model.named_buffers())
        for name, t in stats.items():
            buffers[name].copy_(t)


@contextmanager
def batch_statistics(model: nn.Module, update: bool = True):
    """``model`` in training mode for the block (the reference's
    ``apply_fn(..., train=True, mutable=["batch_stats"])``): its
    ``BatchNorm`` layers normalize with the batch's statistics and, with
    ``update``, move their running statistics once; without, the reference
    drops the new statistics (``frozen_statistics``). The mode is put back
    after the block."""
    was = model.training
    model.train(True)
    try:
        with (nullcontext() if update else frozen_statistics(model)):
            yield
    finally:
        model.train(was)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias in the compute dtype."""
    b = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), b)


class Norm(nn.Module):
    """Config-string-selected normalization over the channel axis (the
    reference's ``Norm``): INSTANCE (the fused kernel), BATCH (running
    statistics, eps 1e-5), GROUP, LAYER or NONE. The child is named
    ``norm``, as in flax."""

    def __init__(self, kind: str, features: int):
        super().__init__()
        kind = str(kind).upper()
        if kind == "INSTANCE":
            self.norm = InstanceNorm(features, epsilon=1e-5)
        elif kind == "GROUP":
            self.norm = GroupNorm(features, groups=math.gcd(8, features))
        elif kind == "LAYER":
            self.norm = GroupNorm(features, groups=None)
        elif kind in ("NONE", ""):
            self.norm = None
        elif kind == "BATCH":
            self.norm = BatchNorm(features, epsilon=1e-5)
        else:
            raise ValueError(f"Unknown norm '{kind}'")

    def forward(self, x: torch.Tensor, relu: bool = False, space=None) -> torch.Tensor:
        """``space``: the level's space axis over a split depth. A BatchNorm
        pools over the mesh's data and space axes whether its level is
        split or whole (``pool_over_ranks``), so it takes no axis."""
        if self.norm is None:
            return F.relu(x) if relu else x
        if space is None or isinstance(self.norm, BatchNorm):
            return self.norm(x, relu=relu)
        return self.norm(x, relu=relu, space=space)


def check_dropout(module: nn.Module, rate: float) -> None:
    """The reference's ``nn.Dropout(deterministic=not train)``: the identity
    outside training. A training forward with dropout raises: the reference
    cannot train with it either, since its ``SegTrainer`` passes no dropout
    RNG to ``apply_fn(..., train=True)``."""
    if rate > 0.0 and module.training:
        raise NotImplementedError(
            f"dropout {rate} in a training forward: the reference cannot train with dropout "
            "either (its SegTrainer gives apply_fn(train=True) no dropout RNG); set dropout 0")


class ConvBlock(nn.Module):
    """Conv3D -> Norm -> Act -> Dropout (the identity outside training). With
    act RELU the ReLU runs inside the norm (the kernel, for INSTANCE)."""

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
        self.dtype = dtype
        self.dropout = float(dropout)
        self.conv = nn.Conv3d(in_features, features, _triple(kernel_size),
                              stride=_triple(strides), bias=not use_norm)
        self.n = Norm(norm, features) if use_norm else None
        self.act = get_act(act) if use_act else None
        self.fuse_relu = use_norm and use_act and str(act).upper() == "RELU"

    def forward(self, x: torch.Tensor, space=None) -> torch.Tensor:
        """``space``: the level's space axis when ``x`` is a depth slab."""
        x = conv3d_same(x, self.conv, self.dtype, space)
        if self.n is not None:
            x = self.n(x, relu=self.fuse_relu, space=space)
        if self.act is not None and not self.fuse_relu:
            x = self.act(x)
        check_dropout(self, self.dropout)
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

    def forward(self, x: torch.Tensor, space=None) -> torch.Tensor:
        """``space``: the level's space axis when ``x`` is a depth slab."""
        res = x if self.residual_proj is None else conv3d_same(x, self.residual_proj, self.dtype, space)
        y = x
        for i in range(self.n_sub):
            y = getattr(self, f"unit{i}")(y, space)
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


class UpSample(nn.Module):
    """Nearest-neighbour upsampling by an integer scale, then a 1x1x1
    projection with bias when the channel count changes (the reference's
    ``UpSample``: repeat, then project)."""

    def __init__(self, in_features: int, features: int, scale: IntOr3 = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scale = _triple(scale)
        self.proj = nn.Conv3d(in_features, features, 1, bias=True) if in_features != features else None

    def forward(self, x: torch.Tensor, slice_to=None) -> torch.Tensor:
        """``slice_to``: the space axis of a split output level whose input
        is whole (this rank keeps its slab of the repeat)."""
        x = repeat_nearest(x, self.scale)
        if slice_to is not None:
            x = slice_depth(x, slice_to)
        return x if self.proj is None else conv3d_same(x, self.proj, self.dtype)


def repeat_nearest(x: torch.Tensor, scale: Tuple[int, int, int]) -> torch.Tensor:
    """``jnp.repeat`` along D, H and W by integer factors: nearest
    interpolation, whose source index ``floor(i / s)`` is exact here."""
    if tuple(scale) == (1, 1, 1):
        return x
    return F.interpolate(x, scale_factor=tuple(float(s) for s in scale), mode="nearest")


def _recompute_context(module: nn.Module):
    """``checkpoint``'s ``context_fn``: the recompute runs every submodule in
    the mode it had in the forward (the caller may have switched it back
    before the backward) and moves no running statistics (the reference's
    ``nn.remat`` returns a segment's statistics once)."""
    modes = [(m, m.training) for m in module.modules()]

    @contextmanager
    def replay():
        now = [m.training for m, _ in modes]
        for m, t in modes:
            m.training = t
        try:
            with frozen_statistics(module):
                yield
        finally:
            for (m, _), t in zip(modes, now):
                m.training = t

    return nullcontext(), replay()


_CAPTURES: list = []  # the open capture_intermediates dicts, innermost last


@contextmanager
def capture_intermediates(enabled: bool = True):
    """flax's ``mutable=["intermediates"]``: inside the block, ``sow(name,
    value)`` appends ``value`` to the yielded dict's list ``name`` (the MoE
    aux loss and dropped fraction, the deep-supervision logits); outside
    any block ``sow`` records nothing. A remat recompute runs in the
    backward, after the block has closed, so it sows nothing twice."""
    inter: Dict[str, list] = {}
    if not enabled:
        yield inter
        return
    _CAPTURES.append(inter)
    try:
        yield inter
    finally:
        _CAPTURES.remove(inter)


def capturing() -> bool:
    return bool(_CAPTURES)


def sow(name: str, value: torch.Tensor) -> None:
    if _CAPTURES:
        _CAPTURES[-1].setdefault(name, []).append(value)


def remat_call(module: nn.Module, *args, enabled: bool) -> torch.Tensor:
    """``module(*args)``; with ``enabled`` (the reference's ``nn.remat``) its
    activations are dropped after the forward and recomputed in the
    backward, so every norm inside launches its forward kernel twice a
    training step; a ``BatchNorm`` inside moves its running statistics in
    the forward only. Nothing inside draws random numbers (dropout raises in
    training), so no RNG state is kept. Without autograd it is a plain call."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=lambda: _recompute_context(module))
    return module(*args)


@torch.no_grad()
def init_flax_defaults(model: nn.Module, seed: int) -> None:
    """flax's default initialisers from an explicit generator:
    lecun-normal kernels (fan_in = kernel volume x input features per group
    for a conv, 2D or 3D, depthwise too; input features for a dense layer: H
    for an attention's q/k/v, heads x head dim for its out projection, as
    flax's DenseGeneral counts), zero biases, ones and zeros in the norms
    and their running statistics (as built), ``normal(0.02)`` for the
    transformers' ``pos_embed`` and ``rel_pos_bias`` (the ViT classifier's
    ``cls_token`` stays zero). The numbers
    differ from JAX's PRNG; the parity tests carry JAX's weights across with
    ``models/convert.py``."""
    gen = torch.Generator().manual_seed(int(seed))
    for name, p in model.named_parameters():
        if name.rpartition(".")[2] in ("pos_embed", "rel_pos_bias"):
            p.normal_(0.0, 0.02, generator=gen)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d, nn.Linear)):
            if isinstance(m, nn.Linear):
                fan_in = m.in_features
            else:
                in_axis = 0 if isinstance(m, (nn.ConvTranspose2d, nn.ConvTranspose3d)) else 1
                fan_in = m.weight.shape[in_axis] * math.prod(m.kernel_size)
            sd = math.sqrt(1.0 / fan_in) / _TRUNC_SD
            nn.init.trunc_normal_(m.weight, mean=0.0, std=sd, a=-2.0 * sd, b=2.0 * sd, generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        # per-expert kernels [E, in, out] (models/moe.py): lecun-normal over
        # (in, out) with the expert axis a batch axis
        for pname in getattr(m, "expert_kernels", ()):
            w = getattr(m, pname)
            sd = math.sqrt(1.0 / w.shape[-2]) / _TRUNC_SD
            nn.init.trunc_normal_(w, mean=0.0, std=sd, a=-2.0 * sd, b=2.0 * sd, generator=gen)


def head_linear(h: torch.Tensor, conv: nn.Conv3d) -> torch.Tensor:
    """An f32 1x1x1 conv head as a matmul over the channels of the NDHWC
    view of ``h`` [B, C, D, H, W]; returns NDHWC. XLA lowers the reference's
    1x1x1 conv the same way, and cuDNN takes the weight gradient of a
    one-output 1x1x1 conv in a direct kernel that cost 148 of 227 ms of a
    batch-8 training step on an H100 (PERF.md)."""
    w = conv.weight.reshape(conv.out_channels, -1)
    return F.linear(h.permute(0, 2, 3, 4, 1).float(), w, conv.bias)


def set_plain_norm(module: nn.Module, plain: bool) -> None:
    """Route every InstanceNorm under ``module`` to the plain PyTorch version
    (``True``) or to the fused kernel (``False``, the default)."""
    for m in module.modules():
        if isinstance(m, InstanceNorm):
            m.plain = plain
