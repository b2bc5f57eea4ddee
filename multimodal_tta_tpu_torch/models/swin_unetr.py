"""SwinUNETR, a shifted-window transformer encoder with a UNETR-style conv
decoder (the port of ``multimodal_tta_tpu/models/swin_unetr.py:56-361``),
registered as ``swin_unetr``.

The encoder works on NDHWC token grids ``[B, D, H, W, C]``:
  - ``SwinBlock``: LayerNorm, zero-pad to the window grid (the pad tokens
    take part in the attention, unmasked, as in the reference), a cyclic
    shift by half a window (``torch.roll`` by -s, then +s) on the odd blocks
    where an axis holds more than one window, windowed attention with a
    gathered relative-position bias and the shift mask (-1e9), the crop
    back, then the exact-GELU MLP; the effective window is ``min(w, dim)``;
  - ``PatchMerging``: odd sizes zero-padded, the 8 neighbours concatenated
    in the reference's ``(dz, dy, dx, c)`` order, LayerNorm, ``reduce`` (no
    bias) to twice the width.
The decoder: ``norm_state{j}`` on each stage's output, ``enc{j}_`` and
``dec{j}_`` ConvBlock pairs, ``dec{j}_up`` cropped back to the skip's size
(odd stages), ``enc0_`` / ``dec0_`` at full resolution, the f32 head.

The windowing helpers are this package's own copies of the reference's
(``_triple``, ``_partition``, ``_unpartition``, ``_rel_pos_index``,
``_axis_slices``, ``_shift_mask``); the index and mask tables are numpy,
built once per shape. A block's ``rel_pos_bias`` has one row per relative
offset of its effective window, which the stage's size sets, so the model
is built for an input size (``image_size`` [D, H, W]), as flax's init sizes
it; an input whose stages take other effective windows raises, as flax's
shape check does. Remat (the reference's rule): the encoder only under ``True``;
the bottleneck pair at level ``stages + 1``, ``enc{j}_`` / ``dec{j}_`` at
level j. ``forward`` takes and returns NDHWC.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike, resolve_device
from ..registry import register_model
from ..utils.config import get_config
from .layers import ConvBlock, LayerNorm, TransposedConvUp, head_linear, linear, remat_call
from .unet3d import finish_model
from .unetr import image_size_of
from .vit import attend

Triple = Tuple[int, int, int]


def _triple(v) -> Triple:
    if isinstance(v, (tuple, list)):
        if len(v) != 3:
            raise ValueError(f"expected 3 window dims, got {v!r}")
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def _partition(x: torch.Tensor, w: Triple) -> torch.Tensor:
    """[B, D, H, W, C] -> [B*nW, prod(w), C] (dims must divide by w)."""
    b, d, h, ww_, c = x.shape
    wd, wh, ww = w
    x = x.reshape(b, d // wd, wd, h // wh, wh, ww_ // ww, ww, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, c)


def _unpartition(xw: torch.Tensor, w: Triple, dims: Triple, b: int) -> torch.Tensor:
    """Inverse of :func:`_partition` back to [B, D, H, W, C]."""
    wd, wh, ww = w
    d, h, ww_ = dims
    c = xw.shape[-1]
    x = xw.reshape(b, d // wd, h // wh, ww_ // ww, wd, wh, ww, c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, ww_, c)


@functools.lru_cache(maxsize=None)
def _rel_pos_index(w: Triple) -> np.ndarray:
    """[N, N] flat index into the (2wd-1)(2wh-1)(2ww-1) relative-bias table."""
    wd, wh, ww = w
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww), indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + np.array([wd - 1, wh - 1, ww - 1])
    rel[..., 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[..., 1] *= 2 * ww - 1
    out = rel.sum(-1)
    out.flags.writeable = False  # cached: shared by every caller
    return out


def _axis_slices(dim: int, w: int, s: int):
    if s == 0:
        return [slice(0, dim)]
    return [slice(0, dim - w), slice(dim - w, dim - s), slice(dim - s, dim)]


@functools.lru_cache(maxsize=None)
def _shift_mask(dims: Triple, w: Triple, s: Triple) -> Optional[np.ndarray]:
    """Additive attention bias [nW, N, N] for shifted windows (the Swin
    region-id construction). None when no axis shifts."""
    if not any(s):
        return None
    ids = np.zeros(dims, np.int64)
    cnt = 0
    for sd in _axis_slices(dims[0], w[0], s[0]):
        for sh in _axis_slices(dims[1], w[1], s[1]):
            for sw in _axis_slices(dims[2], w[2], s[2]):
                ids[sd, sh, sw] = cnt
                cnt += 1
    wd, wh, ww = w
    idw = ids.reshape(dims[0] // wd, wd, dims[1] // wh, wh, dims[2] // ww, ww)
    idw = idw.transpose(0, 2, 4, 1, 3, 5).reshape(-1, wd * wh * ww)
    out = np.where(idw[:, :, None] == idw[:, None, :], 0.0, -1e9).astype(np.float32)
    out.flags.writeable = False
    return out


def stage_windows(dims: Triple, window: Triple, shift: bool) -> Tuple[Triple, Triple, Triple]:
    """(effective window, shift, pads) of a block on a ``dims`` grid: the
    window never exceeds the grid; an axis shifts only where it holds more
    than one window."""
    win = tuple(min(ws, d) for ws, d in zip(window, dims))
    sh = tuple((ws // 2 if (shift and d > ws and ws > 1) else 0) for ws, d in zip(win, dims))
    pads = tuple((-d) % ws for d, ws in zip(dims, win))
    return win, sh, pads


class WindowAttention(nn.Module):
    """Multi-head attention within non-overlapping 3D windows of ``window``
    (the block's effective window), with a learned relative position bias
    per head. The index and mask tensors are kept per device."""

    def __init__(self, dim: int, heads: int, window: Triple, dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        self.heads, self.window, self.dtype = heads, tuple(window), dtype
        for name in ("query", "key", "value"):
            self.add_module(name, nn.Linear(dim, dim))
        wd, wh, ww = self.window
        self.rel_pos_bias = nn.Parameter(torch.zeros((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), heads))
        self.out = nn.Linear(dim, dim)
        self._tables = {}

    def _table(self, key, build):
        got = self._tables.get(key)
        if got is None:
            got = self._tables[key] = build()
        return got

    def forward(self, xw: torch.Tensor, mask_key=None) -> torch.Tensor:
        b, n, _ = xw.shape
        dev = xw.device
        q, k, v = (linear(xw, getattr(self, p), self.dtype).view(b, n, self.heads, -1)
                   for p in ("query", "key", "value"))
        index = self._table(("index", dev), lambda: torch.from_numpy(
            _rel_pos_index(self.window).reshape(-1).copy()).to(dev))
        bias = self.rel_pos_bias[index].reshape(n, n, self.heads).permute(2, 0, 1)
        mask = None
        if mask_key is not None:
            mask = self._table(("mask", dev) + mask_key, lambda: torch.from_numpy(
                _shift_mask(*mask_key).copy()).to(dev))
        return linear(attend(q, k, v, bias=bias, mask=mask), self.out, self.dtype)


class SwinBlock(nn.Module):
    """Pre-norm Swin block: (shifted-)window attention and the MLP, with the
    pad to the window grid and the crop back. ``dims``, the grid it is built
    for, sizes its bias table (the effective window); a grid with another
    effective window raises, as flax's shape check does."""

    def __init__(self, dim: int, heads: int, window: Triple, shift: bool, dims: Triple, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window, self.shift, self.dtype = _triple(window), bool(shift), dtype
        self.ln_attn = LayerNorm(dim, dtype)
        self.attn = WindowAttention(dim, heads, stage_windows(tuple(dims), self.window, shift)[0], dtype)
        self.ln_mlp = LayerNorm(dim, dtype)
        self.mlp_in = nn.Linear(dim, dim * mlp_ratio)
        self.mlp_out = nn.Linear(dim * mlp_ratio, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w_, _ = x.shape
        win, sh, pads = stage_windows((d, h, w_), self.window, self.shift)
        if win != self.attn.window:
            raise ValueError(f"SwinBlock: its rel_pos_bias fits the window {list(self.attn.window)} of the grid it "
                             f"was built for; the grid {[d, h, w_]} takes the window {list(win)}")
        pdims = (d + pads[0], h + pads[1], w_ + pads[2])
        y = self.ln_attn(x)
        if any(pads):
            y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        if any(sh):
            y = torch.roll(y, tuple(-s for s in sh), dims=(1, 2, 3))
        yw = self.attn(_partition(y, win), (pdims, win, sh) if any(sh) else None)
        y = _unpartition(yw, win, pdims, b)
        if any(sh):
            y = torch.roll(y, sh, dims=(1, 2, 3))
        if any(pads):
            y = y[:, :d, :h, :w_]
        x = x + y
        y = F.gelu(linear(self.ln_mlp(x), self.mlp_in, self.dtype), approximate="none")  # flax's exact GELU
        return x + linear(y, self.mlp_out, self.dtype)


class PatchMerging(nn.Module):
    """2x downsample: the 8 neighbours concatenated -> LayerNorm -> ``reduce``
    (no bias) to 2 x dim; odd sizes are zero-padded to even first."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = LayerNorm(8 * dim, dtype)
        self.reduce = nn.Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w_, c = x.shape
        pads = ((-d) % 2, (-h) % 2, (-w_) % 2)
        if any(pads):
            x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
            d, h, w_ = d + pads[0], h + pads[1], w_ + pads[2]
        x = x.reshape(b, d // 2, 2, h // 2, 2, w_ // 2, 2, c)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, d // 2, h // 2, w_ // 2, 8 * c)
        return linear(self.norm(x), self.reduce, self.dtype)


@register_model("swin_unetr")
class SwinUNETR(nn.Module):
    input_sized = True  # ExperimentManager passes training.data.transforms.image_size

    def __init__(
        self,
        in_channels: int = 2,
        num_classes: int = 1,
        feature_size: int = 48,
        depths: Sequence[int] = (2, 2, 2, 2),
        num_heads: Sequence[int] = (3, 6, 12, 24),
        window_size=4,
        patch_size: int = 2,
        mlp_ratio: int = 4,
        norm: str = "INSTANCE",
        act: str = "RELU",
        dtype: torch.dtype = torch.float32,
        remat=False,
        *,
        image_size: Sequence[int],
        device: DeviceLike = "cuda",
        seed: Optional[int] = 0,
    ):
        super().__init__()
        resolve_device(device)
        if len(depths) != len(num_heads):
            raise ValueError("depths and num_heads must have equal length")
        p = int(patch_size)
        self.image_size = tuple(int(s) for s in image_size)
        for ax, dim in enumerate(self.image_size):
            if dim % p:
                raise ValueError(f"SwinUNETR spatial dim {ax} = {dim} must be divisible by patch_size={p}")
        self.in_channels, self.num_classes, self.patch_size = int(in_channels), int(num_classes), p
        self.depths = tuple(int(d) for d in depths)
        self.stages, self.dtype, self.remat = len(self.depths), dtype, remat
        fs = int(feature_size)
        blk = dict(norm=norm, act=act, dtype=dtype)

        self.patch_embed = nn.Conv3d(self.in_channels, fs, p, stride=p, bias=True)
        dims = tuple(d // p for d in self.image_size)
        for s_i, (depth, heads) in enumerate(zip(self.depths, num_heads)):
            dim = fs * 2 ** s_i
            for b_i in range(depth):
                self.add_module(f"stage{s_i}_block{b_i}", SwinBlock(dim, int(heads), _triple(window_size),
                                                                    bool(b_i % 2), dims, int(mlp_ratio), dtype))
            self.add_module(f"merge{s_i}", PatchMerging(dim, dtype))
            dims = tuple(-(-d // 2) for d in dims)
        top = fs * 2 ** self.stages
        self.norm_bottom = LayerNorm(top, dtype)
        self.add_module("bottleneck0", ConvBlock(top, top, **blk))
        self.add_module("bottleneck1", ConvBlock(top, top, **blk))
        for j in reversed(range(self.stages)):
            f = fs * 2 ** j
            self.add_module(f"norm_state{j}", LayerNorm(f, dtype))
            self.add_module(f"enc{j + 1}_0", ConvBlock(f, f, **blk))
            self.add_module(f"enc{j + 1}_1", ConvBlock(f, f, **blk))
            self.add_module(f"dec{j + 1}_up", TransposedConvUp(2 * f, f, 2, dtype))
            self.add_module(f"dec{j + 1}_0", ConvBlock(2 * f, f, **blk))
            self.add_module(f"dec{j + 1}_1", ConvBlock(f, f, **blk))
        self.add_module("enc0_0", ConvBlock(self.in_channels, fs, **blk))
        self.add_module("enc0_1", ConvBlock(fs, fs, **blk))
        self.add_module("dec0_up", TransposedConvUp(fs, fs, p, dtype))
        self.add_module("dec0_0", ConvBlock(2 * fs, fs, **blk))
        self.add_module("dec0_1", ConvBlock(fs, fs, **blk))
        self.head = nn.Conv3d(fs, self.num_classes, 1, bias=True)
        finish_model(self, seed, device)

    @classmethod
    def from_config(cls, cfg, **overrides) -> "SwinUNETR":
        """Build from a model config node (the reference's keys; any other
        key is ignored, as the reference does) and ``image_size`` (D, H, W)."""
        image_size = image_size_of(overrides, "SwinUNETR")
        window = get_config(cfg, "window_size", 4)
        kw = dict(
            in_channels=int(get_config(cfg, "in_channels", 2)),
            num_classes=int(get_config(cfg, "num_classes", 1)),
            feature_size=int(get_config(cfg, "feature_size", 48)),
            depths=tuple(int(d) for d in get_config(cfg, "depths", (2, 2, 2, 2))),
            num_heads=tuple(int(h) for h in get_config(cfg, "num_heads", (3, 6, 12, 24))),
            window_size=window if isinstance(window, int) else tuple(int(w) for w in window),
            patch_size=int(get_config(cfg, "patch_size", 2)),
            mlp_ratio=int(get_config(cfg, "mlp_ratio", 4)),
            norm=str(get_config(cfg, "norm", "INSTANCE")),
            act=str(get_config(cfg, "act", "RELU")),
        )
        kw.update(overrides)
        return cls(**kw, image_size=image_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, D, H, W, C_in] -> logits [B, D, H, W, num_classes] (f32)."""
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"SwinUNETR expects {self.in_channels} input channels, got {x.shape[-1]}")
        for ax, dim in enumerate(x.shape[1:4]):
            if dim % self.patch_size:
                raise ValueError(f"SwinUNETR spatial dim {ax} = {dim} must be divisible by "
                                 f"patch_size={self.patch_size}")
        stages = self.stages
        rl = stages + 2 if self.remat is True else int(self.remat or 0)
        x = x.to(self.dtype).permute(0, 4, 1, 2, 3)  # NCDHW view of NDHWC memory

        def pair(name: str, y: torch.Tensor, level: int) -> torch.Tensor:
            y = remat_call(getattr(self, f"{name}0"), y, enabled=level < rl)
            return remat_call(getattr(self, f"{name}1"), y, enabled=level < rl)

        w = self.patch_embed
        h = F.conv3d(x, w.weight.to(self.dtype), w.bias.to(self.dtype), stride=w.stride)
        h = h.permute(0, 2, 3, 4, 1)  # NDHWC tokens (contiguous: channels_last_3d)
        states = []
        for s_i, depth in enumerate(self.depths):
            for b_i in range(depth):
                h = remat_call(getattr(self, f"stage{s_i}_block{b_i}"), h, enabled=stages + 1 < rl)
            states.append(h)
            h = getattr(self, f"merge{s_i}")(h)

        def ncdhw(t: torch.Tensor) -> torch.Tensor:
            return t.permute(0, 4, 1, 2, 3)

        h = pair("bottleneck", ncdhw(self.norm_bottom(h)), stages + 1)
        for j in reversed(range(stages)):
            skip = pair(f"enc{j + 1}_", ncdhw(getattr(self, f"norm_state{j}")(states[j])), j + 1)
            h = getattr(self, f"dec{j + 1}_up")(h)
            sd, sh_, sw = skip.shape[2:]
            h = h[:, :, :sd, :sh_, :sw]  # merges ceil-halve odd sizes: crop the doubled map back
            h = pair(f"dec{j + 1}_", torch.cat([h, skip], dim=1), j + 1)
        enc0 = pair("enc0_", x, 0)
        h = torch.cat([self.dec0_up(h), enc0], dim=1)
        return head_linear(pair("dec0_", h, 0), self.head)


__all__ = ["SwinUNETR", "SwinBlock", "PatchMerging", "WindowAttention"]
