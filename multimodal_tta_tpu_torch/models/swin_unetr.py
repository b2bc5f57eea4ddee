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

Over the space axis (``parallel/space.py``, ambient inside
``space.sharded(mesh)``) ``x`` is this rank's depth slab. The conv levels
(level 0 the input's, level ``j + 1`` stage j's grid, level ``stages + 1``
the bottleneck's) are split or whole by the reference's rule
(``space.level_axes``). A Swin stage is split only where its level is and
each rank's slab holds whole windows (slab depth ``% min(w, D) == 0`` with
the stage's global ``D``: no depth pad, and every window on one rank); any
other stage runs whole on every space rank. In a split stage the shift
rolls the depth cyclically over the group (``space.roll_depth``, by ``-s``
and back by ``+s``), the shift mask is built on the global padded grid and
each rank takes its windows' rows of it, and only H and W pad. The patch
embed is local where the slab holds whole patches; ``PatchMerging`` merges
a split stage locally (its slab is even), else on the gathered grid, where
the pad lies at the global end of the depth. A whole level's ``dec{j}_up``
output is cropped to the global depth before each rank takes its slab.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike, resolve_device
from ..parallel import space as sp
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
        """``mask_key``: ``(padded grid, window, shift, rows)`` of a shifted
        block, ``rows`` the (start, stop) of this rank's windows in the
        global grid's window order (None: all of them)."""
        b, n, _ = xw.shape
        dev = xw.device
        q, k, v = (linear(xw, getattr(self, p), self.dtype).view(b, n, self.heads, -1)
                   for p in ("query", "key", "value"))
        index = self._table(("index", dev), lambda: torch.from_numpy(
            _rel_pos_index(self.window).reshape(-1).copy()).to(dev))
        bias = self.rel_pos_bias[index].reshape(n, n, self.heads).permute(2, 0, 1)
        mask = None
        if mask_key is not None:
            rows = slice(*mask_key[3]) if mask_key[3] is not None else slice(None)
            mask = self._table(("mask", dev) + mask_key, lambda: torch.from_numpy(
                _shift_mask(*mask_key[:3])[rows].copy()).to(dev))
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

    def forward(self, x: torch.Tensor, space=None) -> torch.Tensor:
        """``space``: the space axis when ``x`` is this rank's depth slab of
        the stage's grid (a slab of whole windows)."""
        b, d, h, w_, _ = x.shape
        dims = (d * sp.space_size(space), h, w_)  # the whole grid's
        win, sh, pads = stage_windows(dims, self.window, self.shift)
        if win != self.attn.window:
            raise ValueError(f"SwinBlock: its rel_pos_bias fits the window {list(self.attn.window)} of the grid it "
                             f"was built for; the grid {list(dims)} takes the window {list(win)}")
        if space is not None and d % win[0]:
            raise ValueError(f"[space] a slab of {d} planes holds no whole windows of depth {win[0]}")
        pdims = tuple(n + p for n, p in zip(dims, pads))
        local = (d + (pads[0] if space is None else 0),) + pdims[1:]  # this rank's padded slab
        rows = None
        if space is not None:  # this rank's windows of the global grid (depth-major)
            n_win = (d // win[0]) * (pdims[1] // win[1]) * (pdims[2] // win[2])
            rows = (space.rank * n_win, (space.rank + 1) * n_win)
        y = self.ln_attn(x)
        if any(pads):
            y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0] if space is None else 0))
        y = self._roll(y, tuple(-s for s in sh), space)
        yw = self.attn(_partition(y, win), (pdims, win, sh, rows) if any(sh) else None)
        y = self._roll(_unpartition(yw, win, local, b), sh, space)
        if any(pads):
            y = y[:, :d, :h, :w_]
        x = x + y
        y = F.gelu(linear(self.ln_mlp(x), self.mlp_in, self.dtype), approximate="none")  # flax's exact GELU
        return x + linear(y, self.mlp_out, self.dtype)

    @staticmethod
    def _roll(y: torch.Tensor, shifts: Triple, space) -> torch.Tensor:
        """``torch.roll`` of the grid by ``shifts`` (D, H, W); a split depth
        rolls over the space group."""
        if not any(shifts):
            return y
        if space is None or not shifts[0]:
            return torch.roll(y, shifts, dims=(1, 2, 3))
        return torch.roll(sp.roll_depth(y, shifts[0], space), shifts[1:], dims=(2, 3))


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
        self.window = _triple(window_size)
        fs = int(feature_size)
        blk = dict(norm=norm, act=act, dtype=dtype)

        self.patch_embed = nn.Conv3d(self.in_channels, fs, p, stride=p, bias=True)
        dims = tuple(d // p for d in self.image_size)
        for s_i, (depth, heads) in enumerate(zip(self.depths, num_heads)):
            dim = fs * 2 ** s_i
            for b_i in range(depth):
                self.add_module(f"stage{s_i}_block{b_i}", SwinBlock(dim, int(heads), self.window,
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

    def stage_axes(self, ax, depth: int) -> Tuple[list, list]:
        """Over a space axis ``ax`` and an input slab of ``depth`` planes:
        each conv level's axis (None where it is whole) and each stage's
        (split where its level is and the slab holds whole windows)."""
        strides = (self.patch_size,) + (2,) * self.stages
        levels = sp.level_axes(ax, depth, strides)
        stages, d = [], depth * sp.space_size(ax) // self.patch_size
        for j in range(self.stages):
            wd = min(self.window[0], d)
            stages.append(levels[j + 1] if levels[j + 1] is not None and (d // ax.size) % wd == 0 else None)
            d = -(-d // 2)
        return levels, stages

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, D, H, W, C_in] -> logits [B, D, H, W, num_classes] (f32);
        over the space axis both are this rank's depth slab."""
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"SwinUNETR expects {self.in_channels} input channels, got {x.shape[-1]}")
        ax = sp.current()
        for i, dim in enumerate((x.shape[1] * sp.space_size(ax),) + tuple(x.shape[2:4])):
            if dim % self.patch_size:
                raise ValueError(f"SwinUNETR spatial dim {i} = {dim} must be divisible by "
                                 f"patch_size={self.patch_size}")
        stages, p = self.stages, self.patch_size
        rl = stages + 2 if self.remat is True else int(self.remat or 0)
        axes, stage_ax = self.stage_axes(ax, x.shape[1])
        x = x.to(self.dtype).permute(0, 4, 1, 2, 3)  # NCDHW view of NDHWC memory

        def pair(name: str, y: torch.Tensor, level: int) -> torch.Tensor:
            y = remat_call(getattr(self, f"{name}0"), y, axes[level], enabled=level < rl)
            return remat_call(getattr(self, f"{name}1"), y, axes[level], enabled=level < rl)

        w = self.patch_embed
        cur = ax if ax is not None and x.shape[2] % p == 0 else None  # a slab of whole patches embeds itself
        src = x if ax is None or cur is not None else sp.gather_depth(x, ax)
        h = F.conv3d(src, w.weight.to(self.dtype), w.bias.to(self.dtype), stride=w.stride)
        h = h.permute(0, 2, 3, 4, 1)  # NDHWC tokens (contiguous: channels_last_3d)
        states = []
        for s_i, depth in enumerate(self.depths):
            h, cur = sp.relayout(h, cur, stage_ax[s_i], ax, 1), stage_ax[s_i]
            for b_i in range(depth):
                h = remat_call(getattr(self, f"stage{s_i}_block{b_i}"), h, cur, enabled=stages + 1 < rl)
            states.append(h)
            if cur is not None and h.shape[1] % 2:  # a split slab merges locally when it is even
                h, cur = sp.gather_depth(h, ax, 1), None
            h = getattr(self, f"merge{s_i}")(h)

        def ncdhw(t: torch.Tensor, have, level: int) -> torch.Tensor:
            return sp.relayout(t.permute(0, 4, 1, 2, 3), have, axes[level], ax, 2)

        h = pair("bottleneck", ncdhw(self.norm_bottom(h), cur, stages + 1), stages + 1)
        for j in reversed(range(stages)):
            skip = pair(f"enc{j + 1}_", ncdhw(getattr(self, f"norm_state{j}")(states[j]), stage_ax[j], j + 1), j + 1)
            h = getattr(self, f"dec{j + 1}_up")(h)
            sd, sh_, sw = skip.shape[2:]
            if axes[j + 2] is None:  # merges ceil-halve odd sizes: crop the doubled map back, then the slab
                h = sp.relayout(h[:, :, :sd * sp.space_size(axes[j + 1])], None, axes[j + 1], ax, 2)
            h = h[:, :, :, :sh_, :sw]
            h = pair(f"dec{j + 1}_", torch.cat([h, skip], dim=1), j + 1)
        enc0 = pair("enc0_", x, 0)
        h = torch.cat([sp.relayout(self.dec0_up(h), axes[1], axes[0], ax, 2), enc0], dim=1)
        return head_linear(pair("dec0_", h, 0), self.head)


__all__ = ["SwinUNETR", "SwinBlock", "PatchMerging", "WindowAttention"]
