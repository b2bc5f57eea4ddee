"""UNETR, a 3D ViT encoder with a conv decoder (the port of
``multimodal_tta_tpu/models/unetr.py:48-256``), registered as ``unetr``.

  - the patch embed is a stride-p conv; its tokens are flattened in flax's
    raster order (``permute(0, 2, 3, 4, 1).reshape(b, N, H)``), the order
    ``pos_embed`` [1, N, H] indexes;
  - ``num_layers`` ``EncoderBlock``s (with ``moe_experts > 0``, block ``i``
    routes to experts when ``i % moe_every == moe_every - 1``); after every
    ``num_layers / levels`` layers the tokens feed a skip branch (``skip{k}_up{s}`` /
    ``skip{k}_conv{s}``: transposed conv up, then a ConvBlock, ``levels - k``
    times), the last through ``encoder_ln`` to the bottleneck;
  - a full-resolution stem pair (``stem0``, ``stem1``) on the raw input;
  - the decoder ``dec{k}_up`` -> concat ``[h, skip]`` -> ``dec{k}_conv0`` /
    ``dec{k}_conv1`` up to full resolution, and the f32 1x1x1 head.

``pos_embed`` has one row per patch, so the model is built for an input
size (``image_size`` [D, H, W]), as flax's init sizes it on the reference's
dummy input (``training.data.transforms.image_size``); an input with
another patch count raises, as flax's shape check does. Remat (the
reference's rule): the encoder blocks only under ``True``; the stem at level
0 and ``dec{k}`` at level k when remat covers the level; the skip branches
never. ``forward`` takes and returns NDHWC. With ``tp_axis="model"`` the
encoder blocks' heads and MLP features shard over the model axis
(``models/vit.py``, ``parallel/tensor.py``), as the reference's do; the
conv decoder stays whole on every rank of the model group.

Over the space axis (``parallel/space.py``, ambient inside
``space.sharded(mesh)``) ``x`` is this rank's depth slab, and each conv
level (the stem's, the skip branches', the decoder's) is split or whole by
the reference's rule (``space.level_axes``), an ``up`` whose output level
is split keeping its slab of a whole input's output. The patch embed needs
whole patches: a slab that holds whole patches embeds them itself (its
block of the raster-ordered tokens, plus its rows of ``pos_embed``), any
other rank gathers the input's depth first (HECKTOR21's 24-plane slab
holds 1.5 patches of 16). The encoder runs whole on every space rank, or,
with ``seq_shard_axis="space"`` and a token count that divides, on this
rank's block of the tokens (``models/vit.py``). A token map enters the
decoder as its level's slab: a split block whose level is split is that
slab already, any other is gathered whole first.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike, resolve_device
from ..parallel import space as sp
from ..registry import register_model
from ..utils.config import get_config
from .layers import ConvBlock, LayerNorm, TransposedConvUp, head_linear, remat_call
from .unet3d import finish_model
from .vit import EncoderBlock, is_moe_block, sequence_axis


def image_size_of(overrides: dict, name: str) -> tuple:
    """``image_size`` (D, H, W) from ``from_config``'s overrides; the
    reference's error when the caller gives none."""
    size = overrides.pop("image_size", None)
    if size is None:
        raise ValueError(f"{name}: training.data.transforms.image_size ([D,H,W]) is required to "
                         "initialize model parameters")
    return tuple(int(s) for s in size)


@register_model("unetr")
class UNETR(nn.Module):
    input_sized = True  # ExperimentManager passes training.data.transforms.image_size

    def __init__(
        self,
        in_channels: int = 2,
        num_classes: int = 1,
        patch_size: int = 16,
        hidden_size: int = 768,
        mlp_dim: int = 3072,
        num_heads: int = 12,
        num_layers: int = 12,
        feature_size: int = 16,
        norm: str = "INSTANCE",
        act: str = "RELU",
        dropout: float = 0.0,
        dtype: torch.dtype = torch.float32,
        remat=False,
        seq_shard_axis: Optional[str] = None,
        tp_axis: Optional[str] = None,
        moe_experts: int = 0,
        moe_every: int = 2,
        moe_k: int = 1,
        moe_capacity_factor: float = 1.25,
        *,
        image_size: Sequence[int],
        device: DeviceLike = "cuda",
        seed: Optional[int] = 0,
    ):
        super().__init__()
        resolve_device(device)
        self.seq_shard_axis = seq_shard_axis
        p = int(patch_size)
        levels = int(math.log2(p))
        if 2 ** levels != p or levels < 2:
            raise ValueError(f"UNETR patch_size must be a power of two >= 4, got {patch_size}")
        if num_layers % levels:
            raise ValueError(f"num_layers={num_layers} must be divisible by {levels} "
                             f"(one token skip every num_layers/{levels} layers)")
        self.image_size = tuple(int(s) for s in image_size)
        for ax, dim in enumerate(self.image_size):
            if dim % p:
                raise ValueError(f"UNETR spatial dim {ax} = {dim} must be divisible by patch_size={p}")
        self.in_channels, self.num_classes = int(in_channels), int(num_classes)
        self.patch_size, self.levels, self.hidden_size = p, levels, int(hidden_size)
        self.num_layers, self.dropout, self.dtype, self.remat = int(num_layers), float(dropout), dtype, remat
        h = self.hidden_size
        feats = [int(feature_size) * 2 ** k for k in range(levels)]
        blk = dict(norm=norm, act=act, dtype=dtype)

        self.patch_embed = nn.Conv3d(self.in_channels, h, p, stride=p, bias=True)
        self.pos_embed = nn.Parameter(torch.zeros(1, math.prod(d // p for d in self.image_size), h))
        for i in range(self.num_layers):
            self.add_module(f"block{i}", EncoderBlock(
                h, num_heads, mlp_dim, dropout, dtype, tp_axis=tp_axis,
                num_experts=moe_experts if is_moe_block(i, moe_experts, moe_every) else 0,
                moe_k=moe_k, moe_capacity_factor=moe_capacity_factor))
        self.encoder_ln = LayerNorm(h, dtype)
        for k in range(1, levels):
            for s in range(levels - k):
                self.add_module(f"skip{k}_up{s}", TransposedConvUp(h if s == 0 else feats[k], feats[k], 2, dtype))
                self.add_module(f"skip{k}_conv{s}", ConvBlock(feats[k], feats[k], **blk))
        self.stem0 = ConvBlock(self.in_channels, feats[0], **blk)
        self.stem1 = ConvBlock(feats[0], feats[0], **blk)
        for k in reversed(range(levels)):
            self.add_module(f"dec{k}_up", TransposedConvUp(h if k == levels - 1 else feats[k + 1], feats[k], 2,
                                                           dtype))
            self.add_module(f"dec{k}_conv0", ConvBlock(2 * feats[k], feats[k], **blk))
            self.add_module(f"dec{k}_conv1", ConvBlock(feats[k], feats[k], **blk))
        self.head = nn.Conv3d(feats[0], self.num_classes, 1, bias=True)
        finish_model(self, seed, device)

    @classmethod
    def from_config(cls, cfg, **overrides) -> "UNETR":
        """Build from a model config node (the reference's keys; any other
        key, such as the HECKTOR21 recipe's ``channels``, is ignored, as the
        reference does) and ``image_size`` (D, H, W)."""
        image_size = image_size_of(overrides, "UNETR")
        kw = dict(
            in_channels=int(get_config(cfg, "in_channels", 2)),
            num_classes=int(get_config(cfg, "num_classes", 1)),
            patch_size=int(get_config(cfg, "patch_size", 16)),
            hidden_size=int(get_config(cfg, "hidden_size", 768)),
            mlp_dim=int(get_config(cfg, "mlp_dim", 3072)),
            num_heads=int(get_config(cfg, "num_heads", 12)),
            num_layers=int(get_config(cfg, "num_layers", 12)),
            feature_size=int(get_config(cfg, "feature_size", 16)),
            norm=str(get_config(cfg, "norm", "INSTANCE")),
            act=str(get_config(cfg, "act", "RELU")),
            dropout=float(get_config(cfg, "dropout", 0.0)),
            seq_shard_axis=get_config(cfg, "seq_shard_axis", None),
            tp_axis=get_config(cfg, "tp_axis", None),
            moe_experts=int(get_config(cfg, "moe_experts", 0)),
            moe_every=int(get_config(cfg, "moe_every", 2)),
            moe_k=int(get_config(cfg, "moe_k", 1)),
            moe_capacity_factor=float(get_config(cfg, "moe_capacity_factor", 1.25)),
        )
        kw.update(overrides)
        return cls(**kw, image_size=image_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, D, H, W, C_in] -> logits [B, D, H, W, num_classes] (f32);
        over the space axis both are this rank's depth slab."""
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"UNETR expects {self.in_channels} input channels, got {x.shape[-1]}")
        p, ax = self.patch_size, sp.current()
        size = sp.space_size(ax)
        dims = (x.shape[1] * size,) + tuple(x.shape[2:4])  # the whole volume's
        for i, dim in enumerate(dims):
            if dim % p:
                raise ValueError(f"UNETR spatial dim {i} = {dim} must be divisible by patch_size={p}")
        grid = tuple(d // p for d in dims)
        if math.prod(grid) != self.pos_embed.shape[1]:
            raise ValueError(f"UNETR's pos_embed has {self.pos_embed.shape[1]} rows, one per patch of image_size "
                             f"{list(self.image_size)}; the input {list(dims)} has {math.prod(grid)} patches")
        levels, b, hid = self.levels, x.shape[0], self.hidden_size
        rl = levels + 1 if self.remat is True else int(self.remat or 0)
        axes = sp.level_axes(ax, x.shape[1], (2,) * levels)  # each level's axis, None where it is whole
        x = x.to(self.dtype).permute(0, 4, 1, 2, 3)  # NCDHW view of NDHWC memory

        w = self.patch_embed
        n = math.prod(grid)
        seq = sequence_axis(self.seq_shard_axis, n)
        local = ax is not None and x.shape[2] % p == 0  # this slab holds whole patches: its block of the tokens
        src = x if ax is None or local else sp.gather_depth(x, ax)
        tok = F.conv3d(src, w.weight.to(self.dtype), w.bias.to(self.dtype), stride=w.stride)
        tok = tok.permute(0, 2, 3, 4, 1).reshape(b, -1, hid)
        pos = self.pos_embed.to(self.dtype)
        if local:
            k = tok.shape[1]
            tok = sp.relayout(tok + pos[:, ax.rank * k:(ax.rank + 1) * k], ax, seq, ax, 1)
        else:
            tok = sp.relayout(tok + pos, None, seq, ax, 1)
        step = self.num_layers // levels
        skips = {}
        for i in range(self.num_layers):
            tok = remat_call(getattr(self, f"block{i}"), tok, seq, enabled=levels < rl)
            k = (i + 1) // step
            if (i + 1) % step == 0 and 1 <= k <= levels - 1:
                skips[k] = tok
        ztop = self.encoder_ln(tok)

        def to_3d(t: torch.Tensor) -> torch.Tensor:
            """The token map as the deepest level's slab (channels_last_3d)."""
            if seq is not None and axes[levels] is not None:  # the block is this rank's slab of planes
                return t.reshape(b, grid[0] // size, *grid[1:], hid).permute(0, 4, 1, 2, 3)
            whole = t if seq is None else sp.gather_depth(t, seq, 1)
            return sp.relayout(whole.reshape(b, *grid, hid).permute(0, 4, 1, 2, 3), None, axes[levels], ax, 2)

        def up(name: str, h: torch.Tensor, k: int) -> torch.Tensor:
            """``name``'s transposed conv from level ``k + 1`` to level ``k``."""
            return sp.relayout(getattr(self, name)(h), axes[k + 1], axes[k], ax, 2)

        branches = {}
        for k in range(1, levels):  # outside remat, as in the reference
            h = to_3d(skips[k])
            for s in range(levels - k):
                lv = levels - s - 1
                h = getattr(self, f"skip{k}_conv{s}")(up(f"skip{k}_up{s}", h, lv), axes[lv])
            branches[k] = h
        enc0 = remat_call(self.stem1, remat_call(self.stem0, x, axes[0], enabled=0 < rl), axes[0], enabled=0 < rl)

        h = to_3d(ztop)
        for k in reversed(range(levels)):
            h = torch.cat([up(f"dec{k}_up", h, k), branches[k] if k > 0 else enc0], dim=1)
            h = remat_call(getattr(self, f"dec{k}_conv0"), h, axes[k], enabled=k < rl)
            h = remat_call(getattr(self, f"dec{k}_conv1"), h, axes[k], enabled=k < rl)
        return head_linear(h, self.head)
