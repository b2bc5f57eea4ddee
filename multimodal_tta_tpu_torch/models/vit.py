"""The Vision Transformer (the port of ``multimodal_tta_tpu/models/vit.py``):
the encoder pieces that UNETR and SwinUNETR share, ``SelfAttention`` and
the pre-norm ``EncoderBlock``, and the ``ViT`` classifier (``vit_b_16``,
``vit_b_32``, ``vit_l_16``, ``vit_l_32``, ``vit_h_14``). Tokens are
``[B, N, H]``.

Module names are flax's (``MultiHeadDotProductAttention_0`` with
``query``/``key``/``value``/``out``, ``LayerNorm_0``, ``LayerNorm_1``,
``Dense_0``, ``Dense_1``), so ``models/convert.py`` carries the reference's
weights across and ``flax_path`` gives back its param paths. A DenseGeneral
projection is an ``nn.Linear`` here: q/k/v ``[heads*hd, H]``, out
``[H, heads*hd]``.

Attention is computed as the reference writes it, step for step: q scaled
by ``1/sqrt(hd)`` in the compute dtype, ``q @ k^T``, softmax over the last
axis, ``@ v``, the out projection. The reference runs it as XLA ops, not a
Pallas kernel, so it is library matmuls here too.

The classifier embeds ``patch x patch`` patches with a VALID conv
(``patch_embed``), prepends ``cls_token``, adds ``pos_embed`` (one row per
patch and the CLS token, so its size follows ``image_size``), runs
``block{i}`` and ``final_ln`` (flax's LayerNorm, eps 1e-6) and returns
``(CLS features, logits)`` in f32 from the ``head``. It has no BatchNorm:
Tent adapts its LayerNorms. With ``num_experts > 0`` an ``EncoderBlock``
swaps its dense MLP for ``models/moe.py:MoEMlp`` (``moe``, after the
pre-norm ``LayerNorm_1``), and ``ViT(moe_experts=...)`` routes every
``moe_every``-th block, as in the reference.

``tp_axis="model"`` makes the heads and the MLP features shardable over
the model axis (``parallel/tensor.py``: ``shard_model`` cuts each rank's
share, Megatron-style; the MoE blocks stay whole, as in the reference); a
model that is not cut runs whole.

The sequence axis (``seq_shard_axis="space"``, the reference's
``_maybe_shard_seq``): inside ``space.sharded(mesh)`` a token axis of ``N``
splits over the space group when ``N % space == 0`` (``space.tokens_split``,
the reference's strict rule), rank ``s`` holding the tokens
``[s*N/space, (s+1)*N/space)``. ``SelfAttention`` then takes this rank's
queries against the keys and values gathered over the group
(``space.gather_depth`` on the token dim: the backward sums each rank's part of their
gradient), and the softmax runs over the whole key axis; the MLP, the
LayerNorms and the residuals are per token and stay local. Any other axis
name, an axis without a mesh and an indivisible count run whole, the
numbers the reference's no-op gives; a name that no ambient mesh carries
(outside every ``space.sharded`` block, or not an axis of its mesh) logs
the reference's warning once per name.

``ViT`` on a space mesh: ``Mesh.local`` cuts the image's
rows, which the forward gathers before the patch embed; the tokens split by
the rule above (whole without the sequence axis), and the CLS features come
out whole on every rank of the group (a loss of them is alike on every
rank: the adapters count it at ``1 / space``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike, resolve_device
from ..parallel import space as sp
from ..parallel.tensor import check_tp_axis, copy_to, narrow_param, reduce_from
from ..registry import register_model
from ..utils.config import get_config
from ..utils.logger import get_logger
from .layers import LayerNorm, check_dropout, linear
from .moe import EXPERT_AXIS, MoEMlp
from .resnet import _VariantFactory, finish_classifier


SEQ_AXIS = "space"  # the mesh axis a token axis splits over (``seq_shard_axis``)


_seq_shard_warned: set = set()


def sequence_axis(seq_shard_axis: Optional[str], n_tokens: int) -> Optional[sp.SpaceAxis]:
    """The ambient space axis that a token axis of ``n_tokens`` splits over
    under ``seq_shard_axis`` (None: the tokens run whole). A
    ``seq_shard_axis`` that no ambient mesh carries (``space.mesh_axes``)
    logs the reference's warning, once per axis name."""
    if seq_shard_axis and seq_shard_axis not in sp.mesh_axes() and seq_shard_axis not in _seq_shard_warned:
        _seq_shard_warned.add(seq_shard_axis)
        get_logger().warning(
            f"[vit] seq_shard_axis={seq_shard_axis!r} is set but no ambient mesh "
            f"carries that axis — sequence parallelism disabled for this "
            f"trace (run under `with mesh:` / jax.set_mesh)"
        )
    ax = sp.current()
    if seq_shard_axis != SEQ_AXIS or ax is None or not sp.tokens_split(n_tokens, ax.size):
        return None
    return ax


def row_parallel(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype, tp) -> torch.Tensor:
    """``linear`` of a row-parallel layer (this rank's input features): the
    products summed over the model group, then the bias once."""
    if tp is None:
        return linear(x, layer, dtype)
    y = reduce_from(F.linear(x.to(dtype), layer.weight.to(dtype)), tp)
    return y + layer.bias.to(dtype)


def is_moe_block(i: int, moe_experts: int, moe_every: int) -> bool:
    """Block ``i`` routes to experts: every ``moe_every``-th, the last of each group."""
    return moe_experts > 0 and i % moe_every == moe_every - 1


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor] = None,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention of ``[B, N, heads, hd]`` q/k/v -> ``[B, N, heads*hd]``.
    ``bias`` ``[heads, N, N]`` is added to every row of windows, ``mask``
    ``[nW, N, N]`` to the windows ``b % nW`` (B = batch x nW, window-major
    within a sample, as the reference's reshape lays them out)."""
    b, n, heads, hd = q.shape
    scale = float(torch.tensor(float(hd), dtype=q.dtype).sqrt())  # jnp.sqrt(hd) in the compute dtype
    q = q / scale
    attn = torch.matmul(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1))  # "bqhd,bkhd->bhqk"
    if bias is not None:
        attn = attn + bias.unsqueeze(0).to(attn.dtype)
    if mask is not None:
        n_win = mask.shape[0]
        attn = (attn.reshape(-1, n_win, heads, n, n) + mask[None, :, None].to(attn.dtype)).reshape(b, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    ctx = torch.matmul(attn, v.permute(0, 2, 1, 3))  # "bhqk,bkhd->bqhd"
    return ctx.permute(0, 2, 1, 3).reshape(b, n, heads * hd)


class SelfAttention(nn.Module):
    """Multi-head self-attention with ``nn.MultiHeadDotProductAttention``'s
    param tree (q/k/v DenseGeneral ``[H, heads, hd]``, out ``[heads, hd, H]``
    in flax). Cut over a model axis (``shard``) a rank holds ``heads /
    model`` heads: the rows of q/k/v, the columns of out."""

    tp = None  # the model axis this module is cut over (``parallel/tensor.py``)

    def __init__(self, hidden: int, heads: int, dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 tp_axis: Optional[str] = None):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden {hidden} not divisible by heads {heads}")
        self.tp_axis = check_tp_axis(tp_axis)
        self.heads, self.dtype, self.dropout = heads, dtype, float(dropout)
        for name in ("query", "key", "value"):
            self.add_module(name, nn.Linear(hidden, hidden))
        self.out = nn.Linear(hidden, hidden)

    def shard(self, axis) -> None:
        """Keep this rank's heads (column-parallel q/k/v, row-parallel out)."""
        heads = axis.block(self.heads, "heads")
        hd = self.query.out_features // self.heads
        rows = slice(heads.start * hd, heads.stop * hd)
        for name in ("query", "key", "value"):
            narrow_param(self, f"{name}.weight", 0, rows, axis)
            narrow_param(self, f"{name}.bias", 0, rows, axis)
        narrow_param(self, "out.weight", 1, rows, axis)
        self.heads, self.tp = heads.stop - heads.start, axis

    def forward(self, x: torch.Tensor, space=None) -> torch.Tensor:
        """``space``: the space axis when ``x`` [B, n, H] is this rank's
        block of a split token axis (its queries; the keys and values are
        gathered over the group)."""
        b, n, _ = x.shape
        x = copy_to(x, self.tp)
        q, k, v = (linear(x, getattr(self, p), self.dtype).view(b, n, self.heads, -1)
                   for p in ("query", "key", "value"))
        if space is not None:
            k, v = sp.gather_depth(torch.cat([k, v], dim=-1), space, 1).chunk(2, dim=-1)
        check_dropout(self, self.dropout)
        return row_parallel(attend(q, k, v), self.out, self.dtype, self.tp)


class EncoderBlock(nn.Module):
    """Pre-norm transformer block: ``x + attn(LN(x))``, then
    ``x + Dense(gelu(Dense(LN(x))))`` with the exact (erf) GELU, or with
    ``num_experts > 0`` ``x + moe(LN(x))`` (``models/moe.py``). Cut over a
    model axis (``shard``) a dense block holds ``mlp_dim / model`` features
    (column-parallel ``Dense_0``, row-parallel ``Dense_1``); a MoE block
    stays whole, as in the reference."""

    tp = None  # the model axis this module's MLP is cut over

    def __init__(self, hidden: int, heads: int, mlp_dim: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, tp_axis: Optional[str] = None, num_experts: int = 0,
                 moe_k: int = 1, moe_capacity_factor: float = 1.25, moe_axis: Optional[str] = EXPERT_AXIS):
        super().__init__()
        self.tp_axis = check_tp_axis(tp_axis)
        self.dtype, self.num_experts = dtype, int(num_experts)
        self.LayerNorm_0 = LayerNorm(hidden, dtype)
        self.MultiHeadDotProductAttention_0 = SelfAttention(hidden, heads, dropout, dtype, tp_axis=tp_axis)
        self.LayerNorm_1 = LayerNorm(hidden, dtype)
        if self.num_experts > 0:
            self.moe = MoEMlp(hidden, mlp_dim, num_experts, moe_k, moe_capacity_factor, moe_axis, dtype)
            return
        self.Dense_0 = nn.Linear(hidden, mlp_dim)
        self.Dense_1 = nn.Linear(mlp_dim, hidden)

    def shard(self, axis) -> None:
        """Keep this rank's MLP features (the attention cuts itself)."""
        if self.num_experts > 0:
            return
        feats = axis.block(self.Dense_0.out_features, "mlp_dim")
        narrow_param(self, "Dense_0.weight", 0, feats, axis)
        narrow_param(self, "Dense_0.bias", 0, feats, axis)
        narrow_param(self, "Dense_1.weight", 1, feats, axis)
        self.tp = axis

    def forward(self, x: torch.Tensor, space=None) -> torch.Tensor:
        """``space``: the space axis when ``x`` is this rank's block of a
        split token axis."""
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x), space)
        if self.num_experts > 0:
            return x + self.moe(self.LayerNorm_1(x), space=space)
        # flax nn.gelu(approximate=False); get_act("GELU") is flax's tanh default
        y = copy_to(self.LayerNorm_1(x), self.tp)
        y = F.gelu(linear(y, self.Dense_0, self.dtype), approximate="none")
        return x + row_parallel(y, self.Dense_1, self.dtype, self.tp)


_SPECS = {
    # (patch, hidden, depth, heads, mlp_dim)
    "vit_b_16": (16, 768, 12, 12, 3072),
    "vit_b_32": (32, 768, 12, 12, 3072),
    "vit_l_16": (16, 1024, 24, 16, 4096),
    "vit_l_32": (32, 1024, 24, 16, 4096),
    "vit_h_14": (14, 1280, 32, 16, 5120),
}


class ViT(nn.Module):
    """x: [B, H, W, C] -> (CLS features [B, hidden], logits [B, num_classes]).
    ``patch``, ``hidden``, ``depth``, ``heads`` and ``mlp_dim`` override the
    variant's topology, as in the reference."""

    def __init__(self, variant: str = "vit_b_16", num_classes: int = 1000, image_size: int = 224,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32, seq_shard_axis: Optional[str] = None,
                 tp_axis: Optional[str] = None, moe_experts: int = 0, moe_every: int = 2, moe_k: int = 1,
                 moe_capacity_factor: float = 1.25, patch: Optional[int] = None,
                 hidden: Optional[int] = None, depth: Optional[int] = None, heads: Optional[int] = None,
                 mlp_dim: Optional[int] = None, in_channels: int = 3, *, device: DeviceLike = "cuda",
                 seed: Optional[int] = 0):
        super().__init__()
        if variant not in _SPECS:
            raise ValueError(f"Unknown vit variant: {variant}")
        resolve_device(device)
        self.seq_shard_axis = seq_shard_axis
        spec = [v if o is None else int(o) for v, o in zip(_SPECS[variant], (patch, hidden, depth, heads, mlp_dim))]
        self.patch, hidden, depth, heads, mlp_dim = spec
        self.variant, self.dtype, self.in_channels = variant, dtype, int(in_channels)
        self.image_size = int(image_size)
        if self.image_size % self.patch:
            raise ValueError(f"ViT input {self.image_size}x{self.image_size} not divisible by patch {self.patch}")
        n_tokens = (self.image_size // self.patch) ** 2 + 1
        self.patch_embed = nn.Conv2d(self.in_channels, hidden, self.patch, self.patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens, hidden))
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", EncoderBlock(
                hidden, heads, mlp_dim, dropout, dtype, tp_axis=tp_axis, num_experts=moe_experts if is_moe_block(
                    i, moe_experts, moe_every) else 0, moe_k=moe_k, moe_capacity_factor=moe_capacity_factor))
        self.final_ln = LayerNorm(hidden, dtype)
        self.head = nn.Linear(hidden, num_classes)
        finish_classifier(self, seed, device)

    @classmethod
    def from_config(cls, cfg, **overrides) -> "ViT":
        kw = dict(
            variant=str(get_config(cfg, "name", "vit_b_16")),
            num_classes=int(get_config(cfg, "num_classes", 1000)),
            image_size=int(get_config(cfg, "image_size", 224)),
            dropout=float(get_config(cfg, "dropout", 0.0)),
            seq_shard_axis=get_config(cfg, "seq_shard_axis", None),
            tp_axis=get_config(cfg, "tp_axis", None),
            moe_experts=int(get_config(cfg, "moe_experts", 0)),
            moe_every=int(get_config(cfg, "moe_every", 2)),
            moe_k=int(get_config(cfg, "moe_k", 1)),
            moe_capacity_factor=float(get_config(cfg, "moe_capacity_factor", 1.25)),
            in_channels=int(get_config(cfg, "in_channels", 3)),
        )
        kw.update(overrides)
        kw.pop("remat", None)
        return cls(**kw)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        ax = sp.current()
        if ax is not None:  # this rank's rows of the images: the patch embed takes them whole
            x = sp.gather_depth(x, ax, dim=1)
        x = self.embed(x)
        seq = sequence_axis(self.seq_shard_axis, x.shape[1])
        if seq is not None:
            x = sp.slice_depth(x, seq, dim=1)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, seq)
        return self.head_of(x if seq is None else sp.gather_depth(x, seq, 1))

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """The tokens [B, N, hidden] the first block takes: the patch
        embedding, the CLS token and the position embedding."""
        b, h, w, c = x.shape
        if h % self.patch or w % self.patch:
            raise ValueError(f"ViT input {h}x{w} not divisible by patch {self.patch}")
        if (h // self.patch) * (w // self.patch) + 1 != self.pos_embed.shape[1]:
            raise ValueError(f"ViT input {h}x{w} gives another patch count than image_size {self.image_size}")
        if c != self.in_channels:
            raise ValueError(f"ViT expects {self.in_channels} input channels, got {c}")
        pe = self.patch_embed
        x = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), pe.weight.to(self.dtype), pe.bias.to(self.dtype),
                     stride=pe.stride)
        x = x.flatten(2).transpose(1, 2)  # [B, N, hidden], patches row-major as the reference's reshape
        cls_tok = self.cls_token.to(self.dtype).expand(b, -1, -1)
        return torch.cat([cls_tok, x], dim=1) + self.pos_embed.to(self.dtype)

    def head_of(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(CLS features, logits)`` in f32 of the last block's tokens."""
        feats = self.final_ln(x)[:, 0].float()
        return feats, F.linear(feats, self.head.weight, self.head.bias)


for _name in _SPECS:
    register_model(_name)(_VariantFactory(ViT, _name))


def get_vit_model(name: str, **kw) -> ViT:
    if name not in _SPECS:
        raise ValueError(f"Unknown vit variant: {name}")
    return ViT(variant=name, **kw)


__all__ = ["SelfAttention", "EncoderBlock", "ViT", "attend", "get_vit_model", "is_moe_block", "sequence_axis"]
