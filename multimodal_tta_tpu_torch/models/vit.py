"""The ViT encoder pieces that UNETR and SwinUNETR share (the port of
``multimodal_tta_tpu/models/vit.py:84-177``): ``SelfAttention`` and the
pre-norm ``EncoderBlock``. Tokens are ``[B, N, H]``.

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

The ViT classifier (``vit_b_16`` ...) waits for ROADMAP.md item 11.2.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNorm, check_dropout, linear


def check_unported(tp_axis: Optional[str] = None, seq_shard_axis: Optional[str] = None,
                   num_experts: int = 0) -> None:
    """The reference's mesh and MoE options raise here, naming their item."""
    for flag, what in ((tp_axis, "tp_axis"), (seq_shard_axis, "seq_shard_axis")):
        if flag:
            raise NotImplementedError(f"{what}={flag!r} is not ported yet (ROADMAP.md, item 12: "
                                      "tensor and sequence parallelism come with the mesh)")
    if num_experts:
        raise NotImplementedError(f"num_experts={num_experts} is not ported yet (ROADMAP.md, item 11: moe)")


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
    in flax)."""

    def __init__(self, hidden: int, heads: int, dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 tp_axis: Optional[str] = None):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden {hidden} not divisible by heads {heads}")
        check_unported(tp_axis=tp_axis)
        self.heads, self.dtype, self.dropout = heads, dtype, float(dropout)
        for name in ("query", "key", "value"):
            self.add_module(name, nn.Linear(hidden, hidden))
        self.out = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = (linear(x, getattr(self, p), self.dtype).view(b, n, self.heads, -1)
                   for p in ("query", "key", "value"))
        check_dropout(self, self.dropout)
        return linear(attend(q, k, v), self.out, self.dtype)


class EncoderBlock(nn.Module):
    """Pre-norm transformer block: ``x + attn(LN(x))``, then
    ``x + Dense(gelu(Dense(LN(x))))`` with the exact (erf) GELU."""

    def __init__(self, hidden: int, heads: int, mlp_dim: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, tp_axis: Optional[str] = None, num_experts: int = 0):
        super().__init__()
        check_unported(tp_axis=tp_axis, num_experts=num_experts)
        self.dtype = dtype
        self.LayerNorm_0 = LayerNorm(hidden, dtype)
        self.MultiHeadDotProductAttention_0 = SelfAttention(hidden, heads, dropout, dtype)
        self.LayerNorm_1 = LayerNorm(hidden, dtype)
        self.Dense_0 = nn.Linear(hidden, mlp_dim)
        self.Dense_1 = nn.Linear(mlp_dim, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        # flax nn.gelu(approximate=False); get_act("GELU") is flax's tanh default
        y = F.gelu(linear(self.LayerNorm_1(x), self.Dense_0, self.dtype), approximate="none")
        return x + linear(y, self.Dense_1, self.dtype)


__all__ = ["SelfAttention", "EncoderBlock", "attend", "check_unported"]
