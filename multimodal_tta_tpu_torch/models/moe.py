"""Mixture-of-Experts MLP (the port of ``multimodal_tta_tpu/models/moe.py``).

A drop-in transformer FFN, ``[B, N, H] -> [B, N, H]``, with the reference's
static Switch/GShard routing:

  - an f32 router (``nn.Linear`` on ``x.float()``), softmax, top-k with k in
    {1, 2}; k=2 gates are renormalized to sum 1, k=1 keeps the raw gate;
  - per-expert capacity ``C = ceil(capacity_factor * k * N / E)`` (at least
    1, at most N), assigned one choice at a time by a cumsum over the
    tokens, so a token's second choice queues behind every first choice;
    tokens past an expert's capacity are dropped (the caller's residual
    carries them);
  - dense ``[B, N, E, C]`` dispatch and combine tensors and three einsums
    over the capacity buffer with the exact GELU, in the compute dtype;
  - the Switch load-balance aux loss ``E * sum_e f_e * P_e`` (``f_e`` the
    share of FIRST choices on e, ``P_e`` the mean router probability) and
    the dropped share ``1 - sum(dispatch) / (B * N * k)``, sown as
    ``moe_aux`` and ``moe_dropped`` (``layers.sow``), which ``SegTrainer``
    collects inside ``capture_intermediates``.

The top-k takes the FIRST maximum (``argmax``), as ``jax.lax.top_k`` puts
the lower index first under a tie: a constant token after a LayerNorm gives
router logits equal to the (zero at init) bias, so every expert ties there.
``F.one_hot`` raises for an index past the capacity where
``jax.nn.one_hot`` gives a zero row, so the position is clamped and the
row multiplied by ``keep``.

The parameters keep flax's names and layouts (``router``; ``wi`` [E, H, F],
``bi`` [E, F], ``wo`` [E, F, H], ``bo`` [E, H]). Over the data axis
(``layers.pool_over_ranks``) the load balance's ``f_e`` and ``P_e`` are
means over the ranks' global padded batch, their sums summed over the data
group before the product.

Over the expert axis (``expert_axis``; ``parallel/expert.py:shard_experts``
calls ``shard``) a rank holds ``E / ep`` experts. The ranks of an expert
group hold the same rows (the reference keeps rows whole over the axis), so
each computes the router, the ``[B, N, E, C]`` dispatch and combine and the
load balance whole, runs the three einsums for its own experts, and its
share of the combine is summed over the expert group (``reduce_from``: the
sum forward, the identity backward). A rank backpropagates through its own
experts only, so the expert path's gradients into the tokens and into the
gates are partial: both enter that path through ``copy_to`` (the identity
forward, the sum over the group backward), and the router and the input
then get whole gradients, the same on every rank of the group. The load
balance reads the gates before that ``copy_to``: it is whole on every rank,
and its gradient enters once. The sum replaces the reference's all-to-all:
that pays only when rows are split over the expert group too, and the
reference does not split them.

Over a split depth (``forward(x, space)``; the flagship's bottleneck at
BraTS's depth) each rank holds a contiguous block of every sample's token
sequence, in rank order. The capacity is the whole sequence's; a token's
buffer position adds the earlier ranks' counts of its expert (an exclusive
prefix over the space group), and with k=2 a second choice queues behind
the whole sequence's first choices, so routing and drops are one
process's token for token. The expert FFN is per token: a rank runs it on
its own kept tokens, and no buffer is gathered. The load balance's sums
meet over the data and space axes (``pool_over_ranks``), so ``f_e``,
``P_e`` and the dropped share are the global means.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.space import space_prefix, space_size
from ..parallel.tensor import copy_to, narrow_param, reduce_from
from .layers import pooled_sums, sow

EXPERT_AXIS = "expert"


def route(gates: torch.Tensor, k: int):
    """``jax.lax.top_k(gates, k)`` with its tie order (lower index first):
    ``(top_g, top_i)`` of shape ``[..., k]``."""
    first = gates.argmax(dim=-1, keepdim=True)
    if k == 1:
        return gates.gather(-1, first), first
    masked = gates.scatter(-1, first, float("-inf"))
    idx = torch.cat([first, masked.argmax(dim=-1, keepdim=True)], dim=-1)
    return gates.gather(-1, idx), idx


def capacity(n: int, num_experts: int, k: int, capacity_factor: float) -> int:
    return max(1, min(int(math.ceil(capacity_factor * k * n / num_experts)), n))


def dispatch_combine(gates: torch.Tensor, k: int, cap: int, space=None):
    """The ``[B, N, E, C]`` dispatch and combine tensors (f32) and the top-k
    indices, from the router's softmax ``gates`` [B, N, E]. Over a split
    token axis (``space``: this rank's block of each sample's sequence, in
    rank order) a token's buffer position also counts the earlier ranks'
    choices of its expert (``space_prefix``), and a second choice queues
    behind the whole sequence's first choices."""
    b, n, e = gates.shape
    top_g, top_i = route(gates, k)
    if k > 1:
        top_g = top_g / torch.clamp(top_g.sum(dim=-1, keepdim=True), min=1e-9)
    counts = gates.new_zeros(b, e)  # tokens already assigned to each expert
    dispatch = gates.new_zeros(b, n, e, cap)
    combine = gates.new_zeros(b, n, e, cap)
    for j in range(k):
        oh_e = F.one_hot(top_i[..., j], e).to(gates.dtype)  # [B, N, E]
        before, total = space_prefix(oh_e.sum(dim=1), space)  # [B, E]: earlier ranks', the sequence's
        pos_e = torch.cumsum(oh_e, dim=1) - 1.0 + (counts + before)[:, None, :]
        pos = (pos_e * oh_e).sum(dim=-1)  # [B, N]
        keep = (pos < cap).to(gates.dtype)
        oh_c = F.one_hot(pos.long().clamp(max=cap - 1), cap).to(gates.dtype)
        d_j = oh_e[..., None] * oh_c[:, :, None, :] * keep[..., None, None]
        dispatch = dispatch + d_j
        combine = combine + d_j * top_g[..., j][..., None, None]
        counts = counts + total
    return dispatch, combine, top_i


class MoEMlp(nn.Module):
    pools_over_ranks = True
    expert_kernels = ("wi", "wo")  # layers.init_flax_defaults: lecun over (in, out)
    ep = None  # the expert axis this block is cut over (``shard``)
    first = 0  # the index of this rank's first expert

    def __init__(self, hidden: int, mlp_dim: int, num_experts: int, k: int = 1, capacity_factor: float = 1.25,
                 expert_axis: Optional[str] = EXPERT_AXIS, dtype: torch.dtype = torch.float32):
        super().__init__()
        if k not in (1, 2):
            raise ValueError(f"MoEMlp supports top-1/top-2 routing, got k={k}")
        if num_experts < 2:
            raise ValueError(f"MoEMlp needs >= 2 experts, got {num_experts}")
        self.num_experts, self.k, self.capacity_factor = int(num_experts), int(k), float(capacity_factor)
        self.expert_axis, self.dtype = expert_axis, dtype
        self.mesh = None  # the data axis the load balance pools over (layers.pool_over_ranks)
        e = self.num_experts
        self.router = nn.Linear(hidden, e)
        self.wi = nn.Parameter(torch.zeros(e, hidden, mlp_dim))
        self.bi = nn.Parameter(torch.zeros(e, mlp_dim))
        self.wo = nn.Parameter(torch.zeros(e, mlp_dim, hidden))
        self.bo = nn.Parameter(torch.zeros(e, hidden))

    def shard(self, axis) -> None:
        """Keep this rank's block of experts over ``axis`` (dim 0 of ``wi``,
        ``bi``, ``wo`` and ``bo``)."""
        block = axis.block(self.num_experts, "num_experts")
        for name in ("wi", "bi", "wo", "bo"):
            narrow_param(self, name, 0, block, axis)
        self.ep, self.first = axis, block.start

    def forward(self, x: torch.Tensor, space=None) -> torch.Tensor:
        """``space``: the space axis when ``x`` [B, n, H] is this rank's
        block of each sample's sequence (a split depth's tokens)."""
        b, n, _ = x.shape
        e, k, dt = self.num_experts, self.k, self.dtype
        cap = capacity(n * space_size(space), e, k, self.capacity_factor)  # the whole sequence's
        # the router in f32 whatever the compute dtype
        gates = torch.softmax(F.linear(x.float(), self.router.weight, self.router.bias), dim=-1)
        dispatch, combine, top_i = dispatch_combine(copy_to(gates, self.ep), k, cap, space)
        top1 = F.one_hot(top_i[..., 0], e).to(gates.dtype)
        # the reference's means over the (global, padded) batch: over ranks
        # the sums meet BEFORE the product
        sums, world = pooled_sums(torch.cat([top1.sum(dim=(0, 1)), gates.sum(dim=(0, 1)),
                                             dispatch.sum().detach()[None]]), self.mesh)
        count = float(b * n * world)
        f_e, p_e = sums[:e] / count, sums[e:2 * e] / count
        sow("moe_aux", e * (f_e * p_e).sum())
        sow("moe_dropped", 1.0 - sums[2 * e] / (count * k))

        if self.ep is not None:  # this rank's experts
            mine = slice(self.first, self.first + self.wi.shape[0])
            dispatch, combine = dispatch[:, :, mine], combine[:, :, mine]
        x = copy_to(x.to(dt), self.ep)
        xin = torch.einsum("bnec,bnh->ebch", dispatch.to(dt), x)
        y = torch.einsum("ebch,ehf->ebcf", xin, self.wi.to(dt)) + self.bi.to(dt)[:, None, None, :]
        y = F.gelu(y, approximate="none")
        y = torch.einsum("ebcf,efh->ebch", y, self.wo.to(dt)) + self.bo.to(dt)[:, None, None, :]
        return reduce_from(torch.einsum("bnec,ebch->bnh", combine.to(dt), y), self.ep)


def collect_moe_aux(intermediates: dict) -> list:
    """Every sown ``moe_aux`` scalar of a ``capture_intermediates`` dict."""
    return list(intermediates.get("moe_aux", []))


__all__ = ["MoEMlp", "collect_moe_aux", "capacity", "dispatch_combine", "route", "EXPERT_AXIS"]
